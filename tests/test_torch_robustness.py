"""The corruption-robustness run of the port
(``nuhtc_tpu_torch.tools.analysis_tools.test_robustness``) against the JAX
package's tools/analysis_tools/test_robustness.py, on the CPU.

Both run on the tiny shared-weight detector of tests/test_torch_patch_tools.py
(``world``: one reference-named ``.pth``; the JAX engine built from it by the
key map in place of its ``init_detector``, f32 products) over a synthetic
PanNuke release of four 256² tiles, with ``--corruptions gaussian_noise
elastic_transform --severities 0 1 --out``, batches of 2:

- the images handed to ``run_batch`` are equal, run by run;
- the detections are one to one (scores 1e-4, boxes 1e-3 px, masks equal
  but for at most 3 pixels a detection);
- the printed lines agree to their 4 decimals, and every metric in the
  ``--out`` json is within 1e-6, under the same {distortion: {severity:
  metrics}} layout.

Also pinned: ``corrupt`` draws the same noise for every image (a fresh
``RandomState`` per call) and truncates to uint8; ``jpeg`` is an alias;
severity 0 is the clean run, reused for every corruption; without
``--device`` and without CUDA the command line raises.
"""

import json
import re

import numpy as np
import pytest
import torch

from nuhtc_tpu_torch.apis.inference import InferenceEngine
from nuhtc_tpu_torch.tools.analysis_tools import test_robustness
from test_torch_patch_tools import CFG, assert_one_to_one, run_jax, world  # noqa: F401
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

ARGS = ["--corruptions", "gaussian_noise", "elastic_transform", "--severities", "0", "1",
        "--limit", "4"]


def _record(calls):
    """A run_batch that keeps its inputs and outputs."""
    def wrap(run):
        def recording(imgs):
            out = run(imgs)
            calls.append(([np.array(x) for x in imgs], out))
            return out
        return recording
    return wrap


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Both command lines with the same arguments: {pkg: (json, stdout, calls)}."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("robustness")
    out = {}
    for pkg in ("jax", "port"):
        calls = []
        path = root / f"{pkg}.json"
        argv = [CFG, world["ckpt"], *ARGS, "--out", str(path), "--cfg-options",
                *world["cfg_options"]]
        buf = io.StringIO()
        mp = pytest.MonkeyPatch()
        try:
            with contextlib.redirect_stdout(buf):
                if pkg == "jax":
                    engine = world["jax_engine"]
                    mp.setattr(engine, "run_batch", _record(calls)(engine.run_batch))
                    run_jax(world, "analysis_tools/test_robustness.py", argv)
                else:
                    plain = InferenceEngine.run_batch
                    mp.setattr(InferenceEngine, "run_batch",
                               lambda self, imgs: _record(calls)(
                                   lambda x: plain(self, x))(imgs))
                    assert test_robustness.main(argv + ["--device", "cpu"], batch_size=2) == 0
        finally:
            mp.undo()
        out[pkg] = (json.load(open(path)), buf.getvalue(), calls)
    return out


def test_corrupted_inputs_equal(runs):
    got, want = runs["port"][2], runs["jax"][2]
    assert len(got) == len(want) == 3 * 2  # clean + two corruptions, 2 batches of 2
    for (g_imgs, _), (w_imgs, _) in zip(got, want):
        assert len(g_imgs) == len(w_imgs) == 2
        for g, w in zip(g_imgs, w_imgs):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


def test_detections_one_to_one(runs):
    n = 0
    for (_, g_out), (_, w_out) in zip(runs["port"][2], runs["jax"][2]):
        for g, w in zip(g_out, w_out):
            n += assert_one_to_one({k: np.asarray(v) for k, v in g.items()},
                                   {k: np.asarray(v) for k, v in w.items()})
    assert n >= 100


def test_metrics_json_within_1e6(runs):
    got, want = runs["port"][0], runs["jax"][0]
    assert list(got) == list(want) == ["gaussian_noise", "elastic_transform"]
    for kind in want:
        assert list(got[kind]) == list(want[kind]) == ["0", "1"]
        assert got[kind]["0"] == got["gaussian_noise"]["0"]  # the clean run, reused
        for sev in want[kind]:
            assert list(got[kind][sev]) == list(want[kind][sev])
            for k, v in want[kind][sev].items():
                np.testing.assert_allclose(got[kind][sev][k], v, rtol=0, atol=1e-6,
                                           err_msg=f"{kind} {sev} {k}")
    assert got["gaussian_noise"]["1"] != got["gaussian_noise"]["0"]
    assert max(got["elastic_transform"]["1"].values()) > 0


def test_printed_lines_agree(runs):
    got = runs["port"][1].replace("port.json", "jax.json").splitlines()
    want = runs["jax"][1].splitlines()
    assert [re.sub(r"[\d.]+$", "", s) for s in got] == [re.sub(r"[\d.]+$", "", s) for s in want]
    assert got[0].startswith("clean: pq=") and got[-1].startswith("wrote ")
    for g, w in zip(got[:-1], want[:-1]):
        assert abs(float(g.split("=")[1]) - float(w.split("=")[1])) <= 1.5e-4


def test_corrupt_quirks():
    img = np.random.RandomState(0).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    a = test_robustness.corrupt(img, "gaussian_noise", 3)
    np.testing.assert_array_equal(a, test_robustness.corrupt(img, "gaussian_noise", 3, seed=0))
    assert not np.array_equal(a, test_robustness.corrupt(img, "gaussian_noise", 3, seed=1))
    noise = test_robustness.CORRUPTIONS["gaussian_noise"](img, 3, np.random.RandomState(0))
    np.testing.assert_array_equal(a, np.clip(noise, 0, 255).astype(np.uint8))  # truncated
    assert (np.rint(noise) != a).any()
    np.testing.assert_array_equal(test_robustness.corrupt(img, "jpeg", 2),
                                  test_robustness.corrupt(img, "jpeg_compression", 2))
    with pytest.raises(ValueError):
        test_robustness.corrupt(img, "rain", 1)
    assert test_robustness._expand_corruptions(["noise", "gaussian_noise", "jpeg", "None"]) == [
        "gaussian_noise", "shot_noise", "impulse_noise", "jpeg"]
    with pytest.raises(ValueError):
        test_robustness._expand_corruptions(["rain"])


def test_raises_without_cuda(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_robustness.main([CFG, world["ckpt"], *ARGS, "--cfg-options",
                              *world["cfg_options"]])
