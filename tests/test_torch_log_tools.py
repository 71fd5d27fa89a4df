"""The log, anchor, dataset-browse and synthetic-release tools of the PyTorch
port against the JAX package's scripts (loaded with importlib and run
through their ``main`` with ``sys.argv`` set), and the port's end-to-end
golden.

Host tools are held exactly:
- ``analyze_logs`` / ``analyze_wsi_logs``: the same stdout on log.json rows
  as the port's trainer writes them (train and val rows; rows with a
  ``time``; a missing key; an empty log); both draw their figure. Without
  matplotlib the port prints the same lines first, then raises ImportError
  naming it;
- ``optimize_anchors``: ``collect_whs`` over the port's dataset equal to the
  JAX tool's over its own, k-means and differential evolution equal on the
  same boxes and seed, and the same stdout and result file from ``main``;
- ``browse_dataset``: the same sample files; the decoded pixels equal to the
  port's own drawing, and to the JAX tool's wherever neither drew an
  outline; the outlines' pixels (thickness 2, which the port's
  ``draw_contours`` holds to OpenCV at an IoU ≥ 0.97, not bit for bit)
  overlapping at IoU ≥ 0.9;
- ``ops.contours.ellipse`` against ``cv2.ellipse(..., 0, 360, color, -1)``
  over 400 random ellipses, axes 0 to 40 (and below 3), any angle (negative
  and beyond 360, rounded halves), centres near and beyond the border;
- ``make_synthetic_pannuke``: the three .npy files byte-equal to the JAX
  tool's at 2 tiles, seeds 0 and 3;
- the golden's device-free hashes (stages 1 and 2 of the chain) equal to
  what the JAX tools write.

The whole chain against tests/goldens/e2e_synthetic_torch.json is opt-in
(``NUHTC_E2E=1``): it takes ~20 s on 8 CPU threads and ~48 s on one, too
much for Tier-1.
"""

import builtins
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest

from nuhtc_tpu_torch.ops.contours import ellipse
from nuhtc_tpu_torch.tools.analysis_tools import analyze_logs, analyze_wsi_logs, optimize_anchors
from nuhtc_tpu_torch.tools.misc import browse_dataset, make_synthetic_pannuke, run_e2e_golden
from nuhtc_tpu_torch.utils.imageio import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(rel: str):
    path = os.path.join(REPO, rel)
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(monkeypatch, capsys, rel, argv):
    mod = _script(rel)
    monkeypatch.setattr(sys, "argv", [rel] + list(argv))
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _run_port(capsys, main, argv):
    capsys.readouterr()
    main(list(argv))
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Two runs' log.json: train rows every step and val rows each epoch
    (as ``Trainer`` writes them), and a log whose rows carry a ``time``."""
    root = tmp_path_factory.mktemp("logs")
    rng = np.random.RandomState(0)
    paths = []
    for run in ("a", "b"):
        os.makedirs(root / run)
        rows = []
        for epoch in (1, 2):
            for i in (1, 2, 3):
                rows.append({"mode": "train", "epoch": epoch, "iter": i, "lr": 1e-4 * i,
                             "total": float(rng.rand()), "s2.loss_mask": float(rng.rand())})
            rows.append({"mode": "val", "epoch": epoch, "tag": "ema", "bPQ": float(rng.rand()),
                         "mPQ": float(rng.rand())})
        paths.append(str(root / run / "log.json"))
        with open(paths[-1], "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
    timed = str(root / "timed.json")
    with open(timed, "w") as f:
        f.write("".join(json.dumps({"mode": "train", "time": 0.1 * k, "total": 1.0}) + "\n"
                        for k in range(1, 5)))
    empty = str(root / "empty.json")
    open(empty, "w").close()
    return paths, timed, empty, root


@pytest.mark.parametrize("case", ["time", "train", "val", "empty"])
def test_analyze_logs_prints_as_jax(logs, monkeypatch, capsys, tmp_path, case):
    (a, b), timed, empty, _ = logs
    args = {"time": ["cal_train_time", a, b, timed],
            "train": ["plot_curve", a, b, "--keys", "total", "loss_cls", "s2.loss_mask",
                      "--title", "t"],
            "val": ["plot_curve", a, "--keys", "bPQ", "mPQ", "--mode", "val",
                    "--legend", "x", "y"],
            "empty": ["cal_train_time", empty]}[case]
    out = {}
    for side in ("jax", "port"):
        argv = args + (["--out", str(tmp_path / f"{side}.png")] if case in ("train", "val")
                       else [])
        out[side] = (_run_jax(monkeypatch, capsys, "tools/analysis_tools/analyze_logs.py", argv)
                     if side == "jax" else _run_port(capsys, analyze_logs.main, argv))
    assert out["port"].replace("port.png", "jax.png") == out["jax"]
    assert out["jax"]
    if case in ("train", "val"):
        assert (tmp_path / "port.png").stat().st_size > 1000


@pytest.mark.parametrize("task", ["plot_val_curve", "cal_train_time"])
def test_analyze_wsi_logs_prints_as_jax(logs, monkeypatch, capsys, tmp_path, task):
    (a, _), _, _, _ = logs
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools", "analysis_tools"))
    args = [task, a] + (["--keys", "bPQ"] if task == "plot_val_curve" else [])
    want = _run_jax(monkeypatch, capsys, "tools/analysis_tools/analyze_wsi_logs.py",
                    args + (["--out", str(tmp_path / "v.png")] if task == "plot_val_curve"
                            else []))
    got = _run_port(capsys, analyze_wsi_logs.main,
                    args + (["--out", str(tmp_path / "v.png")] if task == "plot_val_curve"
                            else []))
    assert got == want
    with pytest.raises(SystemExit, match="usage"):
        analyze_wsi_logs.main(["plot"])


def test_plot_without_matplotlib_raises_after_the_lines(logs, monkeypatch, capsys, tmp_path):
    (a, _), _, _, _ = logs
    real = builtins.__import__

    def no_mpl(name, *args, **kw):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    capsys.readouterr()
    with pytest.raises(ImportError, match="matplotlib"):
        analyze_logs.main(["plot_curve", a, "--keys", "total", "nope", "--out",
                           str(tmp_path / "c.png")])
    assert capsys.readouterr().out == f"{a}: no 'nope' in mode=train rows\n"
    assert not (tmp_path / "c.png").exists()


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """Stages 1 and 2 of the golden chain by the port (fold 1: 8 tiles, fold
    3: 4), under the root the tiny config reads from NUHTC_SYN_ROOT."""
    root = str(tmp_path_factory.mktemp("release"))
    run_e2e_golden.make_data(root)
    return root


class _WithDataInfos:
    """The JAX tool reads mmdet's ``dataset.data_infos``, which the JAX
    package's datasets lack (its ``main`` raises AttributeError on them);
    this view of a JAX dataset adds it, from ``img_info``. The port reads
    ``img_info`` itself."""

    def __init__(self, ds):
        self.ds = ds
        self.data_infos = [ds.img_info(i) for i in range(len(ds))]

    def __len__(self):
        return len(self.ds)

    def get_ann_info(self, idx):
        return self.ds.get_ann_info(idx)


@pytest.fixture
def jax_anchor_data(release, monkeypatch):
    import nuhtc_tpu.data as jax_data

    monkeypatch.setenv("NUHTC_SYN_ROOT", release)
    real = jax_data.build_dataset
    monkeypatch.setattr(jax_data, "build_dataset", lambda cfg: _WithDataInfos(real(cfg)))
    return real


def test_collect_whs_kmeans_and_de_equal_jax(jax_anchor_data):
    jax_tool = _script("tools/analysis_tools/optimize_anchors.py")
    from nuhtc_tpu.config import Config as JaxConfig

    cfg = JaxConfig.fromfile(run_e2e_golden.CONFIG)
    ds = _WithDataInfos(jax_anchor_data(cfg.data["train"]["dataset"]))
    want = jax_tool.collect_whs(ds, [512, 384])
    _, got = optimize_anchors.train_boxes(run_e2e_golden.CONFIG, [512, 384])
    np.testing.assert_array_equal(got, want)
    assert len(got) > 100
    quiet = dict(logger=lambda *a: None)
    for k in (1, 3, 5):
        assert (optimize_anchors.kmeans_anchors(got, k, 100, seed=2, **quiet)
                == jax_tool.kmeans_anchors(got, k, 100, seed=2, **quiet))
    assert (optimize_anchors.de_anchors(got[:60], 3, 15, [512, 384], seed=1, **quiet)
            == jax_tool.de_anchors(got[:60], 3, 15, [512, 384], seed=1, **quiet))


def test_optimize_anchors_main_equals_jax(jax_anchor_data, monkeypatch, capsys, tmp_path):
    monkeypatch.syspath_prepend(REPO)
    argv = [run_e2e_golden.CONFIG, "--algorithm", "k-means", "--input-shape", "256", "256",
            "--iters", "50", "--num-anchors", "4"]
    want = _run_jax(monkeypatch, capsys, "tools/analysis_tools/optimize_anchors.py",
                    argv + ["--output-dir", str(tmp_path / "jax")])
    got = _run_port(capsys, optimize_anchors.main, argv + ["--output-dir", str(tmp_path / "port")])
    assert got.replace("/port/", "/jax/") == want
    assert ((tmp_path / "port" / "anchor_optimize_result.json").read_text()
            == (tmp_path / "jax" / "anchor_optimize_result.json").read_text())


def test_browse_dataset_pixels(release, monkeypatch, capsys, tmp_path):
    from nuhtc_tpu_torch.utils import visualize

    monkeypatch.setenv("NUHTC_SYN_ROOT", release)
    monkeypatch.syspath_prepend(REPO)
    argv = [run_e2e_golden.CONFIG, "--num", "3", "--seed", "4"]
    _run_jax(monkeypatch, capsys, "tools/misc/browse_dataset.py",
             argv + ["--out", str(tmp_path / "jax")])
    assert browse_dataset.main(argv + ["--out", str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 3
    drawn = dict(browse_dataset.render_samples(run_e2e_golden.CONFIG, 3, seed=4))
    # the same samples with nothing drawn on them
    monkeypatch.setattr(visualize, "draw_detections", lambda img, *a, **k: img.copy())
    bare = dict(browse_dataset.render_samples(run_e2e_golden.CONFIG, 3, seed=4))
    assert sorted(drawn) == sorted(bare) == names
    for name in names:
        got = read_png(str(tmp_path / "port" / name))
        want = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / name)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, drawn[name])
        on_port = (got != bare[name]).any(-1)
        on_jax = (want != bare[name]).any(-1)
        # outside both drawings the sample itself: equal
        assert not ((got != want).any(-1) & ~on_port & ~on_jax).any()
        iou = (on_port & on_jax).sum() / max((on_port | on_jax).sum(), 1)
        assert on_port.any() and iou >= 0.9, iou


def test_ellipse_equals_cv2():
    rng = np.random.RandomState(31)
    for k in range(400):
        h, w = rng.randint(6, 72, 2)
        center = (int(rng.randint(-12, w + 12)), int(rng.randint(-12, h + 12)))
        axes = tuple(int(a) for a in (rng.randint(0, 3, 2) if k % 4 == 0
                                      else rng.randint(0, 40, 2)))
        angle = (float(rng.randint(-2, 3)) * 180.0 + 0.5 if k % 10 == 0
                 else float(rng.uniform(-450, 450)))
        want = np.zeros((h, w), np.uint8)
        cv2.ellipse(want, center, axes, angle, 0, 360, 1, -1)
        got = ellipse(np.zeros((h, w), np.uint8), center, axes, angle, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{k}: {center} {axes} {angle}")


@pytest.mark.parametrize("seed", [0, 3])
def test_make_synthetic_pannuke_is_byte_equal(seed, monkeypatch, capsys, tmp_path):
    argv = ["--n-tiles", "2", "--seed", str(seed)]
    want = _run_jax(monkeypatch, capsys, "tools/misc/make_synthetic_pannuke.py",
                    argv + ["--out", str(tmp_path / "jax")])
    got = _run_port(capsys, make_synthetic_pannuke.main, argv + ["--out", str(tmp_path / "port")])
    assert got.replace("port", "jax") == want
    for name in ("images.npy", "masks.npy", "types.npy"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_golden_device_free_hashes_are_the_jax_tools(release, monkeypatch, capsys, tmp_path):
    """Stages 1 and 2 by the JAX tools give the golden's hashes, as the
    port's stages do."""
    work = str(tmp_path)
    for fold, raw, n, seed in run_e2e_golden.FOLDS:
        _run_jax(monkeypatch, capsys, "tools/misc/make_synthetic_pannuke.py",
                 ["--out", os.path.join(work, raw), "--n-tiles", str(n), "--seed", str(seed)])
    monkeypatch.syspath_prepend(REPO)
    for fold, raw, _, _ in run_e2e_golden.FOLDS:
        _run_jax(monkeypatch, capsys, "tools/preprocess_pannuke.py",
                 ["--images", os.path.join(work, raw, "images.npy"),
                  "--masks", os.path.join(work, raw, "masks.npy"),
                  "--types", os.path.join(work, raw, "types.npy"), "--fold", fold,
                  "--out-dir", os.path.join(work, "datasets", "PanNuke"),
                  "--coco-dir", os.path.join(work, "coco", "PanNuke")])
    with open(run_e2e_golden.GOLDEN) as f:
        want = json.load(f)["device_free"]
    assert len(want) == 6 + 4 + 2 * 12
    assert run_e2e_golden.device_free_hashes(work) == want
    assert run_e2e_golden.device_free_hashes(release) == want


@pytest.mark.skipif(not os.environ.get("NUHTC_E2E"),
                    reason="the whole chain takes ~20-48 s on the CPU; set NUHTC_E2E=1")
def test_e2e_chain_matches_the_port_golden(tmp_path):
    summary = run_e2e_golden.build_chain(str(tmp_path / "work"), "cpu", log=lambda *a: None)
    errs = run_e2e_golden.check(summary, "cpu")
    assert not errs, "\n".join(errs)
