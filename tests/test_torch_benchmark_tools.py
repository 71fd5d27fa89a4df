"""The port's benchmark tools and profiling helpers against the JAX
package's (``nuhtc_tpu/utils/profiling.py`` and the scripts
``tools/analysis_tools/{benchmark,benchmark_wsi,benchmark_train,get_flops}.py``,
``tools/misc/wsi_throughput_summary.py``, loaded with importlib and run
through their ``main`` with ``sys.argv`` set), in this process, on the tiny
config and the CPU. Where a JAX tool would build or compile its full-width
model, the test patches the names it calls (in the test, through
``monkeypatch``) so that it records its inputs and stops.

- ``profiling``: ``Timer`` and ``ThroughputMeter`` of both packages under
  one patched ``time.perf_counter``: equal laps, report strings and rates;
  ``trace`` on the CPU writes a Chrome trace that holds the span.
- ``benchmark``: the port's random batches equal the JAX tool's exactly;
  ``measure_inference_speed`` on the tiny engine calls ``engine.forward``
  warmup + max_iter times and prints the JAX function's lines, byte for
  byte, when both see the same clock.
- ``benchmark_wsi``: the slide and its tile origins byte-equal to the JAX
  tool's (captured at ``cv2.imwrite`` and ``infer_slide``).
- ``benchmark_train``: the batch equal to the JAX tool's (captured at
  ``jax.jit``'s step, before any compile); one port step on it at the tiny
  width gives finite losses.
- ``get_flops``: the parameter count equal to the JAX tree's (shapes by
  ``eval_shape``: no compile); backbone + FPN products equal to the sum
  written out below from the config's widths; the full count above it.
- ``wsi_throughput_summary``: on one save directory, the mean and nuclei
  lines byte-equal, the table's cells equal as values.
"""

import importlib.util
import json
import math
import os
import sys
import time
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuhtc_tpu.models.detector  # noqa: F401  (imported before jax.jit is patched)
import nuhtc_tpu.train.train_state  # noqa: F401
import nuhtc_tpu.utils.cache
import nuhtc_tpu.wsi.infer
import nuhtc_tpu.wsi.slide
from nuhtc_tpu.utils import profiling as jax_profiling
from nuhtc_tpu_torch import __version__
from nuhtc_tpu_torch.apis.inference import init_detector
from nuhtc_tpu_torch.tools.analysis_tools import (
    benchmark, benchmark_train, benchmark_wsi, get_flops,
)
from nuhtc_tpu_torch.tools.misc import wsi_throughput_summary
from nuhtc_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_tiny_synthetic.py")


class Stop(Exception):
    """Raised by a patched name to end a JAX tool once its inputs are recorded."""


def _script(rel: str):
    path = os.path.join(REPO, rel)
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_clock(monkeypatch, ticks):
    """``time.perf_counter`` returns the next of ``ticks``."""
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def test_version_is_the_jax_packages():
    from nuhtc_tpu.version import __version__ as jax_version

    assert __version__ == jax_version == "0.1.0"


def test_timer_and_meter_equal_jax(monkeypatch):
    ticks = [0.0, 0.125, 0.5, 0.75, 1.5, 2.0, 3.25, 3.5, 4.0, 4.125, 7.5, 9.0]
    laps = ["read", "forward", "read", "post", "forward"]
    out = []
    for mod in (jax_profiling, profiling):
        _fake_clock(monkeypatch, ticks)
        timer = mod.Timer()
        dts = [timer.lap(name) for name in laps]
        out.append((dts, dict(timer.laps), timer.report()))
    assert out[0] == out[1]
    assert out[1][2] == ("total 3.250s | read: 0.375s (12%) | forward: 0.875s (27%) | "
                         "post: 0.750s (23%)")
    rates = []
    for mod in (jax_profiling, profiling):
        _fake_clock(monkeypatch, ticks)
        meter = mod.ThroughputMeter(window=4)
        seen = [meter.rate]
        for n in (16, 16, 8, 16, 16, 4, 16):
            meter.update(n)
            seen.append(meter.rate)
        rates.append((seen, list(meter.counts), list(meter.times)))
    assert rates[0] == rates[1]
    assert rates[1][1] == [16, 16, 4, 16]


def test_trace_writes_the_span_on_the_cpu(tmp_path):
    with profiling.trace("tiny_span", log_dir=str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "tiny_span.pt.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "tiny_span" for e in events)
    assert any(e.key == "tiny_span" for e in prof.key_averages())


def test_benchmark_inputs_equal_jax(monkeypatch):
    mod = _script("tools/analysis_tools/benchmark.py")
    seen = {}

    def record(engine, imgs, max_iter, log_interval, warmup=5):
        seen["imgs"] = [np.asarray(x) for x in imgs]
        return 1.0

    monkeypatch.setattr(mod, "measure_inference_speed", record)
    monkeypatch.setattr("nuhtc_tpu.apis.init_detector",
                        lambda *a, **k: types.SimpleNamespace(input_size=64))
    monkeypatch.setattr(sys, "argv", ["benchmark.py", CFG, "--batch-size", "2"])
    mod.main()
    mine = benchmark.random_inputs(2, 64)
    assert len(seen["imgs"]) == len(mine) == 4
    for a, b in zip(seen["imgs"], mine):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("n,batch,want", [(5, 2, [[0, 1], [2, 3]]), (20, 4, [
    [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15]]), (3, 8, [[0, 1, 2]])])
def test_benchmark_dataset_batches(monkeypatch, n, batch, want):
    """``--dataset``: the JAX tool's batching of the test images: up to 4
    full batches, or one short batch when there are fewer images."""
    ds = type("DS", (), {"__len__": lambda self: n, "load_image": lambda self, i: i})()
    monkeypatch.setattr("nuhtc_tpu_torch.data.coco.build_dataset", lambda cfg: ds)
    engine = types.SimpleNamespace(preprocess=list)
    cfg = types.SimpleNamespace(data=types.SimpleNamespace(test={}))
    assert benchmark.dataset_inputs(engine, cfg, batch) == want


def test_measure_inference_speed_prints_the_jax_lines(monkeypatch, capsys):
    """The JAX function on a stand-in engine and the port's on the tiny
    engine, each forward advancing one shared clock by 0.25 s: the same
    printed lines and img/s; the port's forward runs warmup + max_iter times."""
    mod = _script("tools/analysis_tools/benchmark.py")
    warmup, max_iter, log_interval = 1, 2, 1
    printed, fps = [], []

    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def jax_forward(params, x, hs, ws):
        clock[0] += 0.25
        return {"scores": np.zeros((x.shape[0], 4), np.float32)}

    engine = types.SimpleNamespace(_forward=jax_forward, _paste=None, params=None)
    imgs = benchmark.random_inputs(1, 32, count=2)
    fps.append(mod.measure_inference_speed(engine, imgs, max_iter, log_interval, warmup))
    printed.append(capsys.readouterr().out)

    clock[0] = 0.0
    engine = init_detector(CFG, None, batch_size=1, device="cpu")
    calls = []
    forward = engine.forward

    def counted(x):
        calls.append(tuple(x.shape))
        out = forward(x)
        clock[0] += 0.25
        return out

    engine.forward = counted
    imgs = [torch.from_numpy(x) for x in benchmark.random_inputs(1, engine.input_size, count=2)]
    fps.append(benchmark.measure_inference_speed(engine, imgs, max_iter, log_interval, warmup))
    printed.append(capsys.readouterr().out)

    assert calls == [(1, engine.input_size, engine.input_size, 3)] * (warmup + max_iter)
    assert printed[0] == printed[1]
    assert printed[1].splitlines() == [
        "Done image [1  / 2], fps: 4.0 img / s, times per image: 250.0 ms / img",
        "Done image [2  / 2], fps: 4.0 img / s, times per image: 250.0 ms / img",
        "Overall fps: 4.0 img / s, times per image: 250.0 ms / img",
    ]
    assert fps[0] == fps[1] == 4.0


def test_benchmark_wsi_slide_equals_jax(monkeypatch):
    mod = _script("tools/analysis_tools/benchmark_wsi.py")
    seen = {}

    def imwrite(path, img):
        seen["img"] = img[..., ::-1].copy()  # the tool writes BGR
        return True

    def infer_slide(engine, slide, coords, *a, **k):
        seen["coords"] = np.asarray(coords)
        raise Stop

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(nuhtc_tpu.utils.cache, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(cv2, "imwrite", imwrite)
    monkeypatch.setattr(nuhtc_tpu.wsi.slide, "ImageReader", lambda path: None)
    monkeypatch.setattr("nuhtc_tpu.apis.inference.init_detector",
                        lambda *a, **k: types.SimpleNamespace(num_classes=5))
    monkeypatch.setattr(nuhtc_tpu.wsi.infer, "infer_slide", infer_slide)
    monkeypatch.setattr(sys, "argv", ["benchmark_wsi.py", "--tiles", "10"])
    with pytest.raises(Stop):
        mod.main()
    img, coords = benchmark_wsi.synthetic_benchmark_slide(10)
    assert img.dtype == seen["img"].dtype and img.shape == (512, 2048, 3)
    assert img.tobytes() == seen["img"].tobytes()
    assert coords.dtype == seen["coords"].dtype and coords.tobytes() == seen["coords"].tobytes()
    assert coords.shape == (10, 2) and coords[9].tolist() == [256, 256]


def test_benchmark_train_batch_equals_jax_and_steps(monkeypatch):
    mod = _script("tools/analysis_tools/benchmark_train.py")
    seen = {}

    class FakeNuHTC:
        def __init__(self, **kwargs):
            seen["model"] = kwargs

        def init(self, *a, **k):
            return {}

    def jit(fn):
        def step(state, batch, key):
            seen["batch"] = {k: np.asarray(v) for k, v in batch.items()}
            raise Stop

        return step

    monkeypatch.setenv("B", "1")
    monkeypatch.setattr(nuhtc_tpu.utils.cache, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setattr(nuhtc_tpu.models.detector, "NuHTC", FakeNuHTC)
    monkeypatch.setattr(nuhtc_tpu.train.train_state, "create_train_state",
                        lambda model, params: (None, None))
    monkeypatch.setattr(nuhtc_tpu.train.train_state, "make_train_step", lambda model, tx: None)
    monkeypatch.setattr(jax, "jit", jit)
    with pytest.raises(Stop):
        mod.main()
    monkeypatch.undo()

    assert seen["model"] == dict(num_classes=5, dtype=jnp.bfloat16, scale_factor=1.0)
    mine = benchmark_train.synthetic_train_batch(np.random.RandomState(0), 1)
    assert sorted(mine) == sorted(seen["batch"])
    for k, v in mine.items():
        assert v.dtype == seen["batch"][k].dtype and np.array_equal(v, seen["batch"][k]), k

    # one step at the tiny config's widths on the CPU
    model = benchmark_train.build_model(
        torch.device("cpu"), fpn_channels=32,
        backbone_cfg=dict(embed_dims=32, depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8]))
    metrics = benchmark_train.make_step(model)({k: torch.from_numpy(v) for k, v in mine.items()})
    metrics = {k: float(v) for k, v in metrics.items()}
    assert metrics["total"] > 0 and "grad_norm" in metrics
    assert all(math.isfinite(v) for v in metrics.values()), metrics


def _swin_fpn_products(side, embed, heads, fpn, window=7):
    """2·M·N·K of every matrix product and convolution of the tiny config's
    Swin (one block a stage, so no shifted window) + FPN on a side² input,
    B1: the patch embedding (4×4 stride 4 from 3 channels); per stage on
    the window-padded map of p² tokens qkv (C → 3C), q·kᵀ and attn·v per
    49-token window, proj (C → C), on the map's s² tokens the MLP (C → 4C →
    C), then the 2×2 merge (4C → 2C on (s/2)²); the FPN's 1×1 laterals and
    3×3 outputs."""
    s = side // 4
    total = 2 * s * s * embed * 3 * 4 * 4
    for i in range(len(heads)):
        c = embed * 2 ** i
        p = -(-s // window) * window
        n = window * window
        total += 2 * p * p * c * 3 * c                        # qkv
        total += 2 * 2 * n * n * c * (p * p // n)            # q·kᵀ, attn·v
        total += 2 * p * p * c * c                            # proj
        total += 2 * s * s * c * 4 * c * 2                    # fc1, fc2
        total += 2 * s * s * c * fpn + 2 * s * s * fpn * fpn * 9  # lateral, output conv
        if i < len(heads) - 1:
            total += 2 * (s // 2) * (s // 2) * 4 * c * 2 * c  # patch merging
            s //= 2
    return total


def test_get_flops_counts_equal_jax_params_and_the_products(capsys):
    from nuhtc_tpu.config import Config as JaxConfig
    from nuhtc_tpu.models.build import build_detector as jax_build

    cfg = JaxConfig.fromfile(CFG)
    model = jax_build(cfg.model, cfg.model.get("test_cfg"))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), method="init_forward"))
    jax_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))

    out = get_flops.main([CFG, "--shape", "250", "--device", "cpu"])  # padded to 256
    lines = capsys.readouterr().out.splitlines()
    assert out["params"] == jax_params
    assert out["feats_flops"] == _swin_fpn_products(256, 32, (1, 2, 4, 8), 32)
    assert out["full_flops"] > out["feats_flops"]
    assert lines == [f"params: {jax_params / 1e6:.2f} M",
                     f"backbone+fpn flops: {out['feats_flops'] / 1e9:.2f} GFLOPs (batch 1)",
                     f"full pipeline flops: {out['full_flops'] / 1e9:.2f} GFLOPs (batch 1)"]


def _save_dir(root):
    rows = ["slide_id,status,n_patches,seg_time,patch_time",
            "a.png,processed,73,0.3125,0.0625",
            "b.png,already_exist,,,",
            "c.png,processed,12,1.2345678,0.5"]
    (root / "process_list_autogen.csv").write_text("\n".join(rows) + "\n")
    for slide, docs in (("a", {"a.geojson": {"type": "FeatureCollection", "features": [{}] * 3},
                               "a_point.geojson": {"features": [{}] * 5},
                               "a_merged.geojson": [{}] * 2}),
                        ("c", {"c.geojson": [{}] * 7})):
        d = root / "nuclei" / slide
        d.mkdir(parents=True)
        for name, doc in docs.items():
            (d / name).write_text(json.dumps(doc))


def _cell(text):
    try:
        return float(text)
    except ValueError:
        return text


def test_wsi_throughput_summary_equals_jax(monkeypatch, capsys, tmp_path):
    _save_dir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["wsi_throughput_summary.py", str(tmp_path)])
    _script("tools/misc/wsi_throughput_summary.py").main()
    want = capsys.readouterr().out.splitlines()
    assert wsi_throughput_summary.main([str(tmp_path)]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4 + 3 + 2
    assert got[4:] == want[4:]
    assert got[-2:] == [f"{'a.geojson':<40s} {3:>8d} nuclei", f"{'c.geojson':<40s} {7:>8d} nuclei"]
    for g, w in zip(got[:4], want[:4]):
        cg, cw = [_cell(c) for c in g.split()], [_cell(c) for c in w.split()]
        assert len(cg) == len(cw)
        for a, b in zip(cg, cw):
            assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b)), (g, w)


@pytest.mark.parametrize("tool,argv", [
    (benchmark, [CFG]),
    (benchmark_wsi, []),
    (benchmark_train, []),
    (get_flops, [CFG]),
])
def test_tools_raise_without_cuda(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
