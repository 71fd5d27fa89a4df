"""The port's spans and counters (``nuhtc_tpu_torch/utils/profiling.py``) on
the CPU, on tiny detectors with random weights (the objectness lifted so
that detections exist) and a tiny ``ArraySlide``:

- off (no ``spans()``, no profiler recording): a batch builds no
  ``record_function``, ``COUNTERS`` and ``SECONDS`` stay empty, and the
  timers that take ``into`` still sum;
- on (inside ``profiling.trace``, or under a bare ``torch.profiler``): every
  documented span of the engine and of the NuHTC and Mask R-CNN forwards is
  in the Chrome trace, inside the span documented as its parent;
- ``infer_slide``: its returned keys unchanged, its timers equal to the
  spans that take them, the ``wsi.*`` spans nested as documented,
  ``wsi.detections`` and ``wsi.nuclei`` equal to the detections entering
  post and the nuclei returned;
- ``nms.rounds`` on a suppression chain of k boxes: k rounds (k - 1 that
  change the keep set, one that finds it fixed);
- ``span_table`` on synthetic traces: self time under nested spans, device
  time by the launch's correlation (a kernel that runs after its span
  closed), idle given to the innermost span open, a trace with no program
  span, records that start before their launch.
"""

import json
import os

import numpy as np
import pytest
import torch

from nuhtc_tpu_torch.apis.inference import InferenceEngine
from nuhtc_tpu_torch.models.build import init_random_weights
from nuhtc_tpu_torch.models.detector import NuHTC
from nuhtc_tpu_torch.models.mask_rcnn import MaskRCNN
from nuhtc_tpu_torch.ops import nms as nms_ops
from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_tiles
from nuhtc_tpu_torch.utils import profiling
from nuhtc_tpu_torch.wsi import infer
from nuhtc_tpu_torch.wsi.slide import ArraySlide
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

T = 96
BACKBONE = dict(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8))
MODELS = {
    "nuhtc": lambda: NuHTC(num_classes=5, fpn_channels=32, backbone_cfg=BACKBONE,
                           rpn_nms_pre=128, rpn_max_per_img=64, rpn_min_bbox_size=0.0,
                           rcnn_max_per_img=32, rcnn_score_thr=0.05, watershed_max=32,
                           nms_candidates=128, scale_factor=1.0),
    "maskrcnn": lambda: MaskRCNN(num_classes=5, fpn_channels=32, backbone_cfg=BACKBONE,
                                 rpn_nms_pre=128, rpn_max_per_img=64, rcnn_max_per_img=32,
                                 nms_candidates=128),
}
ENGINE_PARENTS = {"engine.upload": "engine.dispatch", "engine.prep": "engine.dispatch",
                  "engine.forward": "engine.dispatch", "engine.paste": "engine.forward",
                  "engine.wait": "engine.collect", "engine.download": "engine.collect",
                  "engine.split": "engine.collect"}
MODEL_SPANS = {
    "nuhtc": {"model.backbone": 1, "model.neck": 1, "model.rpn_head": 1,
              "model.rpn_proposals": 1, "model.semantic": 1, "model.components": 1,
              "model.bbox_stage": 3, "model.multiclass_nms": 1, "model.mask_head": 1},
    "maskrcnn": {"model.backbone": 1, "model.neck": 1, "model.rpn_head": 1,
                 "model.rpn_proposals": 1, "model.bbox_stage": 1, "model.multiclass_nms": 1,
                 "model.mask_head": 1},
}


def _engine(kind: str) -> InferenceEngine:
    model = MODELS[kind]()
    init_random_weights(model, torch.Generator().manual_seed(0))
    lift_objectness(model)
    return InferenceEngine(model.eval(), batch_size=2, tile_size=T, scale_factor=1.0,
                           device_preprocess=True, compact_masks=True)


@pytest.fixture(scope="module")
def engines():
    return {kind: _engine(kind) for kind in MODELS}


@pytest.fixture(scope="module")
def tiles():
    return synthetic_tiles(np.random.RandomState(0), 2, T)


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.COUNTERS.clear()
    profiling.SECONDS.clear()
    yield
    assert not profiling.enabled()


def _trace_events(tmp_path, name, fn):
    with profiling.trace(name, log_dir=str(tmp_path)):
        out = fn()
    with open(os.path.join(str(tmp_path), f"{name}.pt.trace.json")) as f:
        return json.load(f)["traceEvents"], out


def _spans_with_parents(events, window):
    """[(name, name of the innermost enclosing span or None)] of the
    ``user_annotation`` spans inside ``window``, in start order."""
    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    win = next(e for e in ann if e["name"] == window)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    inside = sorted((e for e in ann if e is not win and w0 <= e["ts"] <= w1),
                    key=lambda e: (e["ts"], -e["dur"]))
    out = []
    for e in inside:
        holders = [p for p in inside if p is not e and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        parent = min(holders, key=lambda p: p["dur"])["name"] if holders else None
        out.append((e["name"], parent))
    return out


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_spans_off_build_nothing(engines, tiles, kind, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    engine = engines[kind]
    engine.collect_timing.update(device_s=0.0, download_s=0.0)
    assert profiling.span("a") is profiling.span("b")
    engine.run_batch(tiles)
    assert profiling.COUNTERS == {} and profiling.SECONDS == {}
    assert engine.collect_timing["download_s"] > 0.0


@pytest.mark.parametrize("switch", ["trace", "profiler"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_spans_on_nest_as_documented(engines, tiles, kind, switch, tmp_path):
    engine = engines[kind]
    if switch == "trace":
        events, _ = _trace_events(tmp_path, "batch", lambda: engine.run_batch(tiles))
    else:  # a bare profiler turns the spans on while it records
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("batch"):
                engine.run_batch(tiles)
        path = str(tmp_path / "bare.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    got = _spans_with_parents(events, "batch")
    parents = dict(ENGINE_PARENTS, **{k: "engine.forward" for k in MODEL_SPANS[kind]},
                   **{"engine.dispatch": None, "engine.collect": None})
    for name, parent in got:
        assert parents[name] == parent, (name, parent)
    counts = {}
    for name, _ in got:
        counts[name] = counts.get(name, 0) + 1
    assert counts == dict({k: 1 for k in parents}, **MODEL_SPANS[kind])
    assert set(profiling.SECONDS) == set(counts)
    assert profiling.COUNTERS["nms.rounds"] >= 2  # the RPN's NMS and the class NMS
    assert ("components.rounds" in profiling.COUNTERS) == (kind == "nuhtc")


def test_slide_spans_counts_and_timers(engines, tmp_path, monkeypatch):
    engine = engines["nuhtc"]
    pixels = np.concatenate([np.concatenate(synthetic_tiles(np.random.RandomState(i), 2, T),
                                            axis=1) for i in range(2)], axis=0)
    coords = np.array([[x, y] for y in (0, T) for x in (0, T)] + [[T // 2, T // 2]], np.int64)
    entering = []
    collect = engine.collect

    def counted(handle):
        res = collect(handle)
        entering.extend(len(r["boxes"]) for r in res)
        return res

    monkeypatch.setattr(engine, "collect", counted)
    kw = dict(classes=("A", "B", "C", "D", "E"), patch_size=T, mode="qupath", progress=False)
    off = infer.infer_slide(engine, ArraySlide(pixels), coords, str(tmp_path / "off"), "s", **kw)
    assert profiling.COUNTERS == {} and profiling.SECONDS == {}
    entering.clear()
    events, stats = _trace_events(tmp_path, "slide", lambda: infer.infer_slide(
        engine, ArraySlide(pixels), coords, str(tmp_path / "on"), "s", **kw))
    keys = {"tiles", "nuclei", "seconds", "tiles_per_sec", "read_wait_s", "dispatch_s",
            "collect_s", "post_s", "collect_device_s", "collect_download_s"}
    assert set(off) == set(stats) == keys
    assert off["tiles"] == stats["tiles"] == 5 and off["nuclei"] == stats["nuclei"] > 0
    # a timer that takes ``into`` reads the span's own clock
    sec = profiling.SECONDS
    assert stats["post_s"] == sec["wsi.post"] and stats["read_wait_s"] == sec["wsi.read_wait"]
    assert stats["collect_device_s"] == sec["engine.wait"]
    assert stats["collect_download_s"] == sec["engine.download"]
    assert stats["dispatch_s"] >= sec["engine.dispatch"]
    assert stats["collect_s"] >= sec["engine.collect"]
    assert sec["wsi.slide"] >= stats["seconds"]
    assert profiling.COUNTERS["wsi.detections"] == sum(entering) > 0
    assert profiling.COUNTERS["wsi.nuclei"] == stats["nuclei"]
    got = [(n, p) for n, p in _spans_with_parents(events, "slide")
           if n.startswith("wsi.") or p == "wsi.slide"]
    want_parent = {"wsi.read_wait": "wsi.slide", "engine.dispatch": "wsi.slide",
                   "engine.collect": "wsi.slide", "wsi.post": "wsi.slide",
                   "wsi.filter": "wsi.post", "wsi.rle": "wsi.post", "wsi.mask_nms": "wsi.post",
                   "wsi.contours": "wsi.post", "wsi.slide": None}
    for name, parent in got:
        if name == "wsi.export":  # add_tile in post; the exporter's close at the slide's end
            assert parent in ("wsi.post", "wsi.slide")
        else:
            assert want_parent[name] == parent, (name, parent)
    names = [n for n, _ in got]
    assert names.count("wsi.post") == names.count("engine.collect") == 3
    assert names.count("wsi.read_wait") == 4  # three batches and the end of the stream
    assert [p for n, p in got if n == "wsi.export"][-1] == "wsi.slide"
    for name in ("wsi.filter", "wsi.rle", "wsi.mask_nms", "wsi.contours"):
        assert 1 <= names.count(name) <= 5


def _chain(k: int):
    """k boxes of width 10, each overlapping the next by IoU 0.6 (and no
    other), in descending score order."""
    x = np.arange(k, dtype=np.float32)[:, None] * 2.5
    boxes = np.concatenate([x, np.zeros_like(x), x + 10.0, np.full_like(x, 10.0)], axis=1)
    return torch.from_numpy(boxes)[None], torch.ones((1, k), dtype=torch.bool)


@pytest.mark.parametrize("k", [1, 2, 5, 9])
def test_nms_rounds_of_a_suppression_chain(k):
    boxes, valid = _chain(k)
    with profiling.spans():
        keep = nms_ops.nms_keep_sorted(boxes, valid, 0.5)
        assert profiling.COUNTERS["nms.rounds"] == k
    assert keep[0].tolist() == [i % 2 == 0 for i in range(k)]
    nms_ops.nms_keep_sorted(boxes, valid, 0.5)
    assert profiling.COUNTERS["nms.rounds"] == k  # off: not counted


def test_span_into_times_on_and_off():
    into = {"t": 0.0}
    with profiling.span(None, into, "t"):
        pass
    off = into["t"]
    assert off > 0.0 and profiling.SECONDS == {}
    with profiling.spans():
        with profiling.span("stage", into, "t"):
            profiling.count("n", 3)
        with profiling.spans():  # nested: nothing cleared, on after it
            profiling.count("n")
        assert profiling.enabled()
        assert profiling.SECONDS["stage"] == pytest.approx(into["t"] - off, rel=1e-9)
    assert profiling.COUNTERS == {"n": 4}
    profiling.count("n")
    assert profiling.COUNTERS == {"n": 4}


# --------------------------------------------------------------------------- #
# span_table on synthetic traces (times in microseconds, as Chrome traces)

def _x(cat, name, ts, dur, corr=None, tid=1):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _window(dur=1000):
    return _x("user_annotation", "win", 0, dur)


def test_span_table_self_time_under_nested_spans():
    ev = [_window(1100), _x("user_annotation", "outer", 100, 600),
          _x("user_annotation", "inner", 200, 100), _x("user_annotation", "inner", 400, 200),
          _x("user_annotation", "leaf", 450, 50), _x("user_annotation", "other", 10, 5, tid=2)]
    tab = profiling.span_table(ev, "win")
    rows = tab["spans"]
    assert set(rows) == {"outer", "inner", "leaf"}  # another thread's span is left out
    assert rows["outer"]["count"] == 1 and rows["inner"]["count"] == 2
    assert rows["outer"]["host_s"] == pytest.approx(600e-6)
    assert rows["outer"]["self_s"] == pytest.approx(300e-6)
    assert rows["inner"]["self_s"] == pytest.approx(250e-6)
    assert rows["leaf"]["self_s"] == pytest.approx(50e-6)
    # no device work: the window is idle, each span's idle its self time
    assert tab["idle_s"] == pytest.approx(1100e-6)
    for name in rows:
        assert rows[name]["idle_s"] == pytest.approx(rows[name]["self_s"])
    assert tab["uncovered_idle_s"] == pytest.approx(500e-6)


def test_span_table_device_time_by_the_launch():
    ev = [_window(), _x("user_annotation", "a", 100, 200), _x("user_annotation", "b", 150, 50),
          _x("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=1),
          _x("cuda_runtime", "cudaLaunchKernel", 250, 5, corr=2),
          _x("cuda_runtime", "cudaLaunchKernel", 600, 5, corr=3),
          _x("kernel", "k1", 170, 30, corr=1),  # launched in b
          _x("kernel", "k2", 500, 100, corr=2),  # launched in a, runs after a closed
          _x("kernel", "k3", 610, 40, corr=3),  # launched in no span
          _x("kernel", "k4", 700, 10, corr=99)]  # its launch is not in the trace
    tab = profiling.span_table(ev, "win")
    assert tab["spans"]["b"]["device_s"] == pytest.approx(30e-6)
    assert tab["spans"]["a"]["device_s"] == pytest.approx(100e-6)
    assert tab["device_s"] == pytest.approx(180e-6)
    assert tab["unspanned_device_s"] == pytest.approx(50e-6)
    assert tab["early_starts"] == 0


def test_span_table_idle_goes_to_the_innermost_span():
    ev = [_window(), _x("user_annotation", "a", 0, 800), _x("user_annotation", "b", 300, 200),
          _x("kernel", "k", 100, 100, corr=1), _x("kernel", "k", 500, 20, corr=2),
          _x("gpu_memcpy", "copy", 520, 30, corr=3)]
    tab = profiling.span_table(ev, "win")
    # gaps [0, 100), [200, 500) and [550, 1000): b holds [300, 500), a the
    # rest up to 800, no span [800, 1000)
    assert tab["spans"]["b"]["idle_s"] == pytest.approx(200e-6)
    assert tab["spans"]["a"]["idle_s"] == pytest.approx(450e-6)
    assert tab["idle_s"] == pytest.approx(850e-6)
    assert tab["uncovered_idle_s"] == pytest.approx(200e-6)
    assert tab["unspanned_device_s"] == pytest.approx(150e-6)  # no launch records


def test_span_table_without_program_spans():
    ev = [_window(), _x("cpu_op", "aten::add", 100, 50),
          _x("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
          _x("kernel", "k", 100, 100, corr=1)]  # starts before its launch
    tab = profiling.span_table(ev, "win")
    assert tab["spans"] == {}
    assert tab["uncovered_idle_s"] == pytest.approx(900e-6) == pytest.approx(tab["idle_s"])
    assert tab["unspanned_device_s"] == pytest.approx(100e-6)
    assert tab["early_starts"] == 1
    with pytest.raises(ValueError):
        profiling.span_table(ev, "missing")
