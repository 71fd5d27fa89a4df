"""The harness on the CPU: the traffic generator and the weights from the
seed, the window's arithmetic, the comparison's numbers, the trace's
reduction, the result line, and ``BENCHMARK.json`` against the contract's
shape (every cell's files, every metric's reader)."""

import json
import os
import re

import numpy as np
import pytest
import torch

from portbench.harness import check, common, trace, traffic, weights

BIG_SEED = 2 ** 31 + 987654321


def test_seeds_take_large_seeds_and_repeat():
    assert common.seeds(BIG_SEED, 3) == common.seeds(BIG_SEED, 3)
    assert common.seeds(BIG_SEED, 3) != common.seeds(BIG_SEED + 1, 3)
    assert all(0 <= s < 2 ** 32 for s in common.seeds(2 ** 40, 3))


@pytest.mark.parametrize("kind", ["tiles", "slide"])
def test_traffic_same_seed_same_inputs_other_seed_same_sizes(kind):
    def make(seed):
        rng = np.random.RandomState(seed)
        if kind == "tiles":
            return np.stack(traffic.tiles(rng, 4, 256))
        img, coords = traffic.slide(rng, 16, cols=8)
        assert coords.tolist()[:3] == [[0, 0], [256, 0], [512, 0]]
        return img

    a, b, c = make(1), make(1), make(2)
    np.testing.assert_array_equal(a, b)
    assert a.shape == c.shape and a.dtype == np.uint8 and not np.array_equal(a, c)


def test_tiles_equal_the_port_recipe():
    from nuhtc_tpu_torch.tools.synthetic import synthetic_tiles

    ours = traffic.tiles(np.random.RandomState(4), 3, 256)
    theirs = synthetic_tiles(np.random.RandomState(4), 3, 256)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_slide_equals_the_port_recipe():
    from nuhtc_tpu_torch.tools.analysis_tools.benchmark_wsi import synthetic_benchmark_slide

    img, coords = traffic.slide(np.random.RandomState(0), 16)
    want, want_coords = synthetic_benchmark_slide(16, seed=0)
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(coords, want_coords)


@pytest.mark.parametrize("config", ["nuhtc-pannuke", "maskrcnn-nucls"])
def test_weights_follow_the_rule_and_repeat(config):
    cfg = common.config(common.benchmark(), config)
    a = weights.make(cfg, 11, torch.device("cpu"), torch.bfloat16)
    b = weights.make(cfg, 11, torch.device("cpu"), torch.bfloat16)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    w = a["backbone.stages.2.blocks.0.ffn.layers.0.0.weight"].float()
    assert w.std().item() == pytest.approx(384 ** -0.5, rel=0.02)
    assert torch.all(a["backbone.norm0.weight"] == 1)
    if config == "maskrcnn-nucls":
        assert a["roi_head.bbox_head.fc_cls.bias"][0].item() == weights.LIFT
    else:
        for i in range(3):
            bias = a[f"roi_head.bbox_head.{i}.fc_cls.bias"]
            assert bias[5].item() == weights.LIFT and torch.all(bias[:5] == 0)
    from nuhtc_tpu_torch.models.build import build_detector

    port = build_detector(cfg["model"], cfg["model"].get("test_cfg"), cfg["scale_factor"])
    assert set(port.state_dict()) == set(a)


def test_rate_and_tail_take_every_sample():
    assert common.rate(480, 30.0) == 16.0
    ms = list(range(1, 101))
    assert common.percentile(ms, 95) == pytest.approx(95.05)


def test_window_rate_is_all_work_over_all_time():
    from portbench.harness import forward, slide

    win = dict(images=160, seconds=2.0, latency_ms=[10.0] * 19 + [50.0])
    e = forward.e2e(win)
    assert e["forward_img_per_s"] == 80.0 and e["forward_p95_ms"] == pytest.approx(12.0)
    assert slide.e2e(dict(tiles=192, seconds=48.0))["slide_tiles_per_s"] == 4.0


def _det(boxes, labels, scores):
    return dict(boxes=np.asarray(boxes, np.float32), labels=np.asarray(labels),
                scores=np.asarray(scores, np.float32))


def test_unmatched_is_one_minus_f1():
    want = _det([[0, 0, 10, 10], [20, 20, 30, 30]], [1, 2], [0.9, 0.8])
    same = _det([[0, 0, 10, 10.5], [20, 20, 30, 30]], [1, 2], [0.9, 0.8])
    assert check.unmatched([same], [want])[0] == 0.0
    relabel = _det([[0, 0, 10, 10], [20, 20, 30, 30]], [1, 3], [0.9, 0.8])
    assert check.unmatched([relabel], [want])[0] == pytest.approx(0.5)
    half = _det([[0, 0, 10, 10]], [1], [0.9])
    assert check.unmatched([half], [want])[0] == pytest.approx(1 - 2 / 3)


def test_top_unmatched_and_pair_gaps():
    want = _det([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50], [60, 60, 70, 70]],
                [0, 0, 0, 0], [0.9, 0.8, 0.7, 0.6])
    got = _det([[0, 0, 10, 10], [20, 20, 30, 31], [40, 40, 50, 50], [80, 80, 90, 90]],
               [0, 0, 0, 0], [0.88, 0.8, 0.7, 0.6])
    # the last ranks differ only: both top halves are matched
    assert check.top_unmatched([got], [want]) == 0.0
    assert check.unmatched([got], [want])[0] == pytest.approx(0.25)
    score_gap, box_gap = check.pair_gaps([got], [want])
    assert score_gap == pytest.approx(0.0, abs=1e-6) and box_gap == pytest.approx(0.0)
    first_lost = dict(got, boxes=got["boxes"] + np.asarray([100, 0, 100, 0], np.float32) *
                      (np.arange(4) == 0)[:, None])
    assert check.top_unmatched([first_lost], [want]) == pytest.approx(2 / 4)


def test_mask_px_wrong_allows_the_band_only():
    from portbench.harness.program import mask_px_wrong

    full = torch.zeros(2, 4, 4)
    full[0, :2] = 0.9       # detection 1 owns the top rows
    full[1, 2:] = 0.505     # detection 2's edge within the band
    lab = torch.zeros(4, 4, dtype=torch.long)
    lab[:2] = 1
    assert mask_px_wrong(lab, full, 0.5, 0.01) == (0, 16)  # detection 2 dropped: in the band
    lab[2:] = 2
    assert mask_px_wrong(lab, full, 0.5, 0.01) == (0, 16)
    full[1, 2:] = 0.3       # now far under the threshold: drawing it is wrong
    assert mask_px_wrong(lab, full, 0.5, 0.01) == (8, 16)
    lab[:2] = 2             # the second detection over the first: wrong
    full[1] = 0.9
    assert mask_px_wrong(lab, full, 0.5, 0.01)[0] == 8


def test_nuclei_exact_wants_every_point():
    c = np.asarray([[0, 0], [3, 0], [3, 3]])
    a = dict(contours=[c, c + 10], labels=[0, 1], scores=[0.5, 0.5])
    assert check.nuclei_exact([a], [a])[0] == 0.0
    b = dict(contours=[c, c + 11], labels=[0, 1], scores=[0.5, 0.5])
    assert check.nuclei_exact([b], [a])[0] == pytest.approx(0.5)


def test_verdict_rows_carry_value_and_limit():
    ok, rows = check.verdict({"a": 0.1, "b": 0.3, "c_counts": {}}, {"a": 0.2, "b": 0.25})
    assert not ok and rows == [{"name": "a", "value": 0.1, "limit": 0.2},
                               {"name": "b", "value": 0.3, "limit": 0.25}]


def test_trace_summary_of_a_synthetic_trace():
    ev = [
        dict(ph="X", cat="user_annotation", name=trace.SPAN, ts=0, dur=1000),
        dict(ph="X", cat="user_annotation", name=trace.DISPATCH, ts=0, dur=600),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=10, dur=5,
             args={"correlation": 1}),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=20, dur=5,
             args={"correlation": 2}),
        dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize", ts=300, dur=5),
        dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize", ts=800, dur=5),
        dict(ph="X", cat="kernel", name="k_a", ts=100, dur=200, args={"correlation": 1}),
        dict(ph="X", cat="kernel", name="k_b", ts=250, dur=150),
        dict(ph="X", cat="cpu_op", name="aten::foo", ts=400, dur=500),
    ]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(1e-3) and s["busy_s"] == pytest.approx(300e-6)
    assert s["launches"] == 2 and s["lost_launches"] == 1
    assert s["dispatch_spans"] == 1 and s["dispatch_syncs"] == 1
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["aten::foo"] == pytest.approx(600e-6)
    assert trace.kernel_seconds(s, ("k_a",)) == pytest.approx(200e-6)


def test_result_line_format():
    line = common.result_line(True, 10, 0, {"setup_s": (1.5, "s")},
                              {"platform": "gpu", "kind": "X", "count": 1,
                               "memory_peak_bytes": 5},
                              [{"name": "det_unmatched", "value": 0.1, "limit": 0.2}])
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert out["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape_and_files():
    b = common.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(common.ROOT, c["file"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for wl in b["workloads"]:
        assert len(wl["why"]) <= 200 and wl["chips"] == 1
        common.traffic(wl["traffic"])
        assert common.limits(wl["name"])["limits"]
        reported = {m["name"] for m in common.metrics_of(b, wl["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert common.metrics_of(b, wl["name"], "per_layer")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m.get("bound", 0.01) <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        common.metric_reader(m["name"])
    assert len(json.dumps(b)) < 64 * 1024
