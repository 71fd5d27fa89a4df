"""The comparison that decides ``correct`` must fail what it exists to
catch, at a size a CPU test run holds (64² and 96² tiles, B2): the control
(the fp8 reference in the program's place) on three seeds, and a whole run
of each cell with the timed path broken underneath, once for each fault a
served detector can have: half of the batch's detections left out, and an
answer altered where it is produced (each detection's label moved to the
next class), and in the slide cell a contour moved where the post-processing
produces it. A sound run on the same sizes is correct. The readings at the
cells' own size are ``calibrate.py``'s, on the card."""

import argparse
import json
import time

import numpy as np
import pytest
import torch

from portbench import calibrate, run
from portbench.harness import check, common

CELLS = {
    "pannuke-slide-64": (dict(tiles=4, cols=2, tile=64, batch=2, warmup_tiles=2, check_tiles=4,
                              trace_slide=0),
                         {"tile": 64}),
    "maskrcnn-nucls-forward-b16": (dict(batch=2, tile=96, distinct_batches=2, warmup_batches=1,
                                        check_batches=2, check_from_first=3, trace_from=1,
                                        trace_batches=2), {"tile": 96}),
    "pannuke-forward-b16": (dict(batch=2, tile=96, distinct_batches=2, warmup_batches=1,
                                 check_batches=2, check_from_first=3, trace_from=1,
                                 trace_batches=2), {"tile": 96}),
}
CPU = torch.device("cpu")


def _run(workload, seed=2 ** 31 + 5, trace=0):
    kw, cfg_kw = CELLS[workload]
    args = argparse.Namespace(workload=workload, seed=seed, seconds=0.5, trace=trace)
    return run.run_cell(args, CPU, torch, time.perf_counter(), cell_kw=kw, cfg_kw=cfg_kw)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload, trace, capsys):
    res = _run(workload, trace=trace)
    assert res["correct"], res["rows"]
    values = run.metric_values(res, bool(trace))
    run.report(res, bool(trace), "cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "check"
    assert set(line["metrics"]) == set(values)
    if trace:  # no kernel runs on the CPU: the kernels' shares stay silent
        assert res["summary"]["window_s"] > 0 and res["summary"]["busy_s"] == 0
        assert not any(k.endswith("roofline") for k in values)
    else:
        assert set(values) == {m["name"] for m in common.metrics_of(
            common.benchmark(), workload, "end_to_end")}


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload, seed):
    kw, cfg_kw = CELLS[workload]
    _, ctrl = calibrate.readings(workload, seed, 0.5, True, CPU, torch, cell_kw=kw,
                                 cfg_kw=cfg_kw)
    ok, rows = check.verdict(ctrl, common.limits(workload)["limits"])
    assert not ok, rows


def _half_left_out(det):
    b = det["valid"].shape[0]
    det["valid"][b // 2:] = False
    det["label_map"][b // 2:] = 0


def _label_altered(det):
    n = int(det["probs"].shape[-1])
    det["labels"] = torch.where(det["valid"], (det["labels"] + 1) % n, det["labels"])


def test_contour_altered_in_the_slide_post_is_not_correct(monkeypatch):
    """The exported nuclei moved by a pixel where the post-processing
    produces them: ``nuclei_off`` (exact) catches it."""
    from nuhtc_tpu_torch.wsi import infer

    orig = infer.find_contours

    def shifted(mask):
        found, tree = orig(mask)
        return [c + np.asarray([1, 0], np.int32) for c in found], tree

    monkeypatch.setattr(infer, "find_contours", shifted)
    res = _run("pannuke-slide-64")
    assert not res["correct"], res["rows"]
    assert res["numbers"]["nuclei_off"] > 0


@pytest.mark.parametrize("fault", [_half_left_out, _label_altered], ids=["half", "label"])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    from nuhtc_tpu_torch.apis.inference import InferenceEngine

    orig = InferenceEngine.forward

    def broken(self, x):
        det, pasted = orig(self, x)
        fault(det)
        return det, pasted

    monkeypatch.setattr(InferenceEngine, "forward", broken)
    res = _run(workload)
    assert not res["correct"], res["rows"]
