"""The per-layer metrics that read the port's own spans and counters
(``harness/spans.py``): a CPU ``--trace 1`` run of each cell at the control
test's sizes reads every one of them; against a program without the span
registry (an older port) each reads None and nothing raises."""

import argparse
import time

import pytest
import torch

from nuhtc_tpu_torch.utils import profiling
from portbench import run
from portbench.harness import common
from portbench.tests.test_portbench_control import CELLS

SPAN_METRICS = {
    "pannuke-slide-64": {"slide.split_ms_per_tile", "slide.rle_ms_per_tile",
                         "slide.mask_nms_ms_per_tile", "slide.contours_ms_per_tile",
                         "slide.export_ms_per_tile", "slide.post_us_per_detection"},
    "maskrcnn-nucls-forward-b16": {"forward.fixpoint_rounds_per_batch"},
    "pannuke-forward-b16": {"forward.fixpoint_rounds_per_batch"},
}


def _traced(workload):
    kw, cfg_kw = CELLS[workload]
    args = argparse.Namespace(workload=workload, seed=2 ** 31 + 7, seconds=0.5, trace=1)
    profiling.COUNTERS.clear()  # one traced segment a process, as in a benchmark run
    profiling.SECONDS.clear()
    return run.run_cell(args, torch.device("cpu"), torch, time.perf_counter(), cell_kw=kw,
                        cfg_kw=cfg_kw)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_span_metrics_read_in_a_traced_run(workload):
    res = _traced(workload)
    listed = {m["name"] for m in common.metrics_of(common.benchmark(), workload, "per_layer")}
    assert SPAN_METRICS[workload] <= listed
    values = run.metric_values(res, True)
    for name in SPAN_METRICS[workload]:
        assert name in values and values[name][0] >= 0.0, name
    if workload == "pannuke-slide-64":
        parts = sum(values[f"slide.{p}_ms_per_tile"][0] for p in ("rle", "mask_nms", "contours"))
        assert parts <= values["slide.post_ms_per_tile"][0]
        assert values["slide.post_us_per_detection"][0] > 0.0
    else:
        assert values["forward.fixpoint_rounds_per_batch"][0] >= 2.0  # two NMS a batch


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_span_metrics_silent_without_the_registry(workload, monkeypatch):
    res = _traced(workload)
    monkeypatch.delattr(profiling, "SECONDS")
    values = run.metric_values(res, True)
    assert not SPAN_METRICS[workload] & set(values)
    assert values  # the metrics of the earlier harness still read
