"""The cell ``vitdet-b-nucls-forward-b8`` on the CPU at ViTDet-B's widths and a
small image (96² tiles ×2, a 192² input of 12² tokens that the 14² windows
pad): a sound run is correct and reads its metrics, the fp8 control on three
seeds and a run whose labels are moved (``test_portbench_control.py``) are
not correct; the parts' work counts equal ``FlopCounterMode`` (on the meta
device, up to the published 1024²); the weights' rule has a row for every
parameter; the new metric reads nothing from a program without the ViT's
counters.

On a card (``-m cuda``): a short run of the cell prints a correct result
line with every metric of its kind, and a run that leaves out half of its
detections is not correct. That fault is held on the card alone: on the CPU
the program runs in f32 and equals the reference, so leaving out half reads
``top_unmatched`` 1/4, under what bf16 alone reads at this depth (0.239 at
most, ``limits/<cell>.json``); on the card it reads 0.4825 against a limit
of 0.361. ``det_unmatched`` and ``score_gap`` carry no limit in this cell."""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import calibrate, run
from portbench.harness import check, common, weights
from portbench.reference import model as ref_model
from portbench.tests.test_portbench_control import _half_left_out, _label_altered

CELL = "vitdet-b-nucls-forward-b8"
CPU = torch.device("cpu")
TILE = 96
KW = dict(batch=2, tile=TILE, distinct_batches=2, warmup_batches=1, check_batches=2,
          check_from_first=3, trace_from=1, trace_batches=2)


def _cfg(img_size=2 * TILE):
    cfg = common.config(common.benchmark(), "vitdet-b-nucls")
    cfg["model"] = dict(cfg["model"], backbone=dict(cfg["model"]["backbone"], img_size=img_size))
    return cfg


def _cfg_kw():
    return {"tile": TILE, "model": _cfg()["model"]}


def _run(seed=2 ** 31 + 7, trace=0):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5, trace=trace)
    return run.run_cell(args, CPU, torch, time.perf_counter(), cell_kw=KW, cfg_kw=_cfg_kw())


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace, capsys):
    res = _run(trace=trace)
    assert res["correct"], res["rows"]
    values = run.metric_values(res, bool(trace))
    run.report(res, bool(trace), "cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == set(values)
    if trace:
        # 2 × 12 heads × 144² tokens² (global) and 2 × 12 × 196² (one padded window) a block
        want = 16 * 2 * 12 * (4 * 144 ** 2 + 8 * 196 ** 2) / 1e9
        assert values["forward.vit_score_gb_per_batch"][0] == pytest.approx(want)
        assert not any(k.endswith("roofline") for k in values)
    else:
        assert set(values) == {m["name"] for m in common.metrics_of(
            common.benchmark(), CELL, "end_to_end")}


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(seed):
    _, ctrl = calibrate.readings(CELL, seed, 0.5, True, CPU, torch, cell_kw=KW,
                                 cfg_kw=_cfg_kw())
    ok, rows = check.verdict(ctrl, common.limits(CELL)["limits"])
    assert not ok, rows


def _break(monkeypatch, fault):
    from nuhtc_tpu_torch.apis.inference import InferenceEngine

    orig = InferenceEngine.forward

    def broken(self, x):
        det, pasted = orig(self, x)
        fault(det)
        return det, pasted

    monkeypatch.setattr(InferenceEngine, "forward", broken)


def test_label_altered_in_the_timed_path_is_not_correct(monkeypatch):
    _break(monkeypatch, _label_altered)
    res = _run()
    assert not res["correct"], res["rows"]


@pytest.mark.parametrize("side", [96, 160, 224, 1024])
def test_part_flops_equal_flop_counter(side):
    """At the published widths; 224 keeps the pretrain grid, 160 shrinks it
    and pads the windows, 1024 is the cell's input."""
    cfg = _cfg(img_size=side)
    (bb_type, bb_spec), (neck_type, neck_spec) = ref_model.part_specs(cfg["model"])
    with torch.device("meta"):
        backbone, dims = ref_model.part(bb_type).build(bb_spec, 3)
        neck, _ = ref_model.part(neck_type).build(neck_spec, dims)
        img = torch.zeros(1, side, side, 3)
        with FlopCounterMode(display=False) as fc_bb:
            feats = backbone(img)
        with FlopCounterMode(display=False) as fc_neck:
            neck(feats)
    assert fc_bb.get_total_flops() == ref_model.part(bb_type).flops(bb_spec, side, 3)
    assert fc_neck.get_total_flops() == ref_model.part(neck_type).flops(neck_spec, side, dims)


def test_weights_rule_has_a_row_for_every_parameter():
    cfg = common.config(common.benchmark(), "vitdet-b-nucls")
    with torch.device("meta"):
        skeleton = ref_model.build(cfg)
    rule = weights._rule(skeleton)
    assert [name for name, _, _ in rule] != [] and len({n for n, _, _ in rule}) == len(rule)
    assert {n for n, _, _ in rule} == {n for n, _ in skeleton.named_parameters()}
    stds = {name: how for name, _, how in rule}
    assert stds["backbone.pos_embed"] == 0.02
    assert stds["backbone.blocks.2.attn.rel_pos_w"] == 0.02
    assert stds["backbone.blocks.2.attn.qkv.weight"] == pytest.approx(768 ** -0.5)
    assert stds["neck.up4.weight"] == pytest.approx((768 * 16) ** -0.5)


def test_score_metric_reads_nothing_without_the_counters(monkeypatch):
    read = common.metric_reader("forward.vit_score_gb_per_batch")
    ctx = {"trace": {"batches": 12}}
    swin = ({"engine.dispatch": 1.0}, {"nms.rounds": 3})
    vit = ({"engine.dispatch": 1.0}, {"vit.global_score_bytes": 9e9,
                                      "vit.window_score_bytes": 3e9})
    for got, want in ((swin, None), (None, None), (vit, pytest.approx(1.0))):
        monkeypatch.setitem(read.__globals__, "totals", lambda got=got: got)
        assert read(ctx) == want


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "2147484002",
         "--seconds", "3", "--trace", str(trace)],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) == {m["name"] for m in common.metrics_of(
        common.benchmark(), CELL, kind)}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


@pytest.mark.cuda
def test_half_left_out_is_not_correct_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _break(monkeypatch, _half_left_out)
    args = argparse.Namespace(workload=CELL, seed=2147484003, seconds=3.0, trace=0)
    res = run.run_cell(args, torch.device("cuda:0"), torch, time.perf_counter())
    assert not res["correct"], res["rows"]
