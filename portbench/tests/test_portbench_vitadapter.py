"""The cell ``vitadapter-b-nucls-forward-b8`` on the CPU at ViT-Adapter-B's
widths and a small image (96² tiles ×2, a 192² input: a 12² ViT grid that
the 14² windows pad, prior levels of 24², 12², 6²): a sound run is correct
and reads its metrics, the fp8 control on three seeds and a run whose
labels are moved or whose second half of each batch is left out
(``test_portbench_control.py``) are not correct; the
part's work count equals ``FlopCounterMode`` on the meta device plus the
sampling counted by hand (``sampling_flops``), from 128² to the published
1024²; the weights' rule has a row for every parameter, the batch-norms'
four and γ among them; the two new metrics read nothing from a program
without the deformable core's counter or sampling kernels.

On a card (``-m cuda``): a short run of the cell prints a correct result
line with every metric of its kind."""

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

CELL = "vitadapter-b-nucls-forward-b8"
CPU = torch.device("cpu")
TILE = 96
KW = dict(batch=2, tile=TILE, distinct_batches=2, warmup_batches=1, check_batches=2,
          check_from_first=3, trace_from=1, trace_batches=2)


@pytest.fixture(autouse=True)
def _counters_left_empty():
    """The harness reads the port's counters as one process's totals; a
    traced run here leaves none behind for the next test's run."""
    yield
    from nuhtc_tpu_torch.utils import profiling

    profiling.COUNTERS.clear()
    profiling.SECONDS.clear()


def _cfg(img_size=2 * TILE):
    cfg = common.config(common.benchmark(), "vitadapter-b-nucls")
    cfg["model"] = dict(cfg["model"], backbone=dict(cfg["model"]["backbone"], img_size=img_size))
    return cfg


def _cfg_kw():
    return {"tile": TILE, "model": _cfg()["model"]}


def _run(seed=2 ** 31 + 25, trace=0):
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
        assert values["forward.deform_sample_gb_per_batch"][0] > 0
        # the blocks' plain attention on the CPU (0 on the card, through the kernel)
        assert values["forward.vit_score_gb_per_batch"][0] > 0
        assert "forward.deform_sample_share" not in values  # no device trace on the CPU
    else:
        assert set(values) == {m["name"] for m in common.metrics_of(
            common.benchmark(), CELL, "end_to_end")}


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(seed):
    _, ctrl = calibrate.readings(CELL, seed, 0.5, True, CPU, torch, cell_kw=KW,
                                 cfg_kw=_cfg_kw())
    ok, rows = check.verdict(ctrl, common.limits(CELL)["limits"])
    assert not ok, rows


def _broken_forward(fault, monkeypatch):
    from nuhtc_tpu_torch.apis.inference import InferenceEngine

    orig = InferenceEngine.forward

    def broken(self, x):
        det, pasted = orig(self, x)
        fault(det)
        return det, pasted

    monkeypatch.setattr(InferenceEngine, "forward", broken)


def test_label_altered_in_the_timed_path_is_not_correct(monkeypatch):
    _broken_forward(_label_altered, monkeypatch)
    assert not _run()["correct"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """The images of a batch's second half come back without detections:
    the masks of the detections left are right, and ``det_unmatched`` and
    ``top_unmatched`` catch what is missing."""
    _broken_forward(_half_left_out, monkeypatch)
    res = _run()
    assert not res["correct"], res["rows"]
    failed = {row["name"] for row in res["rows"] if row["value"] > row["limit"]}
    assert {"det_unmatched", "top_unmatched"} <= failed, res["rows"]


@pytest.mark.parametrize("side", [128, 224, 512, 1024])
def test_part_flops_equal_flop_counter_plus_sampling(side):
    """At the published widths; 224 keeps the pretrain grid, 128 pads every
    window, 1024 is the cell's input."""
    cfg = _cfg(img_size=side)
    (bb_type, bb_spec), (neck_type, neck_spec) = ref_model.part_specs(cfg["model"])
    part = ref_model.part(bb_type)
    with torch.device("meta"):
        backbone, dims = part.build(bb_spec, 3)
        neck, _ = ref_model.part(neck_type).build(neck_spec, dims)
        img = torch.zeros(1, side, side, 3)
        with FlopCounterMode(display=False) as fc_bb:
            feats = backbone(img)
        with FlopCounterMode(display=False) as fc_neck:
            neck(feats)
    sampling = part.sampling_flops(bb_spec, side)
    assert sampling > 0
    assert fc_bb.get_total_flops() + sampling == part.flops(bb_spec, side, 3)
    assert fc_neck.get_total_flops() == ref_model.part(neck_type).flops(neck_spec, side, dims)


def test_weights_rule_has_a_row_for_every_parameter():
    cfg = common.config(common.benchmark(), "vitadapter-b-nucls")
    with torch.device("meta"):
        skeleton = ref_model.build(cfg)
    rule = weights._rule(skeleton)
    assert len({n for n, _, _ in rule}) == len(rule)
    assert {n for n, _, _ in rule} == {n for n, _ in skeleton.named_parameters()}
    how = {name: h for name, _, h in rule}
    bb = "backbone."
    assert [how[f"{bb}spm.stem.1.{k}"] for k in ("weight", "bias", "running_mean",
                                                 "running_var")] == ["ones", "zeros", "zeros",
                                                                     "ones"]
    assert how[f"{bb}norm4.running_var"] == "ones"
    assert [how[f"{bb}norm{i}.weight"] for i in range(1, 5)] == [0.25] * 4
    assert how[f"{bb}interactions.0.injector.gamma"] == "ones"
    assert how[f"{bb}level_embed"] == 1.0 and how[f"{bb}pos_embed"] == 0.02
    assert how[f"{bb}interactions.3.extra_extractors.1.attn.sampling_offsets.bias"] == "zeros"
    assert how[f"{bb}interactions.1.extractor.ffn.dwconv.dwconv.weight"] == pytest.approx(1 / 3)
    assert how[f"{bb}up.weight"] == pytest.approx((768 * 4) ** -0.5)


VIT = {"engine.dispatch": 1.0}, {"vit.attn_fused": 12}
ADAPTER = {"engine.dispatch": 1.0}, {"deform.attn_plain": 120, "deform.sample_bytes": 24e9}
PLAIN = {"batches": 12, "busy_s": 2.0, "kernel_s": {"vit_attention_kernel": 1.0}}
SAMPLED = dict(PLAIN, kernel_s={"void at::native::grid_sampler_2d_kernel<float>": 0.5})


@pytest.mark.parametrize("metric,totals,trace,want", [
    ("forward.deform_sample_gb_per_batch", VIT, PLAIN, None),
    ("forward.deform_sample_gb_per_batch", None, SAMPLED, None),
    ("forward.deform_sample_gb_per_batch", ADAPTER, None, None),
    ("forward.deform_sample_gb_per_batch", ADAPTER, SAMPLED, 2.0),
    ("forward.deform_sample_share", VIT, PLAIN, None),
    ("forward.deform_sample_share", ADAPTER, None, None),
    ("forward.deform_sample_share", ADAPTER, SAMPLED, 25.0),
], ids=["gb-no-counter", "gb-no-spans", "gb-no-trace", "gb", "share-no-kernel",
        "share-no-trace", "share"])
def test_new_metrics_read_only_the_core(metric, totals, trace, want, monkeypatch):
    """None without the core's counter (the GB) or sampling kernels (the
    share); 24 GB over 12 batches, 0.5 s of 2 s busy otherwise."""
    read = common.metric_reader(metric)
    monkeypatch.setitem(read.__globals__, "totals", lambda: totals)
    got = read({"trace": trace})
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "2147485002",
         "--seconds", "3", "--trace", str(trace)],
        cwd=common.ROOT, capture_output=True, text=True, timeout=900, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) == {m["name"] for m in common.metrics_of(
        common.benchmark(), CELL, kind)}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
