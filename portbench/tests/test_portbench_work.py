"""The frozen counts of work: the FLOP count of backbone + FPN against
``FlopCounterMode`` over the reference at small sizes, each configuration's
``work/<config>.json`` against the count it freezes, and the roofline
bounds' arithmetic."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import common
from portbench.reference import model as ref_model
from portbench.work import flops, roofline

CONFIGS = ["nuhtc-pannuke", "maskrcnn-nucls"]


def _cfg(name):
    return common.config(common.benchmark(), name)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("side", [64, 96, 160])
def test_feats_flops_equal_flop_counter(config, side):
    cfg = _cfg(config)
    model = ref_model.build(cfg).eval()
    img = torch.zeros(1, side, side, 3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.neck(model.backbone(img))
    assert fc.get_total_flops() == flops.feats_flops(cfg, side)


@pytest.mark.parametrize("config", CONFIGS)
def test_frozen_count_is_the_count(config):
    path = os.path.join(common.BENCH_DIR, "work", f"{config}.json")
    with open(path) as f:
        frozen = json.load(f)
    assert frozen == json.loads(json.dumps(flops.count(_cfg(config))))
    assert frozen["flops_per_image"] == pytest.approx(sum(frozen["parts"].values()))


def test_backbone_fpn_count_is_get_flops_figure():
    """52.99 GFLOPs at 512², the port's get_flops figure on the plain path."""
    assert flops.feats_flops(_cfg("nuhtc-pannuke"), 512) == 52986892032.0


def test_k1_bound_is_chip_smoke_stage_table():
    """B16 at 512²: the padded stages (133, 96), (70, 192), (35, 384), (21, 768)."""
    cfg = _cfg("maskrcnn-nucls")
    stages = [(p, c, d) for _, p, c, d in roofline.swin_stages(roofline.backbone_cfg(cfg), 512)]
    assert stages == [(133, 96, 2), (70, 192, 2), (35, 384, 6), (21, 768, 2)]
    want = sum(d * roofline.bound_ms(*roofline.block_bound(16, p, c)[:1], roofline.PEAK_BF16,
                                     roofline.block_bound(16, p, c)[1])[0]
               for p, c, d in stages) * 1e-3
    assert roofline.k1_bound_s(cfg, 16) == pytest.approx(want)
    # PERF.md's table: K1's 12 blocks at B16 bound by operations in 0.917 ms
    assert roofline.k1_bound_s(cfg, 16) == pytest.approx(0.917e-3, rel=2e-3)


def test_k4_bytes_bound_of_mask_rcnn():
    cfg = _cfg("maskrcnn-nucls")
    launches = roofline.k4_launches(cfg, 16)
    assert len(launches) == 8  # four levels, for the boxes and for the masks
    by = 0
    for s in (128, 64, 32, 16):
        by += 16 * s * s * 64 * 2 * 2  # the level's map, read by both calls
        by += 16 * 1000 * 16 + 16 * 1000 * 49 * 64 * 2
        by += 16 * 100 * 16 + 16 * 100 * 196 * 64 * 2
    assert roofline.k4_bound_s(cfg, 16) == pytest.approx(by / roofline.PEAK_BYTES)
