"""ViTDet's plain ViT and NuHTC's ViT_FPN on the port's detectors, against
the benchmark's plain reference (``portbench/reference``: the Mask R-CNN of
``model.py`` on the parts ``parts/ViT.py`` and ``parts/ViT_FPN.py``), on
the CPU in f32.

Weights: ``portbench.harness.weights.make`` from a seed, which draws the
position and relative-position tables (std 0.02), so a program that dropped
the bias differs. The size: embed 32, 2 heads, depth 6 with windows of 4 in
blocks 0, 1, 3 and 4, a 160² input of 10² tokens (the windows pad it to
12²), the 14² pretrain grid shrunk to 10², four pyramid levels of 16
channels (40², 20², 10², 5²). Tolerance: each pyramid map within 1e-5 of
its largest magnitude (f32 products in another order), and the detections
matched one to one with scores and boxes within 1e-5.

Also: zeroing one global block's ``rel_pos_h`` in the port alone breaks the
agreement; the benchmark's existing cells still build Swin-T + FPN with the
reference skeleton's keys; ViTDet-B's published widths build the
reference's keys and shapes; the score counters read 16 bytes an element
(``models/backbones.py``); the relative-position indices and the resize
matrices are buffers built with the module; a misspelled backbone or neck
key, or a neck's ``in_channels`` that the backbone does not return, raises;
``init_detector`` serves the ViT detector through ``dispatch`` and
``collect``.
"""

import copy

import numpy as np
import pytest
import torch

from nuhtc_tpu_torch.apis.inference import init_detector
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.models import backbones
from nuhtc_tpu_torch.models.build import build_detector
from nuhtc_tpu_torch.models.extra_heads import ViT_FPN
from nuhtc_tpu_torch.models.fpn import FPN
from nuhtc_tpu_torch.models.swin import SwinTransformer
from nuhtc_tpu_torch.utils import profiling
from portbench.harness import check, common, traffic, weights
from portbench.reference import model as ref_model
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

SIDE, BATCH, SEED = 160, 2, 5
TOL = 1e-5
SMALL_VIT = {"type": "ViT", "img_size": SIDE, "patch_size": 16, "embed_dims": 32, "depth": 6,
             "num_heads": 2, "mlp_ratio": 4, "qkv_bias": True, "use_abs_pos": True,
             "use_rel_pos": True, "window_size": 4, "window_block_indexes": [0, 1, 3, 4],
             "pretrain_img_size": 224, "pretrain_use_cls_token": True, "out_every": 3}
CELLS = ("pannuke-slide-64", "maskrcnn-nucls-forward-b16", "pannuke-forward-b16")


def _bench_cfg(name):
    return common.config(common.benchmark(), name)


def _small_cfg():
    """``vitdet-b-nucls`` at the test's size."""
    cfg = copy.deepcopy(_bench_cfg("vitdet-b-nucls"))
    cfg["model"].update(backbone=dict(SMALL_VIT),
                        neck={"type": "ViT_FPN", "in_channels": 32, "out_channels": 16},
                        rpn_nms_pre=256, rpn_max_per_img=128, nms_candidates=256,
                        rcnn_max_per_img=32)
    return dict(cfg, tile=SIDE, scale_factor=1.0)


@pytest.fixture(scope="module")
def pair():
    """(port, reference, state dict, the normalized input) at the test size."""
    cfg = _small_cfg()
    state = weights.make(cfg, SEED, torch.device("cpu"), torch.float32)
    port = build_detector(cfg["model"], None, cfg["scale_factor"]).eval()
    port.load_state_dict(state, strict=True)
    ref = ref_model.build(cfg).eval()
    ref.load_state_dict(state, strict=True)
    tiles = np.stack(traffic.tiles(np.random.RandomState(SEED), BATCH, SIDE))
    return port, ref, state, ref_model.prep(torch.from_numpy(tiles), cfg["scale_factor"])


def _pyramid_close(got, want) -> bool:
    return all(g.shape == w.shape and (g - w).abs().max() <= TOL * w.abs().max()
               for g, w in zip(got, want, strict=True))


def _per_image(det):
    out = []
    for i in range(det["valid"].shape[0]):
        v = det["valid"][i]
        out.append({k: det[k][i][v].numpy() for k in ("boxes", "scores", "labels")})
    return out


def test_pyramid_and_detections_equal_the_reference(pair):
    port, ref, _, x = pair
    with torch.no_grad():
        got, want = port.features(x), ref.neck(ref.backbone(x))
    assert [tuple(f.shape) for f in got] == [(BATCH, s, s, 16) for s in (40, 20, 10, 5)]
    assert _pyramid_close(got, want)
    g, w = _per_image(port(x)), _per_image(ref(x))
    assert all(len(d["scores"]) > 0 for d in w)
    det_unmatched, counts = check.unmatched(g, w)
    assert det_unmatched == 0.0, counts
    score_gap, box_gap = check.pair_gaps(g, w)
    assert score_gap <= TOL and box_gap <= TOL


def test_dropping_the_relative_position_bias_breaks_the_agreement(pair):
    port, ref, _, x = pair
    broken = copy.deepcopy(port)
    assert broken.backbone.blocks[2].window_size == 0
    with torch.no_grad():
        broken.backbone.blocks[2].attn.rel_pos_h.zero_()
        assert not _pyramid_close(broken.features(x), ref.neck(ref.backbone(x)))


@pytest.mark.parametrize("cell", CELLS)
def test_existing_cells_build_swin_and_fpn(cell):
    cfg = _bench_cfg(common.workload(common.benchmark(), cell)["config"])
    port = build_detector(cfg["model"], cfg["model"].get("test_cfg"), cfg["scale_factor"])
    assert type(port.backbone) is SwinTransformer and type(port.neck) is FPN
    assert port.backbone.stages[0].blocks[0].kernel == cfg["swin_kernel"]
    with torch.device("meta"):
        skeleton = ref_model.build(cfg)
    want = {k: tuple(v.shape) for k, v in skeleton.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want


def test_vitdet_b_builds_the_reference_keys_at_its_widths():
    cfg = _bench_cfg("vitdet-b-nucls")
    with torch.device("meta"):
        port = build_detector(cfg["model"], None, cfg["scale_factor"])
        skeleton = ref_model.build(cfg)
    assert type(port.backbone) is backbones.ViT and type(port.neck) is ViT_FPN
    assert port.rpn_head.rpn_conv.in_channels == 64 and len(port.backbone.blocks) == 12
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in skeleton.state_dict().items()}
    assert port.state_dict()["backbone.blocks.2.attn.rel_pos_h"].shape == (127, 64)
    assert port.state_dict()["backbone.blocks.0.attn.rel_pos_h"].shape == (27, 64)


def test_nuhtc_takes_a_typed_backbone_and_neck():
    model_cfg = {"type": "NuHTC", "backbone": dict(SMALL_VIT, frozen_stages=1),
                 "neck": {"type": "ViT_FPN", "in_channels": 32, "out_channels": 16}}
    model = build_detector(model_cfg, None, 1.0)
    assert type(model.backbone) is backbones.ViT and model.neck.down.in_channels == 32
    heads = (model.rpn_head.rpn_conv, model.roi_head.mask_head.convs[0].conv)
    assert [m.in_channels for m in heads] == [16, 16]
    model_cfg["neck"].pop("in_channels")
    assert build_detector(model_cfg, None, 1.0).neck.down.in_channels == 32


@pytest.mark.parametrize("part,key,value", [
    ("backbone", "use_relpos", True),
    ("backbone", "window_block_indices", [0, 1]),
    ("neck", "out_channel", 16),
    ("neck", "in_channels", 768),
], ids=["backbone-use_relpos", "backbone-window_block_indices", "neck-out_channel",
        "neck-in_channels"])
def test_a_key_the_part_does_not_take_raises(part, key, value):
    """A misspelled key would build the default, where the reference part
    drops it too: it raises, and a ``neck.in_channels`` the backbone does
    not return raises."""
    model_cfg = {"type": "MaskRCNN", "num_classes": 8, "backbone": dict(SMALL_VIT),
                 "neck": {"type": "ViT_FPN", "in_channels": 32, "out_channels": 16}}
    model_cfg[part][key] = value
    with pytest.raises(ValueError, match=key):
        build_detector(model_cfg, None, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_score_counters_read_16_bytes_an_element(pair, dtype):
    port, _, _, x = pair
    vit = copy.deepcopy(port.backbone).to(dtype)
    with profiling.spans(), torch.no_grad():
        vit(x.to(dtype))
        counters = dict(profiling.COUNTERS)
    nh, tokens, ws = SMALL_VIT["num_heads"], SIDE // 16, SMALL_VIT["window_size"]
    windows = (-(-tokens // ws)) ** 2
    assert counters["vit.global_score_bytes"] == 16 * 2 * BATCH * nh * tokens ** 4
    assert counters["vit.window_score_bytes"] == 16 * 4 * BATCH * windows * nh * ws ** 4


def test_constants_are_built_once(pair, monkeypatch):
    """The indices and the resize matrices are non-persistent buffers, made
    with the module: a forward builds none, and ``.to()`` moves them."""
    port, _, _, x = pair
    vit = copy.deepcopy(port.backbone)
    buffers = dict(vit.named_buffers())
    assert set(buffers) == {"pos_resize"} | {f"blocks.{i}.attn.rel_index_{a}"
                                            for i in range(6) for a in "hw"}
    assert not set(buffers) & set(vit.state_dict())
    assert buffers["blocks.2.attn.rel_index_h"].shape == (SIDE // 16,) * 2
    assert buffers["blocks.0.attn.rel_index_h"].shape == (SMALL_VIT["window_size"],) * 2
    with torch.no_grad():
        first = vit(x)

        def built_again(*args):
            raise AssertionError("a constant was built again")

        monkeypatch.setattr(backbones, "rel_pos_index", built_again)
        monkeypatch.setattr(backbones, "cubic_resize_matrix", built_again)
        again = vit(x)
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))
    with pytest.raises(ValueError, match="token grid"):
        vit(x[:, :-16])
    assert vit.to(torch.float64).pos_resize.dtype == torch.float64


def test_init_detector_serves_the_vit_detector(pair):
    _, ref, state, _ = pair
    cfg = _small_cfg()
    eng = init_detector(Config({"model": cfg["model"], "scale_factor": 1.0}), None,
                        batch_size=BATCH, device="cpu", device_preprocess=True,
                        compact_masks=True, scale_factor=1.0, tile_size=SIDE)
    assert type(eng.model.backbone) is backbones.ViT
    eng.model.load_state_dict(state, strict=True)
    tiles = traffic.tiles(np.random.RandomState(SEED + 1), BATCH, SIDE)
    got = eng.collect(eng.dispatch(tiles))
    want = ref_model.split_results({k: v.numpy() for k, v in ref_model.detect(
        ref, torch.from_numpy(np.stack(tiles)), 1.0).items()}, BATCH)
    assert check.unmatched(got, want)[0] == 0.0
    assert all(np.array_equal(check.label_map_of(g["masks"], (SIDE, SIDE)), w["label_map"])
               for g, w in zip(got, want))
