"""Build the port's detector from the reference-style config tree, read as
nuhtc_tpu/models/build.py reads it: the HTC schema maps onto NuHTC, whose
RoI-head family follows the roi head's type (``*Lite*``: one mask head at the
final stage; ``*Fuse*``: the n-class seg branch besides; any other, e.g.
``HybridTaskCascadeRoIHead_Cus``: a mask head per stage with info-flow; an
explicit ``roi_head.lite`` / ``roi_head.lite_fuse`` key overrides the name);
any other detector ``type`` is a registered detector (``DETECTORS``, e.g.
MaskRCNN) built from the config keys that are its constructor arguments.
Either takes a typed ``backbone`` and ``neck`` (``models/parts.py``); the
Swin kernel tier goes to a ``SwinTransformer`` alone, and ``backbone_cfg``
still spells a Swin."""

from __future__ import annotations

import inspect
import logging
from typing import Any, Dict

import torch
from torch import nn

from nuhtc_tpu_torch.models.detector import NuHTC
from nuhtc_tpu_torch.models.layers import NormedLinear
from nuhtc_tpu_torch.models.mask_rcnn import MaskRCNN  # noqa: F401  (registers it)
from nuhtc_tpu_torch.models.swin import WindowMSA
from nuhtc_tpu_torch.models.vit_adapter import (FrozenBatchNorm2d, Injector, OutputNorm,
                                                ViTAdapter)
from nuhtc_tpu_torch.registry import DETECTORS


def _with_tier(backbone: Dict[str, Any], swin_kernel: str) -> Dict[str, Any]:
    """A typed backbone (a Swin where no type is named), with the Swin
    kernel tier if it is a ``SwinTransformer``."""
    backbone = dict(backbone)
    backbone.setdefault("type", "SwinTransformer")
    if backbone["type"] == "SwinTransformer":
        backbone["kernel"] = swin_kernel
    return backbone


def _build_registered(mtype: str, model_cfg: Dict[str, Any], test_cfg, scale_factor: float,
                      swin_kernel: str) -> nn.Module:
    """A registered detector from the config keys that are its constructor
    arguments; the reference-style ``test_cfg.rcnn`` fills
    ``rcnn_score_thr``, ``rcnn_nms_iou``, ``rcnn_max_per_img`` and
    ``mask_thr_binary`` where the config leaves them out; other keys are
    logged and dropped."""
    cls = DETECTORS.get(mtype)
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    kwargs = {k: v for k, v in model_cfg.items() if k in fields}
    rcnn_tc = dict(dict(test_cfg or model_cfg.get("test_cfg") or {}).get("rcnn") or {})
    for field, val in (("rcnn_score_thr", rcnn_tc.get("score_thr")),
                       ("rcnn_nms_iou", dict(rcnn_tc.get("nms") or {}).get("iou_threshold")),
                       ("rcnn_max_per_img", rcnn_tc.get("max_per_img")),
                       ("mask_thr_binary", rcnn_tc.get("mask_thr_binary"))):
        if field in fields and val is not None:
            kwargs.setdefault(field, val)
    kwargs.setdefault("scale_factor", scale_factor)
    if kwargs.get("backbone"):
        kwargs["backbone"] = _with_tier(kwargs["backbone"], swin_kernel)
    elif "backbone_cfg" in fields:
        kwargs["backbone_cfg"] = dict(kwargs.get("backbone_cfg") or {}, kernel=swin_kernel)
    dropped = set(model_cfg) - set(kwargs) - {"type", "test_cfg"}
    if dropped:
        logging.getLogger("nuhtc_tpu_torch").warning(
            "build_detector %s: ignoring config keys %s", mtype, sorted(dropped))
    return cls(**kwargs)


def build_detector(model_cfg: Dict[str, Any], test_cfg: Dict[str, Any] | None = None,
                   scale_factor: float = 2.0, swin_kernel: str = "block") -> nn.Module:
    """``swin_kernel``: the Swin block's kernel tier on a CUDA device,
    "block" (K1), "attn" (K2) or "none" (models/swin.py)."""
    model_cfg = dict(model_cfg)
    mtype = model_cfg.get("type")
    if mtype and mtype not in ("NuHTC", "HybridTaskCascade_Cus"):
        return _build_registered(mtype, model_cfg, test_cfg, scale_factor, swin_kernel)
    test_cfg = dict(test_cfg or model_cfg.get("test_cfg") or {})
    roi = dict(model_cfg.get("roi_head") or {})
    roi_type = str(roi.get("type", "HybridTaskCascadeRoIHead_Lite"))
    lite = bool(roi.get("lite", "Lite" in roi_type))
    lite_fuse = bool(roi.get("lite_fuse", "Fuse" in roi_type))
    neck = dict(model_cfg.get("neck") or {})
    backbone = _with_tier(model_cfg.get("backbone") or {}, swin_kernel)
    bbox_heads = roi.get("bbox_head") or [{}]
    if isinstance(bbox_heads, dict):
        bbox_heads = [bbox_heads]
    bbox_ext = dict(roi.get("bbox_roi_extractor") or {})
    rpn_test = dict(test_cfg.get("rpn") or {})
    rcnn_test = dict(test_cfg.get("rcnn") or {})
    # train_cfg.rcnn[*].sampler.type picks the cascade's RoI sampler
    rcnn_train = dict(model_cfg.get("train_cfg") or {}).get("rcnn") or []
    if isinstance(rcnn_train, dict):
        rcnn_train = [rcnn_train]
    sampler_type = ""
    for st in rcnn_train:
        sampler_type = ((st or {}).get("sampler") or {}).get("type") or sampler_type
    rcnn_sampler = ("ohem" if "OHEM" in sampler_type
                    else "instance_balanced" if "InstanceBalanced" in sampler_type else "random")
    return NuHTC(
        num_classes=bbox_heads[0].get("num_classes", 5),
        strides=tuple(bbox_ext.get("featmap_strides", (4, 8, 16, 32))),
        num_stages=roi.get("num_stages", 3),
        attn_start_level=bbox_ext.get("start_level", 2),
        attn_thres=bbox_ext.get("thres", 0.965926),
        rpn_nms_pre=rpn_test.get("nms_pre", 3000),
        rpn_max_per_img=rpn_test.get("max_per_img", 1000),
        rpn_nms_iou=dict(rpn_test.get("nms") or {}).get("iou_threshold", 0.7),
        rpn_min_bbox_size=rpn_test.get("min_bbox_size", 10.0),
        rcnn_score_thr=rcnn_test.get("score_thr", 0.35),
        rcnn_nms_iou=dict(rcnn_test.get("nms") or {}).get("iou_threshold", 0.5),
        rcnn_max_per_img=rcnn_test.get("max_per_img", 500),
        mask_thr_binary=rcnn_test.get("mask_thr_binary", 0.5),
        watershed_proposal=roi.get("watershed_proposal", True),
        scale_factor=scale_factor,
        backbone=backbone,
        neck=neck or None,
        rcnn_sampler=rcnn_sampler,
        lite=lite,
        lite_fuse=lite_fuse,
    )


@torch.no_grad()
def init_random_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights for runs without a checkpoint: weights of linear and
    conv layers normal with std 1/sqrt(fan_in), biases 0, norms 1/0, the
    relative-position bias tables std 0.02, the cosine classifier std 0.01;
    a ViT-Adapter's frozen batch-norms 1/0 with running statistics 0/1 (its
    output norms' weight std ``OutputNorm.WEIGHT_STD``), its level embeddings
    std 1 and its injectors' γ 1 (the published γ is 0, which would switch
    the injectors off)."""
    for m in model.modules():
        if isinstance(m, NormedLinear):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.01)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel() if not isinstance(m, nn.ConvTranspose2d) else (
                m.weight.shape[0] * m.weight[0, 0].numel())
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WindowMSA):
            t = m.relative_position_bias_table
            t.copy_(torch.randn(t.shape, generator=generator) * 0.02)
        elif isinstance(m, FrozenBatchNorm2d):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                         (m.running_var, 1.0)):
                t.fill_(v)
            if isinstance(m, OutputNorm):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * OutputNorm.WEIGHT_STD)
        elif isinstance(m, ViTAdapter):
            m.level_embed.copy_(torch.randn(m.level_embed.shape, generator=generator))
        elif isinstance(m, Injector):
            m.gamma.fill_(1.0)
    return model
