"""The operations of one image's forward, counted from the configuration's
shapes: products only (2·M·N·K a matrix product, 2·outputs·Cin·k² a
convolution), as ``torch.utils.flop_counter.FlopCounterMode`` counts them.

- ``feats_flops``: the backbone's and the neck's parts' own counts,
  equal to FlopCounterMode over the reference's backbone and neck (held by
  a test);
- the heads on the kernel path at the configuration's padded sizes: the RPN
  head, the semantic head, the bbox and mask heads' products, the
  attention pools, K4's work at one sample point a bin (4 cells), and the
  label-map paste;
- left out: the plain RoIAlign's dense products (the card runs K4's
  gathers instead) and NMS's suppression products (their rounds follow the
  data).

The count is the same whatever implements the step; ``work/<config>.json``
freezes it per configuration (``python -m portbench.work.flops`` writes
them)."""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from portbench.reference import model as ref_model
from portbench.work.roofline import fpn_channels, input_side

STRIDES = (4, 8, 16, 32)


def conv(out_hw: int, cin: int, cout: int, k: int = 1) -> float:
    return 2.0 * out_hw * cin * cout * k * k


def feats_flops(cfg: dict, side: int) -> float:
    """Backbone + neck of one square image of ``side``: each part's
    ``flops`` (``reference/parts/<type>.py``), the neck over the backbone's
    channels."""
    (bb_type, bb_spec), (neck_type, neck_spec) = ref_model.part_specs(cfg["model"])
    backbone = ref_model.part(bb_type)
    with torch.device("meta"):
        _, dims = backbone.build(bb_spec, 3)
    return (backbone.flops(bb_spec, side, 3)
            + ref_model.part(neck_type).flops(neck_spec, side, dims))


def _level_sides(side: int):
    return [side // s for s in STRIDES]


def _paste(tile: int, n: int, mask: int = 28) -> float:
    """py (t, M) @ masks (M, M) @ px (t, M)ᵀ for ``n`` detections."""
    return n * (2.0 * tile * mask * mask + 2.0 * tile * mask * tile)


def heads_flops(cfg: dict) -> Dict[str, float]:
    m = cfg["model"]
    side = input_side(cfg)
    c = fpn_channels(cfg)
    sides = _level_sides(side)
    parts: Dict[str, float] = {}
    anchors = 3
    parts["rpn_head"] = sum(conv(s * s, c, c, 3) + conv(s * s, c, anchors)
                            + conv(s * s, c, 4 * anchors) for s in sides)
    k4 = lambda r, out, maps: r * out * out * c * 2.0 * 4 * maps  # noqa: E731
    if m["type"] == "MaskRCNN":
        ncls = m.get("num_classes", 8)
        p, d = m.get("rpn_max_per_img", 1000), m.get("rcnn_max_per_img", 100)
        fc = 1024
        parts["bbox_head"] = p * (2.0 * 49 * c * fc + 2.0 * fc * fc + 2.0 * fc * (ncls + 1)
                                  + 2.0 * fc * 4 * ncls)
        parts["mask_head"] = d * (4 * conv(196, c, c, 3) + 2.0 * 196 * c * c * 4
                                  + conv(784, c, ncls))
        parts["roi_align"] = k4(p, 7, 4) + k4(d, 14, 4)
        parts["paste"] = _paste(cfg["tile"], d)
        return parts
    ncls = m["roi_head"]["bbox_head"][0].get("num_classes", 5)
    stages = m["roi_head"].get("num_stages", 3)
    rpn, rcnn = m["test_cfg"]["rpn"], m["test_cfg"]["rcnn"]
    r = rpn.get("max_per_img", 1000) + (512 if m["roi_head"].get("watershed_proposal", True)
                                        else 0)
    d = rcnn.get("max_per_img", 500)
    s0 = sides[0]
    sem = sum(conv(s * s, c, c) for s in sides)  # laterals
    sem += sum(2.0 * c * (s0 * s * s + s0 * s0 * s) for s in sides[1:])  # align-corners resizes
    sem += 4 * conv(s0 * s0, c, c, 3) + conv(s0 * s0, c, 1) + conv(s0 * s0, c, c)
    parts["semantic_head"] = sem
    # attention pools of the levels from start_level on: cos(centre, cell) and the pool
    start = m["roi_head"]["bbox_roi_extractor"].get("start_level", 2)
    pool = lambda n: sum(2 * 2.0 * s * s * c * n for s in sides[start:])  # noqa: E731
    fc = 256
    parts["bbox_heads"] = stages * r * (2.0 * 49 * c * fc + 2.0 * fc * fc
                                        + 2.0 * fc * (ncls + 2) + 2.0 * fc * 4)
    parts["mask_head"] = d * (4 * conv(196, c, c, 3) + 2.0 * 196 * c * c * 4 + conv(784, c, 1))
    parts["attention_pool"] = stages * pool(r) + pool(d)
    parts["roi_align"] = stages * k4(r, 7, 3) + k4(d, 14, 3)
    parts["paste"] = _paste(cfg["tile"], d)
    return parts


def count(cfg: dict) -> dict:
    """The frozen record of ``work/<config>.json``."""
    side = input_side(cfg)
    parts = {"backbone_fpn": feats_flops(cfg, side), **heads_flops(cfg)}
    return {"input_side": side, "flops_per_image": sum(parts.values()), "parts": parts}


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    configs = os.path.join(os.path.dirname(here), "configs")
    for name in sorted(os.listdir(configs)):
        with open(os.path.join(configs, name)) as f:
            cfg = json.load(f)
        with open(os.path.join(here, name), "w") as f:
            json.dump(count(cfg), f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
