"""Box primitives (continuous convention: w = x2 - x1, no +1).

Port of nuhtc_tpu/ops/boxes.py: DeltaXYWHBBoxCoder decode and encode, clipping,
IoU.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def clip_boxes(boxes: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    h, w = shape[:2]
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
               max_shape: Tuple[int, int] | None = None,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Decode (..., 4) deltas against (..., 4) rois."""
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    d = deltas * stds + means
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gx = px + pw * d[..., 0]
    gy = py + ph * d[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    return clip_boxes(out, max_shape) if max_shape is not None else out


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """(..., N, 4) × (..., M, 4) → (..., N, M) IoU, the union floored at
    ``eps`` (the assigners take mmdet 2.x ``bbox_overlaps``'s 1e-6)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=eps)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0), eps: float = 1e-6) -> torch.Tensor:
    """Encode (..., 4) gt boxes against (..., 4) proposals (training targets)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=eps)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=eps)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=eps)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=eps)
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                          torch.log(gh / ph)], dim=-1)
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means) / stds

