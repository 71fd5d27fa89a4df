"""RoI feature extractors, batched (port of nuhtc_tpu/models/roi_extractor.py).

``attention_roi_features`` is the reference AttentionRoIExtractor: the sum
over pyramid levels of RoIAlign on levels below ``start_level`` and the
cosine-similarity attention pool, broadcast over the output grid, on the
others. ``single_roi_features`` is plain RoIAlign on the semantic map.
``stage_roi_features`` is their sum as the detector takes it: one fused
RoIAlign call (K4 on CUDA tensors) over the fine levels and the semantic
map, with the attention pools as its per-RoI bias.
"""

from __future__ import annotations

from typing import Sequence

import torch

from nuhtc_tpu_torch.ops.roi_align import attention_pool, roi_align, roi_align_sum


def attention_roi_features(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                           output_size: int, sampling_ratio: int,
                           strides: Sequence[int] = (4, 8, 16, 32), start_level: int = 2,
                           thres: float = 0.965926, max_grid: int = 8) -> torch.Tensor:
    """feats per-level (B, H, W, C), rois (B, R, 4) → (B, R, out, out, C)."""
    out = None
    for lvl, (feat, stride) in enumerate(zip(feats, strides)):
        if lvl < start_level:
            t = roi_align(feat, rois, 1.0 / stride, output_size,
                          sampling_ratio=sampling_ratio, max_grid=max_grid)
        else:
            t = attention_pool(feat, rois, stride, thres)[:, :, None, None, :]
        out = t if out is None else out + t
    return out


def single_roi_features(feat: torch.Tensor, rois: torch.Tensor, output_size: int,
                        stride: int = 4, sampling_ratio: int = 0, max_grid: int = 8,
                        pool_from: int | None = None) -> torch.Tensor:
    return roi_align(feat, rois, 1.0 / stride, output_size, sampling_ratio=sampling_ratio,
                     max_grid=max_grid, pool_from=pool_from)


def stage_roi_features(feats: Sequence[torch.Tensor], semantic_feat: torch.Tensor,
                       rois: torch.Tensor, output_size: int, sampling_ratio: int,
                       sem_pool_from: int | None, strides: Sequence[int] = (4, 8, 16, 32),
                       start_level: int = 2, thres: float = 0.965926,
                       max_grid: int = 8) -> torch.Tensor:
    """``attention_roi_features(feats, …) + single_roi_features(semantic_feat, …)``
    (the semantic map at ``strides[0]``, adaptive grid, ``sem_pool_from``) as
    one ``roi_align_sum``: the attention pools of the levels from
    ``start_level`` on are summed to one (B, R, C) f32 bias, the levels below
    and the semantic map are RoIAligned and summed in f32 with it, and the
    result is rounded once. → (B, R, out, out, C)."""
    bias = None
    for feat, stride in list(zip(feats, strides))[start_level:]:
        pooled = attention_pool(feat, rois, stride, thres, out_dtype=torch.float32)
        bias = pooled if bias is None else bias + pooled
    maps = list(feats[:start_level]) + [semantic_feat]
    scales = [1.0 / s for s in strides[:start_level]] + [1.0 / strides[0]]
    return roi_align_sum(maps, rois, scales, output_size,
                         [sampling_ratio] * start_level + [0],
                         [None] * start_level + [sem_pool_from], bias=bias, max_grid=max_grid)
