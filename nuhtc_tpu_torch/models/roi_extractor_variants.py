"""The other RoI extractors (port of nuhtc_tpu/models/roi_extractor_variants.py;
reference nuhtc/models/roi_extractors_cus.py), batched: maps (B, H, W, C),
RoIs (B, R, 4), each image equal to the JAX function of that image.

- ``selected_roi_features``: the sum of RoIAlign over the selected levels;
- ``local_global_roi_features``: RoIAlign on the levels below
  ``start_level`` plus each coarser level's global mean, the same in every
  bin;
- ``pos_attention_pool``: each RoI's centre-cell vector mixed with the
  others' by cosine similarity over the unique centre cells.

The RoIAlign sums go through K4's wrapper ``roi_align_sum`` (up to three
maps a launch; the hand kernel on CUDA tensors, its plain version on CPU
ones): ``selected_roi_features`` over four levels is two launches, and
``local_global_roi_features`` one, its coarse levels' means entering as
K4's per-RoI bias. ``pos_attention_pool`` is plain tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from nuhtc_tpu_torch.ops.roi_align import roi_align_sum

MAPS_PER_LAUNCH = 3  # what one roi_align_sum call takes


def _roi_align_levels(feats, rois, strides, output_size, sampling_ratio, max_grid, bias=None):
    """Σ RoIAlign over ``feats`` in launches of up to three maps, ``bias``
    (B, R, C) added in the first."""
    out = None
    for i in range(0, len(feats), MAPS_PER_LAUNCH):
        group = range(i, min(i + MAPS_PER_LAUNCH, len(feats)))
        t = roi_align_sum([feats[j] for j in group], rois, [1.0 / strides[j] for j in group],
                          output_size, [sampling_ratio] * len(group), [None] * len(group),
                          bias if i == 0 else None, max_grid)
        out = t if out is None else out + t
    return out


def selected_roi_features(feats: Sequence[torch.Tensor], rois: torch.Tensor, output_size: int,
                          sampling_ratio: int, strides: Sequence[int] = (4, 8, 16, 32),
                          selected_levels: Optional[Sequence[int]] = None,
                          max_grid: int = 8) -> torch.Tensor:
    """Σ over the selected levels of RoIAlign → (B, R, out, out, C)."""
    levels = list(selected_levels) if selected_levels is not None else list(range(len(feats)))
    return _roi_align_levels([feats[i] for i in levels], rois, [strides[i] for i in levels],
                             output_size, sampling_ratio, max_grid)


def local_global_roi_features(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                              output_size: int, sampling_ratio: int,
                              strides: Sequence[int] = (4, 8, 16, 32), start_level: int = 2,
                              max_grid: int = 8) -> torch.Tensor:
    """RoIAlign on the levels below ``start_level`` plus the global mean of
    every other level, broadcast over the bins → (B, R, out, out, C)."""
    fine = list(feats[:start_level])
    b, r = rois.shape[:2]
    coarse = [f.float().mean(dim=(1, 2)) for f in feats[start_level:]]  # (B, C) each
    bias = None
    if coarse:
        bias = torch.stack(coarse).sum(0)[:, None, :].expand(b, r, -1).contiguous()
    if not fine:
        c = feats[0].shape[3]
        return bias[:, :, None, None, :].expand(b, r, output_size, output_size, c).to(
            feats[0].dtype)
    return _roi_align_levels(fine, rois, strides[:start_level], output_size, sampling_ratio,
                             max_grid, bias)


def pos_attention_pool(feat: torch.Tensor, rois: torch.Tensor, stride: int,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feat (B, H, W, C), rois (B, R, 4), valid (B, R) bool or None → (B, R, C):
    out_i = (1/U) Σ over the unique centre cells b of cos(v_i, w_b) · w_b,
    with v_i the (detached) vector of RoI i's centre cell. Every RoI j weighs
    1/multiplicity of its cell among the valid RoIs, which gives the sums
    over unique cells (RoIs sharing a cell share its vector); invalid RoIs
    weigh 0, and U is the number of unique valid cells (at least 1)."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    cx = torch.floor((rois[..., 0] + rois[..., 2]) / (2.0 * stride)).clamp(0, w - 1).long()
    cy = torch.floor((rois[..., 1] + rois[..., 3]) / (2.0 * stride)).clamp(0, h - 1).long()
    flat = feat.reshape(b, h * w, c).float()
    v = torch.gather(flat, 1, (cy * w + cx)[..., None].expand(b, r, c)).detach()
    ok = (torch.ones((b, r), dtype=torch.bool, device=feat.device) if valid is None
          else valid.bool())
    same_cell = (cx[:, :, None] == cx[:, None, :]) & (cy[:, :, None] == cy[:, None, :])
    same_cell = same_cell & ok[:, None, :]
    mult = same_cell.sum(dim=2).clamp(min=1)
    inv_m = torch.where(ok, 1.0 / mult, torch.zeros((), device=feat.device))
    u = inv_m.sum(dim=1).clamp(min=1.0)
    norm = torch.linalg.vector_norm(v, dim=2).clamp(min=1e-8)
    cos = (v @ v.transpose(1, 2)) / (norm[:, :, None] * norm[:, None, :])
    out = (cos * inv_m[:, None, :]) @ v / u[:, None, None]
    return out.to(feat.dtype)
