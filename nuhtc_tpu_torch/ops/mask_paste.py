"""Paste 28×28 mask probabilities into the image frame.

Port of nuhtc_tpu/ops/mask_paste.py: each mask is resampled onto the image
with ``F.grid_sample(align_corners=False, padding_mode='zeros')`` semantics
(pixel centre p + 0.5 maps to mask coordinate (p + 0.5 - b0) / (b1 - b0) · M
- 0.5, bilinear, zero outside), as two f32 interpolation products per
detection. ``paste_masks`` gives one full-frame binary mask per detection;
``paste_label_map`` one instance label map per image, where a pixel gets 1 +
the lowest index of a valid detection above the threshold there, 0 if none.
"""

from __future__ import annotations

import torch


def _paste_matrix(b0: torch.Tensor, b1: torch.Tensor, out_size: int, mask_size: int):
    """(...,) box starts/ends → (..., out_size, mask_size) f32 matrices."""
    p = torch.arange(out_size, dtype=torch.float32, device=b0.device) + 0.5
    extent = (b1 - b0).clamp(min=1e-6)
    m = (p - b0[..., None]) / extent[..., None] * mask_size - 0.5  # (..., out)
    k = torch.arange(mask_size, dtype=torch.float32, device=b0.device)
    return (1.0 - (k - m[..., None]).abs()).clamp(min=0.0)


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, out_shape: tuple[int, int],
                threshold: float = 0.5, chunk: int = 128) -> torch.Tensor:
    """masks (N, M, M) probabilities, boxes (N, 4) in the output frame →
    (N, H, W) uint8 binary masks (full > threshold), or the f32 pasted
    probabilities when ``threshold`` < 0. Detections go in chunks of
    ``chunk``: the (chunk, H, W) f32 intermediate is 33.6 MB at 256²."""
    n, msize, _ = masks.shape
    h, w = out_shape
    out = torch.empty((n, h, w), dtype=torch.uint8 if threshold >= 0 else torch.float32,
                      device=masks.device)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        bx = boxes[sl].float()
        py = _paste_matrix(bx[:, 1], bx[:, 3], h, msize)  # (c, H, M)
        px = _paste_matrix(bx[:, 0], bx[:, 2], w, msize)  # (c, W, M)
        full = py @ masks[sl].float() @ px.transpose(-1, -2)  # (c, H, W)
        out[sl] = (full > threshold) if threshold >= 0 else full
    return out


def paste_label_map(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                    out_shape: tuple[int, int], threshold: float = 0.5) -> torch.Tensor:
    """masks (B, N, M, M) probabilities, boxes (B, N, 4) in the output frame,
    valid (B, N) → (B, H, W) int32 label map. Detections go in chunks of 64:
    the (B, 64, H, W) f32 intermediate is 268 MB at B16, 256²."""
    chunk = 64
    b, n, msize, _ = masks.shape
    h, w = out_shape
    big = n + 1
    lab = torch.full((b, h, w), big, dtype=torch.int32, device=masks.device)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        bx = boxes[:, sl].float()
        py = _paste_matrix(bx[..., 1], bx[..., 3], h, msize)  # (B, c, H, M)
        px = _paste_matrix(bx[..., 0], bx[..., 2], w, msize)  # (B, c, W, M)
        full = py @ masks[:, sl].float() @ px.transpose(-1, -2)  # (B, c, H, W)
        on = (full > threshold) & valid[:, sl, None, None]
        ids = torch.arange(sl.start, sl.stop, dtype=torch.int32, device=masks.device)
        cand = torch.where(on, ids[None, :, None, None], big).amin(dim=1)
        lab = torch.minimum(lab, cand)
    return torch.where(lab >= big, 0, lab + 1)
