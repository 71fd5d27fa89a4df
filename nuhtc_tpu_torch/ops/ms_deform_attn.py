"""Multi-scale deformable attention's sampling core (Deformable DETR,
arXiv:2010.04159, eq. 3), as ViT-Adapter's ``MSDeformAttn`` runs it.

For a value map of L levels, each query q, head m, level l and point p
carries a location ``loc`` in the unit square, (x, y), and a weight; the
core returns, per head,

    out[q, m] = Σ_l Σ_p weight[q, m, l, p] · bilinear(value_l[m], loc[q, m, l, p])

where ``bilinear`` samples level l (H_l × W_l) at the pixel
(x·W_l − 0.5, y·H_l − 0.5), taking zero for each corner outside the map:
``F.grid_sample(2·loc − 1, mode="bilinear", padding_mode="zeros",
align_corners=False)``.

``ms_deform_attn`` is that in plain PyTorch, the same code on the CPU and the
card, written after Deformable DETR's ``ms_deform_attn_core_pytorch``: one
``grid_sample`` a level over an f32 copy of the level's values (positions
in f32: a bf16 grid would place samples on a 1/4-pixel lattice at 128
pixels a side), the samples stacked, weighted and summed in f32, the
output in the value's dtype. The level shapes and starts are Python ints.
Each call counts itself in ``deform.attn_plain`` and the bytes of every
tensor it writes before its output (the level value copies and grids, the
samples, their stack, the weights' copy, the weighted product and its sum) in
``deform.sample_bytes`` (``utils/profiling.py``). No TPU kernel computes
it; the JAX package has no deformable attention.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from nuhtc_tpu_torch.utils.profiling import count


def level_starts(shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """The first token of each level in a value map that concatenates the
    levels' row-major tokens in order."""
    starts, at = [], 0
    for h, w in shapes:
        starts.append(at)
        at += h * w
    return starts


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ms_deform_attn(value: torch.Tensor, shapes: Sequence[Tuple[int, int]], loc: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """value (b, S, M, Dh), S = Σ H_l·W_l over ``shapes`` ((H_l, W_l) Python
    ints); loc (b, Lq, M, L, P, 2) f32, (x, y) in the unit square; weights
    (b, Lq, M, L, P) f32 → (b, Lq, M·Dh) in value's dtype."""
    b, _, m, dh = value.shape
    lq, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if nl != len(shapes):
        raise ValueError(f"ms_deform_attn: {nl} levels of locations, {len(shapes)} shapes")
    grids = 2.0 * loc.float() - 1.0
    written = _nbytes(grids)
    samples = []
    for lvl, ((h, w), start) in enumerate(zip(shapes, level_starts(shapes))):
        v = value.new_empty((b * m, dh, h, w), dtype=torch.float32)
        v.view(b, m, dh, h, w).copy_(
            value[:, start:start + h * w].view(b, h, w, m, dh).permute(0, 3, 4, 1, 2))
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(b * m, lq, p, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        samples.append(s)  # (b·M, Dh, Lq, P)
        written += _nbytes(v) + _nbytes(g) + _nbytes(s)
    stacked = torch.stack(samples, dim=-2).flatten(-2)  # (b·M, Dh, Lq, L·P)
    wts = weights.float().transpose(1, 2).reshape(b * m, 1, lq, nl * p)
    prod = stacked * wts
    out = prod.sum(-1)  # (b·M, Dh, Lq)
    written += _nbytes(stacked) + _nbytes(wts) + _nbytes(prod) + _nbytes(out)
    count("deform.attn_plain")
    count("deform.sample_bytes", written)
    return out.view(b, m * dh, lq).transpose(1, 2).to(value.dtype)
