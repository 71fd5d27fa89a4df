"""Backbone part ``ViTAdapter``: ViT-Adapter (Chen et al., arXiv:2205.08534;
``github.com/czczup/ViT-Adapter``, ``detection/configs/mask_rcnn/
mask_rcnn_deit_adapter_base_fpn_3x_coco.py``) in plain f32 PyTorch, and its
work count.

For an NHWC image of H × W, D = ``embed_dim``, the ViT's grid h × w = H/16
× W/16 and the prior's levels at 1/8, 1/16, 1/32:

- the ViT: ``parts/ViT.py``'s 16 × 16 patch embedding, position table (its
  class token dropped, resized by ``cubic_matrix`` on each axis) and blocks,
  with no relative-position tables; block i attends in windows of
  ``window_size[i]`` where ``window_attn[i]``, else globally;
- the spatial prior: conv3×3 s2 (3 → C), BN, ReLU, conv3×3 (C → C), BN,
  ReLU twice, maxpool 3 s2 p1 (``c1``, 1/4); then conv3×3 s2 + BN + ReLU to
  2C (1/8), 4C (1/16), 4C (1/32), C = ``conv_inplane``; no conv bias; 1×1
  convs with a bias to D. ``c2``, ``c3``, ``c4`` plus ``level_embed[0..2]``,
  flattened and concatenated, are the token stream c;
- BN: ``(x − running_mean) / √(running_var + 1e-5) · weight + bias``, all
  four held as parameters;
- ``deform_attn(query, ref, feat, shapes)``: values ``value_proj(feat)`` in
  M heads of D·ratio/M; offsets ``sampling_offsets(query)`` (M, L, P,
  (x, y)); weights ``attention_weights(query)`` with a softmax over L·P;
  ``loc = ref + offset / (W_l, H_l)``; ``sample`` reads level l at pixel
  (loc_x·W_l − 0.5, loc_y·H_l − 0.5) from its four neighbours, bilinearly,
  zero outside the map, by index gathers; Σ over levels and points of the
  weight times the sample; ``output_proj``;
- injector: ``x + γ ⊙ deform_attn(LN(x), centres of h × w, LN(c), the three
  levels)``; extractor: ``c + deform_attn(LN(c), centres of each level,
  LN(x), (h, w))``, then ``c + fc2(GELU(dw3×3(fc1(LN(c)))))``, the
  depthwise conv on each level's map; LN eps 1e-6;
- interactions: for each [a, b] an injector, blocks a … b, an extractor,
  and two more extractors in the last;
- output: ``c1 + up(c2)`` (ConvTranspose2d 2, stride 2), level i plus the
  ViT's map after interaction i resized bilinearly (``F.interpolate``,
  ``align_corners=False``) by 4, 2, 1, 0.5 (the published ``outs``), then a
  BN each.

``INIT``: the batch-norms 1, 0, 0, 1 (the published initialisation),
but the four on the outputs draw their weight normal with std 0.25: with
running statistics 0 and 1 random weights leave the pyramid at the ViT
stream's scale (rms 3 to 5 a channel), where a trained model's statistics
bring each channel to about 1, and at that scale the random heads put the
lifted class's score at 0.99 to 1 on every box, so that bf16 reorders most
detections at the 100-an-image cap;
``level_embed`` normal of std 1 (published); γ 1, where the published
value is 0 (random weights would switch the injectors off);
``sampling_offsets`` takes the Linear rule (bias 0), not Deformable DETR's
grid of initial offsets; ``pos_embed`` std 0.02, as ``parts/ViT.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import part

_vit = part("ViT")

KEYS = ("img_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "qkv_bias", "window_attn",
        "window_size", "pretrain_size", "conv_inplane", "n_points", "deform_num_heads",
        "interaction_indexes", "cffn_ratio", "deform_ratio")
PATCH = 16
# queries sampled at once on the card: bounds the gathered (b, M, q·P, Dh) blocks
QUERY_BLOCK = 4096


class BN(nn.Module):
    INIT = {"weight": "ones", "bias": "zeros", "running_mean": "zeros", "running_var": "ones"}

    def __init__(self, c: int):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            setattr(self, name, nn.Parameter(torch.full((c,), fill), requires_grad=False))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        return ((x - self.running_mean.view(shape)) / torch.sqrt(self.running_var.view(shape)
                                                                 + 1e-5)
                * self.weight.view(shape) + self.bias.view(shape))


class OutBN(BN):
    """The batch-norm on each output level; its weight drawn smaller than
    the published 1 (the module docstring's ``INIT``)."""

    INIT = dict(BN.INIT, weight=0.25)


def _cbr(cin: int, cout: int, stride: int) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride, 1, bias=False), BN(cout), nn.ReLU()]


class SPM(nn.Module):
    def __init__(self, c: int, d: int, in_channels: int):
        super().__init__()
        self.stem = nn.Sequential(*_cbr(in_channels, c, 2), *_cbr(c, c, 1), *_cbr(c, c, 1),
                                  nn.MaxPool2d(3, 2, 1))
        self.conv2 = nn.Sequential(*_cbr(c, 2 * c, 2))
        self.conv3 = nn.Sequential(*_cbr(2 * c, 4 * c, 2))
        self.conv4 = nn.Sequential(*_cbr(4 * c, 4 * c, 2))
        self.fc1, self.fc2 = nn.Conv2d(c, d, 1), nn.Conv2d(2 * c, d, 1)
        self.fc3, self.fc4 = nn.Conv2d(4 * c, d, 1), nn.Conv2d(4 * c, d, 1)

    def forward(self, img):
        c1 = self.stem(img)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        return self.fc1(c1), self.fc2(c2), self.fc3(c3), self.fc4(c4)


def sample(value: torch.Tensor, h: int, w: int, loc: torch.Tensor) -> torch.Tensor:
    """value (b, M, h·w, Dh) of one level; loc (b, M, n, 2), (x, y) in the
    unit square → (b, M, n, Dh): bilinear at pixel (x·w − 0.5, y·h − 0.5)
    from the four neighbours, each neighbour outside the map zero."""
    px = loc[..., 0] * w - 0.5
    py = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    out = 0.0
    for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        got = value.gather(2, idx[..., None].expand(-1, -1, -1, value.shape[-1]))
        out = out + got * (wt * inside)[..., None]
    return out


def sample_and_sum(value: torch.Tensor, shapes, loc: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """value (b, S, M, Dh) over the levels of ``shapes``; loc (b, q, M, L, P,
    2); weights (b, q, M, L, P) → (b, q, M·Dh): Σ_l Σ_p weight · sample."""
    b, _, m, dh = value.shape
    q, nl, p = loc.shape[1], loc.shape[3], loc.shape[4]
    out = value.new_zeros(b, m, q, dh)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 1, 3)
        start += h * w
        for a in range(0, q, QUERY_BLOCK):
            z = min(q, a + QUERY_BLOCK)
            lc = loc[:, a:z, :, lvl].permute(0, 2, 1, 3, 4).reshape(b, m, (z - a) * p, 2)
            s = sample(v, h, w, lc).reshape(b, m, z - a, p, dh)
            wt = weights[:, a:z, :, lvl].permute(0, 2, 1, 3)
            out[:, :, a:z] += (s * wt[..., None]).sum(3)
    return out.permute(0, 2, 1, 3).reshape(b, q, m * dh)


class DeformAttn(nn.Module):
    def __init__(self, d: int, levels: int, heads: int, points: int, ratio: float):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.value_proj = nn.Linear(d, int(d * ratio))
        self.output_proj = nn.Linear(int(d * ratio), d)

    def forward(self, query, ref, feat, shapes):
        b, q, _ = query.shape
        m, nl, p = self.heads, self.levels, self.points
        value = self.value_proj(feat)
        value = value.reshape(b, value.shape[1], m, -1)
        off = self.sampling_offsets(query).reshape(b, q, m, nl, p, 2)
        wts = self.attention_weights(query).reshape(b, q, m, nl * p).softmax(-1)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=off.dtype, device=off.device)
        loc = ref[None, :, None, None, None, :] + off / norm[None, None, None, :, None, :]
        out = sample_and_sum(value, shapes, loc, wts.reshape(b, q, m, nl, p))
        return self.output_proj(out)


class Injector(nn.Module):
    INIT = {"gamma": "ones"}

    def __init__(self, d, heads, points, ratio):
        super().__init__()
        self.query_norm, self.feat_norm = nn.LayerNorm(d, eps=1e-6), nn.LayerNorm(d, eps=1e-6)
        self.attn = DeformAttn(d, 3, heads, points, ratio)
        self.gamma = nn.Parameter(torch.zeros(d))

    def forward(self, x, ref, c, shapes):
        return x + self.gamma * self.attn(self.query_norm(x), ref, self.feat_norm(c), shapes)


class DWConv(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dwconv = nn.Conv2d(c, c, 3, 1, 1, groups=c)


class ConvFFN(nn.Module):
    def __init__(self, d, hidden):
        super().__init__()
        self.fc1, self.dwconv, self.fc2 = nn.Linear(d, hidden), DWConv(hidden), nn.Linear(hidden, d)

    def forward(self, x, shapes):
        x = self.fc1(x)
        parts, start = [], 0
        for h, w in shapes:
            m = x[:, start:start + h * w].reshape(x.shape[0], h, w, -1).permute(0, 3, 1, 2)
            parts.append(self.dwconv.dwconv(m).permute(0, 2, 3, 1).reshape(x.shape[0], h * w, -1))
            start += h * w
        return self.fc2(F.gelu(torch.cat(parts, 1)))


class Extractor(nn.Module):
    def __init__(self, d, heads, points, ratio, cffn_ratio):
        super().__init__()
        self.query_norm, self.feat_norm = nn.LayerNorm(d, eps=1e-6), nn.LayerNorm(d, eps=1e-6)
        self.attn = DeformAttn(d, 1, heads, points, ratio)
        self.ffn = ConvFFN(d, int(d * cffn_ratio))
        self.ffn_norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, c, ref, x, vit_shape, c_shapes):
        c = c + self.attn(self.query_norm(c), ref, self.feat_norm(x), [vit_shape])
        return c + self.ffn(self.ffn_norm(c), c_shapes)


class Interaction(nn.Module):
    def __init__(self, d, heads, points, ratio, cffn_ratio, extra):
        super().__init__()
        self.injector = Injector(d, heads, points, ratio)
        self.extractor = Extractor(d, heads, points, ratio, cffn_ratio)
        self.extra_extractors = nn.ModuleList(
            Extractor(d, heads, points, ratio, cffn_ratio) for _ in range(2)) if extra else None


def centres(shapes, device) -> torch.Tensor:
    """(Σ h·w, 2) centres (x, y) of each level's cells in the unit square."""
    out = []
    for h, w in shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        out.append(torch.stack((xs[None, :].expand(h, w), ys[:, None].expand(h, w)),
                               -1).reshape(-1, 2))
    return torch.cat(out)


def _sides(img_size) -> Tuple[int, int]:
    return (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)


def _windows(window_attn, window_size) -> List[int]:
    """Each block's window side, 0 for a global block."""
    return [int(ws) if wa else 0 for wa, ws in zip(window_attn, window_size)]


class ViTAdapter(nn.Module):
    INIT = {"level_embed": 1.0, "pos_embed": 0.02}

    def __init__(self, img_size=1024, in_channels=3, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, qkv_bias=True, window_attn=(False,) * 12,
                 window_size=(None,) * 12, pretrain_size=224, conv_inplane=64, n_points=4,
                 deform_num_heads=12, interaction_indexes=((0, 2), (3, 5), (6, 8), (9, 11)),
                 cffn_ratio=0.25, deform_ratio=0.5):
        super().__init__()
        hh, ww = _sides(img_size)
        d = embed_dim
        self.vit_shape = (hh // PATCH, ww // PATCH)
        self.c_shapes = [(hh // s, ww // s) for s in (8, 16, 32)]
        self.grid = pretrain_size // PATCH
        self.indexes = [tuple(ab) for ab in interaction_indexes]
        self.patch_embed = _vit.PatchEmbed(in_channels, d, PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid ** 2 + 1, d))
        self.blocks = nn.ModuleList(_vit.Block(d, num_heads, mlp_ratio, qkv_bias, False, ws, 0)
                                    for ws in _windows(window_attn, window_size))
        self.level_embed = nn.Parameter(torch.zeros(3, d))
        self.spm = SPM(conv_inplane, d, in_channels)
        n = len(self.indexes)
        self.interactions = nn.ModuleList(
            Interaction(d, deform_num_heads, n_points, deform_ratio, cffn_ratio, i == n - 1)
            for i in range(n))
        self.up = nn.ConvTranspose2d(d, d, 2, 2)
        self.norm1, self.norm2, self.norm3, self.norm4 = (OutBN(d) for _ in range(4))

    def forward(self, img):
        b = img.shape[0]
        c1, c2, c3, c4 = self.spm(img.permute(0, 3, 1, 2))
        d = c1.shape[1]
        c = torch.cat([m.flatten(2).transpose(1, 2) + self.level_embed[i]
                       for i, m in enumerate((c2, c3, c4))], 1)
        x = self.patch_embed(img)
        pos = self.pos_embed[:, 1:].reshape(1, self.grid, self.grid, d)
        if self.vit_shape != (self.grid, self.grid):
            mh = torch.from_numpy(_vit.cubic_matrix(self.grid, self.vit_shape[0])).to(img.device)
            mw = torch.from_numpy(_vit.cubic_matrix(self.grid, self.vit_shape[1])).to(img.device)
            pos = torch.einsum("wW,bHwc->bHWc", mw, torch.einsum("hH,bhwc->bHwc", mh, pos))
        x = x + pos
        h, w = self.vit_shape
        ref_x = centres([self.vit_shape], img.device)
        ref_c = centres(self.c_shapes, img.device)
        xs = []
        for (a, z), it in zip(self.indexes, self.interactions):
            x = it.injector(x.reshape(b, h * w, d), ref_x, c, self.c_shapes).reshape(b, h, w, d)
            for blk in self.blocks[a:z + 1]:
                x = blk(x)
            tokens = x.reshape(b, h * w, d)
            for ex in [it.extractor] + list(it.extra_extractors or []):
                c = ex(c, ref_c, tokens, self.vit_shape, self.c_shapes)
            xs.append(x.permute(0, 3, 1, 2))
        maps, start = [], 0
        for hl, wl in self.c_shapes:
            maps.append(c[:, start:start + hl * wl].transpose(1, 2).reshape(b, d, hl, wl))
            start += hl * wl
        outs = [c1 + self.up(maps[0])] + maps
        outs = [o + (xi if f == 1 else F.interpolate(xi, scale_factor=f, mode="bilinear",
                                                     align_corners=False))
                for o, xi, f in zip(outs, xs, (4, 2, 1, 0.5))]
        return tuple(n(o).permute(0, 2, 3, 1)
                     for n, o in zip((self.norm1, self.norm2, self.norm3, self.norm4), outs))


def build(spec: dict, in_channels: int) -> Tuple[nn.Module, List[int]]:
    """The backbone of ``spec`` on ``in_channels`` image channels, and the
    channels of each map it returns."""
    kw = {k: v for k, v in spec.items() if k in KEYS}
    model = ViTAdapter(in_channels=in_channels, **kw)
    return model, [spec.get("embed_dim", 768)] * 4


def _deform(lq: int, s: int, d: int, levels: int, heads: int, points: int, ratio: float):
    """Products of one deformable attention: the value, offset, weight and
    output projections."""
    v = int(d * ratio)
    return 2.0 * (s * d * v + lq * d * heads * levels * points * 3 + lq * v * d)


def sampling_flops(spec: dict, side: int) -> float:
    """The sampling of one square image of ``side``, which FlopCounterMode
    does not see: for each query, head, level, point and value channel a
    weighted sum of four neighbours (8 FLOP) and its attention weight's
    product and sum (2 FLOP)."""
    d = spec.get("embed_dim", 768)
    dh = int(d * spec.get("deform_ratio", 0.5)) // spec.get("deform_num_heads", 12)
    m, p = spec.get("deform_num_heads", 12), spec.get("n_points", 4)
    n_vit = (side // PATCH) ** 2
    n_c = sum((side // s) ** 2 for s in (8, 16, 32))
    n = len(spec.get("interaction_indexes", ((0, 2), (3, 5), (6, 8), (9, 11))))
    extractors = n + 2
    per = 10.0 * m * p * dh
    return n * n_vit * 3 * per + extractors * n_c * 1 * per


def flops(spec: dict, side: int, in_channels: int) -> float:
    """Products of one square image of ``side`` as FlopCounterMode counts
    them (convolutions, linears, the position resize, the attention
    products), plus ``sampling_flops``."""
    d = spec.get("embed_dim", 768)
    pch = PATCH
    s = side // pch
    g = spec.get("pretrain_size", 224) // pch
    c = spec.get("conv_inplane", 64)
    total = 2.0 * s * s * in_channels * d * pch * pch
    if g != s:
        total += 2.0 * g * d * s * (g + s)
    mlp = 4.0 * spec.get("mlp_ratio", 4) * s * s * d * d
    for ws in _windows(spec.get("window_attn", (False,) * 12),
                       spec.get("window_size", (None,) * 12)):
        if ws > 0:
            total += (-(-s // ws)) ** 2 * _vit._attention(ws * ws, ws, ws, d, False)
        else:
            total += _vit._attention(s * s, s, s, d, False)
        total += mlp
    conv = lambda hw, ci, co, k: 2.0 * hw * ci * co * k * k  # noqa: E731
    s2, s4, s8, s16, s32 = ((side // f) ** 2 for f in (2, 4, 8, 16, 32))
    total += conv(s2, in_channels, c, 3) + 2 * conv(s2, c, c, 3)
    total += conv(s8, c, 2 * c, 3) + conv(s16, 2 * c, 4 * c, 3) + conv(s32, 4 * c, 4 * c, 3)
    total += conv(s4, c, d, 1) + conv(s8, 2 * c, d, 1) + conv(s16, 4 * c, d, 1)
    total += conv(s32, 4 * c, d, 1)
    n_c = s8 + s16 + s32
    m, p = spec.get("deform_num_heads", 12), spec.get("n_points", 4)
    ratio = spec.get("deform_ratio", 0.5)
    hidden = int(d * spec.get("cffn_ratio", 0.25))
    n = len(spec.get("interaction_indexes", ((0, 2), (3, 5), (6, 8), (9, 11))))
    extractors = n + 2
    total += n * _deform(s * s, n_c, d, 3, m, p, ratio)
    total += extractors * (_deform(n_c, s * s, d, 1, m, p, ratio)
                           + 2.0 * n_c * d * hidden * 2 + 2.0 * n_c * hidden * 9)
    total += conv(s8, d, d, 2)  # up: 2×2 transposed conv over c2
    return total + sampling_flops(spec, side)
