"""Backbone part ``ViT``: ViTDet's plain ViT (Li et al., arXiv:2203.16527;
detectron2's ``modeling/backbone/vit.py`` as ``mask_rcnn_vitdet_b_100ep.py``
configures it) in plain f32 PyTorch, and its work count.

For an NHWC image and ``p = patch_size``, ``C = embed_dims``:

- patch embedding: a p × p convolution of stride p with a bias;
- absolute positions: the pretrain table (1, [1 +] g², C), its class token
  dropped, as a g × g grid resized to the token grid and added. The resize
  is Keys' cubic with a = -0.5 over the grid's own samples, each output's
  weights renormalised, the kernel widened by the scale when it shrinks
  (``jax.image.resize(..., "cubic")``'s weights, the port's), written out
  here in ``cubic_matrix``. Departure: detectron2 resizes by
  ``F.interpolate(mode="bicubic", align_corners=False)`` (a = -0.75, edge
  samples clamped);
- blocks, pre-LN (eps 1e-6): ``x + attn(LN1(x))``, then ``x + fc2(GELU(fc1(
  LN2(x))))`` with the erf GELU. A windowed block zero-pads LN1's output at
  the bottom and right to a multiple of the window, attends in each window
  and crops; a global block attends over all tokens;
- attention: ``q, k, v`` from one linear with a bias; ``attn = (q / √d) kᵀ +
  q·Rhᵀ[h_q, h_k] + q·Rwᵀ[w_q, w_k]`` with ``Rh[i, j] = rel_pos_h[i - j + s
  - 1]`` (the decomposed relative-position bias, tables of 2s - 1 rows for
  a side s: the window's, or the token grid's in a global block); the
  softmax in f32; ``attn v``, then the projection;
- outputs: the maps after every ``out_every``-th block (the port's; detectron2
  returns the last alone, the one ``ViT_FPN`` reads).

``INIT`` gives ``pos_embed``, ``rel_pos_h`` and ``rel_pos_w`` a normal of
std 0.02: detectron2 initialises them by ``trunc_normal_(std=0.02)``; the
truncation at ±2 std is left out. Drop path runs only in training, so
``drop_path_rate`` is dropped with the other keys outside ``KEYS``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

KEYS = ("img_size", "patch_size", "embed_dims", "depth", "num_heads", "mlp_ratio", "qkv_bias",
        "use_abs_pos", "use_rel_pos", "window_size", "window_block_indexes",
        "pretrain_img_size", "pretrain_use_cls_token", "out_every")


def keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 at distances ``x`` ≥ 0, in f32."""
    x = x.astype(np.float32)
    near = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0)
    out = np.where(x < 1.0, near, np.where(x < 2.0, far, np.float32(0.0)))
    return out.astype(np.float32)


def cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of the resize along one axis: output j
    samples the input at (j + 0.5)·n_in/n_out - 0.5; the kernel is widened by
    n_in/n_out when that exceeds 1; each output's weights are divided by
    their sum (none where the sum is near 0), and an output whose sample
    lies outside [-0.5, n_in - 0.5] gets none."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    step = np.float32(n_in / n_out)
    width = max(step, np.float32(1.0))
    at = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * step - np.float32(0.5)
    dist = np.abs(at[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / width
    w = keys_cubic(dist)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (at >= -0.5) & (at <= np.float32(n_in) - np.float32(0.5))
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def rel_index(size: int) -> torch.Tensor:
    """(size, size) rows of a (2·size - 1)-row table: i - j + size - 1."""
    pos = torch.arange(size)
    return pos[:, None] - pos[None, :] + (size - 1)


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) zero-padded at the bottom and right to multiples of
    ``ws`` → ((B·nW, ws, ws, C), (Hp, Wp))."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws))
    hp, wp = x.shape[1:3]
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    b = wins.shape[0] // (hp // ws * (wp // ws))
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :hw[0], :hw[1]]


class Attention(nn.Module):
    INIT = {"rel_pos_h": 0.02, "rel_pos_w": 0.02}

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, use_rel_pos: bool,
                 side: int):
        super().__init__()
        self.num_heads, self.use_rel_pos = num_heads, use_rel_pos
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, dim // num_heads))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, dim // num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, hd).unbind(0)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        if self.use_rel_pos:
            if self.rel_pos_h.shape[0] != 2 * h - 1 or self.rel_pos_w.shape[0] != 2 * w - 1:
                raise ValueError(f"reference ViT: relative-position tables of "
                                 f"{self.rel_pos_h.shape[0]} rows do not fit a {h}×{w} grid")
            rh = self.rel_pos_h[rel_index(h).to(x.device)]
            rw = self.rel_pos_w[rel_index(w).to(x.device)]
            r_q = q.reshape(b * nh, h, w, hd)
            bias_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
            bias_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
            attn = (attn.reshape(b * nh, h, w, h, w) + bias_h[:, :, :, :, None]
                    + bias_w[:, :, :, None, :]).reshape(b * nh, h * w, h * w)
        attn = attn.float().softmax(dim=-1)
        out = (attn @ v).reshape(b, nh, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 use_rel_pos: bool, window_size: int, tokens: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, use_rel_pos,
                              window_size if window_size > 0 else tokens)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        h, w = x.shape[1:3]
        y = self.norm1(x)
        if self.window_size > 0:
            wins, pad_hw = window_partition(y, self.window_size)
            y = window_unpartition(self.attn(wins), self.window_size, pad_hw, (h, w))
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)

    def forward(self, img):
        return self.proj(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ViT(nn.Module):
    INIT = {"pos_embed": 0.02}

    def __init__(self, img_size=1024, patch_size=16, in_channels=3, embed_dims=768, depth=12,
                 num_heads=12, mlp_ratio=4.0, qkv_bias=True, use_abs_pos=True,
                 use_rel_pos=False, window_size=0,
                 window_block_indexes: Sequence[int] = (0, 1, 3, 4, 6, 7, 9, 10),
                 pretrain_img_size=224, pretrain_use_cls_token=True, out_every=3):
        super().__init__()
        self.out_every, self.cls_token = out_every, pretrain_use_cls_token
        self.grid = pretrain_img_size // patch_size
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size)
        self.pos_embed = None
        if use_abs_pos:
            self.pos_embed = nn.Parameter(torch.zeros(
                1, self.grid ** 2 + (1 if pretrain_use_cls_token else 0), embed_dims))
        tokens = img_size // patch_size
        self.blocks = nn.ModuleList(
            Block(embed_dims, num_heads, mlp_ratio, qkv_bias, use_rel_pos,
                  window_size if i in window_block_indexes else 0, tokens)
            for i in range(depth))

    def abs_pos(self, hw: Tuple[int, int]) -> torch.Tensor:
        """The table as a (1, H, W, C) grid of the tokens' side."""
        pos = self.pos_embed[:, 1:] if self.cls_token else self.pos_embed
        pos = pos.reshape(1, self.grid, self.grid, -1).float()
        if (self.grid, self.grid) == tuple(hw):
            return pos
        dev = pos.device
        mh = torch.from_numpy(cubic_matrix(self.grid, hw[0])).to(dev)
        mw = torch.from_numpy(cubic_matrix(self.grid, hw[1])).to(dev)
        pos = torch.einsum("hH,bhwc->bHwc", mh, pos)
        return torch.einsum("wW,bHwc->bHWc", mw, pos)

    def forward(self, img):
        x = self.patch_embed(img)
        if self.pos_embed is not None:
            x = x + self.abs_pos(tuple(x.shape[1:3]))
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if (i + 1) % self.out_every == 0:
                outs.append(x)
        return tuple(outs)


def build(spec: dict, in_channels: int) -> Tuple[nn.Module, List[int]]:
    """The backbone of ``spec`` on ``in_channels`` image channels, and the
    channels of each map it returns."""
    kw = {k: v for k, v in spec.items() if k in KEYS}
    model = ViT(in_channels=in_channels, **kw)
    dim = model.patch_embed.proj.out_channels
    return model, [dim] * (len(model.blocks) // model.out_every)


def _attention(n: int, hh: int, ww: int, c: int, rel: bool) -> float:
    """One attention over an hh × ww grid of n = hh·ww tokens: qkv and proj,
    q kᵀ and attn v, and the two bias products."""
    return 8.0 * n * c * c + 4.0 * n * n * c + (2.0 * n * c * (hh + ww) if rel else 0.0)


def flops(spec: dict, side: int, in_channels: int) -> float:
    """Products of one square image of ``side``: the patch embedding, the
    position table's two resize products, each block's attention (a
    windowed block's on its padded windows) and its MLP on the tokens."""
    p = spec.get("patch_size", 16)
    c = spec.get("embed_dims", 768)
    s = side // p
    g = spec.get("pretrain_img_size", 224) // p
    rel = spec.get("use_rel_pos", False)
    ws = spec.get("window_size", 0)
    windowed = set(spec.get("window_block_indexes", (0, 1, 3, 4, 6, 7, 9, 10)))
    total = 2.0 * s * s * in_channels * c * p * p
    if spec.get("use_abs_pos", True) and g != s:
        total += 2.0 * g * c * s * (g + s)
    mlp = 4.0 * spec.get("mlp_ratio", 4) * s * s * c * c
    for i in range(spec.get("depth", 12)):
        if ws > 0 and i in windowed:
            n_win = (-(-s // ws)) ** 2
            total += n_win * _attention(ws * ws, ws, ws, c, rel)
        else:
            total += _attention(s * s, s, s, c, rel)
        total += mlp
    return total
