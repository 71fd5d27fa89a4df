"""Backbone part ``SwinTransformer``: the Swin-T blocks on the port's plain
path (exact softmax, erf GELU; ``nuhtc_tpu_torch/models/swin.py``), frozen
as they stood when the benchmark was defined, and its work count.

The spec is the configuration's ``backbone`` (or ``backbone_cfg``) dict;
keys outside ``KEYS`` (``type``, ``drop_path_rate``, ``frozen_stages``, ...)
change nothing at inference and are dropped."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import MLP
from portbench.work.roofline import swin_stages

KEYS = ("embed_dims", "depths", "num_heads", "window_size", "mlp_ratio", "qkv_bias",
        "qk_scale", "patch_norm", "out_indices", "patch_size")


def shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wss] = cnt
            cnt += 1
    m = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(m[:, :, None] != m[:, None, :], -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = wins.shape[0] // (h // ws * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def rel_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


class WindowMSA(nn.Module):
    INIT = {"relative_position_bias_table": 0.02}

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 qk_scale: float | None = None):
        super().__init__()
        self.num_heads, self.window_size, self.qk_scale = num_heads, window_size, qk_scale
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(rel_position_index(window_size)), persistent=False)

    def forward(self, x, mask=None):
        bw, n, c = x.shape
        nh = self.num_heads
        scale = self.qk_scale or (c // nh) ** -0.5
        q, k, v = self.qkv(x).reshape(bw, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        bias = bias.reshape(n, n, nh).permute(2, 0, 1)
        attn = (q * scale) @ k.transpose(-1, -2) + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None]).reshape(bw, nh, n, n)
        return self.proj((attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, n, c))


class ShiftWindowMSA(nn.Module):
    def __init__(self, dim, num_heads, window_size, qkv_bias=True, qk_scale=None):
        super().__init__()
        self.w_msa = WindowMSA(dim, num_heads, window_size, qkv_bias, qk_scale)


def _pad_roll(x, ws: int, shift: int):
    h, w = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
    return torch.roll(x, (-shift, -shift), dims=(1, 2)) if shift else x


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift: bool, mlp_ratio=4.0, qkv_bias=True,
                 qk_scale=None):
        super().__init__()
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = MLP(dim, int(dim * mlp_ratio))

    def forward(self, x):
        _, h, w, _ = x.shape
        ws, s = self.window_size, self.shift
        h1p = _pad_roll(self.norm1(x), ws, s)
        hp, wp = h1p.shape[1:3]
        mask = torch.from_numpy(shift_attn_mask(hp, wp, ws, s)).to(x.device) if s else None
        y = window_reverse(self.attn.w_msa(window_partition(h1p, ws), mask), ws, hp, wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y[:, :h, :w]
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h, w = x.shape[1:3]
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinStage(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, qkv_bias, qk_scale,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, shift=(i % 2 == 1), mlp_ratio=mlp_ratio,
                      qkv_bias=qkv_bias, qk_scale=qk_scale) for i in range(depth))
        self.downsample = PatchMerging(dim, 2 * dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch_size: int, norm: bool):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(dim, eps=1e-5) if norm else None

    def forward(self, img):
        x = self.projection(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class SwinTransformer(nn.Module):
    def __init__(self, embed_dims=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, mlp_ratio=4.0, qkv_bias=True, qk_scale=None, patch_norm=True,
                 out_indices=(0, 1, 2, 3), patch_size=4, in_channels=3):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size, patch_norm)
        self.stages = nn.ModuleList()
        dim = embed_dims
        for i, depth in enumerate(depths):
            self.stages.append(SwinStage(dim, depth, num_heads[i], window_size, mlp_ratio,
                                         qkv_bias, qk_scale, downsample=i < len(depths) - 1))
            if i in self.out_indices:
                self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=1e-5))
            dim *= 2

    def forward(self, img):
        x = self.patch_embed(img)
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)


def build(spec: dict, in_channels: int) -> Tuple[nn.Module, List[int]]:
    """The backbone of ``spec`` on ``in_channels`` image channels, and the
    channels of each map it returns."""
    kw = {k: v for k, v in spec.items() if k in KEYS}
    model = SwinTransformer(in_channels=in_channels, **kw)
    dim = model.patch_embed.projection.out_channels
    return model, [dim * 2 ** i for i in model.out_indices]


def flops(spec: dict, side: int, in_channels: int) -> float:
    """Products of one square image of ``side``: the patch embedding, each
    block's qkv and proj on the padded map, its attention (two products a
    window) and its MLP on the map, and the patch mergings."""
    patch = spec.get("patch_size", 4)
    total = 2.0 * (side // patch) ** 2 * in_channels * spec.get("embed_dims", 96) * patch * patch
    ws2 = spec.get("window_size", 7) ** 2
    mlp = spec.get("mlp_ratio", 4)
    stages = swin_stages(spec, side)
    for i, (s, p, c, depth) in enumerate(stages):
        mp, m = p * p, s * s
        total += depth * (8.0 * mp * c * c + 4.0 * mp * ws2 * c + 4.0 * mlp * m * c * c)
        if i < len(stages) - 1:
            h2 = (s + 1) // 2
            total += 2.0 * h2 * h2 * 4 * c * 2 * c
    return total
