"""Swin Transformer backbone, NHWC (port of nuhtc_tpu/models/swin.py).

mmdet SwinTransformer as NuHTC configures it (Swin-T: embed 96, depths
2-2-6-2, heads 3-6-12-24, window 7), with the mmdet state-dict names
(``stages.{i}.blocks.{j}.attn.w_msa.qkv`` ...). PatchMerging keeps mmdet's
unfold channel order.

Dispatch per block (as nuhtc_tpu/models/swin.py:236-282), by the
constructor argument ``kernel`` with the JAX package's tier names. On a CUDA
tensor in eval mode, ``"block"`` runs the block after LN1 through the K1
kernel (``ops.window_block``); ``"attn"`` runs attention and proj through
the K2 kernel (``ops.window_attention``) and leaves the residual, LN2 and
the erf-GELU MLP to PyTorch; ``"none"`` takes the plain path with exact
softmax attention and erf GELU. On the CPU and in training mode every tier
takes the plain path, as the JAX train step trains the blocks in XLA
(nuhtc_tpu/models/swin.py:236-241 takes the Pallas tiers only when
deterministic).

In training mode each block's two residual branches go through stochastic
depth (``drop_path``, nuhtc_tpu/models/layers.py), at rates rising linearly
over the blocks to ``drop_path_rate``, with draws from the generator the
caller passes to ``forward``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nuhtc_tpu_torch.models.layers import MLP
from nuhtc_tpu_torch.ops.window_block import (
    BlockParams, shift_attn_mask, source_key, window_attention, window_block, window_partition,
    window_reverse,
)

KERNEL_TIERS = ("block", "attn", "none")


def keep_mask(generator: torch.Generator, shape, keep: float, device) -> torch.Tensor:
    """Bernoulli(keep) draws of stochastic depth, from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < keep


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth on the batch axis: each sample's branch is kept with
    probability 1 - rate and then scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("drop_path: training draws need an explicit torch.Generator")
    keep = 1.0 - rate
    mask = keep_mask(generator, (x.shape[0],) + (1,) * (x.dim() - 1), keep, x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def rel_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws-1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


class WindowMSA(nn.Module):
    """Window multi-head self-attention with a relative-position bias."""

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

    @property
    def scale(self) -> float:
        return self.qk_scale or (self.qkv.in_features // self.num_heads) ** -0.5

    def bias49(self) -> torch.Tensor:
        """(nh, ws², ws²) relative-position bias."""
        n = self.window_size ** 2
        b = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        return b.reshape(n, n, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B·nW, N, C), mask (nW, N, N) additive or None."""
        bw, n, c = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-1, -2) + self.bias49()[None].to(x.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None].to(x.dtype))
            attn = attn.reshape(bw, nh, n, n)
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    """Holds ``w_msa`` under mmdet's name; padding and rolling live in SwinBlock."""

    def __init__(self, dim, num_heads, window_size, qkv_bias=True, qk_scale=None):
        super().__init__()
        self.w_msa = WindowMSA(dim, num_heads, window_size, qkv_bias, qk_scale)


def _pad_roll(x: torch.Tensor, ws: int, shift: int) -> torch.Tensor:
    h, w = x.shape[1:3]
    x = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
    return torch.roll(x, (-shift, -shift), dims=(1, 2)) if shift else x


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, qk_scale: float | None = None,
                 kernel: str = "block", drop_path_rate: float = 0.0):
        super().__init__()
        if kernel not in KERNEL_TIERS:
            raise ValueError(f"SwinBlock: kernel must be one of {KERNEL_TIERS}, not {kernel!r}")
        self.kernel = kernel
        self.drop_path_rate = drop_path_rate
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, num_heads, window_size, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = MLP(dim, int(dim * mlp_ratio))
        self._params: BlockParams | None = None

    def kernel_params(self) -> BlockParams:
        """The block's parameters as K1 and K2 read them (``BlockParams``),
        made at first use and made anew when a parameter was written in
        place, replaced or moved since (``source_key``)."""
        msa = self.attn.w_msa
        src = dict(wqkv=msa.qkv.weight, bqkv=msa.qkv.bias, wproj=msa.proj.weight,
                   bproj=msa.proj.bias, bias49=msa.relative_position_bias_table,
                   g2=self.norm2.weight, b2=self.norm2.bias,
                   wfc1=self.ffn.fc1.weight, bfc1=self.ffn.fc1.bias,
                   wfc2=self.ffn.fc2.weight, bfc2=self.ffn.fc2.bias)
        if src["bqkv"] is None:
            del src["bqkv"]
        key = source_key(src.values())
        if self._params is None or self._params.key != key:
            with torch.no_grad():
                src["bias49"] = msa.bias49()
                src.setdefault("bqkv", msa.qkv.weight.new_zeros(msa.qkv.out_features))
                self._params = BlockParams(key=key, **src)
        return self._params

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, H, W, C) → (B, H, W, C); ``generator`` draws the stochastic
        depth in training mode."""
        _, h, w, c = x.shape
        ws, s = self.window_size, self.shift
        h1p = _pad_roll(self.norm1(x), ws, s)
        hp, wp = h1p.shape[1:3]
        msa = self.attn.w_msa
        on_kernel = x.is_cuda and not self.training and self.kernel != "none"
        if on_kernel and self.kernel == "block":
            out = window_block(_pad_roll(x, ws, s), h1p, *self.kernel_params().block(),
                               ws=ws, num_heads=msa.num_heads, shift=s, qk_scale=msa.qk_scale)
            if s:
                out = torch.roll(out, (s, s), dims=(1, 2))
            return out[:, :h, :w]
        if on_kernel:
            y = window_attention(h1p, *self.kernel_params().attention(), ws=ws,
                                 num_heads=msa.num_heads, shift=s, qk_scale=msa.qk_scale)
        else:
            mask = None
            if s:
                mask = torch.from_numpy(shift_attn_mask(hp, wp, ws, s)).to(x.device)
            y = window_reverse(msa(window_partition(h1p, ws), mask), ws, hp, wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        rate = self.drop_path_rate if self.training else 0.0
        x = x + drop_path(y[:, :h, :w], rate, generator)
        return x + drop_path(self.ffn(self.norm2(x)), rate, generator)


class PatchMerging(nn.Module):
    """2× downsample with mmdet's unfold channel order (c·4 + kh·2 + kw)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h, w = x.shape[1:3]
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinStage(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, qkv_bias, qk_scale,
                 downsample: bool, kernel: str = "block", drop_path_rates=None):
        super().__init__()
        rates = drop_path_rates if drop_path_rates is not None else [0.0] * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, shift=(i % 2 == 1), mlp_ratio=mlp_ratio,
                      qkv_bias=qkv_bias, qk_scale=qk_scale, kernel=kernel,
                      drop_path_rate=float(rates[i]))
            for i in range(depth))
        self.downsample = PatchMerging(dim, 2 * dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch_size: int, norm: bool):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(dim, eps=1e-5) if norm else None

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.projection(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class SwinTransformer(nn.Module):
    """Returns the per-level NHWC features listed in ``out_indices``."""

    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, qk_scale: float | None = None,
                 patch_norm: bool = True, out_indices: Sequence[int] = (0, 1, 2, 3),
                 patch_size: int = 4, in_channels: int = 3, kernel: str = "block",
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size, patch_norm)
        self.stages = nn.ModuleList()
        dim = embed_dims
        dprs = np.linspace(0, drop_path_rate, sum(depths))
        for i, depth in enumerate(depths):
            first = sum(depths[:i])
            self.stages.append(SwinStage(dim, depth, num_heads[i], window_size, mlp_ratio,
                                         qkv_bias, qk_scale, downsample=i < len(depths) - 1,
                                         kernel=kernel, drop_path_rates=dprs[first:first + depth]))
            if i in self.out_indices:
                self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=1e-5))
            dim *= 2

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None):
        """img (B, H, W, 3) normalized → tuple of NHWC feature maps;
        ``generator`` draws the stochastic depth in training mode."""
        x = self.patch_embed(img)
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x, generator)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)
