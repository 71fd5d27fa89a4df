"""The alternative backbones, NHWC (port of nuhtc_tpu/models/backbones.py).

``ViT`` is the ViTDet plain ViT (reference visiontransformer.py): a stride-16
patch embedding, absolute position embeddings resized from the pretrain
grid (the cls token dropped), windowed attention (no shift) on the blocks in
``window_block_indexes`` and global attention on the rest, an optional
decomposed relative position bias, features after every ``out_every``-th
block. Its keys are the reference's: ``patch_embed.proj``, ``pos_embed``,
``blocks.{i}.{norm1,attn.{qkv,proj,rel_pos_h,rel_pos_w},norm2,mlp.{fc1,fc2}}``.
The MLP is plain PyTorch (the JAX package runs it in XLA; no TPU kernel
computes it). The attention of a CUDA input with head dim 64 runs the hand
kernel ``ops/vit_attention.py`` (q·kᵀ, the bias from the tables, an f32
online softmax and p·v, no score or bias tensor in device memory), which
raises on a dtype other than bf16 or a grid over 64 a side. A forward that
autograd records (the kernel has no backward), a CPU input or another head
dim runs plain PyTorch products with the softmax in f32. Each block's attention
runs inside a span, ``model.vit_window_attn`` or ``model.vit_global_attn``,
counts its call in ``vit.attn_fused`` or ``vit.attn_plain``, and counts the
bytes of the (b, heads, n, n) score tensors it writes, at the dtype it
writes them (0 on the kernel's path), in ``vit.window_score_bytes`` or
``vit.global_score_bytes`` (``utils/profiling.py``). The relative-position
indices and the position table's resize matrix (one for both axes of the
square grid) are non-persistent buffers, built with the module for its
``img_size``: they follow ``.to()`` and stay out of the state dict, and a
forward copies no constant to the device.

The absolute-position resize is the JAX package's, not torch's bicubic:
``jax.image.resize(..., "cubic")`` is Keys' cubic with a = -0.5, drops the
taps that fall outside the grid and renormalises each output's weights, and
widens the kernel by the scale factor when it shrinks (antialiasing).
``cubic_resize_matrix`` builds one such weight matrix per axis, as
``jax.image.scale_and_translate`` builds it, and the resize is two products.

``SwinUnet`` (the JAX package's U-shaped Swin; the reference's
swin_unet.py is dead code) is built on the port's ``SwinBlock`` and
``PatchMerging``: on a CUDA tensor in eval mode each of its blocks runs
through the Swin kernel of its ``kernel`` tier, as ``SwinTransformer``'s do.
Keys follow the JAX module names: ``enc{s}_block{b}`` → ``enc.{s}.blocks.{b}``
(the Swin block's mmdet sub-names), ``down{s}`` → ``enc.{s}.downsample``,
``up{s}_expand`` → ``dec.{s}.expand``, ``dec{s}_block`` → ``dec.{s}.block``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nuhtc_tpu_torch.models.swin import PatchEmbed, SwinBlock, SwinStage
from nuhtc_tpu_torch.ops.vit_attention import HEAD_DIMS as VIT_HEAD_DIMS
from nuhtc_tpu_torch.ops.vit_attention import vit_attention
from nuhtc_tpu_torch.registry import BACKBONES
from nuhtc_tpu_torch.utils.profiling import count, span


def vit_window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) → ((B·nW, ws, ws, C), (Hp, Wp)), zero-padded at the
    bottom and right (reference window_partition; no shift)."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
    hp, wp = x.shape[1:3]
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def vit_window_unpartition(wins: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // ws // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def rel_pos_index(size: int) -> torch.Tensor:
    """(size, size) int64 indices of the pairwise relative coordinates into
    a (2·size-1)-row table (reference get_rel_pos, q_size == k_size): a
    table indexed by them is (q, k, head_dim)."""
    coords = torch.arange(size)
    return coords[:, None] - coords[None, :] + (size - 1)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, a = -0.5, on |x| (jax.image's ``_fill_keys_cubic_kernel``)."""
    one = np.float32(1.0)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    out = np.where(x >= one, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= np.float32(2.0), np.float32(0.0), out).astype(np.float32)


def cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of ``jax.image.resize(method="cubic")``
    along one axis (antialiased, translation 0): sample i sits at (i + 0.5) /
    scale - 0.5; the kernel is widened by 1 / scale when shrinking; each
    output's weights are divided by their sum (an output whose sum is near 0
    gets none), and an output whose sample lies outside [-0.5, in - 0.5] gets
    none."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    inv = np.float32(1.0 / (out_size / in_size))  # in f64, then rounded, as jax.image
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= np.float32(in_size) - np.float32(0.5))
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ViTAttention(nn.Module):
    """Packed qkv attention with the optional decomposed relative position
    bias of ``input_size`` (reference visiontransformer.py Attention)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 use_rel_pos: bool = False, input_size: Tuple[int, int] | None = None,
                 counter: str = "vit.global_score_bytes"):
        super().__init__()
        self.num_heads = num_heads
        self.counter = counter
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            hd = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))
            self.register_buffer("rel_index_h", rel_pos_index(input_size[0]), persistent=False)
            self.register_buffer("rel_index_w", rel_pos_index(input_size[1]), persistent=False)

    def _check_tables(self, h: int, w: int) -> None:
        if self.rel_pos_h.shape[0] != 2 * h - 1 or self.rel_pos_w.shape[0] != 2 * w - 1:
            raise ValueError(f"ViTAttention: relative position tables "
                             f"{tuple(self.rel_pos_h.shape)}, {tuple(self.rel_pos_w.shape)} "
                             f"do not fit a {h}×{w} grid")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) → (B, H, W, C). A CUDA input of a head dim the
        kernel takes runs ``ops/vit_attention.py`` (no score or bias tensor
        written), which raises on what else the kernel does not take (a dtype
        other than bf16, a grid over 64 a side). The kernel has no backward,
        so a forward that autograd records takes the plain path, as does a
        CPU input or another head dim."""
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x.reshape(b, h * w, c))
        tables = (self.rel_pos_h, self.rel_pos_w) if self.use_rel_pos else ()
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (qkv, *tables))
        if qkv.is_cuda and hd in VIT_HEAD_DIMS and not grad:
            if self.use_rel_pos:
                self._check_tables(h, w)
            rel = tuple(t.to(qkv).contiguous() for t in tables) or (None, None)
            out = vit_attention(qkv, b, h, w, nh, *rel, hd ** -0.5)
            count("vit.attn_fused")
            count(self.counter, 0)  # no (b, nh, n, n) tensor written
            return self.proj(out).reshape(b, h, w, c)
        count("vit.attn_plain")
        q, k, v = qkv.reshape(b, h * w, 3, nh, hd).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q * hd ** -0.5, k)
        written = _nbytes(attn)  # of the (b, nh, n, n) tensors
        if self.use_rel_pos:
            self._check_tables(h, w)
            rq = q.reshape(b, h, w, nh, hd)
            bias_h = torch.einsum("bhwnd,hkd->bnhwk", rq, self.rel_pos_h[self.rel_index_h].to(q))
            bias_w = torch.einsum("bhwnd,wkd->bnhwk", rq, self.rel_pos_w[self.rel_index_w].to(q))
            attn = attn.reshape(b, nh, h, w, h, w) + bias_h[..., :, None]
            written += _nbytes(attn)
            attn = attn + bias_w[..., None, :]
            written += _nbytes(attn)
            attn = attn.reshape(b, nh, h * w, h * w)
        if attn.dtype != torch.float32:
            attn = attn.float()
            written += _nbytes(attn)
        attn = attn.softmax(dim=-1)
        written += _nbytes(attn)
        if v.dtype != attn.dtype:
            attn = attn.to(v.dtype)
            written += _nbytes(attn)
        count(self.counter, written)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, h * w, c)
        return self.proj(out).reshape(b, h, w, c)


class ViTMlp(nn.Module):
    """fc1, erf GELU, fc2 (the reference's timm Mlp names)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-LN attention (global, or in unshifted windows of ``window_size``)
    and pre-LN MLP, each with its residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 use_rel_pos: bool = False, window_size: int = 0,
                 input_size: Tuple[int, int] | None = None):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        kind = "window" if window_size > 0 else "global"
        self.span = f"model.vit_{kind}_attn"
        attn_size = (window_size, window_size) if window_size > 0 else input_size
        self.attn = ViTAttention(dim, num_heads, qkv_bias, use_rel_pos, attn_size,
                                 counter=f"vit.{kind}_score_bytes")
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = ViTMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = self.norm1(x)
        with span(self.span):
            if self.window_size > 0:
                wins, pad_hw = vit_window_partition(y, self.window_size)
                y = vit_window_unpartition(self.attn(wins), self.window_size, pad_hw, (h, w))
            else:
                y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class ViTPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.proj(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@BACKBONES.register()
class ViT(nn.Module):
    """The ViTDet plain ViT; returns the features after every
    ``out_every``-th block (``out_channels``: the channels of each). The
    global blocks' relative position tables and the position table's resize
    matrix (f32 until the module is cast) are made for ``img_size //
    patch_size`` tokens a side (the JAX module sizes them from its first
    input), and an input of another size raises. It has no stochastic
    depth: ``drop_path_rate`` is accepted and unused, and training a ViT
    detector is out of scope (a train step would run it without drop path)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, in_channels: int = 3,
                 embed_dims: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, use_abs_pos: bool = True,
                 use_rel_pos: bool = False, window_size: int = 0,
                 window_block_indexes: Sequence[int] = (0, 1, 3, 4, 6, 7, 9, 10),
                 pretrain_img_size: int = 224, pretrain_use_cls_token: bool = True,
                 out_every: int = 3, drop_path_rate: float = 0.0, init_cfg=None):
        super().__init__()
        self.out_every = out_every
        self.out_channels = [embed_dims] * (depth // out_every)
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.grid = pretrain_img_size // patch_size
        self.patch_embed = ViTPatchEmbed(in_channels, embed_dims, patch_size)
        self.pos_embed = None
        tokens = img_size // patch_size
        self.tokens = tokens
        if use_abs_pos:
            n_pos = self.grid ** 2 + (1 if pretrain_use_cls_token else 0)
            self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, embed_dims))
            resize = torch.from_numpy(cubic_resize_matrix(self.grid, tokens))
            self.register_buffer("pos_resize", resize, persistent=False)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dims, num_heads, mlp_ratio, qkv_bias, use_rel_pos,
                     window_size if i in window_block_indexes else 0, (tokens, tokens))
            for i in range(depth))

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None):
        """img (B, H, W, 3) normalized → tuple of (B, H/16, W/16, C) maps;
        ``generator`` is the detectors' stochastic-depth argument, unused."""
        x = self.patch_embed(img)
        if self.pos_embed is not None:
            pos = self.pos_embed[:, 1:] if self.pretrain_use_cls_token else self.pos_embed
            if x.shape[1:3] != (self.tokens, self.tokens):
                raise ValueError(f"ViT: a {tuple(x.shape[1:3])} token grid, where the "
                                 f"position table is resized to {self.tokens}²")
            pos = pos.reshape(1, self.grid, self.grid, -1).float()
            m = self.pos_resize.float()
            x = x + torch.einsum("bhwc,hH,wW->bHWc", pos, m, m).to(x.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if (i + 1) % self.out_every == 0:
                outs.append(x)
        return tuple(outs)


class SwinUnetUp(nn.Module):
    """One decoder stage: repeat ×2 on both axes, ``expand`` to half the
    channels, crop to the skip, add it, one unshifted Swin block."""

    def __init__(self, dim: int, num_heads: int, window_size: int, kernel: str):
        super().__init__()
        self.expand = nn.Linear(dim, dim // 2)
        self.block = SwinBlock(dim // 2, num_heads, window_size, shift=False, kernel=kernel)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        th, tw = skip.shape[1:3]
        return self.block(self.expand(x)[:, :th, :tw] + skip, generator)


@BACKBONES.register()
class SwinUnet(nn.Module):
    """Swin stages down, then expand + skip-sum stages back up; returns the
    decoder's features at the four scales (finest first, the deepest
    encoder output last; ``out_channels``: the channels of each). ``kernel``
    picks the Swin kernel tier of every block (``SwinBlock``)."""

    def __init__(self, embed_dims: int = 96, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 in_channels: int = 3, kernel: str = "block"):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, embed_dims, 4, norm=True)
        n = len(depths)
        self.out_channels = [embed_dims * 2 ** s for s in range(n)]
        self.enc = nn.ModuleList(
            SwinStage(embed_dims * 2 ** s, depth, num_heads[s], window_size, 4.0, True, None,
                      downsample=s < n - 1, kernel=kernel)
            for s, depth in enumerate(depths))
        self.dec = nn.ModuleList(
            SwinUnetUp(embed_dims * 2 ** (s + 1), num_heads[s], window_size, kernel)
            for s in range(n - 1))

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None):
        """``generator`` draws the blocks' stochastic depth in training mode."""
        x = self.patch_embed(img)
        skips = []
        for stage in self.enc:
            for blk in stage.blocks:
                x = blk(x, generator)
            skips.append(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        outs = [x]
        for s in range(len(self.dec) - 1, -1, -1):
            x = self.dec[s](x, skips[s], generator)
            outs.insert(0, x)
        return tuple(outs)
