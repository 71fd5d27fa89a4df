"""ViT-Adapter (Chen et al., "Vision Transformer Adapter for Dense
Predictions", arXiv:2205.08534), NHWC in and out, for inference.

A plain ViT (the port's ``ViTBlock``, ``ViTPatchEmbed`` and position resize
of ``models/backbones.py``) runs beside a convolutional prior of three
token levels, and the two streams trade features by multi-scale deformable
attention (``MSDeformAttn``, core ``ops/ms_deform_attn.py``). With D the
embed width, an H × W image and the ViT's h × w = H/16 × W/16 grid:

- the spatial prior module (``spm``): a stem of three 3×3 convs (the first
  of stride 2), each with a frozen batch-norm and a ReLU, and a 3×3
  max-pool of stride 2 (``c1`` at 1/4), then ``conv2``, ``conv3``,
  ``conv4``, each a 3×3 conv of stride 2, a batch-norm and a ReLU (1/8,
  1/16, 1/32); the convs have no bias; ``fc1`` … ``fc4`` are 1×1 convs to
  D. ``c2``, ``c3``, ``c4`` get ``level_embed[0..2]`` added and are
  flattened and concatenated into the token stream ``c``;
- ``MSDeformAttn(query, ref, feat, shapes)``: ``value_proj`` D → D·ratio in
  M heads, ``sampling_offsets`` → M·L·P·(x, y), ``attention_weights`` →
  M·L·P with a softmax over L·P in f32; ``loc = ref + offset / (W_l,
  H_l)``; the core samples and sums; ``output_proj`` back to D;
- the injector (L = 3): ``x ← x + γ ⊙ MSDeformAttn(LN_q(x), the h × w
  grid's centres, LN_f(c), the 1/8, 1/16, 1/32 shapes)``;
- the extractor (L = 1): ``c ← c + MSDeformAttn(LN_q(c), the three levels'
  centres, LN_f(x), (h, w))``, then ``c ← c + fc2(GELU(DWConv(fc1(LN(c)))))``
  with the depthwise 3×3 run on each level's map;
- an interaction per ``interaction_indexes`` pair [a, b]: the injector,
  ViT blocks a … b, the extractor, and in the last one two more extractors;
- the output: ``c1 ← up(c2) + c1`` (a 2×2 transposed conv of stride 2),
  the ViT's map after interaction i added to level i bilinearly (×4, ×2,
  ×1, ×0.5, ``align_corners=False``), a frozen batch-norm on each → four
  D-wide maps at strides 4, 8, 16, 32.

LayerNorms take eps 1e-6, GELU is the erf form. Keys are the published
ones (``spm.stem.{0,1,3,4,6,7}``, ``spm.conv{2,3,4}.{0,1}``,
``spm.fc{1..4}``, ``level_embed``, ``interactions.{i}.injector.{query_norm,
feat_norm,attn.*,gamma}``, ``interactions.{i}.extractor.{…,ffn.{fc1,
dwconv.dwconv,fc2},ffn_norm}``, ``interactions.3.extra_extractors.{0,1}``,
``up``, ``norm{1..4}``) beside the ViT's (``patch_embed.proj``,
``pos_embed``, ``blocks.{i}``).

``FrozenBatchNorm2d`` is an eval-mode batch-norm whose ``weight``, ``bias``,
``running_mean`` and ``running_var`` are all parameters (eps 1e-5): mmcv's
keys, so a checkpoint loads without ``num_batches_tracked``, and one rule of
random weights covers them (``OutputNorm``, the four on the outputs, draws
its weight smaller). Training is out of scope: a batch-norm in training mode
raises.

The prior's levels stay in token order, (b, Nc, D): the depthwise conv and
the output fusion see each level as an NCHW view of its tokens
(channels-last in memory), so no level is copied into NCHW order. The
level shapes, the level starts and the ViT's window pattern are Python
ints, fixed for ``img_size``. The reference points and the offsets'
normaliser are integer buffers (non-persistent, made with the module): a
cast of the module to bf16 leaves them exact, and a forward copies no
constant to the device. Spans (``utils/profiling.py``): ``model.adapter_spm``,
``model.adapter_injector``, ``model.adapter_extractor`` (with the ConvFFN),
``model.deform_attn`` (the core, inside both) and ``model.adapter_out``; the
ViT blocks keep ``model.vit_window_attn`` and ``model.vit_global_attn``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nuhtc_tpu_torch.models.backbones import (ViTPatchEmbed, cubic_resize_matrix,
                                              resized_pos, vit_blocks)
from nuhtc_tpu_torch.ops.ms_deform_attn import level_starts, ms_deform_attn
from nuhtc_tpu_torch.registry import BACKBONES
from nuhtc_tpu_torch.utils.profiling import span

Shapes = Sequence[Tuple[int, int]]


class FrozenBatchNorm2d(nn.Module):
    """``(x − running_mean) / √(running_var + eps) · weight + bias`` over the
    channels of an NCHW map, the affine taken in f32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.running_mean = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.running_var = nn.Parameter(torch.ones(channels), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("FrozenBatchNorm2d: a ViT-Adapter runs for inference only; "
                               "call .eval()")
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class OutputNorm(FrozenBatchNorm2d):
    """The batch-norm on each output level. Random weights draw its
    ``weight`` normal with std ``WEIGHT_STD``, where the published
    initialisation is 1: with running statistics 0 and 1, random weights
    would leave the pyramid at the ViT stream's scale (3 to 5 a channel by
    rms), where a trained model's statistics bring each channel to about 1;
    the random heads then saturate the lifted class's score near 1 and
    bf16's rounding reorders most detections at the per-image cap."""

    WEIGHT_STD = 0.25


def _conv_bn_relu(cin: int, cout: int, stride: int) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride, 1, bias=False), FrozenBatchNorm2d(cout),
            nn.ReLU(inplace=True)]


class SpatialPriorModule(nn.Module):
    def __init__(self, inplanes: int = 64, embed_dim: int = 768, in_channels: int = 3):
        super().__init__()
        self.stem = nn.Sequential(*_conv_bn_relu(in_channels, inplanes, 2),
                                  *_conv_bn_relu(inplanes, inplanes, 1),
                                  *_conv_bn_relu(inplanes, inplanes, 1),
                                  nn.MaxPool2d(kernel_size=3, stride=2, padding=1))
        self.conv2 = nn.Sequential(*_conv_bn_relu(inplanes, 2 * inplanes, 2))
        self.conv3 = nn.Sequential(*_conv_bn_relu(2 * inplanes, 4 * inplanes, 2))
        self.conv4 = nn.Sequential(*_conv_bn_relu(4 * inplanes, 4 * inplanes, 2))
        self.fc1 = nn.Conv2d(inplanes, embed_dim, 1)
        self.fc2 = nn.Conv2d(2 * inplanes, embed_dim, 1)
        self.fc3 = nn.Conv2d(4 * inplanes, embed_dim, 1)
        self.fc4 = nn.Conv2d(4 * inplanes, embed_dim, 1)

    def forward(self, img: torch.Tensor):
        """img (B, 3, H, W) → c1 (B, D, H/4, W/4) and c2, c3, c4 as NCHW
        maps at 1/8, 1/16, 1/32."""
        c1 = self.stem(img)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        return self.fc1(c1), self.fc2(c2), self.fc3(c3), self.fc4(c4)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention over the levels of ``shapes``,
    ``n_heads`` heads and ``n_points`` points, values ``ratio`` ×
    ``d_model`` wide. ``normalizer`` (L, 2) holds each level's (W_l, H_l)."""

    def __init__(self, d_model: int, n_heads: int, n_points: int, ratio: float, shapes: Shapes):
        super().__init__()
        self.shapes = [tuple(s) for s in shapes]
        self.n_levels, self.n_heads, self.n_points = len(self.shapes), n_heads, n_points
        n_levels, value_dim = self.n_levels, int(d_model * ratio)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, value_dim)
        self.output_proj = nn.Linear(value_dim, d_model)
        self.register_buffer("normalizer", torch.tensor([(w, h) for h, w in self.shapes],
                                                        dtype=torch.int32), persistent=False)

    def locations(self, ref: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """ref (Lq, 2) and offsets (b, Lq, M, L, P, 2) in pixels of each
        level, both f32 and (x, y) → (b, Lq, M, L, P, 2) in the unit square."""
        return ref[None, :, None, None, None, :] + offsets / self.normalizer[:, None, :]

    def forward(self, query: torch.Tensor, ref: torch.Tensor, feat: torch.Tensor
                ) -> torch.Tensor:
        """query (b, Lq, D), ref (Lq, 2) f32, feat (b, S, D) over the levels
        of ``shapes`` → (b, Lq, D)."""
        b, lq, _ = query.shape
        m, nl, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(feat)
        value = value.view(b, value.shape[1], m, value.shape[2] // m)
        offsets = self.sampling_offsets(query).view(b, lq, m, nl, p, 2).float()
        weights = self.attention_weights(query).view(b, lq, m, nl * p).float().softmax(-1)
        loc = self.locations(ref, offsets)
        with span("model.deform_attn"):
            out = ms_deform_attn(value, self.shapes, loc, weights.view(b, lq, m, nl, p))
        return self.output_proj(out)


class Injector(nn.Module):
    def __init__(self, dim: int, n_heads: int, n_points: int, ratio: float, shapes: Shapes):
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttn(dim, n_heads, n_points, ratio, shapes)
        self.gamma = nn.Parameter(torch.zeros(dim))  # the published init_values, 0

    def forward(self, x: torch.Tensor, ref: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x (b, n, D) the ViT's tokens, c (b, Nc, D) the prior's."""
        with span("model.adapter_injector"):
            attn = self.attn(self.query_norm(x), ref, self.feat_norm(c))
            return x + self.gamma * attn


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class ConvFFN(nn.Module):
    """fc1, the depthwise 3×3 on each level's map, GELU, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def depthwise(self, x: torch.Tensor, shapes: Shapes) -> torch.Tensor:
        """x (b, Nc, C) over the levels of ``shapes`` → the same, each
        level's tokens convolved as their own map."""
        b, _, c = x.shape
        out = []
        for (h, w), start in zip(shapes, level_starts(shapes)):
            lvl = x[:, start:start + h * w].view(b, h, w, c).permute(0, 3, 1, 2)
            out.append(self.dwconv.dwconv(lvl).permute(0, 2, 3, 1).reshape(b, h * w, c))
        return torch.cat(out, dim=1)

    def forward(self, x: torch.Tensor, shapes: Shapes) -> torch.Tensor:
        return self.fc2(F.gelu(self.depthwise(self.fc1(x), shapes)))


class Extractor(nn.Module):
    def __init__(self, dim: int, n_heads: int, n_points: int, ratio: float,
                 vit_shape: Tuple[int, int], c_shapes: Shapes, cffn_ratio: float):
        super().__init__()
        self.c_shapes = [tuple(s) for s in c_shapes]
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttn(dim, n_heads, n_points, ratio, [vit_shape])
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio))
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, c: torch.Tensor, ref: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """c (b, Nc, D) the prior's tokens, x (b, n, D) the ViT's."""
        with span("model.adapter_extractor"):
            c = c + self.attn(self.query_norm(c), ref, self.feat_norm(x))
            return c + self.ffn(self.ffn_norm(c), self.c_shapes)


class InteractionBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, n_points: int, ratio: float,
                 vit_shape: Tuple[int, int], c_shapes: Shapes, cffn_ratio: float,
                 extra_extractor: bool):
        super().__init__()
        self.injector = Injector(dim, n_heads, n_points, ratio, c_shapes)
        self.extractor = Extractor(dim, n_heads, n_points, ratio, vit_shape, c_shapes, cffn_ratio)
        self.extra_extractors = nn.Sequential(*(
            Extractor(dim, n_heads, n_points, ratio, vit_shape, c_shapes, cffn_ratio)
            for _ in range(2))) if extra_extractor else None

    def forward(self, x: torch.Tensor, c: torch.Tensor, blocks: Sequence[nn.Module],
                refs: Tuple[torch.Tensor, torch.Tensor]):
        """x (b, h, w, D) the ViT's map, c (b, Nc, D); ``refs``: the ViT
        grid's centres and the prior levels' centres."""
        b, h, w, d = x.shape
        x = self.injector(x.reshape(b, h * w, d), refs[0], c).view(b, h, w, d)
        for blk in blocks:
            x = blk(x)
        tokens = x.reshape(b, h * w, d)
        c = self.extractor(c, refs[1], tokens)
        for extractor in self.extra_extractors or ():
            c = extractor(c, refs[1], tokens)
        return x, c


def centres(shapes: Shapes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The centres of the cells of each level's grid, concatenated, as int32
    numerators (2j + 1, 2i + 1) and denominators (2W_l, 2H_l): (x, y) =
    num / den in the unit square."""
    num, den = [], []
    for h, w in shapes:
        i, j = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        num.append(torch.stack((2 * j + 1, 2 * i + 1), -1).reshape(-1, 2))
        den.append(torch.tensor([2 * w, 2 * h]).expand(h * w, 2))
    return torch.cat(num).to(torch.int32), torch.cat(den).to(torch.int32)


@BACKBONES.register()
class ViTAdapter(nn.Module):
    """ViT-Adapter on a plain stride-16 ViT of ``depth`` blocks; block i
    attends in windows of ``window_size[i]`` where ``window_attn[i]`` (the
    published lists; the port's ViTDet windows, zero-padded), else
    globally. ``img_size`` (a side, or (H, W)) fixes the grids: each side a
    multiple of 32, and an input of another size raises. The last
    interaction has the two extra extractors. Returns four
    ``embed_dim``-wide NHWC maps at strides 4, 8, 16, 32 (``out_channels``)."""

    def __init__(self, img_size=1024, in_channels: int = 3, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, window_attn: Sequence[bool] = (False,) * 12,
                 window_size: Sequence[int | None] = (None,) * 12, pretrain_size: int = 224,
                 conv_inplane: int = 64, n_points: int = 4, deform_num_heads: int = 12,
                 interaction_indexes: Sequence[Sequence[int]] = ((0, 2), (3, 5), (6, 8), (9, 11)),
                 cffn_ratio: float = 0.25, deform_ratio: float = 0.5):
        super().__init__()
        H, W = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        if H % 32 or W % 32:
            raise ValueError(f"ViTAdapter: img_size {img_size}: the sides must be multiples "
                             f"of 32")
        self.out_channels = [embed_dim] * 4
        self.img_hw = (H, W)
        self.vit_shape = (H // 16, W // 16)
        self.c_shapes = [(H // s, W // s) for s in (8, 16, 32)]
        self.interaction_indexes = [tuple(ab) for ab in interaction_indexes]
        if len(window_attn) != depth or len(window_size) != depth:
            raise ValueError(f"ViTAdapter: window_attn and window_size list "
                             f"{len(window_attn)} and {len(window_size)} blocks, not {depth}")
        if len(self.interaction_indexes) != 4:
            raise ValueError(f"ViTAdapter: {len(self.interaction_indexes)} interactions, where "
                             f"the output adds the ViT's map after each of four to a level")
        self.grid = pretrain_size // 16
        self.patch_embed = ViTPatchEmbed(in_channels, embed_dim, 16)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid ** 2 + 1, embed_dim))
        for axis, n in zip("hw", self.vit_shape):
            self.register_buffer(f"pos_resize_{axis}",
                                 torch.from_numpy(cubic_resize_matrix(self.grid, n)),
                                 persistent=False)
        self.blocks = vit_blocks(embed_dim, num_heads, mlp_ratio, qkv_bias, False,
                                 [int(size) if windowed else 0
                                  for windowed, size in zip(window_attn, window_size)],
                                 self.vit_shape)
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim))
        self.spm = SpatialPriorModule(conv_inplane, embed_dim, in_channels)
        n = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            InteractionBlock(embed_dim, deform_num_heads, n_points, deform_ratio, self.vit_shape,
                             self.c_shapes, cffn_ratio, i == n - 1)
            for i in range(n))
        self.up = nn.ConvTranspose2d(embed_dim, embed_dim, 2, 2)
        self.norm1, self.norm2, self.norm3, self.norm4 = (OutputNorm(embed_dim)
                                                          for _ in range(4))
        for name, shapes in (("ref_vit", [self.vit_shape]), ("ref_c", self.c_shapes)):
            num, den = centres(shapes)
            self.register_buffer(f"{name}_num", num, persistent=False)
            self.register_buffer(f"{name}_den", den, persistent=False)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None):
        """img (B, H, W, 3) normalized → four (B, H/s, W/s, D) maps, s = 4,
        8, 16, 32; ``generator`` is the detectors' stochastic-depth
        argument, unused."""
        if tuple(img.shape[1:3]) != self.img_hw:
            raise ValueError(f"ViTAdapter: a {tuple(img.shape[1:3])} input, where the grids "
                             f"are built for {self.img_hw}")
        b = img.shape[0]
        with span("model.adapter_spm"):
            c1, c2, c3, c4 = self.spm(img.permute(0, 3, 1, 2))
            c = torch.cat([(ci.flatten(2).transpose(1, 2) + self.level_embed[i])
                           for i, ci in enumerate((c2, c3, c4))], dim=1)
        x = self.patch_embed(img)
        x = x + resized_pos(self.pos_embed[:, 1:], self.grid, self.pos_resize_h,
                            self.pos_resize_w).to(x.dtype)
        refs = (self.ref_vit_num / self.ref_vit_den, self.ref_c_num / self.ref_c_den)
        xs = []  # the ViT's map after each interaction
        for (a, z), layer in zip(self.interaction_indexes, self.interactions):
            x, c = layer(x, c, self.blocks[a:z + 1], refs)
            xs.append(x.permute(0, 3, 1, 2))
        with span("model.adapter_out"):
            return self.fuse(c1, c, xs)

    def fuse(self, c1: torch.Tensor, c: torch.Tensor, xs: Sequence[torch.Tensor]):
        """c1 (b, D, H/4, W/4), the prior's tokens c (b, Nc, D) and the
        ViT's NCHW map after each interaction → the four NHWC outputs: level
        i plus ``xs[i]`` resized to it (the published ``outs``), normed."""
        b, _, d = c.shape
        maps = [c[:, s:s + h * w].view(b, h, w, d).permute(0, 3, 1, 2)
                for (h, w), s in zip(self.c_shapes, level_starts(self.c_shapes))]
        outs = [self.up(maps[0]) + c1] + maps
        outs = [o + (xi if f == 1 else F.interpolate(xi, scale_factor=f, mode="bilinear",
                                                     align_corners=False))
                for o, xi, f in zip(outs, xs, (4, 2, 1, 0.5))]
        norms = (self.norm1, self.norm2, self.norm3, self.norm4)
        return tuple(n(o).permute(0, 2, 3, 1) for n, o in zip(norms, outs))
