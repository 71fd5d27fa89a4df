"""Neck part ``ViT_FPN``: NuHTC's single-scale to four-level neck
(``nuhtc/necks/vit_fpn.py``, as the port builds it) in plain f32 PyTorch,
and its work count.

The backbone's last map x (stride 16) gives four maps of ``out_channels``:
a transposed convolution of kernel and stride 4 (stride 4), one of kernel
and stride 2 (stride 8), a 1 × 1 convolution (stride 16) and a 3 × 3
convolution of stride 2 (stride 32) padded as flax's SAME pads it: the
ceil(side / 2) outputs take the padding that is missing at the bottom and
right, (0, 1) on an even side and (1, 1) on an odd one. Each has a bias;
there is no norm, no activation and no sixth level (detectron2's
``SimpleFeaturePyramid`` has LN, 256 channels and a P6)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch.nn.functional as F
from torch import nn


class ViT_FPN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up4 = nn.ConvTranspose2d(in_channels, out_channels, 4, stride=4)
        self.up2 = nn.ConvTranspose2d(in_channels, out_channels, 2, stride=2)
        self.same = nn.Conv2d(in_channels, out_channels, 1)
        self.down = nn.Conv2d(in_channels, out_channels, 3, stride=2)

    def forward(self, feats):
        x = feats[-1].permute(0, 3, 1, 2)
        h, w = x.shape[2:]
        ph, pw = (max((-(-n // 2) - 1) * 2 + 3 - n, 0) for n in (h, w))
        down = self.down(F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)))
        return tuple(y.permute(0, 2, 3, 1) for y in (self.up4(x), self.up2(x), self.same(x),
                                                       down))


def build(spec: dict, in_channels: Sequence[int]) -> Tuple[nn.Module, List[int]]:
    """The neck of ``spec`` over the backbone's maps of ``in_channels`` (the
    last is read), and the channels of each map it returns."""
    out = spec.get("out_channels", 64)
    return ViT_FPN(list(in_channels)[-1], out), [out] * 4


def flops(spec: dict, side: int, in_channels: Sequence[int]) -> float:
    """Products of one square image of ``side`` (the map at stride 16): a
    transposed convolution's over its input's positions, a convolution's
    over its outputs'."""
    out, c = spec.get("out_channels", 64), list(in_channels)[-1]
    s = side // 16
    half = -(-s // 2)
    return 2.0 * c * out * (s * s * (16 + 4 + 1) + half * half * 9)
