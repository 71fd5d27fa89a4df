"""Neck part ``FPN``: the port's plain feature pyramid (lateral 1×1 convs,
nearest ×2 top-down sums, 3×3 output convs), frozen as it stood when the
benchmark was defined, and its work count.

The spec is the configuration's ``neck`` dict (a Mask R-CNN's
``fpn_channels`` as ``out_channels``); its ``in_channels`` are the
backbone's, whatever the spec lists. Input ``i`` lies at stride
``4 · 2**i``: the first at a quarter of the image's side, each further one
at the ceiling of half the one before, as the top-down sums crop it."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from torch import nn

from portbench.reference.model import ConvModule


class FPN(nn.Module):
    def __init__(self, in_channels=(96, 192, 384, 768), out_channels=64, num_outs=4):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, relu=False) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, relu=False) for _ in in_channels)

    def forward(self, feats):
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            th, tw = laterals[i - 1].shape[1:3]
            up = laterals[i].repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            laterals[i - 1] = laterals[i - 1] + up[:, :th, :tw]
        return tuple(conv(x) for conv, x in zip(self.fpn_convs, laterals))[: self.num_outs]


def build(spec: dict, in_channels: Sequence[int]) -> Tuple[nn.Module, List[int]]:
    """The neck of ``spec`` over maps of ``in_channels``, and the channels
    of each map it returns."""
    out, num_outs = spec.get("out_channels", 64), spec.get("num_outs", 4)
    return FPN(in_channels, out, num_outs), [out] * min(num_outs, len(in_channels))


def flops(spec: dict, side: int, in_channels: Sequence[int]) -> float:
    """Products over the maps of one square image of ``side``: every
    level's lateral and output conv (all run; the first ``num_outs`` are
    returned)."""
    out = spec.get("out_channels", 64)
    total, s = 0.0, side // 4
    for c in in_channels:
        total += 2.0 * s * s * c * out + 2.0 * s * s * out * out * 9
        s = (s + 1) // 2
    return total
