"""Feature Pyramid Network neck, NHWC (port of nuhtc_tpu/models/fpn.py).

mmdet FPN as NuHTC configures it: 1×1 lateral convs, nearest 2× top-down
sum, 3×3 output convs, no norm or activation.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from nuhtc_tpu_torch.models.layers import ConvModule
from nuhtc_tpu_torch.registry import NECKS


@NECKS.register()
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 out_channels: int = 64, num_outs: int = 4):
        super().__init__()
        self.num_outs = num_outs
        self.out_channels = out_channels
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
