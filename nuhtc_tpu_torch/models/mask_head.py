"""Mask and semantic heads, NHWC (port of nuhtc_tpu/models/mask_head.py).

- ``HTCMaskHead``: 4× 3×3 conv + ReLU, 2×2 stride-2 ConvTranspose + ReLU,
  1×1 logits (class-agnostic, one channel), 28×28 from 14×14 RoI features —
  the deconv form. ``with_conv_res`` adds HTC's info-flow input (the full
  cascade's heads of stages 1 and 2): ``conv_res`` (1×1 + ReLU) of the
  previous head's feature is added to ``x`` before ``conv0``; ``feat`` is
  the output of the last 3×3 conv. The lite head has no ``conv_res``.
- ``FusedSemanticHead``: 1×1 laterals + ReLU, bilinear (align_corners=True)
  upsample-sum at level 0, 4× 3×3 conv + ReLU, 1×1 logits and a 1×1 + ReLU
  embedding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nuhtc_tpu_torch.models.layers import ConvModule, conv_nhwc
from nuhtc_tpu_torch.ops.components import resize_align_corners


class HTCMaskHead(nn.Module):
    def __init__(self, num_convs: int = 4, in_channels: int = 64,
                 conv_out_channels: int = 64, num_classes: int = 5,
                 class_agnostic: bool = True, with_conv_res: bool = False):
        super().__init__()
        if with_conv_res:
            self.conv_res = ConvModule(conv_out_channels, conv_out_channels, 1)
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels, conv_out_channels, 3)
            for i in range(num_convs))
        self.upsample = nn.ConvTranspose2d(conv_out_channels, conv_out_channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels, 1 if class_agnostic else num_classes, 1)

    def forward(self, x: torch.Tensor, res_feat: torch.Tensor | None = None,
                return_logits: bool = True, return_feat: bool = False):
        """x (R, S, S, C), ``res_feat`` the previous head's feature or None →
        logits (R, 2S, 2S, out) f32 and/or the feature (R, S, S, C'), in
        that order."""
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = conv(x)
        outs = []
        if return_logits:
            y = F.relu(conv_nhwc(self.upsample, x))
            outs.append(conv_nhwc(self.conv_logits, y).float())
        if return_feat:
            outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)


class FusedSemanticHead(nn.Module):
    def __init__(self, num_ins: int = 4, fusion_level: int = 0, num_convs: int = 4,
                 in_channels: int = 64, conv_out_channels: int = 64, num_classes: int = 1):
        super().__init__()
        self.num_ins, self.fusion_level = num_ins, fusion_level
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, in_channels, 1) for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels, conv_out_channels, 3)
            for i in range(num_convs))
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)
        self.conv_embedding = ConvModule(conv_out_channels, conv_out_channels, 1)

    def forward(self, feats):
        """Per-level NHWC → (logits (B, H0, W0, classes) f32, embedding (B, H0, W0, C))."""
        fl = self.fusion_level
        x = self.lateral_convs[fl](feats[fl])
        th, tw = x.shape[1:3]
        for i, f in enumerate(feats[: self.num_ins]):
            if i == fl:
                continue
            lat = self.lateral_convs[i](f)
            x = x + resize_align_corners(lat.permute(0, 3, 1, 2), (th, tw)).permute(0, 2, 3, 1)
        for conv in self.convs:
            x = conv(x)
        return conv_nhwc(self.conv_logits, x).float(), self.conv_embedding(x)
