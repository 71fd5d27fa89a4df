"""The seg heads of the ``_Lite_Fuse`` family, NHWC (port of
nuhtc_tpu/models/extra_heads.py; reference nuhtc/models/htc_seg_head_cus.py).

``HTCSegHead`` fuses two stride-2 convs of the raw image with the semantic
feature (bilinear, ``align_corners=True``, then a 1×1 lateral + ReLU), runs
``num_convs`` 3×3 convs and predicts a seg map, a distance map (both
upsampled to the image) and a global multi-label class vector;
``HTCSegBranch`` is its n-class variant. ``soft_distance_target`` is the
reference's normalized interior distance (iterated 3×3 erosions).

``ViT_FPN`` (reference nuhtc/necks/vit_fpn.py) turns the ViT's last map into
a four-level pyramid: transposed convolutions ×4 and ×2 (flax's with kernel
= stride, whose kernel ``utils/convert.py`` flips), a 1×1 convolution, and a
3×3 stride-2 convolution with flax's SAME padding ((0, 1) on an even side,
(1, 1) on an odd one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nuhtc_tpu_torch.models.layers import conv_nhwc
from nuhtc_tpu_torch.ops import morphology
from nuhtc_tpu_torch.ops.components import resize_align_corners
from nuhtc_tpu_torch.registry import HEADS, NECKS


def _same_stride2(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 3×3 stride-2 conv of NHWC ``x`` with flax's SAME padding: the
    ceil(H/2) outputs take the padding that is missing at the bottom/right
    (none at the top/left for an even side)."""
    h, w = x.shape[1:3]
    ph, pw = max((-(-h // 2) - 1) * 2 + 3 - h, 0), max((-(-w // 2) - 1) * 2 + 3 - w, 0)
    x = F.pad(x.permute(0, 3, 1, 2), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return conv(x).permute(0, 2, 3, 1)


@HEADS.register()
class HTCSegHead(nn.Module):
    """Binary seg + distance map + global classes from the raw image and the
    semantic feature."""

    def __init__(self, in_channels: int = 64, conv_out_channels: int = 64, num_convs: int = 2,
                 num_classes: int = 1):
        super().__init__()
        c = conv_out_channels
        self.img_conv0 = nn.Conv2d(3, c, 3, stride=2)
        self.img_conv1 = nn.Conv2d(c, c, 3, stride=2)
        self.sem_lateral = nn.Conv2d(in_channels, c, 1)
        self.convs = nn.ModuleList(nn.Conv2d(c, c, 3, padding=1) for _ in range(num_convs))
        self.conv_seg = nn.Conv2d(c, num_classes, 1)
        self.conv_dist = nn.Conv2d(c, 1, 1)
        self.fc_cls = nn.Linear(c, max(num_classes, 1))

    def forward(self, img: torch.Tensor, semantic_feat: torch.Tensor):
        """img (B, H, W, 3), semantic_feat (B, H/4, W/4, C) → (feat (B, H/4,
        W/4, C'), seg (B, H, W, classes) f32, dist (B, H, W) f32, cls (B,
        classes) f32)."""
        h, w = img.shape[1:3]
        x = F.relu(_same_stride2(self.img_conv0, img))
        x = F.relu(_same_stride2(self.img_conv1, x))
        sem = resize_align_corners(semantic_feat.permute(0, 3, 1, 2), tuple(x.shape[1:3]))
        x = x + F.relu(conv_nhwc(self.sem_lateral, sem.permute(0, 2, 3, 1)))
        for conv in self.convs:
            x = F.relu(conv_nhwc(conv, x))
        seg = conv_nhwc(self.conv_seg, x)
        dist = conv_nhwc(self.conv_dist, x)
        cls = self.fc_cls(x.mean(dim=(1, 2)))
        seg = resize_align_corners(seg.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
        dist = resize_align_corners(dist.permute(0, 3, 1, 2), (h, w))[:, 0]
        return x, seg.float(), dist.float(), cls.float()


@HEADS.register()
class HTCSegBranch(HTCSegHead):
    """The n-class variant of HTCSegHead (reference htc_seg_head_cus.py:238-353)."""


def soft_distance_target(mask: torch.Tensor, iterations: int = 8) -> torch.Tensor:
    """Normalized interior distance of (..., H, W) masks: the number of 3×3
    erosions each pixel survives, over ``iterations``."""
    cur = mask.float()
    acc = torch.zeros_like(cur)
    for _ in range(iterations):
        cur = morphology.binary_erosion(cur, ksize=3, iterations=1)
        acc = acc + cur
    return acc / iterations


@NECKS.register()
class ViT_FPN(nn.Module):
    """Single-scale ViT feature → (×4, ×2, ×1, ×½) maps of ``out_channels``;
    of the backbone's maps it reads the last (``takes_last_map``), of
    ``in_channels``."""

    takes_last_map = True

    def __init__(self, in_channels: int = 768, out_channels: int = 64):
        super().__init__()
        self.out_channels = out_channels
        self.up4 = nn.ConvTranspose2d(in_channels, out_channels, 4, stride=4)
        self.up2 = nn.ConvTranspose2d(in_channels, out_channels, 2, stride=2)
        self.same = nn.Conv2d(in_channels, out_channels, 1)
        self.down = nn.Conv2d(in_channels, out_channels, 3, stride=2)

    def forward(self, feats):
        """feats: the ViT's maps, (B, H/16, W/16, C) last → four NHWC maps."""
        x = feats[-1]
        return (conv_nhwc(self.up4, x), conv_nhwc(self.up2, x), conv_nhwc(self.same, x),
                _same_stride2(self.down, x))
