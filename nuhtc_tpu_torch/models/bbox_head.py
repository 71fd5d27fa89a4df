"""Bbox heads (port of nuhtc_tpu/models/bbox_head.py).

- ``Shared2FCBBoxHeadWithProb`` (the cascade of NuHTC): two shared fcs +
  ReLU, a NormedLinear classifier (temperature 20) with C+2 channels
  (classes + positive/negative objectness), class-agnostic box regression.
- ``Shared2FCBBoxHead`` (mmdet's default head, the Mask R-CNN family): two
  shared fcs of 1024 + ReLU, a plain (C+1)-way classifier and class-specific
  box regression (4·C).

RoI features are flattened in the reference's (c, i, j) order, so its
weights load unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nuhtc_tpu_torch.models.layers import NormedLinear


class Shared2FCBBoxHeadWithProb(nn.Module):
    def __init__(self, num_classes: int = 5, in_channels: int = 64, fc_out_channels: int = 256,
                 roi_feat_size: int = 7, cls_temperature: float = 20.0):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = NormedLinear(fc_out_channels, num_classes + 2, temperature=cls_temperature)
        self.fc_reg = nn.Linear(fc_out_channels, 4)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (R, S, S, C) → (cls_score (R, C+2) f32, bbox_pred (R, 4) f32)."""
        x = roi_feats.permute(0, 3, 1, 2).flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 8, in_channels: int = 64,
                 fc_out_channels: int = 1024, roi_feat_size: int = 7,
                 reg_class_agnostic: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4 if reg_class_agnostic else 4 * num_classes)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (R, S, S, C) → (cls_score (R, C+1) f32, bbox_pred (R, 4·C) f32)."""
        x = roi_feats.permute(0, 3, 1, 2).flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()


def seesaw_activation(cls_score: torch.Tensor) -> torch.Tensor:
    """(..., C+2) logits → (..., C+1) scores: softmax over classes times the
    positive objectness; the last column is the negative objectness."""
    c = cls_score.shape[-1] - 2
    score_classes = torch.softmax(cls_score[..., :c], dim=-1)
    score_obj = torch.softmax(cls_score[..., c:], dim=-1)
    return torch.cat([score_classes * score_obj[..., :1], score_obj[..., 1:2]], dim=-1)
