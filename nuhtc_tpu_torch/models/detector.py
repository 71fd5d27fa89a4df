"""NuHTC detector, batched inference (port of nuhtc_tpu/models/detector.py).

The lite Hybrid Task Cascade with component ("watershed") proposals:

  img (B, H, W, 3) → Swin-T → FPN → RPN proposals → fused semantic head →
  component proposals, prepended → 3 cascade stages (attention RoI features
  + semantic RoI features → Shared2FC head, DeltaXYWH refinement between
  stages) → stage-averaged Seesaw scores → multiclass NMS (score 0.35, the
  top 2048 candidates, IoU 0.5, top 500) → mask head on the detections.

Outputs are padded to fixed shapes, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from nuhtc_tpu_torch.models.bbox_head import Shared2FCBBoxHeadWithProb, seesaw_activation
from nuhtc_tpu_torch.models.fpn import FPN
from nuhtc_tpu_torch.models.mask_head import FusedSemanticHead, HTCMaskHead
from nuhtc_tpu_torch.models.roi_extractor import stage_roi_features
from nuhtc_tpu_torch.models.rpn_head import RPNHead, rpn_proposals
from nuhtc_tpu_torch.models.swin import SwinTransformer
from nuhtc_tpu_torch.ops import boxes as box_ops
from nuhtc_tpu_torch.ops import nms as nms_ops
from nuhtc_tpu_torch.ops.components import component_proposals_batched

# per-stage DeltaXYWH stds (reference config)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))


class RoIHead(nn.Module):
    """Holds the RoI-stage heads under the reference's ``roi_head.*`` names."""

    def __init__(self, num_classes: int, channels: int, num_stages: int):
        super().__init__()
        self.semantic_head = FusedSemanticHead(in_channels=channels, conv_out_channels=channels)
        self.bbox_head = nn.ModuleList(
            Shared2FCBBoxHeadWithProb(num_classes=num_classes, in_channels=channels)
            for _ in range(num_stages))
        self.mask_head = HTCMaskHead(in_channels=channels, conv_out_channels=channels,
                                     num_classes=num_classes)


class NuHTC(nn.Module):
    def __init__(self, num_classes: int = 5, fpn_channels: int = 64,
                 strides: Tuple[int, ...] = (4, 8, 16, 32), num_stages: int = 3,
                 attn_start_level: int = 2, attn_thres: float = 0.965926,
                 rpn_nms_pre: int = 3000, rpn_max_per_img: int = 1000,
                 rpn_nms_iou: float = 0.7, rpn_min_bbox_size: float = 10.0,
                 rcnn_score_thr: float = 0.35, rcnn_nms_iou: float = 0.5,
                 rcnn_max_per_img: int = 500, mask_thr_binary: float = 0.5,
                 watershed_proposal: bool = True, watershed_max: int = 512,
                 watershed_min_area: int = 10, scale_factor: float = 2.0,
                 nms_candidates: int = 2048, backbone_cfg: dict | None = None):
        super().__init__()
        self.num_classes, self.strides, self.num_stages = num_classes, tuple(strides), num_stages
        self.attn_start_level, self.attn_thres = attn_start_level, attn_thres
        self.rpn_nms_pre, self.rpn_max_per_img = rpn_nms_pre, rpn_max_per_img
        self.rpn_nms_iou, self.rpn_min_bbox_size = rpn_nms_iou, rpn_min_bbox_size
        self.rcnn_score_thr, self.rcnn_nms_iou = rcnn_score_thr, rcnn_nms_iou
        self.rcnn_max_per_img, self.mask_thr_binary = rcnn_max_per_img, mask_thr_binary
        self.watershed_proposal, self.watershed_max = watershed_proposal, watershed_max
        self.watershed_min_area, self.scale_factor = watershed_min_area, scale_factor
        self.nms_candidates = nms_candidates
        self.backbone = SwinTransformer(**(backbone_cfg or {}))
        dims = [self.backbone.patch_embed.projection.out_channels * 2 ** i
                for i in range(len(self.backbone.stages))]
        self.neck = FPN(in_channels=dims, out_channels=fpn_channels)
        self.rpn_head = RPNHead(in_channels=fpn_channels, feat_channels=fpn_channels)
        self.roi_head = RoIHead(num_classes, fpn_channels, num_stages)

    def _roi_features(self, feats, semantic_feat, rois, out_size: int, sampling_ratio: int,
                      sem_pool_from: int | None):
        return stage_roi_features(feats, semantic_feat, rois, out_size, sampling_ratio,
                                  sem_pool_from, strides=self.strides,
                                  start_level=self.attn_start_level, thres=self.attn_thres)

    def _bbox_stage(self, stage: int, feats, semantic_feat, rois):
        """rois (B, P, 4) → (cls (B, P, C+2), reg (B, P, 4))."""
        b, p, _ = rois.shape
        # adaptive_avg_pool2d(RoIAlign14, 7) of the semantic map, fused
        rf = self._roi_features(feats, semantic_feat, rois, 7, 2, 14)
        cls, reg = self.roi_head.bbox_head[stage](rf.reshape(b * p, *rf.shape[2:]))
        return cls.reshape(b, p, -1), reg.reshape(b, p, 4)

    def _mask_forward(self, feats, semantic_feat, boxes):
        """boxes (B, D, 4) in the network-input frame → mask probs (B, D, 28, 28)."""
        b, d, _ = boxes.shape
        mf = self._roi_features(feats, semantic_feat, boxes, 14, 0, None)
        logits = self.roi_head.mask_head(mf.reshape(b * d, *mf.shape[2:]))
        return torch.sigmoid(logits[..., 0]).reshape(b, d, 28, 28)

    def _multiclass_nms(self, boxes, scores, valid) -> Dict[str, torch.Tensor]:
        """boxes (B, P, 4), scores (B, P, C+1), valid (B, P) → padded top
        ``rcnn_max_per_img`` detections per image."""
        b, p, _ = boxes.shape
        c = self.num_classes
        cls_scores = scores[..., :c]
        cand_scores = cls_scores.reshape(b, p * c)
        cand_valid = (cand_scores > self.rcnn_score_thr) & valid.repeat_interleave(c, dim=1)
        dev = boxes.device
        cand_labels = torch.arange(c, dtype=torch.int32, device=dev).repeat(p)
        cand_roi = torch.arange(p, device=dev).repeat_interleave(c)
        k = min(self.nms_candidates, p * c)
        top_scores, top_idx = nms_ops.sort_desc(
            torch.where(cand_valid, cand_scores, nms_ops.NEG_INF))
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        top_valid = top_scores > self.rcnn_score_thr
        top_roi = cand_roi[top_idx]  # (B, k)
        top_boxes = boxes.gather(1, top_roi[..., None].expand(-1, -1, 4))
        top_labels = cand_labels[top_idx]
        bound = torch.where(top_valid[..., None], top_boxes, 0.0).amax(dim=(1, 2))
        ob, os_, oi, ov = nms_ops.batched_nms(
            top_boxes, torch.where(top_valid, top_scores, nms_ops.NEG_INF), top_labels,
            top_valid, self.rcnn_nms_iou, self.rcnn_max_per_img, coord_bound=bound)
        roi = top_roi.gather(1, oi)
        probs = cls_scores.gather(1, roi[..., None].expand(-1, -1, c))
        return {
            "boxes": ob,
            "scores": torch.where(ov, os_, 0.0),
            "labels": torch.where(ov, top_labels.gather(1, oi), -1),
            "probs": torch.where(ov[..., None], probs, 0.0),
            "valid": ov,
        }

    @torch.no_grad()
    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3) normalized → dict of padded detections: boxes
        (B, D, 4) in the original frame (input / scale_factor), scores (B, D),
        labels (B, D) int32, probs (B, D, C), mask_probs (B, D, 28, 28),
        valid (B, D)."""
        h, w = img.shape[1:3]
        img_shape = (h, w)
        # contiguous once: the convolutions return permuted views, and every
        # cascade stage hands these maps to the RoIAlign kernel
        feats = tuple(f.contiguous() for f in self.neck(self.backbone(img)))

        cls_scores, bbox_preds = self.rpn_head(feats)
        prop_boxes, _, prop_valid = rpn_proposals(
            cls_scores, bbox_preds, img_shape, strides=self.strides,
            nms_pre=self.rpn_nms_pre, max_per_img=self.rpn_max_per_img,
            nms_iou=self.rpn_nms_iou, min_bbox_size=self.rpn_min_bbox_size)

        semantic_logits, semantic_feat = self.roi_head.semantic_head(feats)
        semantic_feat = semantic_feat.contiguous()
        rois, rois_valid = prop_boxes, prop_valid
        if self.watershed_proposal:
            ws_boxes5, ws_valid = component_proposals_batched(
                semantic_logits[..., 0], img_shape, max_components=self.watershed_max,
                min_area=self.watershed_min_area)
            rois = torch.cat([ws_boxes5[..., :4], prop_boxes], dim=1)
            rois_valid = torch.cat([ws_valid, prop_valid], dim=1)

        ms_scores = []
        bbox_pred = None
        for stage in range(self.num_stages):
            cls_score, bbox_pred = self._bbox_stage(stage, feats, semantic_feat, rois)
            ms_scores.append(cls_score)
            if stage < self.num_stages - 1:
                rois = box_ops.delta2bbox(rois, bbox_pred, stds=STAGE_STDS[stage],
                                          max_shape=img_shape)
        scores_act = seesaw_activation(sum(ms_scores) / float(len(ms_scores)))
        bboxes = box_ops.delta2bbox(rois, bbox_pred, stds=STAGE_STDS[self.num_stages - 1],
                                    max_shape=img_shape)
        det = self._multiclass_nms(bboxes / self.scale_factor, scores_act, rois_valid)
        det["mask_probs"] = self._mask_forward(feats, semantic_feat,
                                               det["boxes"] * self.scale_factor)
        return det

