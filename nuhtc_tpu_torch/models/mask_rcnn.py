"""Mask R-CNN with the mid-seg head and partial-mask training (port of
nuhtc_tpu/models/mask_rcnn.py; reference mask_rcnn_part.py and
roi_head_partial.py).

  img (B, H, W, 3) → Swin-T → FPN → RPN proposals (anchor scale 8) →
  multilevel RoIAlign (each RoI on one level, ``map_roi_levels``) →
  Shared2FC head ((C+1)-way softmax, class-specific DeltaXYWH with stds
  (.1, .1, .2, .2)) → multiclass NMS over the top P·C candidates → the
  class-specific FCN mask head on the detections.

Outputs are padded to fixed shapes with NuHTC's keys (``boxes``,
``scores``, ``labels``, ``probs``, ``valid``, ``mask_probs``), so the
inference engine takes them unchanged. The backbone and the neck are any
registered ones (``backbone``, ``neck``; else ``backbone_cfg``'s Swin and an
FPN of ``fpn_channels``: ``models/parts.py``), the heads at the neck's
channels.

``compute_losses``: RPN (256 samples at pos fraction .5 on the anchors
inside the image), the bbox branch on every gt (512 samples at .25), the
mask branch re-assigned over the ``ismask == 1`` gts only and capped at 128
RoIs, and the mid-seg BCE: the stride-4 FPN map pixel-shuffled to the
image's size, concatenated with the image, one 3×3 conv against the ×4
nearest-upsampled ``gt_semantic != 0``. Every RoIAlign goes through
``roi_align`` (K4 on CUDA tensors, K4's backward for its gradient). Inside a
data-parallel step the normalizers span the global batch, as NuHTC's do
(``models/detector.py compute_losses``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from nuhtc_tpu_torch.models import losses as L
from nuhtc_tpu_torch.models.bbox_head import Shared2FCBBoxHead
from nuhtc_tpu_torch.models.layers import conv_nhwc
from nuhtc_tpu_torch.models.mask_head import HTCMaskHead
from nuhtc_tpu_torch.models.parts import build_backbone_neck
from nuhtc_tpu_torch.models.roi_extractor import multilevel_roi_features
from nuhtc_tpu_torch.models.rpn_head import RPNHead, rpn_proposals
from nuhtc_tpu_torch.ops import boxes as box_ops
from nuhtc_tpu_torch.ops import nms as nms_ops
from nuhtc_tpu_torch.ops.anchors import grid_anchors
from nuhtc_tpu_torch.parallel import mesh as P
from nuhtc_tpu_torch.registry import DETECTORS
from nuhtc_tpu_torch.train import targets as T
from nuhtc_tpu_torch.utils.profiling import span

BBOX_STDS = (0.1, 0.1, 0.2, 0.2)  # faster/mask-rcnn defaults
# train recipe (mmdet faster/mask-rcnn defaults; fixed in the JAX package)
RPN_SAMPLES, RCNN_SAMPLES, MASK_CAP = 256, 512, 128
TRAIN_NMS_PRE, TRAIN_MAX_PER_IMG = 2000, 1000


class RoIHead(nn.Module):
    """Holds the RoI heads under mmdet's Mask R-CNN names (``roi_head.*``)."""

    def __init__(self, num_classes: int, channels: int):
        super().__init__()
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes, in_channels=channels)
        self.mask_head = HTCMaskHead(in_channels=channels, conv_out_channels=channels,
                                     num_classes=num_classes, class_agnostic=False)


@DETECTORS.register()
class MaskRCNN(nn.Module):
    def __init__(self, num_classes: int = 8, fpn_channels: int = 64,
                 strides: Tuple[int, ...] = (4, 8, 16, 32), rpn_nms_pre: int = 1000,
                 rpn_max_per_img: int = 1000, rpn_nms_iou: float = 0.7,
                 rpn_min_bbox_size: float = 0.0, anchor_scale: float = 8.0,
                 rcnn_score_thr: float = 0.05, rcnn_nms_iou: float = 0.5,
                 rcnn_max_per_img: int = 100, nms_candidates: int = 1024,
                 mask_thr_binary: float = 0.5, scale_factor: float = 1.0,
                 with_mid_seg: bool = True, backbone_cfg: dict | None = None,
                 backbone: dict | None = None, neck: dict | None = None):
        super().__init__()
        self.num_classes, self.strides = num_classes, tuple(strides)
        self.rpn_nms_pre, self.rpn_max_per_img = rpn_nms_pre, rpn_max_per_img
        self.rpn_nms_iou, self.rpn_min_bbox_size = rpn_nms_iou, rpn_min_bbox_size
        self.anchor_scale = anchor_scale
        self.rcnn_score_thr, self.rcnn_nms_iou = rcnn_score_thr, rcnn_nms_iou
        self.rcnn_max_per_img, self.nms_candidates = rcnn_max_per_img, nms_candidates
        self.mask_thr_binary, self.scale_factor = mask_thr_binary, scale_factor
        self.with_mid_seg = with_mid_seg
        self.backbone, self.neck = build_backbone_neck(backbone, neck, backbone_cfg, fpn_channels)
        channels = self.neck.out_channels
        self.rpn_head = RPNHead(in_channels=channels, feat_channels=channels)
        self.roi_head = RoIHead(num_classes, channels)
        if with_mid_seg:
            # the reference's conv_last: 3×3 over [image, pixel-shuffled level 0]
            self.conv_last = nn.Conv2d(3 + channels // 16, 1, 3, padding=1)

    # ------------------------------------------------------------------ #
    def features(self, img: torch.Tensor, generator: torch.Generator | None = None
                 ) -> Tuple[torch.Tensor, ...]:
        """img (B, H, W, 3) normalized → the 4-level FPN pyramid, (B, h, w, C)
        each, contiguous (the RoI kernel reads them); ``generator`` draws the
        backbone's stochastic depth in training mode."""
        with span("model.backbone"):
            x = self.backbone(img, generator)
        with span("model.neck"):
            return tuple(f.contiguous() for f in self.neck(x))

    def mid_seg_logits(self, img: torch.Tensor, feat0: torch.Tensor) -> torch.Tensor:
        """Level 0 pixel-shuffled to the image's size (einops 'b (p1 p2 c) h
        w -> b c (h p1) (w p2)', p = 4, in NHWC), after the image → (B, H, W)
        f32 logits of ``conv_last``."""
        b, h4, w4, c = feat0.shape
        p = 4
        x = feat0.reshape(b, h4, w4, p, p, c // (p * p)).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h4 * p, w4 * p, c // (p * p))
        fused = torch.cat([img.to(x.dtype), x], dim=-1)
        return conv_nhwc(self.conv_last, fused)[..., 0].float()

    def _roi_forward(self, feats, rois):
        """rois (B, P, 4) → cls (B, P, C+1), reg (B, P, 4·C), f32."""
        b, p, _ = rois.shape
        rf = multilevel_roi_features(feats, rois, 7, 0, strides=self.strides)
        cls, reg = self.roi_head.bbox_head(rf.reshape(b * p, *rf.shape[2:]))
        return cls.reshape(b, p, -1), reg.reshape(b, p, -1)

    def _mask_forward(self, feats, boxes):
        """boxes (B, D, 4) → per-class mask logits (B, D, 28, 28, C) f32."""
        b, d, _ = boxes.shape
        mf = multilevel_roi_features(feats, boxes, 14, 0, strides=self.strides)
        logits = self.roi_head.mask_head(mf.reshape(b * d, *mf.shape[2:]))
        return logits.reshape(b, d, 28, 28, self.num_classes)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3) normalized → dict of padded detections: boxes
        (B, D, 4) in the original frame (input / scale_factor), scores (B, D),
        labels (B, D) int32, probs (B, D, C), mask_probs (B, D, 28, 28) of the
        detected class, valid (B, D)."""
        b, h, w, _ = img.shape
        img_shape = (h, w)
        feats = self.features(img)
        with span("model.rpn_head"):
            cls_scores, bbox_preds = self.rpn_head(feats)
        with span("model.rpn_proposals"):
            prop_boxes, _, prop_valid = rpn_proposals(
                cls_scores, bbox_preds, img_shape, strides=self.strides,
                scales=(self.anchor_scale,), nms_pre=self.rpn_nms_pre,
                max_per_img=self.rpn_max_per_img, nms_iou=self.rpn_nms_iou,
                min_bbox_size=self.rpn_min_bbox_size)
        with span("model.bbox_stage"):
            cls, reg = self._roi_forward(feats, prop_boxes)
        scores = torch.softmax(cls, dim=-1)  # (B, P, C+1)
        p, c = prop_boxes.shape[1], self.num_classes
        rois_pc = prop_boxes[:, :, None, :].expand(b, p, c, 4)
        boxes_pc = box_ops.delta2bbox(rois_pc, reg.reshape(b, p, c, 4), stds=BBOX_STDS,
                                      max_shape=img_shape)
        with span("model.multiclass_nms"):
            det = nms_ops.multiclass_nms(
                boxes_pc / self.scale_factor, scores, prop_valid, c, self.rcnn_score_thr,
                self.rcnn_nms_iou, self.rcnn_max_per_img, self.nms_candidates)
        with span("model.mask_head"):
            mask_logits = self._mask_forward(feats, det["boxes"] * self.scale_factor)
            lbl = det["labels"].clamp(0, c - 1).long()
            sel = mask_logits.gather(-1, lbl[:, :, None, None, None].expand(-1, -1, 28, 28, 1))
            det["mask_probs"] = torch.sigmoid(sel[..., 0])
        return det

    # ------------------------------------------------------------------ #
    def _assign_sample(self, generator, gt_boxes, gt_labels, gt_valid, props, props_valid):
        """Candidates = the gts then the proposals; IoU .5 assignment without
        low-quality matches, 512 random samples at .25 → (rois, SampleResult)."""
        cand = torch.cat([gt_boxes, props], dim=1)
        cand_valid = torch.cat([gt_valid, props_valid], dim=1)
        assign = T.max_iou_assign(cand, cand_valid, gt_boxes, gt_valid, gt_labels,
                                  pos_thr=0.5, neg_thr=0.5, min_pos_iou=0.5,
                                  match_low_quality=False)
        samp = T.random_sample(generator, assign, RCNN_SAMPLES, 0.25, self.num_classes)
        return cand.gather(1, samp.idx[..., None].expand(-1, -1, 4)), samp

    def compute_losses(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                       cum_samples: torch.Tensor | None = None,
                       generator: torch.Generator | None = None):
        """The train losses of one batch.

        img (B, H, W, 3) normalized; batch: gt_boxes (B, G, 4) f32,
        gt_labels (B, G) int, gt_valid (B, G) bool, gt_patches (B, G, M, M)
        f32, gt_semantic (B, H/4, W/4) int, optionally gt_ismask (B, G)
        (default all 1). ``generator`` draws the backbone's stochastic depth,
        then the samplers of the RPN, the bbox branch and the mask branch, in
        this order (the JAX package's per-image keys 0, 1 and 2).
        ``cum_samples`` (NuHTC's seesaw counts) is passed through unchanged:
        given, the return is (losses, cum_samples), as the train step takes
        it; else the losses dict alone."""
        gt_boxes, gt_labels, gt_valid = batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"]
        ismask = batch.get("gt_ismask")
        if ismask is None:
            ismask = torch.ones_like(gt_valid, dtype=torch.float32)
        b = gt_boxes.shape[0]
        h, w = img.shape[1:3]
        img_shape = (h, w)
        dev = img.device
        feats = self.features(img, generator)
        losses: Dict[str, torch.Tensor] = {}

        # ---- RPN ----------------------------------------------------------
        cls_scores, bbox_preds = self.rpn_head(feats)
        sizes = [tuple(cs.shape[1:3]) for cs in cls_scores]
        anchors = torch.from_numpy(np.concatenate(grid_anchors(
            sizes, self.strides, (self.anchor_scale,), (0.5, 1.0, 2.0)))).to(dev)
        inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] <= w)
                  & (anchors[:, 3] <= h))
        flat_cls = torch.cat([c.reshape(b, -1) for c in cls_scores], dim=1).float()
        flat_reg = torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], dim=1).float()
        anchors_b = anchors.expand(b, -1, -1)
        assign = T.max_iou_assign(anchors_b, inside.expand(b, -1), gt_boxes, gt_valid,
                                  gt_labels, pos_thr=0.7, neg_thr=0.3, min_pos_iou=0.3)
        samp = T.random_sample(generator, assign, RPN_SAMPLES, 0.5, 1)
        sel_anchors = anchors_b.gather(1, samp.idx[..., None].expand(-1, -1, 4))
        r_tgt, _ = T.encode_stage_targets(sel_anchors, samp, gt_boxes, (1.0, 1.0, 1.0, 1.0))
        r_val = samp.valid.float()
        sel_cls = flat_cls.gather(1, samp.idx)
        sel_reg = flat_reg.gather(1, samp.idx[..., None].expand(-1, -1, 4))
        num_total = P.global_sum(r_val.sum()).clamp(min=1.0)
        losses["loss_rpn_cls"] = (L.sigmoid_ce(sel_cls, samp.is_pos.float()) * r_val
                                  ).sum() / num_total
        losses["loss_rpn_bbox"] = (L.smooth_l1(sel_reg, r_tgt, beta=1.0 / 9.0)
                                   * samp.is_pos[..., None]).sum() / num_total

        with torch.no_grad():  # proposals carry no gradient (JAX: stop_gradient)
            prop_boxes, _, prop_valid = rpn_proposals(
                cls_scores, bbox_preds, img_shape, strides=self.strides,
                scales=(self.anchor_scale,), nms_pre=TRAIN_NMS_PRE,
                max_per_img=TRAIN_MAX_PER_IMG, nms_iou=self.rpn_nms_iou,
                min_bbox_size=self.rpn_min_bbox_size)

        # ---- bbox branch: every gt -----------------------------------------
        rois, samp = self._assign_sample(generator, gt_boxes, gt_labels, gt_valid, prop_boxes,
                                         prop_valid)
        cls, reg = self._roi_forward(feats, rois)
        s, c = rois.shape[1], self.num_classes
        lbl = samp.labels.clamp(0, c - 1)
        reg_sel = reg.reshape(b, s, c, 4).gather(2, lbl[..., None, None].expand(-1, -1, 1, 4)
                                                 )[:, :, 0]
        bbox_tgt, bbox_w = T.encode_stage_targets(rois, samp, gt_boxes, BBOX_STDS)
        flat_w = samp.valid.reshape(-1).float()
        avg = P.global_sum(flat_w.sum()).clamp(min=1.0)
        losses["loss_cls"] = (L.softmax_ce(cls.reshape(-1, c + 1), samp.labels.reshape(-1))
                              * flat_w).sum() / avg
        losses["loss_bbox"] = (L.smooth_l1(reg_sel, bbox_tgt, beta=1.0) * bbox_w[..., None]
                               ).sum() / avg

        # ---- mask branch: the ismask == 1 gts only --------------------------
        # the reference re-assigns over the masked subset; invalidating the
        # box-only gts before the assignment selects the same way
        mask_gt_valid = gt_valid & (ismask > 0.5)
        mrois, msamp = self._assign_sample(generator, gt_boxes, gt_labels, mask_gt_valid,
                                           prop_boxes, prop_valid)
        mrois = mrois[:, :MASK_CAP]
        mpos = msamp.is_pos[:, :MASK_CAP]
        mgt = msamp.gt_inds[:, :MASK_CAP]
        mlbl = msamp.labels[:, :MASK_CAP].clamp(0, c - 1)
        mask_logits = self._mask_forward(feats, mrois)  # (B, S, 28, 28, C)
        sel = mask_logits.gather(-1, mlbl[:, :, None, None, None].expand(-1, -1, 28, 28, 1)
                                 )[..., 0]
        mtgt = T.mask_targets_from_patches(mrois, mgt, gt_boxes, batch["gt_patches"],
                                           mask_size=28)
        mvalid = mpos.float()
        mavg = (P.global_sum(mvalid.sum()) * 28 * 28).clamp(min=1.0)
        losses["loss_mask"] = (L.sigmoid_ce(sel, mtgt) * mvalid[..., None, None]).sum() / mavg

        # ---- mid-seg aux loss -----------------------------------------------
        if self.with_mid_seg:
            mid = self.mid_seg_logits(img, feats[0])  # (B, H, W)
            sem = (batch["gt_semantic"] != 0).float()
            sem_full = sem.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)[:, :h, :w]
            losses["loss_mid_seg"] = P.share(L.sigmoid_ce(mid, sem_full).mean())

        losses["total"] = sum(losses.values())
        if cum_samples is not None:
            return losses, cum_samples
        return losses
