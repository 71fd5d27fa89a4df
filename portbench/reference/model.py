"""The frozen reference models: NuHTC (the lite Hybrid Task Cascade with
component proposals) and Mask R-CNN, inference only, plain PyTorch in f32.

A frozen copy of the port's plain paths (``nuhtc_tpu_torch/models``: the
RPN head and proposals, the fused semantic head, the bbox and mask heads,
the RoI extractors through the plain RoIAlign, the multiclass NMS; and
``apis/inference.py``'s WSI-mode preprocess and label-map paste) as they
stood when the benchmark was defined. Module and parameter names are the
port's, so one state dict loads into both. It imports nothing of the port.

The backbone and the neck are parts, looked up by their ``type``:
``parts/<type>.py`` (``part``) holds the plain module and its work count,

- ``build(spec, in_channels)`` → (module, the channels of each map it
  returns): a backbone takes the image's channels, a neck the backbone's;
- ``flops(spec, side, in_channels)`` → the module's products on one square
  image of ``side``, as ``FlopCounterMode`` counts them;

and any module class in it may declare ``INIT = {attr: std | "zeros" |
"ones"}`` for parameters it owns outside a linear, convolution or norm
(``harness/weights.py``). A new backbone or neck is a new part file.

``build(cfg)`` reads the configuration file's ``model`` dict the way the
port's ``build_detector`` reads it.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops

# per-stage DeltaXYWH stds of the NuHTC cascade, and the Mask R-CNN's
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))
BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)
PARTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parts")


# ---------------------------------------------------------------- layers
def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, padding=kernel_size // 2)
        self.relu = relu

    def forward(self, x):
        x = conv_nhwc(self.conv, x)
        return F.relu(x) if self.relu else x


class NormedLinear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, temperature: float = 20.0,
                 power: float = 1.0, eps: float = 1e-6):
        super().__init__(in_features, out_features)
        self.temperature, self.power, self.eps = temperature, power, eps

    def forward(self, x):
        w = self.weight / (self.weight.norm(dim=1, keepdim=True) ** self.power + self.eps)
        x = x / (x.norm(dim=-1, keepdim=True) ** self.power + self.eps)
        return F.linear(x * self.temperature, w, self.bias)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(dim, hidden), nn.GELU()),
                                    nn.Linear(hidden, dim))

    def forward(self, x):
        return self.layers(x)


# ---------------------------------------------------------------- RPN
class RPNHead(nn.Module):
    def __init__(self, in_channels=64, feat_channels=64, num_anchors=3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats):
        cls_out, reg_out = [], []
        for f in feats:
            h = F.relu(conv_nhwc(self.rpn_conv, f))
            cls_out.append(conv_nhwc(self.rpn_cls, h))
            reg_out.append(conv_nhwc(self.rpn_reg, h))
        return cls_out, reg_out


def rpn_proposals(cls_scores, bbox_preds, img_shape, strides=(4, 8, 16, 32), scales=(4,),
                  ratios=(0.5, 1.0, 2.0), nms_pre=3000, max_per_img=1000, nms_iou=0.7,
                  min_bbox_size=10.0):
    b = cls_scores[0].shape[0]
    dev = cls_scores[0].device
    sizes = [tuple(cs.shape[1:3]) for cs in cls_scores]
    anchors = ops.grid_anchors(sizes, strides, scales, ratios)
    lvl_boxes, lvl_scores, lvl_ids = [], [], []
    for lvl, (cs, bp, anc) in enumerate(zip(cls_scores, bbox_preds, anchors)):
        scores = torch.sigmoid(cs.reshape(b, -1).float())
        deltas = bp.reshape(b, -1, 4).float()
        anc = torch.from_numpy(anc).to(dev).expand(b, -1, -1)
        if 0 < nms_pre < scores.shape[1]:
            scores, top = ops.sort_desc(scores)
            scores, top = scores[:, :nms_pre], top[:, :nms_pre]
            deltas = deltas.gather(1, top[..., None].expand(-1, -1, 4))
            anc = anc.gather(1, top[..., None].expand(-1, -1, 4))
        lvl_boxes.append(ops.delta2bbox(anc, deltas, max_shape=img_shape))
        lvl_scores.append(scores)
        lvl_ids.append(torch.full_like(scores, lvl, dtype=torch.int32))
    boxes, scores, ids = torch.cat(lvl_boxes, 1), torch.cat(lvl_scores, 1), torch.cat(lvl_ids, 1)
    valid = torch.ones_like(scores, dtype=torch.bool)
    if min_bbox_size >= 0:
        valid = ((boxes[..., 2] - boxes[..., 0]) > min_bbox_size) & (
            (boxes[..., 3] - boxes[..., 1]) > min_bbox_size)
    cap = min(4 * max_per_img + 96, boxes.shape[1])
    if boxes.shape[1] > cap:
        top_scores, top = ops.sort_desc(torch.where(valid, scores, -1.0))
        top_scores, top = top_scores[:, :cap], top[:, :cap]
        boxes = boxes.gather(1, top[..., None].expand(-1, -1, 4))
        scores = scores.gather(1, top)
        ids = ids.gather(1, top)
        valid = valid.gather(1, top) & (top_scores > -0.5)
    out_boxes, out_scores, _, out_valid = ops.batched_nms(
        boxes, scores, ids, valid, nms_iou, max_per_img,
        coord_bound=float(max(img_shape[0], img_shape[1])))
    return out_boxes, out_scores, out_valid


# ---------------------------------------------------------------- heads
class HTCMaskHead(nn.Module):
    def __init__(self, num_convs=4, in_channels=64, conv_out_channels=64, num_classes=5,
                 class_agnostic=True):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels, conv_out_channels, 3)
            for i in range(num_convs))
        self.upsample = nn.ConvTranspose2d(conv_out_channels, conv_out_channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels, 1 if class_agnostic else num_classes, 1)

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return conv_nhwc(self.conv_logits, F.relu(conv_nhwc(self.upsample, x)))


class FusedSemanticHead(nn.Module):
    def __init__(self, num_ins=4, fusion_level=0, num_convs=4, in_channels=64,
                 conv_out_channels=64, num_classes=1):
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
        fl = self.fusion_level
        x = self.lateral_convs[fl](feats[fl])
        th, tw = x.shape[1:3]
        for i, f in enumerate(feats[: self.num_ins]):
            if i == fl:
                continue
            lat = self.lateral_convs[i](f)
            x = x + ops.resize_align_corners(lat.permute(0, 3, 1, 2), (th, tw)).permute(0, 2, 3, 1)
        for conv in self.convs:
            x = conv(x)
        return conv_nhwc(self.conv_logits, x), self.conv_embedding(x)


class Shared2FCBBoxHeadWithProb(nn.Module):
    def __init__(self, num_classes=5, in_channels=64, fc_out_channels=256, roi_feat_size=7,
                 cls_temperature=20.0):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = NormedLinear(fc_out_channels, num_classes + 2, temperature=cls_temperature)
        self.fc_reg = nn.Linear(fc_out_channels, 4)

    def forward(self, roi_feats):
        x = roi_feats.permute(0, 3, 1, 2).flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes=8, in_channels=64, fc_out_channels=1024, roi_feat_size=7):
        super().__init__()
        self.num_classes = num_classes
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4 * num_classes)

    def forward(self, roi_feats):
        x = roi_feats.permute(0, 3, 1, 2).flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


def seesaw_activation(cls_score):
    c = cls_score.shape[-1] - 2
    score_classes = torch.softmax(cls_score[..., :c], dim=-1)
    score_obj = torch.softmax(cls_score[..., c:], dim=-1)
    return torch.cat([score_classes * score_obj[..., :1], score_obj[..., 1:2]], dim=-1)


def stage_roi_features(feats, semantic_feat, rois, output_size, sampling_ratio, sem_pool_from,
                       strides=(4, 8, 16, 32), start_level=2, thres=0.965926, max_grid=8):
    bias = None
    for feat, stride in list(zip(feats, strides))[start_level:]:
        pooled = ops.attention_pool(feat, rois, stride, thres, out_dtype=torch.float32)
        bias = pooled if bias is None else bias + pooled
    maps = list(feats[:start_level]) + [semantic_feat]
    scales = [1.0 / s for s in strides[:start_level]] + [1.0 / strides[0]]
    return ops.roi_align_sum_plain(maps, rois, scales, output_size,
                                   [sampling_ratio] * start_level + [0],
                                   [None] * start_level + [sem_pool_from], bias=bias,
                                   max_grid=max_grid)


def roi_levels(rois, num_levels: int, finest_scale: float = 56.0):
    rois = rois.float()
    scale = torch.sqrt((rois[..., 2] - rois[..., 0]).clamp(min=0.0)
                       * (rois[..., 3] - rois[..., 1]).clamp(min=0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def multilevel_roi_features(feats, rois, output_size, sampling_ratio=0,
                            strides=(4, 8, 16, 32), finest_scale=56.0, max_grid=8):
    lvl = roi_levels(rois, len(strides), finest_scale)
    out = None
    for i, (feat, stride) in enumerate(zip(feats, strides)):
        t = ops.roi_align_plain(feat, rois, 1.0 / stride, output_size, sampling_ratio, max_grid)
        t = t * (lvl == i).to(t.dtype)[:, :, None, None, None]
        out = t if out is None else out + t
    return out


def _multiclass_nms(boxes_pc, scores, valid, num_classes, score_thr, nms_iou, max_per_img,
                    candidates, class_specific: bool):
    """The top ``candidates`` (roi, class) pairs above ``score_thr``, NMS per
    class, the top ``max_per_img``. boxes_pc (B, P, C, 4) when
    ``class_specific``, else (B, P, 4)."""
    b, p = scores.shape[:2]
    c = num_classes
    cls_scores = scores[..., :c]
    cand_scores = cls_scores.reshape(b, p * c)
    cand_valid = (cand_scores > score_thr) & valid.repeat_interleave(c, dim=1)
    dev = scores.device
    cand_labels = torch.arange(c, dtype=torch.int32, device=dev).repeat(p)
    cand_roi = torch.arange(p, device=dev).repeat_interleave(c)
    k = min(candidates, p * c)
    top_scores, top_idx = ops.sort_desc(torch.where(cand_valid, cand_scores, ops.NEG_INF))
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_valid = top_scores > score_thr
    top_roi = cand_roi[top_idx]
    if class_specific:
        top_boxes = boxes_pc.reshape(b, p * c, 4).gather(1, top_idx[..., None].expand(-1, -1, 4))
    else:
        top_boxes = boxes_pc.gather(1, top_roi[..., None].expand(-1, -1, 4))
    top_labels = cand_labels[top_idx]
    bound = torch.where(top_valid[..., None], top_boxes, 0.0).amax(dim=(1, 2))
    ob, os_, oi, ov = ops.batched_nms(
        top_boxes, torch.where(top_valid, top_scores, ops.NEG_INF), top_labels, top_valid,
        nms_iou, max_per_img, coord_bound=bound)
    roi = top_roi.gather(1, oi)
    probs = cls_scores.gather(1, roi[..., None].expand(-1, -1, c))
    return {"boxes": ob, "scores": torch.where(ov, os_, 0.0),
            "labels": torch.where(ov, top_labels.gather(1, oi), -1),
            "probs": torch.where(ov[..., None], probs, 0.0), "valid": ov}


# ---------------------------------------------------------------- detectors
class NuHTCRoIHead(nn.Module):
    def __init__(self, num_classes, channels, num_stages):
        super().__init__()
        self.semantic_head = FusedSemanticHead(in_channels=channels, conv_out_channels=channels)
        self.bbox_head = nn.ModuleList(
            Shared2FCBBoxHeadWithProb(num_classes=num_classes, in_channels=channels)
            for _ in range(num_stages))
        self.mask_head = HTCMaskHead(in_channels=channels, conv_out_channels=channels,
                                     num_classes=num_classes)


class NuHTC(nn.Module):
    """The lite head family (one mask head, at the final stage)."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, fpn_channels: int, num_classes=5,
                 strides=(4, 8, 16, 32), num_stages=3,
                 attn_start_level=2, attn_thres=0.965926, rpn_nms_pre=3000, rpn_max_per_img=1000,
                 rpn_nms_iou=0.7, rpn_min_bbox_size=10.0, rcnn_score_thr=0.35, rcnn_nms_iou=0.5,
                 rcnn_max_per_img=500, mask_thr_binary=0.5, watershed_proposal=True,
                 watershed_max=512, watershed_min_area=10, scale_factor=2.0, nms_candidates=2048):
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
        self.backbone, self.neck = backbone, neck
        self.rpn_head = RPNHead(in_channels=fpn_channels, feat_channels=fpn_channels)
        self.roi_head = NuHTCRoIHead(num_classes, fpn_channels, num_stages)

    def _roi_features(self, feats, semantic_feat, rois, out_size, sampling_ratio, sem_pool_from):
        return stage_roi_features(feats, semantic_feat, rois, out_size, sampling_ratio,
                                  sem_pool_from, strides=self.strides,
                                  start_level=self.attn_start_level, thres=self.attn_thres)

    @torch.no_grad()
    def forward(self, img):
        h, w = img.shape[1:3]
        img_shape = (h, w)
        feats = tuple(f.contiguous() for f in self.neck(self.backbone(img)))
        cls_scores, bbox_preds = self.rpn_head(feats)
        prop_boxes, _, prop_valid = rpn_proposals(
            cls_scores, bbox_preds, img_shape, strides=self.strides, nms_pre=self.rpn_nms_pre,
            max_per_img=self.rpn_max_per_img, nms_iou=self.rpn_nms_iou,
            min_bbox_size=self.rpn_min_bbox_size)
        semantic_logits, semantic_feat = self.roi_head.semantic_head(feats)
        rois, rois_valid = prop_boxes, prop_valid
        if self.watershed_proposal:
            ws_boxes5, ws_valid = ops.component_proposals_batched(
                semantic_logits[..., 0], img_shape, max_components=self.watershed_max,
                min_area=self.watershed_min_area)
            rois = torch.cat([ws_boxes5[..., :4], prop_boxes], dim=1)
            rois_valid = torch.cat([ws_valid, prop_valid], dim=1)
        ms_scores, bbox_pred = [], None
        for stage in range(self.num_stages):
            b, p, _ = rois.shape
            rf = self._roi_features(feats, semantic_feat, rois, 7, 2, 14)
            cls, bbox_pred = self.roi_head.bbox_head[stage](rf.reshape(b * p, *rf.shape[2:]))
            cls, bbox_pred = cls.reshape(b, p, -1), bbox_pred.reshape(b, p, 4)
            ms_scores.append(cls)
            if stage < self.num_stages - 1:
                rois = ops.delta2bbox(rois, bbox_pred, stds=STAGE_STDS[stage], max_shape=img_shape)
        scores_act = seesaw_activation(sum(ms_scores) / float(len(ms_scores)))
        bboxes = ops.delta2bbox(rois, bbox_pred, stds=STAGE_STDS[self.num_stages - 1],
                                max_shape=img_shape)
        det = _multiclass_nms(bboxes / self.scale_factor, scores_act, rois_valid,
                              self.num_classes, self.rcnn_score_thr, self.rcnn_nms_iou,
                              self.rcnn_max_per_img, self.nms_candidates, class_specific=False)
        det["mask_probs"] = self._masks((feats, semantic_feat), det["boxes"], det["labels"])
        return det

    def _masks(self, state, boxes, labels):
        """Mask probabilities (B, D, 28, 28) of boxes (B, D, 4) in the
        original frame (the lite head is class-agnostic)."""
        feats, semantic_feat = state
        b, d, _ = boxes.shape
        mf = self._roi_features(feats, semantic_feat, boxes * self.scale_factor, 14, 0, None)
        probs = torch.sigmoid(self.roi_head.mask_head(mf.reshape(b * d, *mf.shape[2:]))[..., 0])
        return probs.reshape(b, d, 28, 28)

    @torch.no_grad()
    def mask_probs(self, img, boxes, labels):
        feats = tuple(f.contiguous() for f in self.neck(self.backbone(img)))
        return self._masks((feats, self.roi_head.semantic_head(feats)[1]), boxes, labels)


class MaskRCNNRoIHead(nn.Module):
    def __init__(self, num_classes, channels):
        super().__init__()
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes, in_channels=channels)
        self.mask_head = HTCMaskHead(in_channels=channels, conv_out_channels=channels,
                                     num_classes=num_classes, class_agnostic=False)


class MaskRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module, fpn_channels: int, num_classes=8,
                 strides=(4, 8, 16, 32), rpn_nms_pre=1000,
                 rpn_max_per_img=1000, rpn_nms_iou=0.7, rpn_min_bbox_size=0.0, anchor_scale=8.0,
                 rcnn_score_thr=0.05, rcnn_nms_iou=0.5, rcnn_max_per_img=100,
                 nms_candidates=1024, mask_thr_binary=0.5, scale_factor=1.0, with_mid_seg=True):
        super().__init__()
        self.num_classes, self.strides = num_classes, tuple(strides)
        self.rpn_nms_pre, self.rpn_max_per_img = rpn_nms_pre, rpn_max_per_img
        self.rpn_nms_iou, self.rpn_min_bbox_size = rpn_nms_iou, rpn_min_bbox_size
        self.anchor_scale = anchor_scale
        self.rcnn_score_thr, self.rcnn_nms_iou = rcnn_score_thr, rcnn_nms_iou
        self.rcnn_max_per_img, self.nms_candidates = rcnn_max_per_img, nms_candidates
        self.mask_thr_binary, self.scale_factor = mask_thr_binary, scale_factor
        self.backbone, self.neck = backbone, neck
        self.rpn_head = RPNHead(in_channels=fpn_channels, feat_channels=fpn_channels)
        self.roi_head = MaskRCNNRoIHead(num_classes, fpn_channels)
        if with_mid_seg:  # the training-only mid-seg conv: loaded, never run at test
            self.conv_last = nn.Conv2d(3 + fpn_channels // 16, 1, 3, padding=1)

    @torch.no_grad()
    def forward(self, img):
        b, h, w, _ = img.shape
        img_shape = (h, w)
        feats = tuple(f.contiguous() for f in self.neck(self.backbone(img)))
        cls_scores, bbox_preds = self.rpn_head(feats)
        prop_boxes, _, prop_valid = rpn_proposals(
            cls_scores, bbox_preds, img_shape, strides=self.strides, scales=(self.anchor_scale,),
            nms_pre=self.rpn_nms_pre, max_per_img=self.rpn_max_per_img, nms_iou=self.rpn_nms_iou,
            min_bbox_size=self.rpn_min_bbox_size)
        p = prop_boxes.shape[1]
        rf = multilevel_roi_features(feats, prop_boxes, 7, 0, strides=self.strides)
        cls, reg = self.roi_head.bbox_head(rf.reshape(b * p, *rf.shape[2:]))
        scores = torch.softmax(cls.reshape(b, p, -1), dim=-1)
        c = self.num_classes
        rois_pc = prop_boxes[:, :, None, :].expand(b, p, c, 4)
        boxes_pc = ops.delta2bbox(rois_pc, reg.reshape(b, p, c, 4), stds=BBOX_STDS,
                                  max_shape=img_shape)
        det = _multiclass_nms(boxes_pc / self.scale_factor, scores, prop_valid, c,
                              self.rcnn_score_thr, self.rcnn_nms_iou, self.rcnn_max_per_img,
                              self.nms_candidates, class_specific=True)
        det["mask_probs"] = self._masks(feats, det["boxes"], det["labels"])
        return det

    def _masks(self, feats, boxes, labels):
        """Mask probabilities (B, D, 28, 28) of boxes (B, D, 4) in the
        original frame, of each one's class."""
        b, d, _ = boxes.shape
        c = self.num_classes
        mf = multilevel_roi_features(feats, boxes * self.scale_factor, 14, 0,
                                     strides=self.strides)
        logits = self.roi_head.mask_head(mf.reshape(b * d, *mf.shape[2:])).reshape(b, d, 28, 28, c)
        lbl = labels.clamp(0, c - 1).long()
        sel = logits.gather(-1, lbl[:, :, None, None, None].expand(-1, -1, 28, 28, 1))
        return torch.sigmoid(sel[..., 0])

    @torch.no_grad()
    def mask_probs(self, img, boxes, labels):
        return self._masks(tuple(f.contiguous() for f in self.neck(self.backbone(img))), boxes,
                           labels)


def part(type_name: str):
    """The module of ``parts/<type_name>.py``, loaded by its path."""
    path = os.path.join(PARTS_DIR, f"{type_name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"reference: no part of type {type_name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"portbench_part_{type_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def part_specs(model_cfg: dict) -> Tuple[Tuple[str, dict], Tuple[str, dict]]:
    """((type, spec) of the backbone, (type, spec) of the neck) of a
    configuration's ``model`` dict: the backbone from ``backbone``, else
    ``backbone_cfg``; the neck from ``neck``, else an FPN of
    ``fpn_channels``; the types ``SwinTransformer`` and ``FPN`` where none
    is named."""
    bb = dict(model_cfg.get("backbone") or model_cfg.get("backbone_cfg") or {})
    neck = dict(model_cfg.get("neck") or {"out_channels": model_cfg.get("fpn_channels", 64)})
    return ((bb.get("type", "SwinTransformer"), bb), (neck.get("type", "FPN"), neck))


def build_feats(model_cfg: dict) -> Tuple[nn.Module, nn.Module, int]:
    """(backbone, neck, the neck's channels) of a ``model`` dict."""
    (bb_type, bb_spec), (neck_type, neck_spec) = part_specs(model_cfg)
    backbone, dims = part(bb_type).build(bb_spec, 3)
    neck, channels = part(neck_type).build(neck_spec, dims)
    return backbone, neck, channels[0]


def build(cfg: dict) -> nn.Module:
    """The reference detector of a configuration file (``cfg``: its
    ``model`` dict and ``scale_factor``), read as the port's
    ``build_detector`` reads a config."""
    model_cfg = dict(cfg["model"])
    scale = float(cfg["scale_factor"])
    test_cfg = dict(model_cfg.get("test_cfg") or {})
    if model_cfg.get("type") == "MaskRCNN":
        keys = ("num_classes", "strides", "rpn_nms_pre", "rpn_max_per_img", "rpn_nms_iou",
                "rpn_min_bbox_size", "anchor_scale", "rcnn_score_thr", "rcnn_nms_iou",
                "rcnn_max_per_img", "nms_candidates", "mask_thr_binary", "with_mid_seg")
        kw = {k: model_cfg[k] for k in keys if k in model_cfg}
        return MaskRCNN(*build_feats(model_cfg), scale_factor=scale, **kw)
    if model_cfg.get("type") != "NuHTC":
        raise ValueError(f"reference: no model of type {model_cfg.get('type')!r}")
    roi = dict(model_cfg.get("roi_head") or {})
    if "Lite" not in str(roi.get("type", "HybridTaskCascadeRoIHead_Lite")) or \
            "Fuse" in str(roi.get("type", "")):
        raise ValueError("reference: only the lite NuHTC head family is frozen here")
    heads = roi.get("bbox_head") or [{}]
    heads = [heads] if isinstance(heads, dict) else heads
    ext = dict(roi.get("bbox_roi_extractor") or {})
    rpn_test, rcnn_test = dict(test_cfg.get("rpn") or {}), dict(test_cfg.get("rcnn") or {})
    return NuHTC(
        *build_feats(model_cfg),
        num_classes=heads[0].get("num_classes", 5),
        strides=tuple(ext.get("featmap_strides", (4, 8, 16, 32))),
        num_stages=roi.get("num_stages", 3),
        attn_start_level=ext.get("start_level", 2),
        attn_thres=ext.get("thres", 0.965926),
        rpn_nms_pre=rpn_test.get("nms_pre", 3000),
        rpn_max_per_img=rpn_test.get("max_per_img", 1000),
        rpn_nms_iou=dict(rpn_test.get("nms") or {}).get("iou_threshold", 0.7),
        rpn_min_bbox_size=rpn_test.get("min_bbox_size", 10.0),
        rcnn_score_thr=rcnn_test.get("score_thr", 0.35),
        rcnn_nms_iou=dict(rcnn_test.get("nms") or {}).get("iou_threshold", 0.5),
        rcnn_max_per_img=rcnn_test.get("max_per_img", 500),
        mask_thr_binary=rcnn_test.get("mask_thr_binary", 0.5),
        watershed_proposal=roi.get("watershed_proposal", True),
        scale_factor=scale)


# ---------------------------------------------------------------- WSI-mode engine
def prep(tiles_u8: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """(B, t, t, 3) uint8 tiles → the normalized, zero-padded network input
    (B, S, S, 3) f32: half-pixel bilinear resize by ``scale_factor``, then
    normalize, then pad to a multiple of 32 (full tiles only)."""
    t = tiles_u8.shape[1]
    rs = int(t * scale_factor + 0.5)
    size = (rs + 31) // 32 * 32
    x = ops.resize_half_pixel(tiles_u8.float().permute(0, 3, 1, 2), (rs, rs)).permute(0, 2, 3, 1)
    mean = torch.tensor(IMG_MEAN, device=x.device)
    std = torch.tensor(IMG_STD, device=x.device)
    x = (x - mean) / std
    if size != rs:
        x = F.pad(x, (0, 0, 0, size - rs, 0, size - rs))
    return x


@torch.no_grad()
def detect(model: nn.Module, tiles_u8: torch.Tensor, scale_factor: float
           ) -> Dict[str, torch.Tensor]:
    """WSI mode on a batch of uint8 tiles: the model, then every detection's
    mask pasted into one int32 label map a tile (``label_map``)."""
    t = tiles_u8.shape[1]
    det = model(prep(tiles_u8, scale_factor))
    det["label_map"] = ops.paste_label_map(det.pop("mask_probs"), det["boxes"], det["valid"],
                                           (t, t), threshold=model.mask_thr_binary)
    return det


def split_results(det: Dict[str, np.ndarray], n: int, with_masks: bool = True):
    """Per-tile dicts of the valid detections (boxes, scores, labels, probs,
    ``ids`` their slots, and with ``with_masks`` each one's binary mask out
    of the label map)."""
    out = []
    for i in range(n):
        valid = det["valid"][i]
        ids = np.nonzero(valid)[0]
        r = dict(boxes=det["boxes"][i][valid], scores=det["scores"][i][valid],
                 labels=det["labels"][i][valid], probs=det["probs"][i][valid], ids=ids,
                 label_map=det["label_map"][i])
        if with_masks:
            r["masks"] = (det["label_map"][i][None] == (ids + 1)[:, None, None]).astype(np.uint8)
        out.append(r)
    return out



@torch.no_grad()
def mask_probs_at(model: nn.Module, tiles_u8: torch.Tensor, dets, scale_factor: float):
    """The reference's masks for given detections: ``dets`` per tile (boxes
    in the tile frame, labels) → (probabilities (B, D, 28, 28), boxes
    (B, D, 4), valid (B, D)) from the reference's own features."""
    b = tiles_u8.shape[0]
    d = max(1, max(len(x["boxes"]) for x in dets))
    dev = tiles_u8.device
    boxes = torch.zeros((b, d, 4), device=dev)
    labels = torch.zeros((b, d), dtype=torch.long, device=dev)
    valid = torch.zeros((b, d), dtype=torch.bool, device=dev)
    for i, x in enumerate(dets):
        n = len(x["boxes"])
        boxes[i, :n] = torch.as_tensor(np.asarray(x["boxes"], np.float32), device=dev)
        labels[i, :n] = torch.as_tensor(np.asarray(x["labels"], np.int64), device=dev)
        valid[i, :n] = True
    return model.mask_probs(prep(tiles_u8, scale_factor), boxes, labels), boxes, valid


def pasted_probs(probs: torch.Tensor, boxes: torch.Tensor, out_shape) -> torch.Tensor:
    """One tile's (D, 28, 28) probabilities pasted full-frame → (D, H, W),
    the paste's interpolation before its threshold."""
    h, w = out_shape
    py = ops._paste_matrix(boxes[:, 1].float(), boxes[:, 3].float(), h, probs.shape[-1])
    px = ops._paste_matrix(boxes[:, 0].float(), boxes[:, 2].float(), w, probs.shape[-1])
    return py @ probs.float() @ px.transpose(-1, -2)
