"""NuHTC detector, batched inference (port of nuhtc_tpu/models/detector.py).

The Hybrid Task Cascade with component ("watershed") proposals:

  img (B, H, W, 3) → Swin-T → FPN → RPN proposals → fused semantic head →
  component proposals, prepended → 3 cascade stages (attention RoI features
  + semantic RoI features → Shared2FC head, DeltaXYWH refinement between
  stages) → stage-averaged Seesaw scores → multiclass NMS (score 0.35, the
  top 2048 candidates, IoU 0.5, top 500) → mask head on the detections.

Three RoI-head families, as ``build_detector`` picks them from the config:
``lite`` (``HybridTaskCascadeRoIHead_Lite``) has one mask head, at the final
stage; the full cascade (``lite=False``, ``HybridTaskCascadeRoIHead_Cus``)
has a mask head per stage, chained by HTC's info-flow (each head's
``conv_res`` takes the previous head's feature), trained at every stage and
sigmoid-averaged at test; ``lite_fuse`` (``_Lite_Fuse``) adds the n-class
``HTCSegBranch``, whose per-class watershed instances ``fuse_test`` returns.

Outputs are padded to fixed shapes, as in the JAX package. The backbone
and the neck are any registered ones (``backbone``, ``neck``; else
``backbone_cfg``'s Swin and an FPN of ``fpn_channels``: ``models/parts.py``),
the heads at the neck's channels.

``compute_losses`` is the supervised train path (port of
nuhtc_tpu/models/detector.py:539-865 with ``exact_rois=True``: the port
computes the exact RoIAlign semantics, never the TPU's banded extraction):
RPN assign/sample/losses, train-budget proposals, the semantic Dice loss,
the seg branch's ``loss_binary_seg`` (and with ``fuse_aux_losses`` its
distance and global-class losses), component proposals injected from the
detached semantic logits, three interleaved cascade stages with
re-assignment (random, instance-balanced or OHEM sampler), and the mask
Dice loss at the final stage (at every stage for the full cascade). Boxes
are detached where the JAX package stops gradients; every RoI feature goes
through ``roi_align_sum``, whose gradient on the card is K4's backward.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from nuhtc_tpu_torch.models import losses as L
from nuhtc_tpu_torch.models.bbox_head import Shared2FCBBoxHeadWithProb, seesaw_activation
from nuhtc_tpu_torch.models.extra_heads import HTCSegBranch, soft_distance_target
from nuhtc_tpu_torch.models.mask_head import FusedSemanticHead, HTCMaskHead
from nuhtc_tpu_torch.models.parts import build_backbone_neck
from nuhtc_tpu_torch.models.roi_extractor import stage_roi_features
from nuhtc_tpu_torch.models.rpn_head import RPNHead, rpn_proposals
from nuhtc_tpu_torch.ops import boxes as box_ops
from nuhtc_tpu_torch.ops import nms as nms_ops
from nuhtc_tpu_torch.ops.anchors import grid_anchors
from nuhtc_tpu_torch.ops.components import component_proposals_batched, resize_align_corners
from nuhtc_tpu_torch.ops.mask_paste import paste_masks
from nuhtc_tpu_torch.ops.watershed import watershed_segmentation
from nuhtc_tpu_torch.parallel import mesh as P
from nuhtc_tpu_torch.train import samplers as S
from nuhtc_tpu_torch.train import targets as T
from nuhtc_tpu_torch.utils.profiling import span

# per-stage DeltaXYWH stds (reference config)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))
# train recipe of the lite head (reference config; fixed in the JAX package)
STAGE_IOU = (0.5, 0.6, 0.7)  # pos = neg = min_pos IoU of each stage's assigner
STAGE_LOSS_WEIGHTS = (1.0, 0.5, 0.25)
RPN_SAMPLES, RCNN_SAMPLES, MASK_SAMPLES = 1024, 1024, 256
TRAIN_NMS_PRE, TRAIN_MAX_PER_IMG = 6000, 3000
SAMPLERS = ("random", "instance_balanced", "ohem")


class RoIHead(nn.Module):
    """Holds the RoI-stage heads under the reference's ``roi_head.*`` names:
    one ``mask_head`` (lite) or a ModuleList of one per stage, stage 0
    without ``conv_res`` (``roi_head.mask_head.{0,1,2}.*``), and with
    ``lite_fuse`` the ``seg_branch``."""

    def __init__(self, num_classes: int, channels: int, num_stages: int, lite: bool = True,
                 lite_fuse: bool = False):
        super().__init__()
        self.semantic_head = FusedSemanticHead(in_channels=channels, conv_out_channels=channels)
        self.bbox_head = nn.ModuleList(
            Shared2FCBBoxHeadWithProb(num_classes=num_classes, in_channels=channels)
            for _ in range(num_stages))
        if lite:
            self.mask_head = HTCMaskHead(in_channels=channels, conv_out_channels=channels,
                                         num_classes=num_classes)
        else:
            self.mask_head = nn.ModuleList(
                HTCMaskHead(in_channels=channels, conv_out_channels=channels,
                            num_classes=num_classes, with_conv_res=stage > 0)
                for stage in range(num_stages))
        if lite_fuse:
            self.seg_branch = HTCSegBranch(in_channels=channels, conv_out_channels=channels,
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
                 nms_candidates: int = 2048, backbone_cfg: dict | None = None,
                 rcnn_sampler: str = "random", lite: bool = True, lite_fuse: bool = False,
                 fuse_max_instances: int = 256, fuse_aux_losses: bool = False,
                 backbone: dict | None = None, neck: dict | None = None):
        super().__init__()
        if rcnn_sampler not in SAMPLERS:
            raise ValueError(f"NuHTC: rcnn_sampler must be one of {SAMPLERS}, not {rcnn_sampler!r}")
        self.rcnn_sampler = rcnn_sampler
        self.num_classes, self.strides, self.num_stages = num_classes, tuple(strides), num_stages
        self.attn_start_level, self.attn_thres = attn_start_level, attn_thres
        self.rpn_nms_pre, self.rpn_max_per_img = rpn_nms_pre, rpn_max_per_img
        self.rpn_nms_iou, self.rpn_min_bbox_size = rpn_nms_iou, rpn_min_bbox_size
        self.rcnn_score_thr, self.rcnn_nms_iou = rcnn_score_thr, rcnn_nms_iou
        self.rcnn_max_per_img, self.mask_thr_binary = rcnn_max_per_img, mask_thr_binary
        self.watershed_proposal, self.watershed_max = watershed_proposal, watershed_max
        self.watershed_min_area, self.scale_factor = watershed_min_area, scale_factor
        self.nms_candidates = nms_candidates
        self.lite, self.lite_fuse = lite, lite_fuse
        self.fuse_max_instances, self.fuse_aux_losses = fuse_max_instances, fuse_aux_losses
        self.backbone, self.neck = build_backbone_neck(backbone, neck, backbone_cfg, fpn_channels)
        channels = self.neck.out_channels
        self.rpn_head = RPNHead(in_channels=channels, feat_channels=channels)
        self.roi_head = RoIHead(num_classes, channels, num_stages, lite, lite_fuse)

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
        """boxes (B, D, 4) in the network-input frame → mask probs (B, D, 28,
        28). The full cascade runs every stage's head on the same features,
        chained by info-flow, and averages their sigmoids."""
        b, d, _ = boxes.shape
        mf = self._roi_features(feats, semantic_feat, boxes, 14, 0, None)
        mf = mf.reshape(b * d, *mf.shape[2:])
        if self.lite:
            probs = torch.sigmoid(self.roi_head.mask_head(mf)[..., 0])
        else:
            last, probs = None, 0.0
            for head in self.roi_head.mask_head:
                logits, last = head(mf, res_feat=last, return_feat=True)
                probs = probs + torch.sigmoid(logits[..., 0])
            probs = probs / float(self.num_stages)
        return probs.reshape(b, d, 28, 28)

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

    def features(self, img: torch.Tensor, generator: torch.Generator | None = None
                 ) -> Tuple[torch.Tensor, ...]:
        """img (B, H, W, 3) normalized → the 4-level FPN pyramid, (B, h, w, C)
        each, contiguous (the RoI kernel reads them), with gradients;
        ``generator`` draws the backbone's stochastic depth in training mode."""
        return tuple(f.contiguous() for f in self.neck(self.backbone(img, generator)))

    @torch.no_grad()
    def extract_feats(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """img (B, H, W, 3) normalized → the 4-level FPN pyramid, (B, h, w, C) each."""
        with span("model.backbone"):
            x = self.backbone(img)
        with span("model.neck"):
            return tuple(self.neck(x))

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
        feats = tuple(f.contiguous() for f in self.extract_feats(img))

        with span("model.rpn_head"):
            cls_scores, bbox_preds = self.rpn_head(feats)
        with span("model.rpn_proposals"):
            prop_boxes, _, prop_valid = rpn_proposals(
                cls_scores, bbox_preds, img_shape, strides=self.strides,
                nms_pre=self.rpn_nms_pre, max_per_img=self.rpn_max_per_img,
                nms_iou=self.rpn_nms_iou, min_bbox_size=self.rpn_min_bbox_size)

        with span("model.semantic"):
            semantic_logits, semantic_feat = self.roi_head.semantic_head(feats)
            semantic_feat = semantic_feat.contiguous()
        rois, rois_valid = prop_boxes, prop_valid
        if self.watershed_proposal:
            with span("model.components"):
                ws_boxes5, ws_valid = component_proposals_batched(
                    semantic_logits[..., 0], img_shape, max_components=self.watershed_max,
                    min_area=self.watershed_min_area)
            rois = torch.cat([ws_boxes5[..., :4], prop_boxes], dim=1)
            rois_valid = torch.cat([ws_valid, prop_valid], dim=1)

        ms_scores = []
        bbox_pred = None
        for stage in range(self.num_stages):
            with span("model.bbox_stage"):
                cls_score, bbox_pred = self._bbox_stage(stage, feats, semantic_feat, rois)
            ms_scores.append(cls_score)
            if stage < self.num_stages - 1:
                rois = box_ops.delta2bbox(rois, bbox_pred, stds=STAGE_STDS[stage],
                                          max_shape=img_shape)
        scores_act = seesaw_activation(sum(ms_scores) / float(len(ms_scores)))
        bboxes = box_ops.delta2bbox(rois, bbox_pred, stds=STAGE_STDS[self.num_stages - 1],
                                    max_shape=img_shape)
        with span("model.multiclass_nms"):
            det = self._multiclass_nms(bboxes / self.scale_factor, scores_act, rois_valid)
        with span("model.mask_head"):
            det["mask_probs"] = self._mask_forward(feats, semantic_feat,
                                                   det["boxes"] * self.scale_factor)
        return det

    @torch.no_grad()
    def fuse_test(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``_Lite_Fuse`` inference: the seg branch over the image and the
        semantic feature, upsampled to the original frame (bilinear,
        ``align_corners=True``), then the per-class watershed of every class
        map of the batch at once (one K3 launch on the card). The reference
        returns these instances alone. img (B, H, W, 3) → dict: fuse_boxes
        (B, C, K, 5) [x1, y1, x2+1, y2+1, 0.36] in the original frame,
        fuse_valid (B, C, K), fuse_inst (B, C, Ho, Wo) int32 instance maps,
        fuse_roots (B, C, K) (instance k is ``fuse_inst == fuse_roots + 1``)."""
        if not self.lite_fuse:
            raise ValueError("model was built with lite_fuse=False")
        b, h, w, _ = img.shape
        oh, ow = int(round(h / self.scale_factor)), int(round(w / self.scale_factor))
        _, semantic_feat = self.roi_head.semantic_head(self.extract_feats(img))
        _, seg_pred, _, _ = self.roi_head.seg_branch(img, semantic_feat)
        seg_ori = resize_align_corners(seg_pred.permute(0, 3, 1, 2), (oh, ow))
        c = seg_ori.shape[1]
        boxes5, valid, inst, roots = watershed_segmentation(
            seg_ori.reshape(b * c, oh, ow), max_instances=self.fuse_max_instances,
            min_area=self.watershed_min_area)
        return {"fuse_boxes": boxes5.reshape(b, c, -1, 5), "fuse_valid": valid.reshape(b, c, -1),
                "fuse_inst": inst.reshape(b, c, oh, ow), "fuse_roots": roots.reshape(b, c, -1)}


    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    def _assign_sample(self, generator, props, props_valid, batch, stage: int, num: int,
                       sampler: str):
        """Candidates = the gts then ``props``; stage-IoU assignment and the
        sampler → (rois (B, num, 4), SampleResult, is_gt (B, num))."""
        gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]
        thr = STAGE_IOU[stage]
        cand = torch.cat([gt_boxes, props], dim=1)
        cand_valid = torch.cat([gt_valid, props_valid], dim=1)
        assign = T.max_iou_assign(cand, cand_valid, gt_boxes, gt_valid, batch["gt_labels"],
                                  pos_thr=thr, neg_thr=thr, min_pos_iou=thr)
        if sampler == "instance_balanced":
            samp = S.instance_balanced_sample(generator, assign, num, 0.25, self.num_classes,
                                              gt_boxes.shape[1])
        else:
            samp = T.random_sample(generator, assign, num, 0.25, self.num_classes)
        rois = cand.gather(1, samp.idx[..., None].expand(-1, -1, 4))
        return rois, samp, samp.is_pos & (samp.idx < gt_boxes.shape[1])

    def _ohem_select(self, rois, cls_score, bbox_pred, samp, is_gt):
        """OHEMSampler_HTC: the pool's candidates ranked by their current
        seesaw classification loss (detached); the head outputs of the pool
        are gathered, so the head runs once per stage."""
        probs = seesaw_activation(cls_score.detach())
        lbl = samp.labels.clamp(0, self.num_classes)  # negatives → the background column
        ploss = -torch.log(probs.gather(2, lbl[..., None])[..., 0] + 1e-12)
        pool = T.AssignResult(
            gt_inds=torch.where(samp.is_pos, samp.gt_inds + 1, torch.where(samp.valid, 0, -1)),
            max_iou=torch.zeros_like(ploss),
            labels=torch.where(samp.is_pos, samp.labels, -1))
        sel = S.ohem_sample(ploss, pool, RCNN_SAMPLES, 0.25, self.num_classes)

        def take(x):
            idx = sel.idx if x.dim() == 2 else sel.idx[..., None].expand(-1, -1, x.shape[-1])
            return x.gather(1, idx)

        samp = T.SampleResult(idx=take(samp.idx), is_pos=sel.is_pos, valid=sel.valid,
                              gt_inds=sel.gt_inds, labels=sel.labels)
        return take(rois), take(cls_score), take(bbox_pred), samp, take(is_gt) & sel.is_pos

    def _mask_train_forward(self, feats, semantic_feat, boxes, stage: int):
        """boxes (B, S, 4) → mask logits (B, S, 28, 28) of the lite head (no
        info-flow, as the reference _Lite._mask_forward_train), or of stage
        ``stage``'s head of the full cascade, whose info-flow input the heads
        before it compute feature-only on the same RoI features."""
        b, s, _ = boxes.shape
        mf = self._roi_features(feats, semantic_feat, boxes, 14, 0, None)
        mf = mf.reshape(b * s, *mf.shape[2:])
        if self.lite:
            logits = self.roi_head.mask_head(mf)
        else:
            heads, last = self.roi_head.mask_head, None
            for i in range(stage):
                last = heads[i](mf, res_feat=last, return_logits=False, return_feat=True)
            logits = heads[stage](mf, res_feat=last)
        return logits[..., 0].reshape(b, s, 28, 28)

    def _pasted_max(self, batch, keep, out_shape, distance: bool) -> torch.Tensor:
        """Per image, the pixelwise max over the kept gt instances of their
        patches pasted into the input frame: the soft pasted probabilities,
        or with ``distance`` the ``soft_distance_target`` of each binary
        mask → (B, H, W). f32 products even under autocast, as the mask
        targets'."""
        out = []
        with torch.autocast(keep.device.type, enabled=False):
            for gtb, gtp, k in zip(batch["gt_boxes"], batch["gt_patches"], keep):
                full = paste_masks(gtp, gtb, out_shape, threshold=0.5 if distance else -1.0)
                full = full.float() * k.float()[:, None, None]
                out.append((soft_distance_target(full) if distance else full).amax(dim=0))
        return torch.stack(out)

    def _seg_branch_losses(self, img, semantic_feat, batch, losses):
        """The ``_Lite_Fuse`` seg branch's ``loss_binary_seg`` (and with
        ``fuse_aux_losses`` ``loss_dist`` and ``loss_global_cls``): the
        n-class sigmoid CE against the stride-1 class map of ``gt_semantic``;
        pixels of box-only instances (``gt_ismask`` 0) are left out."""
        h, w = img.shape[1:3]
        gt_sem = batch["gt_semantic"]
        _, seg_pred, seg_dist, seg_cls = self.roi_head.seg_branch(img, semantic_feat)
        fac = h // gt_sem.shape[1]
        sem_up = gt_sem.repeat_interleave(fac, dim=1).repeat_interleave(fac, dim=2)
        cls_ids = torch.arange(1, self.num_classes + 1, device=img.device)
        gt_seg_c = (sem_up[..., None] == cls_ids).float()
        ismask, gt_valid = batch.get("gt_ismask"), batch["gt_valid"]
        pos_mask = 1.0
        if ismask is not None:
            with torch.no_grad():
                union = self._pasted_max(batch, (ismask < 0.5) & gt_valid, (h, w), False)
                pos_mask = (1.0 - union.clamp(0.0, 1.0))[..., None]
        losses["loss_binary_seg"] = 0.2 * P.share((L.sigmoid_ce(seg_pred, gt_seg_c) * pos_mask
                                                   ).mean())
        if not self.fuse_aux_losses:
            return
        # the instance-by-instance distance keeps the valley between touching nuclei
        with torch.no_grad():
            keep = gt_valid if ismask is None else gt_valid & (ismask > 0.5)
            gt_dist = self._pasted_max(batch, keep, (h, w), True)
        losses["loss_dist"] = 0.2 * P.share(((torch.sigmoid(seg_dist)[..., None]
                                              - gt_dist[..., None]).abs() * pos_mask).mean())
        labels = torch.where(gt_valid, batch["gt_labels"], 0).long()
        present = torch.zeros((labels.shape[0], self.num_classes), device=img.device)
        present = present.scatter_reduce(1, labels, gt_valid.float(), reduce="amax")
        losses["loss_global_cls"] = 0.2 * P.share(L.sigmoid_ce(seg_cls, present).mean())

    def compute_losses(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                       cum_samples: torch.Tensor, generator: torch.Generator | None = None):
        """The train losses of one batch.

        img (B, H, W, 3) normalized; batch: gt_boxes (B, G, 4) f32, gt_labels
        (B, G) int, gt_valid (B, G) bool, gt_patches (B, G, M, M) f32,
        gt_semantic (B, Hs, Ws) int, optionally gt_ismask (B, G) f32;
        cum_samples (num_stages, C) seesaw counts; ``generator`` draws the
        samplers' uniforms and the backbone's stochastic depth, in this order:
        backbone, RPN sampler, then per stage the sample and the re-sample.
        Returns (losses dict with "total", new cum_samples).

        Inside a data-parallel step (``parallel.mesh.data_parallel``, which
        the train steps enter) the losses are this rank's share of the global
        batch's: each normalizer (the RPN's sample count, each stage's, the
        Dice weights, the seesaw counts) is summed over the ranks, each mean
        over images or pixels divided by the world size, and the draws are
        the global batch's rows of this rank."""
        gt_boxes, gt_labels, gt_valid = batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"]
        b = gt_boxes.shape[0]
        h, w = img.shape[1:3]
        img_shape = (h, w)
        dev = img.device
        feats = self.features(img, generator)
        losses: Dict[str, torch.Tensor] = {}

        # ---- RPN ----------------------------------------------------------
        cls_scores, bbox_preds = self.rpn_head(feats)
        sizes = [tuple(cs.shape[1:3]) for cs in cls_scores]
        anchors = torch.from_numpy(np.concatenate(
            grid_anchors(sizes, self.strides, (4,), (0.5, 1.0, 2.0)))).to(dev)
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
                nms_pre=TRAIN_NMS_PRE, max_per_img=TRAIN_MAX_PER_IMG,
                nms_iou=self.rpn_nms_iou, min_bbox_size=self.rpn_min_bbox_size)

        # ---- semantic head -------------------------------------------------
        semantic_logits, semantic_feat = self.roi_head.semantic_head(feats)
        semantic_feat = semantic_feat.contiguous()
        sem_target = (batch["gt_semantic"] != 0).float()
        losses["loss_semantic_seg"] = L.dice_loss(torch.sigmoid(semantic_logits[..., 0]),
                                                  sem_target)
        if self.lite_fuse:
            self._seg_branch_losses(img, semantic_feat, batch, losses)

        # ---- component proposals from the detached semantic logits ----------
        proposals, proposals_valid = prop_boxes, prop_valid
        if self.watershed_proposal:
            with torch.no_grad():
                ws_boxes5, ws_valid = component_proposals_batched(
                    semantic_logits[..., 0].detach(), img_shape,
                    max_components=self.watershed_max, min_area=self.watershed_min_area)
            proposals = torch.cat([ws_boxes5[..., :4], prop_boxes], dim=1)
            proposals_valid = torch.cat([ws_valid, prop_valid], dim=1)

        # ---- cascade stages, interleaved ------------------------------------
        sampler = self.rcnn_sampler
        draw_sampler = "random" if sampler == "ohem" else sampler
        pool = 2 * RCNN_SAMPLES if sampler == "ohem" else RCNN_SAMPLES
        ismask = batch.get("gt_ismask")
        new_cum = []
        for stage in range(self.num_stages):
            lw = STAGE_LOSS_WEIGHTS[stage]
            rois, samp, is_gt = self._assign_sample(generator, proposals, proposals_valid,
                                                    batch, stage, pool, draw_sampler)
            cls_score, bbox_pred = self._bbox_stage(stage, feats, semantic_feat, rois)
            cls_score, bbox_pred = cls_score.float(), bbox_pred.float()
            if sampler == "ohem":
                rois, cls_score, bbox_pred, samp, is_gt = self._ohem_select(
                    rois, cls_score, bbox_pred, samp, is_gt)
            bbox_tgt, bbox_w = T.encode_stage_targets(rois, samp, gt_boxes, STAGE_STDS[stage])
            flat_w = samp.valid.reshape(-1).float()
            loss_cls, loss_obj, cum = L.seesaw_loss(
                cls_score.reshape(-1, self.num_classes + 2), samp.labels.reshape(-1), flat_w,
                cum_samples[stage])
            avg = P.global_sum(flat_w.sum()).clamp(min=1.0)
            loss_bbox = (L.smooth_l1(bbox_pred, bbox_tgt, beta=1.0) * bbox_w[..., None]
                         ).sum() / avg
            losses[f"s{stage}.loss_cls"] = lw * loss_cls
            losses[f"s{stage}.loss_obj"] = lw * loss_obj
            losses[f"s{stage}.loss_bbox"] = lw * loss_bbox
            new_cum.append(cum)

            # refine, then re-assign and re-sample at the target size
            refined = box_ops.delta2bbox(rois, bbox_pred, stds=STAGE_STDS[stage],
                                         max_shape=img_shape).detach()
            refined_valid = samp.valid & ~is_gt
            rois2, samp2, _ = self._assign_sample(generator, refined, refined_valid, batch,
                                                  stage, RCNN_SAMPLES, draw_sampler)
            proposals, proposals_valid = refined, refined_valid

            # the mask loss at the final stage (lite), at every stage (full cascade)
            if not self.lite or stage == self.num_stages - 1:
                mrois = rois2[:, :MASK_SAMPLES]
                mpos = samp2.is_pos[:, :MASK_SAMPLES]
                mgt = samp2.gt_inds[:, :MASK_SAMPLES]
                mask_logits = self._mask_train_forward(feats, semantic_feat, mrois, stage)
                mtgt = T.mask_targets_from_patches(mrois, mgt, gt_boxes, batch["gt_patches"])
                mw = mpos.float()
                if ismask is not None:  # box-only instances give no mask loss
                    mw = mw * ismask.float().gather(1, mgt)
                losses[f"s{stage}.loss_mask"] = lw * L.dice_loss(
                    torch.sigmoid(mask_logits.float().reshape(-1, 28, 28)),
                    mtgt.reshape(-1, 28, 28), weight=mw.reshape(-1))

        losses["total"] = sum(losses.values())
        return losses, torch.stack(new_cum)
