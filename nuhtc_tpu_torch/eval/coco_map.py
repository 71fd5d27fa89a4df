"""COCO-protocol mAP / AR evaluation (bbox + segm + proposal); port of
nuhtc_tpu/eval/coco_map.py, numpy only.

Replaces the reference's pycocotools COCOeval dependency (used by
WSICocoDataset.evaluate's 'bbox'/'segm'/'proposal' metrics via mmdet) with a
self-contained implementation of the COCO matching protocol: per-class,
per-IoU-threshold greedy matching of score-sorted detections capped at
``max_dets`` per image (COCOeval maxDets=100 for the headline mAP),
101-point interpolated AP, averaged over IoU 0.50:0.95.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0, 1, 101)


def _box_iou(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    a2 = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-9)


def _match_image(iou: np.ndarray, thr: float):
    """Greedy COCO matching for one image/class. Returns (dt_matched bool,
    gt_matched bool) in dt score order (iou rows already sorted). The scan
    over detections is inherently sequential; the per-row best-gt pick is
    vectorized."""
    nd, ng = iou.shape
    gt_taken = np.zeros(ng, bool)
    dt_m = np.zeros(nd, bool)
    for d in range(nd):
        row = np.where(gt_taken, -1.0, iou[d])
        j = int(np.argmax(row)) if ng else -1
        if ng and row[j] >= thr:
            gt_taken[j] = True
            dt_m[d] = True
    return dt_m, gt_taken


def evaluate_map(
    per_image: List[Dict],  # each: {"dt_boxes", "dt_scores", "dt_labels", "gt_boxes", "gt_labels", optional "iou_fn"}
    num_classes: int,
    iou_fn=None,  # optional callable(image_entry, dt_idx, gt_idx sets) → iou matrix (for masks)
    max_dets: int = 100,  # COCOeval maxDets for the headline mAP
) -> Dict[str, float]:
    """Returns mAP, mAP_50, mAP_75 (+ per-class AP)."""
    iou_thrs = IOU_THRS
    ap = np.full((len(iou_thrs), num_classes), np.nan)
    for c in range(num_classes):
        # gather all detections/gts of class c
        n_gt = 0
        all_matches = []  # per image: (scores, dt_m (T, nd))
        for img in per_image:
            dsel = img["dt_labels"] == c
            gsel = img["gt_labels"] == c
            scores = img["dt_scores"][dsel]
            order = np.argsort(-scores, kind="stable")[:max_dets]
            scores = scores[order]
            n_gt += int(gsel.sum())
            if iou_fn is not None:
                iou = iou_fn(img, dsel, gsel)
                iou = iou[order] if iou.size else iou
            else:
                iou = _box_iou(img["dt_boxes"][dsel][order], img["gt_boxes"][gsel])
            dt_m = np.zeros((len(iou_thrs), len(scores)), bool)
            for t, thr in enumerate(iou_thrs):
                dt_m[t], _ = _match_image(iou, thr)
            all_matches.append((scores, dt_m))
        if n_gt == 0:
            continue
        scores = np.concatenate([m[0] for m in all_matches]) if all_matches else np.zeros(0)
        if len(scores) == 0:
            ap[:, c] = 0.0
            continue
        order = np.argsort(-scores, kind="stable")
        for t in range(len(iou_thrs)):
            matched = np.concatenate([m[1][t] for m in all_matches])[order]
            tp = np.cumsum(matched)
            fp = np.cumsum(~matched)
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-9)
            # monotone precision envelope
            precision = np.maximum.accumulate(precision[::-1])[::-1]
            # 101-point interpolation
            idxs = np.searchsorted(recall, RECALL_THRS, side="left")
            prec_at = np.where(idxs < len(precision), precision[np.minimum(idxs, len(precision) - 1)], 0.0)
            ap[t, c] = prec_at.mean()

    # index IoU 0.50/0.75 by value so overridden IOU_THRS (e.g.
    # coco_error_analysis' single-threshold re-eval) keeps working
    def _ap_at(v: float) -> float:
        hits = np.where(np.isclose(iou_thrs, v))[0]
        return float(np.nanmean(ap[hits[0]])) if len(hits) else float("nan")

    out = {
        "mAP": float(np.nanmean(ap)),
        "mAP_50": _ap_at(0.5),
        "mAP_75": _ap_at(0.75),
    }
    for c in range(num_classes):
        out[f"AP_class_{c}"] = float(np.nanmean(ap[:, c]))
    return out


def _match_image_ignore(iou: np.ndarray, thr: float, gt_ignore: np.ndarray):
    """COCOeval-style greedy matching with ignore semantics for one
    image/class (pycocotools COCOeval.evaluateImg behavior spec): gts are
    visited unignored-first; once a detection holds an unignored match it
    never trades it for an ignored one; ignored gts act like crowds (matched
    without being consumed, the detection becomes ignored). Returns
    (dt_matched, dt_ignored, gt_matched)."""
    nd, ng = iou.shape
    order = np.argsort(gt_ignore, kind="stable")  # unignored gts first
    gt_taken = np.zeros(ng, bool)
    dt_m = np.zeros(nd, bool)
    dt_ig = np.zeros(nd, bool)
    for d in range(nd):
        best, best_iou = -1, min(thr, 1 - 1e-10)
        for g in order:
            if gt_taken[g] and not gt_ignore[g]:
                continue
            if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                break
            if iou[d, g] < best_iou:
                continue
            best_iou = iou[d, g]
            best = g
        if best == -1:
            continue
        dt_ig[d] = bool(gt_ignore[best])
        if not gt_ignore[best]:
            gt_taken[best] = True
            dt_m[d] = True
    return dt_m, dt_ig, gt_taken


def pr_curves(
    per_image: List[Dict],
    num_classes: int,
    iou_thrs: Sequence[float],
    area_rngs: Sequence[Sequence[float]] = ((0.0, 1e10),),
    max_dets: int = 100,
    gt_ignore_key: str = "gt_ignore",
    iou_fn=None,  # optional callable(image_entry, dsel, gsel) → iou matrix (masks)
) -> np.ndarray:
    """COCOeval ``eval['precision']``-shaped PR curves: (T, R, K, A) —
    precision at the 101 recall thresholds per IoU threshold, class, and
    area range (behavior spec: pycocotools COCOeval.accumulate; used by the
    reference's coco_error_analysis.py:262-296 allowed-error progression).

    Area is box area (the reference tool feeds detection jsons whose
    ``area`` equals the box/segment area; for nuclei the distinction is
    immaterial at the plot level). Entries may carry an optional per-gt
    ``gt_ignore`` bool array (the tool's confusion-forgiveness relabeling);
    gts outside the area range are additionally ignored, and unmatched
    detections outside the range are excluded, per COCO protocol.
    Classes with zero unignored gts get -1 (COCOeval's sentinel)."""
    iou_thrs = np.asarray(iou_thrs, np.float64)
    T, K, A, R = len(iou_thrs), num_classes, len(area_rngs), len(RECALL_THRS)
    ps = np.full((T, R, K, A), -1.0)

    def box_area(b):
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    for c in range(K):
        per_img_cls = []
        for img in per_image:
            dsel = img["dt_labels"] == c
            gsel = img["gt_labels"] == c
            scores = img["dt_scores"][dsel]
            order = np.argsort(-scores, kind="stable")[:max_dets]
            dt_boxes = img["dt_boxes"][dsel][order]
            gt_boxes = img["gt_boxes"][gsel]
            base_ig = (
                np.asarray(img[gt_ignore_key])[gsel]
                if gt_ignore_key in img
                else np.zeros(len(gt_boxes), bool)
            )
            if iou_fn is not None:
                iou = iou_fn(img, dsel, gsel)
                iou = iou[order] if iou.size else iou
            else:
                iou = _box_iou(dt_boxes, gt_boxes)
            dt_area = (
                np.asarray(img["dt_areas"])[dsel][order]
                if "dt_areas" in img
                else box_area(dt_boxes)
            )
            gt_area = (
                np.asarray(img["gt_areas"])[gsel]
                if "gt_areas" in img
                else box_area(gt_boxes)
            )
            per_img_cls.append((scores[order], iou, base_ig, dt_area, gt_area))
        for a, (lo, hi) in enumerate(area_rngs):
            n_gt = 0
            scores_all, match_all, ig_all = [], [], []
            for scores, iou, base_ig, dt_area, gt_area in per_img_cls:
                gt_ig = base_ig | (gt_area < lo) | (gt_area > hi)
                n_gt += int((~gt_ig).sum())
                dt_out = (dt_area < lo) | (dt_area > hi)
                dt_m = np.zeros((T, len(scores)), bool)
                dt_ig = np.zeros((T, len(scores)), bool)
                for t, thr in enumerate(iou_thrs):
                    m, ig, _ = _match_image_ignore(iou, thr, gt_ig)
                    dt_m[t] = m
                    dt_ig[t] = ig | (~m & dt_out)
                scores_all.append(scores)
                match_all.append(dt_m)
                ig_all.append(dt_ig)
            if n_gt == 0:
                continue
            scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
            order = np.argsort(-scores, kind="stable")
            for t in range(T):
                matched = np.concatenate([m[t] for m in match_all])[order]
                ignored = np.concatenate([g[t] for g in ig_all])[order]
                matched, keep = matched[~ignored], ~ignored
                if not keep.any():
                    ps[t, :, c, a] = 0.0
                    continue
                tp = np.cumsum(matched)
                fp = np.cumsum(~matched)
                recall = tp / n_gt
                precision = tp / np.maximum(tp + fp, 1e-9)
                precision = np.maximum.accumulate(precision[::-1])[::-1]
                idxs = np.searchsorted(recall, RECALL_THRS, side="left")
                ps[t, :, c, a] = np.where(
                    idxs < len(precision),
                    precision[np.minimum(idxs, len(precision) - 1)],
                    0.0,
                )
    return ps


def proposal_recall(
    per_image: List[Dict], proposal_nums: Sequence[int] = (100, 300, 1000)
) -> Dict[str, float]:
    """Class-agnostic average recall AR@N over IoU 0.5:0.95. The IoU matrix
    is computed once per image at max(N) and sliced for the smaller caps."""
    nums = sorted(proposal_nums)
    per_n_tp = {n: np.zeros(len(IOU_THRS), np.int64) for n in nums}
    total = 0
    for img in per_image:
        order = np.argsort(-img["dt_scores"], kind="stable")[: nums[-1]]
        iou = _box_iou(img["dt_boxes"][order], img["gt_boxes"])
        total += iou.shape[1]
        if not iou.size:
            continue
        for n in nums:
            best = iou[:n].max(axis=0) if len(iou[:n]) else np.zeros(iou.shape[1])
            per_n_tp[n] += (best[None, :] >= IOU_THRS[:, None]).sum(axis=1)
    out = {}
    for n in proposal_nums:
        out[f"AR@{n}"] = float(np.mean(per_n_tp[n] / max(total, 1)))
    return out
