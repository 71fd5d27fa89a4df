"""Dataset-level evaluation: the WSICocoDataset.evaluate equivalent (port of
nuhtc_tpu/eval/evaluate.py).

Mirrors the reference metric engine (nuhtc/datasets/WSI_coco.py:278-760):
fg_thr=0.1 score filter → per-image greedy mask-NMS (RLE IoU > 0.05) →
per-image AJI/AJI+/DQ/SQ/PQ/Dice → class-wise tp/fp/fn/iou aggregation into
mPQ (nanmean of per-image per-class PQ) and mPQ+ (PQ of summed totals) →
confusion matrix → optional format conversion (pannuke / conic / consep
instance maps, the last through ``scipy.io.savemat``) and overlays
(``utils.visualize.draw_detections``, written by ``utils.imageio.write_png``).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Dict, List, Sequence

import numpy as np

from nuhtc_tpu_torch.eval import stats as S
from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.utils.imageio import write_png
from nuhtc_tpu_torch.utils.visualize import draw_detections


def greedy_nms(scores: np.ndarray, iou_of: Callable[[np.ndarray], np.ndarray],
               thr: float) -> np.ndarray:
    """Greedy suppression, score-descending: ``iou_of(order)`` gives the
    (n, n) IoU of the detections taken in ``order``, and a detection goes
    when its IoU with a kept one of higher score is above ``thr``. Returns
    the kept original indices, in score order."""
    order = np.argsort(scores)[::-1]
    sup = iou_of(order) > thr
    keep = np.ones(len(order), bool)
    for i in np.flatnonzero(sup.any(1)):  # a row with nothing above thr suppresses nothing
        if keep[i]:
            keep[i + 1:] &= ~sup[i, i + 1:]
    return order[keep]


def mask_nms(rles: List[dict], scores: np.ndarray, thr: float = 0.05):
    """Greedy RLE-IoU suppression, score-descending. Returns (kept rles,
    kept original indices)."""
    n = len(rles)
    if n == 0:
        return [], np.zeros(0, np.int64)

    def iou_of(order):
        ordered = [rles[i] for i in order]
        return rle_ops.iou(ordered, ordered, [0] * n)

    kept = greedy_nms(scores, iou_of, thr)
    return [rles[i] for i in kept], kept


def convert_format(
    mask_li: List[dict],
    label_li: np.ndarray,
    height: int,
    width: int,
    num_classes: int,
    data_format: str = "conic",
):
    """Per-image instance maps in pannuke/conic/consep layouts
    (reference WSI_coco.py:863-907)."""
    if data_format == "pannuke":
        out = np.zeros((height, width, num_classes + 1), int)
        if len(mask_li) == 0:
            return out
        masks = np.stack([rle_ops.decode(r) for r in mask_li])
        for c in range(num_classes):
            cls_masks = masks[label_li == c]
            if len(cls_masks) == 0:
                continue
            ids = np.arange(1, len(cls_masks) + 1)
            out[:, :, c] = np.max(cls_masks * ids[:, None, None], axis=0)
        out[:, :, -1] = 1 - np.max(masks, axis=0)
        return out
    out = np.zeros((height, width, 2), int)
    if len(mask_li):
        masks = np.stack([rle_ops.decode(r) for r in mask_li])
        ids = np.arange(1, len(masks) + 1)
        out[:, :, 0] = np.max(masks * ids[:, None, None], axis=0)
        out[:, :, 1] = np.max(masks * (np.asarray(label_li) + 1)[:, None, None], axis=0)
    if data_format == "consep":
        mat = {"inst_map": out[:, :, 0], "inst_type": out[:, :, 1]}
        if len(mask_li):
            bbs = np.stack([rle_ops.toBbox(r) for r in mask_li])
            cent = np.stack([bbs[:, 0] + bbs[:, 2] / 2, bbs[:, 1] + bbs[:, 3] / 2], axis=1)
            mat["inst_centroid"] = cent
            # one entry fewer than there are instances, as the JAX package has it
            mat["inst_uid"] = np.arange(1, len(label_li))
        return mat
    return out


def update_confusion_matrix(cm, iou, gt_labels, pred_labels, tp_iou_thr=0.5):
    """cm: (C+1, C+1); iou: (T, P) pairwise (reference WSI_coco.py:732-747)."""
    true_positives = np.zeros(len(gt_labels), np.int64)
    for i, det_label in enumerate(pred_labels):
        det_match = 0
        for j, gt_label in enumerate(gt_labels):
            if iou[j, i] >= tp_iou_thr:
                det_match += 1
                true_positives[j] += 1
                cm[gt_label, det_label] += 1
        if det_match == 0:
            cm[-1, det_label] += 1
    for num_tp, gt_label in zip(true_positives, gt_labels):
        if num_tp == 0:
            cm[gt_label, -1] += 1


def _save_outputs(dataset, idx, rles, labels, scores, num_classes,
                  save, save_path, data_format, overlay, overlay_score_thr,
                  pred_array):
    """Converted-prediction / overlay artifacts for one image (shared by the
    metric and --format-only paths)."""
    if not (save or overlay):
        return
    info = dataset.img_info(idx)
    if save:
        pm = convert_format(rles, labels, info["height"], info["width"], num_classes, data_format)
        base = os.path.splitext(info["file_name"])[0]
        if data_format == "consep":
            from scipy import io as sio

            sio.savemat(f"{save_path}/{base}.mat", pm)
        else:
            np.save(f"{save_path}/{base}.npy", pm)
            pred_array.append(pm)
    if overlay:
        img = dataset.load_image(idx)
        keep = [i for i, s in enumerate(scores) if s >= overlay_score_thr]
        masks = [rle_ops.decode(rles[i]) for i in keep]
        ov = draw_detections(img, masks, [labels[i] for i in keep],
                             palette=dataset.PALETTE)
        os.makedirs(f"{save_path}/overlay", exist_ok=True)
        base = os.path.splitext(info["file_name"])[0]
        write_png(f"{save_path}/overlay/{base}_overlay.png", ov)


def evaluate_dataset(
    dataset,
    results: Sequence,  # per image: (bbox_results [C×(n,5+)], segm [C×[rle…]])
    fg_thr: float = 0.1,
    nms_thr: float = 0.05,
    save: bool = False,
    save_path: str = "infer",
    data_format: str = "conic",
    overlay: bool = False,
    overlay_score_thr: float = 0.0,  # extra threshold for drawn instances only
    format_only: bool = False,  # write converted preds/overlays, skip metrics
    logger=None,
) -> "OrderedDict[str, float]":
    num_classes = len(dataset.CLASSES)
    stat_res: Dict[str, List[float]] = {}
    mpq_info_list = []
    confusion = np.zeros((num_classes + 1, num_classes + 1))
    pred_array = []

    if save:
        # _Sliced/limit wrappers delegate attributes to the real dataset —
        # use the delegated name so artifact dirs match the reference layout
        ds_name = getattr(dataset, "dataset_name", None) or dataset.__class__.__name__
        save_path = f"{save_path}/{ds_name}"
        os.makedirs(save_path, exist_ok=True)

    assert len(dataset) == len(results)
    for idx, res in enumerate(results):
        bbox_res, segm_res = res
        boxes = np.concatenate(bbox_res) if len(bbox_res) else np.zeros((0, 5))
        labels = np.concatenate(
            [np.full(len(b), c, np.int64) for c, b in enumerate(bbox_res)]
        ) if len(bbox_res) else np.zeros(0, np.int64)
        rles = [m for cls_masks in segm_res for m in cls_masks]

        scores = boxes[:, 4] if len(boxes) else np.zeros(0)
        sel = scores >= fg_thr
        rles = [r for r, s in zip(rles, sel) if s]
        labels = labels[sel]
        scores = scores[sel]

        if len(rles):
            rles, keep_idx = mask_nms(rles, scores, thr=nms_thr)
            labels = labels[keep_idx]
            scores = scores[keep_idx]

        if format_only:
            # reference --format-only: emit the converted predictions without
            # touching annotations or computing any metric
            _save_outputs(dataset, idx, rles, labels, scores, num_classes,
                          save, save_path, data_format, overlay,
                          overlay_score_thr, pred_array)
            continue

        ann = dataset.get_ann_info(idx)
        gt_rles = ann["masks"]
        gt_labels = ann["labels"]

        tables = S.tables_from_rles(gt_rles, rles)
        tmp = S.stat_calc_tables(*tables) if (len(gt_rles) or len(rles)) else None
        if tmp:
            for k, v in tmp.items():
                stat_res.setdefault(k, []).append(v)

        # per-class stats for mPQ
        mpq_info = []
        for c in range(num_classes):
            t_sel = [r for r, l in zip(gt_rles, gt_labels) if l == c]
            p_sel = [r for r, l in zip(rles, labels) if l == c]
            t = S.tables_from_rles(t_sel, p_sel)
            r = S.stat_calc_tables(*t) if (len(t_sel) or len(p_sel)) else None
            if r:
                mpq_info.append([r["tp"], r["fp"], r["fn"], r["iou"]])
            else:
                mpq_info.append([np.nan] * 4)
        mpq_info_list.append(mpq_info)

        if len(gt_rles) and len(rles):
            iou = tables[0] / (tables[1] + 1e-6)
            update_confusion_matrix(confusion, iou, gt_labels, labels)
        elif len(rles):
            for l in labels:
                confusion[-1, l] += 1
        elif len(gt_rles):
            for l in gt_labels:
                confusion[l, -1] += 1

        _save_outputs(dataset, idx, rles, labels, scores, num_classes,
                      save, save_path, data_format, overlay, overlay_score_thr,
                      pred_array)

    if format_only:
        if save and data_format != "consep" and pred_array:
            np.save(f"{save_path}/preds_{data_format}.npy", np.asarray(pred_array))
        return OrderedDict()

    eval_results = OrderedDict()
    for k, v in stat_res.items():
        if k not in ("tp", "fp", "fn", "iou"):
            eval_results[k] = float(np.mean(v))

    if mpq_info_list:
        m = np.asarray(mpq_info_list, float)  # (imgs, C, 4)
        totals = np.nansum(m, axis=0)
        mpq_plus = []
        for c in range(num_classes):
            tp, fp, fn, iou_sum = totals[c]
            dq = tp / (tp + 0.5 * fp + 0.5 * fn + 1e-6)
            sq = iou_sum / (tp + 1e-6)
            eval_results[f"multi_pq+_{c}"] = dq * sq
            mpq_plus.append(dq * sq)
        eval_results["multi_pq+"] = float(np.mean(mpq_plus))

        dq = m[:, :, 0] / (m[:, :, 0] + 0.5 * m[:, :, 1] + 0.5 * m[:, :, 2] + 1e-6)
        sq = m[:, :, 3] / (m[:, :, 0] + 1e-6)
        per_img_pq = dq * sq
        per_class = np.nanmean(per_img_pq, axis=0)
        for c in range(num_classes):
            eval_results[f"multi_pq_{c}"] = float(per_class[c])
        eval_results["multi_pq"] = float(np.mean(per_class))

    if save and data_format != "consep" and pred_array:
        np.save(f"{save_path}/preds_{data_format}.npy", np.asarray(pred_array))

    # normalized confusion matrix (%)
    row_sums = confusion.sum(axis=1, keepdims=True)
    eval_results["confusion_matrix"] = (confusion * 100 / (row_sums + 1e-5)).tolist()

    if logger:
        for k, v in eval_results.items():
            if k != "confusion_matrix":
                logger.info(f"{k}: {v:.4f}")
    return eval_results
