"""Instance-segmentation metrics: PQ / AJI / AJI+ / ensemble Dice (port of
nuhtc_tpu/eval/stats.py, numpy and scipy only; RLE tables through the
port's ``ops.rle``).

Same quantities and edge-case conventions as the reference metric engine
(nuhtc/utils/stats_utils.py:34-507 and nuhtc/datasets/WSI_coco.py:560-705),
reimplemented from the metric definitions (Kirillov PQ, MoNuSeg AJI,
HoVer-Net AJI+/dice2). Core functions operate on pairwise
intersection/union tables so they work identically from label maps, mask
stacks, or RLE lists; IoU uses the reference's ``inter / (union + 1e-6)``.

Notable reference behaviors preserved:
- AJI pairs each GT with its best-IoU pred WITHOUT deduplicating preds
  (a pred's union may be summed multiple times);
- PQ with match_iou ≥ 0.5 uses the unique >thr pairing; < 0.5 uses Hungarian;
- ensemble dice keeps pairs with IoU ≥ 1e-4 and returns 1 whenever NO pair
  survives the threshold — including images with non-empty GT and non-empty
  predictions that simply never overlap (the reference get_fast_dice quirk:
  ti/pi always have equal length, so the "both empty" wording understates it).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from nuhtc_tpu_torch.ops import rle as rle_ops


# --------------------------------------------------------------------------- #
# pairwise tables from different mask representations
# --------------------------------------------------------------------------- #
def tables_from_labelmaps(true: np.ndarray, pred: np.ndarray):
    """Joint-histogram inter/union between contiguous-labeled instance maps."""
    t_max, p_max = int(true.max()), int(pred.max())
    t_areas = np.bincount(true.ravel(), minlength=t_max + 1)[1:].astype(np.float64)
    p_areas = np.bincount(pred.ravel(), minlength=p_max + 1)[1:].astype(np.float64)
    if t_max == 0 or p_max == 0:
        inter = np.zeros((t_max, p_max))
        union = t_areas[:, None] + p_areas[None, :] if (t_max and p_max) else inter.copy()
        return inter, union, t_areas, p_areas
    joint = (true.astype(np.int64) * (p_max + 1) + pred.astype(np.int64)).ravel()
    counts = np.bincount(joint, minlength=(t_max + 1) * (p_max + 1)).reshape(
        t_max + 1, p_max + 1
    )
    inter = counts[1:, 1:].astype(np.float64)
    union = t_areas[:, None] + p_areas[None, :] - inter
    return inter, union, t_areas, p_areas


def tables_from_masks(true_masks: np.ndarray, pred_masks: np.ndarray):
    """(T, H, W) × (P, H, W) binary stacks → inter/union via matmul
    (the reference's mask_iou formulation, WSI_coco.py:660-705)."""
    t = true_masks.reshape(len(true_masks), -1).astype(np.float64)
    p = pred_masks.reshape(len(pred_masks), -1).astype(np.float64)
    inter = t @ p.T
    t_areas = t.sum(1)
    p_areas = p.sum(1)
    union = t_areas[:, None] + p_areas[None, :] - inter
    return inter, union, t_areas, p_areas


def tables_from_rles(true_rles: Sequence[dict], pred_rles: Sequence[dict]):
    """RLE lists → tables via RLE IoU + areas (reference WSI_coco.py:582-588)."""
    t_areas = np.asarray([rle_ops.area(r) for r in true_rles], np.float64)
    p_areas = np.asarray([rle_ops.area(r) for r in pred_rles], np.float64)
    if len(true_rles) == 0 or len(pred_rles) == 0:
        z = np.zeros((len(true_rles), len(pred_rles)))
        return z, z.copy(), t_areas, p_areas
    iou = rle_ops.iou(list(true_rles), list(pred_rles), [0] * len(pred_rles))
    sum_areas = t_areas[:, None] + p_areas[None, :]
    inter = sum_areas * iou / (1 + iou)
    union = sum_areas / (1 + iou)
    return inter, union, t_areas, p_areas


# --------------------------------------------------------------------------- #
# table-based metrics (reference formulas)
# --------------------------------------------------------------------------- #
def pq_from_tables(inter, union, t_areas, p_areas, match_iou: float = 0.5):
    iou = inter / (union + 1e-6)
    nt, npred = iou.shape
    if match_iou >= 0.5:
        if iou.size:
            ti, pi = np.nonzero(iou > match_iou)
            paired_iou = iou[ti, pi]
        else:
            ti = pi = np.zeros(0, np.int64)
            paired_iou = np.zeros(0)
    else:
        if iou.size:
            ti, pi = linear_sum_assignment(-iou)
            keep = iou[ti, pi] > match_iou
            ti, pi = ti[keep], pi[keep]
            paired_iou = iou[ti, pi]
        else:
            ti = pi = np.zeros(0, np.int64)
            paired_iou = np.zeros(0)
    unpaired_t = np.setdiff1d(np.arange(nt), ti)
    unpaired_p = np.setdiff1d(np.arange(npred), pi)
    tp, fp, fn = len(ti), len(unpaired_p), len(unpaired_t)
    dq = tp / (tp + 0.5 * fp + 0.5 * fn) if (tp + fp + fn) > 0 else 0.0
    sq = paired_iou.sum() / (tp + 1e-6)
    return [dq, sq, dq * sq], [list(ti), list(pi), list(unpaired_t), list(unpaired_p)]


def aji_from_tables(inter, union, t_areas, p_areas) -> float:
    """MoNuSeg AJI — greedy best-pred per GT, preds may be reused."""
    if len(t_areas) == 0:
        return 0.0
    if len(p_areas) == 0:
        return 0.0
    iou = inter / (union + 1e-6)
    paired_pred = np.argmax(iou, axis=1)
    best_iou = np.max(iou, axis=1)
    paired_true = np.nonzero(best_iou > 0.0)[0]
    pp = paired_pred[paired_true]
    overall_inter = inter[paired_true, pp].sum()
    overall_union = union[paired_true, pp].sum()
    unpaired_true = np.setdiff1d(np.arange(len(t_areas)), paired_true)
    unpaired_pred = np.setdiff1d(np.arange(len(p_areas)), pp)
    overall_union += t_areas[unpaired_true].sum() + p_areas[unpaired_pred].sum()
    return float(overall_inter / overall_union) if overall_union > 0 else 0.0


def aji_plus_from_tables(inter, union, t_areas, p_areas, paired=None) -> float:
    if len(t_areas) == 0 or len(p_areas) == 0:
        return 0.0
    iou = inter / (union + 1e-6)
    if paired is None:
        ti, pi = linear_sum_assignment(-iou)
    else:
        ti, pi = np.asarray(paired[0], np.int64), np.asarray(paired[1], np.int64)
    keep = iou[ti, pi] > 0.0 if len(ti) else np.zeros(0, bool)
    ti, pi = ti[keep], pi[keep]
    overall_inter = inter[ti, pi].sum()
    overall_union = union[ti, pi].sum()
    unpaired_t = np.setdiff1d(np.arange(len(t_areas)), ti)
    unpaired_p = np.setdiff1d(np.arange(len(p_areas)), pi)
    overall_union += t_areas[unpaired_t].sum() + p_areas[unpaired_p].sum()
    return float(overall_inter / overall_union) if overall_union > 0 else 0.0


def dice2_from_tables(inter, union, t_areas, p_areas, paired=None) -> float:
    """Ensemble dice over paired instances (reference get_fast_dice)."""
    iou = inter / (union + 1e-6)
    if paired is None:
        if iou.size == 0:
            ti = pi = np.zeros(0, np.int64)
        else:
            ti, pi = linear_sum_assignment(-iou)
    else:
        ti, pi = np.asarray(paired[0], np.int64), np.asarray(paired[1], np.int64)
    if len(ti):
        keep = iou[ti, pi] >= 1e-4
        ti, pi = ti[keep], pi[keep]
    if len(ti) == 0:
        # reference get_fast_dice quirk: no surviving pair → 1.0, even when
        # GT and predictions are both non-empty but disjoint (ti and pi
        # always have equal length, so a separate 0.0 branch is unreachable)
        return 1.0
    overall_inter = inter[ti, pi].sum()
    overall_total = (t_areas[ti] + p_areas[pi]).sum()
    return float(2 * overall_inter / overall_total) if overall_total > 0 else 0.0


# --------------------------------------------------------------------------- #
# label-map API (tools/analysis_tools parity)
# --------------------------------------------------------------------------- #
def remap_label(pred: np.ndarray, by_size: bool = False) -> np.ndarray:
    ids = np.unique(pred)
    ids = ids[ids != 0]
    if len(ids) == 0:
        return np.zeros_like(pred)
    if by_size:
        sizes = [(pred == i).sum() for i in ids]
        ids = ids[np.argsort(sizes)[::-1]]
    out = np.zeros_like(pred)
    for new_id, old_id in enumerate(ids, 1):
        out[pred == old_id] = new_id
    return out


def get_fast_pq(true: np.ndarray, pred: np.ndarray, match_iou: float = 0.5):
    true, pred = remap_label(true), remap_label(pred)
    return pq_from_tables(*tables_from_labelmaps(true, pred), match_iou=match_iou)


def get_fast_aji(true: np.ndarray, pred: np.ndarray) -> float:
    true, pred = remap_label(true), remap_label(pred)
    return aji_from_tables(*tables_from_labelmaps(true, pred))


def get_fast_aji_plus(true: np.ndarray, pred: np.ndarray) -> float:
    true, pred = remap_label(true), remap_label(pred)
    return aji_plus_from_tables(*tables_from_labelmaps(true, pred))


def get_fast_dice_2(true: np.ndarray, pred: np.ndarray) -> float:
    true, pred = remap_label(true), remap_label(pred)
    return dice2_from_tables(*tables_from_labelmaps(true, pred))


def get_dice_1(true: np.ndarray, pred: np.ndarray) -> float:
    t, p = true > 0, pred > 0
    denom = t.sum() + p.sum()
    return float(2 * np.logical_and(t, p).sum() / denom) if denom > 0 else 0.0


def pair_coordinates(
    set_a: np.ndarray, set_b: np.ndarray, radius: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian pairing of 2D point sets within ``radius`` (centroid F1)."""
    if len(set_a) == 0 or len(set_b) == 0:
        return np.zeros((0, 2), np.int64), np.arange(len(set_a)), np.arange(len(set_b))
    dist = np.linalg.norm(set_a[:, None, :] - set_b[None, :, :], axis=-1)
    ai, bi = linear_sum_assignment(dist)
    keep = dist[ai, bi] <= radius
    pairing = np.stack([ai[keep], bi[keep]], axis=-1)
    unpaired_a = np.setdiff1d(np.arange(len(set_a)), pairing[:, 0])
    unpaired_b = np.setdiff1d(np.arange(len(set_b)), pairing[:, 1])
    return pairing, unpaired_a, unpaired_b


def stat_calc(true: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """All per-image metrics from label maps (reference stat_calc)."""
    true, pred = remap_label(true), remap_label(pred)
    tables = tables_from_labelmaps(true, pred)
    return stat_calc_tables(*tables)


def stat_calc_tables(inter, union, t_areas, p_areas, match_iou: float = 0.5) -> Dict[str, float]:
    """Per-image metrics from tables — the dataset-eval variant
    (reference WSICocoDataset.stat_calc, WSI_coco.py:546-637)."""
    nt, npred = len(t_areas), len(p_areas)
    if nt == 0 and npred == 0:
        return None  # reference returns None → image skipped
    if nt == 0 or npred == 0:
        return {
            "aji": 0.0, "aji_plus": 0.0, "dq": 0.0, "sq": 0.0, "pq": 0.0,
            "dice": 0.0, "precision": 0.0, "recall": 0.0,
            "tp": 0, "fp": npred, "fn": nt, "iou": 0.0,
        }
    iou = inter / (union + 1e-6)
    paired_true, paired_pred = np.nonzero(iou > match_iou)
    paired = (paired_true, paired_pred)
    pq_res, pq_pairs = pq_from_tables(inter, union, t_areas, p_areas, match_iou)
    tp = len(pq_pairs[0])
    fp = len(pq_pairs[3])
    fn = len(pq_pairs[2])
    return {
        "aji": aji_from_tables(inter, union, t_areas, p_areas),
        "aji_plus": aji_plus_from_tables(inter, union, t_areas, p_areas, paired),
        "dq": pq_res[0],
        "sq": pq_res[1],
        "pq": pq_res[2],
        "dice": dice2_from_tables(inter, union, t_areas, p_areas, paired),
        "precision": tp / (tp + fp + 1e-9),
        "recall": tp / (tp + fn + 1e-9),
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "iou": pq_res[1] * (tp + 1e-6),
    }
