"""Evaluation helpers (port of the parts of nuhtc_tpu/eval/evaluate.py that
inference uses)."""

from __future__ import annotations

from typing import List

import numpy as np

from nuhtc_tpu_torch.ops import rle as rle_ops


def mask_nms(rles: List[dict], scores: np.ndarray, thr: float = 0.05):
    """Greedy RLE-IoU suppression, score-descending. Returns (kept rles,
    kept original indices)."""
    n = len(rles)
    if n == 0:
        return [], np.zeros(0, np.int64)
    order = np.argsort(scores)[::-1]
    sorted_rles = [rles[i] for i in order]
    iou = rle_ops.iou(sorted_rles, sorted_rles, [0] * n)
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        sup = iou[i, i + 1:] > thr
        keep[i + 1:] &= ~sup
    return [sorted_rles[i] for i in np.nonzero(keep)[0]], order[keep]
