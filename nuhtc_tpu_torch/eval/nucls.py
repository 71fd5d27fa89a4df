"""NuCLS classification metrics: per-class AUROC + MCC over Hungarian-matched
detections (port of nuhtc_tpu/eval/nucls.py; reference
nuhtc/datasets/WSI_coco_NuCLS.py:20 and nuhtc/datasets/coco_utils.py/coco_eval.py
— sklearn-free implementation)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from nuhtc_tpu_torch.eval.stats import pair_coordinates


def auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary AUROC via the rank statistic (Mann-Whitney U)."""
    pos = scores[labels > 0]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(len(order), float)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    allv = np.concatenate([pos, neg])
    for v in np.unique(allv):
        sel = allv == v
        ranks[sel] = ranks[sel].mean()
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2
    return float(u / (len(pos) * len(neg)))


def mcc(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> float:
    """Multiclass Matthews correlation coefficient."""
    cm = np.zeros((num_classes, num_classes), np.float64)
    for t, p in zip(y_true, y_pred):
        cm[int(t), int(p)] += 1
    t_sum = cm.sum(1)
    p_sum = cm.sum(0)
    n = cm.sum()
    c = np.trace(cm)
    num = c * n - (t_sum * p_sum).sum()
    den = np.sqrt(max(n * n - (p_sum * p_sum).sum(), 0)) * np.sqrt(max(n * n - (t_sum * t_sum).sum(), 0))
    return float(num / den) if den > 0 else 0.0


def classification_metrics(
    per_image: List[Dict],  # {"gt_centroids", "gt_labels", "dt_centroids", "dt_labels", "dt_probs"}
    num_classes: int,
    radius: float = 12.0,
) -> Dict[str, float]:
    """Hungarian-match detections to GT by centroid distance, then compute
    per-class AUROC (one-vs-rest on matched pairs) and multiclass MCC."""
    y_true, y_pred, probs = [], [], []
    for img in per_image:
        pairing, _, _ = pair_coordinates(img["gt_centroids"], img["dt_centroids"], radius)
        for a, b in pairing:
            y_true.append(int(img["gt_labels"][a]))
            y_pred.append(int(img["dt_labels"][b]))
            probs.append(img["dt_probs"][b])
    if not y_true:
        # same key set as the populated path — callers index these directly
        out = {"mcc": 0.0, "matched": 0, "auroc_macro": float("nan"),
               "accuracy": float("nan")}
        for c in range(num_classes):
            out[f"auroc_class_{c}"] = float("nan")
        return out
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    probs = np.asarray(probs)
    out = {"mcc": mcc(y_true, y_pred, num_classes), "matched": len(y_true)}
    aurocs = []
    for c in range(num_classes):
        a = auroc((y_true == c).astype(int), probs[:, c])
        out[f"auroc_class_{c}"] = a
        if not np.isnan(a):
            aurocs.append(a)
    out["auroc_macro"] = float(np.mean(aurocs)) if aurocs else float("nan")
    out["accuracy"] = float((y_true == y_pred).mean())
    return out
