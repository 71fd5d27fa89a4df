"""PanNuke detection suite per class and per tissue (the command line of
tools/analysis_tools/pannuke/compute_stats_all.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.pannuke.compute_stats_all \\
      --true_path masks.npy --pred_path preds.npy --type_path types.npy \\
      --save_path out/ [--num_classes 5] [--mode coord|iou]

DQ / precision / recall (nan-mean aggregated) and TP / FP / FN counts
(summed) under two matchings: ``coord`` pairs instance centroids within 12
pixels by Hungarian assignment; ``iou`` pairs instances at IoU > 0.5 and
also reports PQ. Writes ``class_stats_{metric}.csv`` and
``tissue_stats_{metric}.csv`` to ``--save_path``.

A quirk of the reference kept on purpose: where a class has no ground truth
the counts of the last class and image that had some are carried over (the
``tp_tmp`` / ``fp_tmp`` / ``fn_tmp`` of the reference persist across both
loops), starting from empty lists.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.eval.stats import get_fast_pq, pair_coordinates, remap_label
from nuhtc_tpu_torch.tools.analysis_tools.pannuke.compute_stats import binarize

# Reference :27-47 — the fixed 19 PanNuke tissue types.
TISSUE_TYPES = [
    "Adrenal_gland", "Bile-duct", "Bladder", "Breast", "Cervix", "Colon",
    "Esophagus", "HeadNeck", "Kidney", "Liver", "Lung", "Ovarian",
    "Pancreatic", "Prostate", "Skin", "Stomach", "Testis", "Thyroid",
    "Uterus",
]

CLASS_NAMES = ["Neoplastic", "Inflam", "Connective", "Dead", "Non-Neoplastic"]


def _centroids(labelmap: np.ndarray) -> np.ndarray:
    """(K, 2) centers of mass of instances 1..K (contiguous ids)."""
    lab = labelmap.ravel()
    k = int(lab.max())
    if k == 0:
        return np.zeros((0, 2), np.float64)
    counts = np.bincount(lab, minlength=k + 1)[1:].astype(np.float64)
    rows, cols = np.indices(labelmap.shape)
    rsum = np.bincount(lab, weights=rows.ravel(), minlength=k + 1)[1:]
    csum = np.bincount(lab, weights=cols.ravel(), minlength=k + 1)[1:]
    return np.stack([rsum / counts, csum / counts], axis=-1)


def get_coord_pq(true: np.ndarray, pred: np.ndarray, radius: float = 12.0):
    """Centroid-pairing detection quality (ref pannuke/utils.py:211-255).

    Returns ``[dq, paired, unpaired_true, unpaired_pred]``; the empty-pred
    early-out mirrors ref :242-243 (dq=0, all GT ids unpaired).
    """
    true = remap_label(true)
    pred = remap_label(pred)
    if pred.max() == 0:
        return [0, [], list(range(int(true.max()))), []]
    pairing, unpaired_t, unpaired_p = pair_coordinates(
        _centroids(true), _centroids(pred), radius
    )
    tp, fp, fn = len(pairing), len(unpaired_p), len(unpaired_t)
    dq = tp / (tp + 0.5 * fp + 0.5 * fn)
    return [dq, pairing, unpaired_t, unpaired_p]


def format_metric(m_all, b_all, save_path, types, metric="PQ"):
    """nanmean aggregation per class / per tissue (ref :78-128)."""
    m_all = [np.asarray(x, np.float64) for x in m_all]
    m_each_image = [np.nanmean(x) for x in m_all]
    b_each_image = [np.nanmean(np.asarray(x, np.float64)) for x in b_all]
    num_classes = len(m_all[0])

    rows = {"Class Name": CLASS_NAMES[:num_classes] + ["Total"], metric: []}
    for c in range(num_classes):
        rows[metric].append(np.nanmean([x[c] for x in m_all]))
    rows[metric].append(np.nanmean(np.asarray(b_all, np.float64)))
    _write_csv(os.path.join(save_path, f"class_stats_{metric}.csv"), rows)

    tissues = TISSUE_TYPES if all(t in TISSUE_TYPES for t in types) else sorted(set(types))
    all_m, all_b = [], []
    for tname in tissues:
        idx = [i for i, t in enumerate(types) if t == tname]
        all_m.append(np.nanmean([m_each_image[i] for i in idx]) if idx else np.nan)
        all_b.append(np.nanmean([b_each_image[i] for i in idx]) if idx else np.nan)
    trows = {
        "Tissue name": list(tissues) + ["mean"],
        metric: all_m + [np.nanmean(all_m)],
        f"{metric} bin": all_b + [np.nanmean(all_b)],
    }
    _write_csv(os.path.join(save_path, f"tissue_stats_{metric}.csv"), trows)
    print(f"Average m{metric}: {np.nanmean(all_m)}")
    print(f"Average b{metric}: {np.nanmean(all_b)}")
    return trows


def format_metric_det(m_all, b_all, save_path, types, metric="TP"):
    """sum aggregation for detection counts (ref :48-76)."""
    num_classes = len(m_all[0])
    rows = {"Class Name": CLASS_NAMES[:num_classes] + ["Total"], metric: []}
    for c in range(num_classes):
        rows[metric].append(float(np.sum([x[c] for x in m_all])))
    rows[metric].append(float(np.sum(b_all)))
    _write_csv(os.path.join(save_path, f"class_stats_{metric}.csv"), rows)
    return rows


def _write_csv(path, cols):
    """pandas-free CSV with the pandas index column the reference files have."""
    keys = list(cols)
    n = len(cols[keys[0]])
    with open(path, "w") as f:
        f.write("," + ",".join(keys) + "\n")
        for i in range(n):
            vals = [str(cols[k][i]) for k in keys]
            f.write(f"{i}," + ",".join(vals) + "\n")


def run(true, pred, types, save_path, num_classes=5, mode="coord"):
    os.makedirs(save_path, exist_ok=True)
    acc = {m: ([], []) for m in ["PQ", "DQ", "Precision", "Recall", "TP", "FP", "FN"]}
    # stale-carry seeds (see module docstring)
    tp_tmp, fp_tmp, fn_tmp = [], [], []
    precision_tmp = recall_tmp = np.nan

    for i in range(len(true)):
        per = {m: [] for m in acc}
        true_bin = binarize(true[i][:, :, :num_classes + 1])
        pred_bin = remap_label(binarize(pred[i][:, :, :num_classes + 1]))
        if true_bin.max() == 0:
            # ref :197-203/:325-332 — empty GT ⇒ NaN rates, zero counts
            binv = dict(PQ=np.nan, DQ=np.nan, Precision=np.nan, Recall=np.nan,
                        TP=0, FP=0, FN=0)
        else:
            if mode == "coord":
                dq_b, tp, fn, fp = get_coord_pq(true_bin, pred_bin)
                pq_b = np.nan
            else:
                [dq_b, _, pq_b], (tp, _, fn, fp) = get_fast_pq(true_bin, pred_bin)
            binv = dict(
                PQ=pq_b, DQ=dq_b,
                Precision=len(tp) / (len(tp) + len(fp) + 1e-9),
                Recall=len(tp) / (len(tp) + len(fn) + 1e-9),
                TP=len(tp), FP=len(fp), FN=len(fn),
            )
        for j in range(num_classes):
            t = remap_label(true[i][:, :, j].astype(np.int32))
            p = remap_label(pred[i][:, :, j].astype(np.int32))
            if t.max() == 0:
                pq_c = dq_c = np.nan
                if mode == "coord":
                    precision_c, recall_c = np.nan, np.nan
                else:
                    # ref main_iou :351-352 — only pq/dq reset; rates stale
                    precision_c, recall_c = precision_tmp, recall_tmp
            else:
                if mode == "coord":
                    dq_c, tp_tmp, fn_tmp, fp_tmp = get_coord_pq(t, p)
                    pq_c = np.nan
                else:
                    [dq_c, _, pq_c], (tp_tmp, _, fn_tmp, fp_tmp) = get_fast_pq(t, p)
                precision_c = len(tp_tmp) / (len(tp_tmp) + len(fp_tmp) + 1e-9)
                recall_c = len(tp_tmp) / (len(tp_tmp) + len(fn_tmp) + 1e-9)
                precision_tmp, recall_tmp = precision_c, recall_c
            per["PQ"].append(pq_c)
            per["DQ"].append(dq_c)
            per["Precision"].append(precision_c)
            per["Recall"].append(recall_c)
            # ref :233-235 — stale-carry counts on empty-GT classes
            per["TP"].append(len(tp_tmp))
            per["FP"].append(len(fp_tmp))
            per["FN"].append(len(fn_tmp))
        for m in acc:
            acc[m][0].append(per[m])
            acc[m][1].append([binv[m]])

    out = {}
    if mode == "iou":
        out["PQ"] = format_metric(*acc["PQ"], save_path, types, metric="PQ")
    out["DQ"] = format_metric(*acc["DQ"], save_path, types, metric="DQ")
    out["Precision"] = format_metric(*acc["Precision"], save_path, types, metric="Precision")
    out["Recall"] = format_metric(*acc["Recall"], save_path, types, metric="Recall")
    for m in ["TP", "FP", "FN"]:
        out[m] = format_metric_det(*acc[m], save_path, types, metric=m)
    return out


def _resolve(path, default_name):
    if os.path.splitext(path)[1] != "":
        return path
    return os.path.join(path, default_name)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--true_path", required=True)
    ap.add_argument("--pred_path", required=True)
    ap.add_argument("--type_path", required=True)
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--num_classes", type=int, default=5)
    ap.add_argument("--mode", choices=["coord", "iou"], default="coord")
    args = ap.parse_args(argv)

    true = np.load(_resolve(args.true_path, "masks.npy"), allow_pickle=True)
    pred = np.load(_resolve(args.pred_path, "masks.npy"), allow_pickle=True)
    types = np.load(_resolve(args.type_path, "types.npy"), allow_pickle=True)
    run(true, pred, list(types), args.save_path,
        num_classes=args.num_classes, mode=args.mode)

    return 0

if __name__ == "__main__":
    raise SystemExit(main())
