"""CoNIC metric suite (the command line of
tools/analysis_tools/conic/compute_stats.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.conic.compute_stats \\
      --true labels.npy --pred preds_conic.npy [--num-classes 6]
  python -m nuhtc_tpu_torch.tools.analysis_tools.conic.compute_stats --mode regression \\
      --true counts_true.csv --pred counts_pred.csv

``seg_class`` over (N, 256, 256, 2) instance / class maps: binary PQ per
image averaged, the multi-PQ+ pooled over the dataset per class, and AJI,
AJI+ and Dice per image averaged. ``regression`` over per-image nucleus
count CSVs (read as pandas reads them, ``utils.tables.read_csv_columns``): R² per
CoNIC class, averaged.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.eval.stats import (
    get_fast_pq,
    get_fast_aji,
    get_fast_aji_plus,
    get_dice_1,
    remap_label,
    tables_from_labelmaps,
    pq_from_tables,
)
from nuhtc_tpu_torch.utils.tables import read_csv_columns

# CoNIC class order (reference get_multi_r2:192-199)
CONIC_CLASSES = [
    "epithelial",
    "lymphocyte",
    "plasma",
    "neutrophil",
    "eosinophil",
    "connective",
]


def r2_score(y_true, y_pred):
    """Coefficient of determination, sklearn convention:
    1 - SS_res/SS_tot (SS_tot about the mean of y_true)."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    if ss_tot == 0.0:
        # constant target: perfect prediction scores 1, anything else 0
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


def get_multi_r2(true_cols, pred_cols, class_names=CONIC_CLASSES):
    """Per-class R² over the count columns ({name: values}), averaged
    (reference get_multi_r2:179-215 — unknown column headers are an error)."""
    for col in true_cols:
        if col not in class_names:
            raise ValueError(f"{col} column header not recognised")
    for col in pred_cols:
        if col not in class_names:
            raise ValueError(f"{col} column header not recognised")
    r2_list = [r2_score(true_cols[c], pred_cols[c]) for c in class_names]
    return float(np.mean(r2_list))


def seg_class_stats(true, pred, num_classes=6):
    """Returns dict(pq, multi_pq+, aji, aji_plus, dice, pq+_per_class)."""
    n, c = len(true), num_classes
    pq_list, aji_list, aji_plus_list, dice_list = [], [], [], []
    totals = np.zeros((c, 4))  # tp, fp, fn, iou_sum (pooled over the dataset)
    for i in range(n):
        t_inst = remap_label(true[i][..., 0].astype(np.int32))
        p_inst = remap_label(pred[i][..., 0].astype(np.int32))
        t_cls = true[i][..., 1].astype(np.int32)
        p_cls = pred[i][..., 1].astype(np.int32)
        [_, _, pq], _ = get_fast_pq(t_inst, p_inst)
        pq_list.append(pq)
        aji_list.append(get_fast_aji(t_inst, p_inst))
        aji_plus_list.append(get_fast_aji_plus(t_inst, p_inst))
        dice_list.append(get_dice_1(t_inst, p_inst))
        for cls in range(1, c + 1):
            t = remap_label(np.where(t_cls == cls, t_inst, 0))
            p = remap_label(np.where(p_cls == cls, p_inst, 0))
            if t.max() == 0 and p.max() == 0:
                continue  # contributes all-zero stats either way
            tables = tables_from_labelmaps(t, p)
            res, pairs = pq_from_tables(*tables)
            tp, fp, fn = len(pairs[0]), len(pairs[3]), len(pairs[2])
            totals[cls - 1] += [tp, fp, fn, res[1] * (tp + 1e-6)]

    per_class = []
    for cls in range(c):
        tp, fp, fn, iou_sum = totals[cls]
        dq = tp / (tp + 0.5 * fp + 0.5 * fn + 1e-6)
        sq = iou_sum / (tp + 1e-6)
        per_class.append(dq * sq)
    return {
        "pq": float(np.mean(pq_list)),
        "multi_pq+": float(np.mean(per_class)),
        "aji": float(np.nanmean(aji_list)),
        "aji_plus": float(np.nanmean(aji_plus_list)),
        "dice": float(np.nanmean(dice_list)),
        "pq+_per_class": [float(v) for v in per_class],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["seg_class", "regression"],
                    default="seg_class")
    ap.add_argument("--true", required=True)
    ap.add_argument("--pred", required=True)
    ap.add_argument("--num-classes", type=int, default=6)
    ap.add_argument("--out", default=None, help="optional json output path")
    args = ap.parse_args(argv)

    if args.mode == "seg_class":
        true = np.load(args.true, allow_pickle=True)
        pred = np.load(args.pred, allow_pickle=True)
        assert len(true) == len(pred)
        results = seg_class_stats(true, pred, args.num_classes)
        for cls, v in enumerate(results["pq+_per_class"], 1):
            print(f"PQ+_class_{cls}: {v:.4f}")
        for k in ("pq", "multi_pq+", "aji", "aji_plus", "dice"):
            print(f"{k}: {results[k]:.4f}")
    else:
        for p in (args.true, args.pred):
            if p.split(".")[-1] != "csv":
                raise ValueError("pred and true must be in csv format.")
        results = {
            "multi_r2": get_multi_r2(read_csv_columns(args.true),
                                     read_csv_columns(args.pred))
        }
        print(f"multi_r2: {results['multi_r2']:.4f}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)

    return 0

if __name__ == "__main__":
    raise SystemExit(main())
