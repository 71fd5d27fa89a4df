"""PanNuke metric suite: bPQ / mPQ per class and per tissue (the command line
of tools/analysis_tools/pannuke/compute_stats.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.pannuke.compute_stats \\
      --true masks.npy --pred preds_pannuke.npy [--types types.npy] [--out out.json]

Inputs are PanNuke-layout arrays (N, 256, 256, 6): per-class instance maps
in channels 0-4, background in channel 5, as ``tools.test --eval-options
save=True format=pannuke`` writes them.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.eval.stats import get_fast_pq, remap_label


def binarize(arr6: np.ndarray) -> np.ndarray:
    """(256, 256, 6) per-class instance maps → single instance map."""
    out = np.zeros(arr6.shape[:2], np.int32)
    offset = 0
    for c in range(arr6.shape[2] - 1):
        inst = remap_label(arr6[:, :, c].astype(np.int32))
        m = inst > 0
        out[m] = inst[m] + offset
        offset = out.max()
    return out


def compute_stats(true, pred, types=None, num_classes=None):
    """Reference main() body (:94-180) on in-memory arrays; returns the
    results dict. ``types``: optional per-image tissue-type array."""
    assert len(true) == len(pred), (len(true), len(pred))
    n = len(true)
    if num_classes is None:
        num_classes = true[0].shape[2] - 1

    bpq_list = []
    mpq_per_img = np.full((n, num_classes), np.nan)
    for i in range(n):
        t6, p6 = true[i], pred[i]
        true_bin = binarize(t6)
        if len(np.unique(true_bin)) == 1:
            # reference :103-105: empty GT ⇒ NaN REGARDLESS of predictions
            # (a pred-only image must not drag bPQ to 0)
            bpq_list.append(np.nan)
        else:
            [_, _, bpq], _ = get_fast_pq(true_bin, remap_label(binarize(p6)))
            bpq_list.append(bpq)
        for c in range(num_classes):
            t = remap_label(t6[:, :, c].astype(np.int32))
            p = remap_label(p6[:, :, c].astype(np.int32))
            if len(np.unique(t)) == 1:
                continue  # stays NaN — empty GT class (reference :117-119)
            [_, _, pq], _ = get_fast_pq(t, p)
            mpq_per_img[i, c] = pq

    # per-image mPQ = nanmean over classes (reference mPQ_each_image)
    mpq_each_image = np.nanmean(mpq_per_img, axis=1)
    results = {}
    for c in range(num_classes):
        results[f"PQ_class_{c}"] = float(np.nanmean(mpq_per_img[:, c]))

    if types is not None:
        # reference :155-176: Average mPQ/bPQ are means over the per-TISSUE
        # means, not over images
        tissue_mpq, tissue_bpq = [], []
        for tt in sorted(set(types.tolist())):
            sel = np.asarray([t == tt for t in types])
            m = float(np.nanmean(mpq_each_image[sel]))
            b = float(np.nanmean(np.asarray(bpq_list)[sel]))
            results[f"mPQ_{tt}"] = m
            results[f"bPQ_{tt}"] = b
            tissue_mpq.append(m)
            tissue_bpq.append(b)
        results["mPQ"] = float(np.nanmean(tissue_mpq))
        results["bPQ"] = float(np.nanmean(tissue_bpq))
    else:
        # no tissue file: aggregate over images directly
        results["mPQ"] = float(np.nanmean(mpq_each_image))
        results["bPQ"] = float(np.nanmean(bpq_list))
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--true", required=True)
    ap.add_argument("--pred", required=True)
    ap.add_argument("--types", default=None, help="per-image tissue types npy")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    true = np.load(args.true, allow_pickle=True)
    pred = np.load(args.pred, allow_pickle=True)
    types = np.load(args.types, allow_pickle=True) if args.types else None
    results = compute_stats(true, pred, types=types)

    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)

    return 0

if __name__ == "__main__":
    raise SystemExit(main())
