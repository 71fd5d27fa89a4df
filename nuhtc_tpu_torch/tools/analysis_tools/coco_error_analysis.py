"""COCO error analysis (the command line of
tools/analysis_tools/coco_error_analysis.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.coco_error_analysis CONFIG RESULTS.pkl \\
      --out-dir work_dirs/error_analysis [--types bbox segm] [--extraplots] \\
      [--areas 1024 9216 10000000000]

Per-class AP decomposed by forgiving error types one after another, as
stacked PR-curve figures (one per class and area group, and the allclass
aggregate) and ``{type}_error_analysis.json`` of the banded APs. The seven
bands: C75 / C50 (precision at IoU 0.75 / 0.5); Loc (IoU 0.1 matching);
Sim (ground truth of other classes of the same supercategory ignored);
Oth (all other classes ignored); BG (background false positives forgiven:
precision > 0 → 1); FN (missed nuclei forgiven, 1). Matching is
``eval.coco_map.pr_curves``; segm IoUs come from ``ops.rle``. The json is
written after the figures, which need matplotlib, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.tools.analysis_tools import load_test_dataset, pyplot

AREA_NAMES = ["allarea", "small", "medium", "large"]
TYPES = ["C75", "C50", "Loc", "Sim", "Oth", "BG", "FN"]
# band fills
COLORS = [
    (1.00, 1.00, 1.00), (1.00, 1.00, 1.00), (0.31, 0.51, 0.74),
    (0.75, 0.31, 0.30), (0.36, 0.90, 0.38), (0.50, 0.39, 0.64),
    (1.00, 0.60, 0.00),
]


def make_per_image(dataset, results, mode="bbox"):
    """results: list of (bbox_results, segm_results) per image (the
    tools/test.py --out pickle contract) → pr_curves entries."""
    per_image = []
    for idx, res in enumerate(results):
        bbox_res, segm_res = res if isinstance(res, tuple) else (res, None)
        ann = dataset.get_ann_info(idx)
        if len(bbox_res):
            boxes = np.concatenate(bbox_res)
            labels = np.concatenate(
                [np.full(len(b), c, np.int64) for c, b in enumerate(bbox_res)]
            )
        else:
            boxes = np.zeros((0, 5), np.float32)
            labels = np.zeros(0, np.int64)
        entry = dict(
            dt_boxes=boxes[:, :4].astype(np.float32),
            dt_scores=boxes[:, 4].astype(np.float32),
            dt_labels=labels,
            gt_boxes=np.asarray(ann["bboxes"], np.float32),
            gt_labels=np.asarray(ann["labels"], np.int64),
        )
        if mode == "segm" and segm_res is not None:
            rles = [r for cls in segm_res for r in cls]
            entry["dt_rles"] = rles
            entry["dt_areas"] = np.asarray([rle_ops.area(r) for r in rles], np.float64)
            gt_rles = ann.get("masks")
            if gt_rles is not None:
                entry["gt_rles"] = gt_rles
                entry["gt_areas"] = np.asarray(
                    [rle_ops.area(r) for r in gt_rles], np.float64
                )
        per_image.append(entry)
    return per_image


def _segm_iou_fn(img, dsel, gsel):
    dt = [r for r, s in zip(img["dt_rles"], dsel) if s]
    gt = [r for r, s in zip(img["gt_rles"], gsel) if s]
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)))
    return rle_ops.iou(dt, gt)


def analyze(per_image, class_names, out_dir, supercategories=None,
            areas=(1024, 9216, 10000000000), extraplots=False, iou_type="bbox",
            iou_fn=None):
    """Build the (7, R, K, A) band stack + plots + json. Returns the aps
    dict {class: {area: {band: ap}}}.

    ``supercategories``: optional list mapping class index → supercategory
    name; default treats every class as one supercategory (nuclei datasets
    have a flat hierarchy, so Sim == Oth there — same as running the
    reference on a flat COCO json)."""
    from nuhtc_tpu_torch.eval.coco_map import RECALL_THRS, pr_curves

    os.makedirs(out_dir, exist_ok=True)
    K = len(class_names)
    supercats = supercategories or ["all"] * K
    area_rngs = [
        (0.0, float(areas[2])), (0.0, float(areas[0])),
        (float(areas[0]), float(areas[1])), (float(areas[1]), float(areas[2])),
    ]
    base = pr_curves(per_image, K, [0.75, 0.5, 0.1], area_rngs, iou_fn=iou_fn)
    R = base.shape[1]
    ps = np.concatenate([base, np.zeros((4, R, K, len(area_rngs)))])

    for k in range(K):
        # forgiveness runs: dets of class k vs class-k gts + ignored others
        def forgiven(ignore_classes):
            entries = []
            for img in per_image:
                dsel = img["dt_labels"] == k
                keep_gt = (img["gt_labels"] == k) | np.isin(
                    img["gt_labels"], ignore_classes
                )
                e = dict(
                    dt_boxes=img["dt_boxes"][dsel],
                    dt_scores=img["dt_scores"][dsel],
                    dt_labels=np.zeros(int(dsel.sum()), np.int64),
                    gt_boxes=img["gt_boxes"][keep_gt],
                    gt_labels=np.zeros(int(keep_gt.sum()), np.int64),
                    gt_ignore=np.asarray(img["gt_labels"][keep_gt] != k),
                )
                if "dt_areas" in img:
                    e["dt_areas"] = np.asarray(img["dt_areas"])[dsel]
                    e["gt_areas"] = np.asarray(img["gt_areas"])[keep_gt]
                if "dt_rles" in img:
                    e["dt_rles"] = [r for r, s in zip(img["dt_rles"], dsel) if s]
                    e["gt_rles"] = [r for r, s in zip(img["gt_rles"], keep_gt) if s]
                entries.append(e)
            return pr_curves(entries, 1, [0.1], area_rngs, iou_fn=iou_fn)[0, :, 0, :]

        same_super = [c for c in range(K) if supercats[c] == supercats[k] and c != k]
        ps[3, :, k, :] = forgiven(same_super)          # Sim 
        ps[4, :, k, :] = forgiven(list(range(K)))      # Oth 
    ps[ps == -1] = 0
    ps[5] = ps[4] > 0                                  # BG  
    ps[6] = 1.0                                        # FN  

    stacks = {name: ps[:, :, k] for k, name in enumerate(class_names)}
    stacks["allclass"] = ps.mean(axis=2)
    aps = {name: _band_aps(ps_k) for name, ps_k in stacks.items()}
    with open(os.path.join(out_dir, f"{iou_type}_error_analysis.json"), "w") as f:
        json.dump(aps, f, indent=2)
    for name, ps_k in stacks.items():
        _plot_class(RECALL_THRS, ps_k, out_dir, name, iou_type)
    if extraplots:
        _bar_plot(ps, out_dir, iou_type)
    return aps


def _band_aps(ps_k) -> dict:
    """ps_k: (7, R, A) → {area: {band: AP}}, each AP the mean of its curve."""
    return {area_name: {t: float(ps_k[i, :, a].mean()) for i, t in enumerate(TYPES)}
            for a, area_name in enumerate(AREA_NAMES)}


def _plot_class(rs, ps_k, out_dir, class_name, iou_type):
    """ps_k: (7, R, A). One stacked-band png per area group."""
    plt = pyplot("the error analysis figures")
    for a, (area_name, aps) in enumerate(_band_aps(ps_k).items()):
        curves = [ps_k[t, :, a] for t in range(len(TYPES))]
        stack = [np.zeros_like(curves[0])] + curves
        title = f"{iou_type}-{class_name}-{area_name}"
        fig = plt.figure()
        ax = plt.subplot(111)
        for t, band in enumerate(TYPES):
            ax.plot(rs, stack[t + 1], color=[0, 0, 0], linewidth=0.5)
            ax.fill_between(
                rs, stack[t], stack[t + 1], color=COLORS[t],
                label=f"[{aps[band]:.3f}]{band}",
            )
        plt.xlabel("recall")
        plt.ylabel("precision")
        plt.xlim(0, 1.0)
        plt.ylim(0, 1.0)
        plt.title(title)
        plt.legend()
        fig.savefig(os.path.join(out_dir, f"{title}.png"))
        plt.close(fig)


def _bar_plot(ps, out_dir, iou_type):
    """Grouped mAP bars per area group."""
    plt = pyplot("the error analysis figures")

    fig, ax = plt.subplots()
    x = np.arange(len(AREA_NAMES))
    width = 0.6
    title = f"{iou_type}-allclass-ap bar plot"
    for t in range(len(TYPES) - 1):
        aps = [float(ps[t, :, :, a].mean()) for a in range(len(AREA_NAMES))]
        rects = ax.bar(
            x - width / 2 + (t + 1) * width / len(TYPES), aps,
            width / len(TYPES), label=TYPES[t],
        )
        for rect in rects:
            h = rect.get_height()
            ax.annotate(
                f"{h * 100:2.0f}" if 0 < h <= 1 else f"{h:2.0f}",
                xy=(rect.get_x() + rect.get_width() / 2, h),
                xytext=(0, 3), textcoords="offset points",
                ha="center", va="bottom", fontsize="x-small",
            )
    ax.set_ylabel("Mean Average Precision (mAP)")
    ax.set_title(title)
    ax.set_xticks(x)
    ax.set_xticklabels(AREA_NAMES)
    ax.legend()
    fig.savefig(os.path.join(out_dir, f"{title}.png"))
    plt.close(fig)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="COCO Error Analysis Tool")
    ap.add_argument("config")
    ap.add_argument("results", help="tools/test.py --out pickle")
    ap.add_argument("--out-dir", default="work_dirs/error_analysis")
    ap.add_argument("--types", nargs="+", default=["bbox"],
                    choices=["bbox", "segm"])
    ap.add_argument("--extraplots", action="store_true")
    ap.add_argument("--areas", type=int, nargs="+",
                    default=[1024, 9216, 10000000000])
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    assert len(args.areas) == 3

    _, dataset = load_test_dataset(args.config)
    with open(args.results, "rb") as f:
        results = pickle.load(f)

    for iou_type in args.types:
        per_image = make_per_image(dataset, results, mode=iou_type)
        iou_fn = _segm_iou_fn if iou_type == "segm" else None
        out = os.path.join(args.out_dir, iou_type)
        aps = analyze(
            per_image, list(dataset.CLASSES), out, areas=args.areas,
            extraplots=args.extraplots, iou_type=iou_type, iou_fn=iou_fn,
        )
        for name, by_area in aps.items():
            print(name, {t: round(v, 3) for t, v in by_area["allarea"].items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
