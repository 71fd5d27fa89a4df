"""Confusion matrix from detection results (the command line of
tools/analysis_tools/confusion_matrix.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.confusion_matrix <config> results.pkl \\
      <save_dir> [--score-thr 0.3] [--tp-iou-thr 0.5] [--nms-iou-thr 0.5] [--color-theme plasma]
  python -m nuhtc_tpu_torch.tools.analysis_tools.confusion_matrix metrics.json \\
      --classes A B --out cm.png

Reference mode: a config, the pickle ``tools.test --out`` wrote and a save
directory. Per image every detection with a score ≥ ``--score-thr`` is
box-IoU-matched (≥ ``--tp-iou-thr``) against every ground-truth box: a
detection over k boxes counts in k cells (every pair, not one to one),
unmatched detections go to the background row, boxes no detection of their
class hit to the background column; ``--nms-iou-thr`` runs a per-class box
NMS first. ``confusion_matrix.npy`` is written before the figure, which
needs matplotlib. Legacy mode plots the ``confusion_matrix`` of a metrics
json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.tools.analysis_tools import load_test_dataset, pyplot


def _bbox_overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (N, 4) and (M, 4) xyxy boxes."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:4] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:4] - b[:, :2], axis=1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def analyze_per_img_dets(cm, gt_bboxes, gt_labels, result,
                         score_thr=0.0, tp_iou_thr=0.5, nms_iou_thr=None):
    """One image's detections (per class, (n, 5) with the score last) into
    ``cm`` (C + 1, C + 1), rows ground truth, columns predictions."""
    true_positives = np.zeros(len(gt_labels), np.int64)
    for det_label, det_bboxes in enumerate(result):
        det_bboxes = np.asarray(det_bboxes, np.float32).reshape(-1, 5)
        if nms_iou_thr:
            from nuhtc_tpu_torch.apis.inference import _box_nms

            det_bboxes = det_bboxes[det_bboxes[:, 4] >= score_thr]
            keep = _box_nms(det_bboxes[:, :4], det_bboxes[:, 4], nms_iou_thr)
            det_bboxes = det_bboxes[keep]
        ious = _bbox_overlaps(det_bboxes[:, :4], np.asarray(gt_bboxes, np.float32))
        for i in range(len(det_bboxes)):
            if det_bboxes[i, 4] < score_thr:
                continue
            hit = ious[i] >= tp_iou_thr
            if hit.any():
                for j in np.nonzero(hit)[0]:
                    if gt_labels[j] == det_label:
                        true_positives[j] += 1
                    cm[gt_labels[j], det_label] += 1
            else:
                cm[-1, det_label] += 1  # a background false positive
    for num_tp, gt_label in zip(true_positives, gt_labels):
        if num_tp == 0:
            cm[gt_label, -1] += 1  # a missed nucleus


def calculate_confusion_matrix(dataset, results, score_thr=0.0,
                               nms_iou_thr=None, tp_iou_thr=0.5):
    num_classes = len(dataset.CLASSES)
    cm = np.zeros((num_classes + 1, num_classes + 1), np.float64)
    assert len(dataset) == len(results)
    for idx, per_img in enumerate(results):
        res_bboxes = per_img[0] if isinstance(per_img, tuple) else per_img
        ann = dataset.get_ann_info(idx)
        analyze_per_img_dets(cm, ann["bboxes"], ann["labels"], res_bboxes,
                             score_thr, tp_iou_thr, nms_iou_thr)
    return cm


def plot_confusion_matrix(cm, classes, out_path, color_theme="Blues",
                          title="Normalized Confusion Matrix", normalize=False):
    plt = pyplot("the confusion matrix figure")
    cm = np.asarray(cm, float)
    if normalize:  # rows as percentages
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-9) * 100
    fig, ax = plt.subplots(figsize=(1 + len(classes), 1 + len(classes)))
    im = ax.imshow(cm, cmap=color_theme, vmin=0, vmax=100 if normalize else None)
    ax.set_title(title)
    ax.set_xticks(range(len(classes)))
    ax.set_yticks(range(len(classes)))
    ax.set_xticklabels(classes, rotation=45, ha="right")
    ax.set_yticklabels(classes)
    ax.set_xlabel("Prediction Label")
    ax.set_ylabel("Ground Truth Label")
    thresh = (np.nanmax(cm) or 1) / 2
    for i in range(len(classes)):
        for j in range(len(classes)):
            ax.text(j, i, f"{cm[i, j]:.0f}", ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black", fontsize=8)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    return out_path


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Generate confusion matrix from detection results")
    ap.add_argument("config", help="config file OR a metrics json (legacy)")
    ap.add_argument("prediction_path", nargs="?", default=None,
                    help="pkl from tools/test.py --out")
    ap.add_argument("save_dir", nargs="?", default=None)
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--color-theme", default="plasma")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--tp-iou-thr", type=float, default=0.5)
    ap.add_argument("--nms-iou-thr", type=float, default=None)
    ap.add_argument("--cfg-options", nargs="+", default=None)
    ap.add_argument("--classes", nargs="+", default=None, help="(legacy mode)")
    ap.add_argument("--out", default="confusion_matrix.png", help="(legacy mode)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.config.endswith(".json"):
        with open(args.config) as f:
            m = json.load(f)
        classes = list(args.classes or []) + ["Background"]
        print(f"saved {plot_confusion_matrix(m['confusion_matrix'], classes, args.out)}")
        return 0

    if not (args.prediction_path and args.save_dir):
        sys.exit("reference mode: confusion_matrix.py <config> <results.pkl> <save_dir>")

    import pickle

    _, dataset = load_test_dataset(args.config, args.cfg_options)
    with open(args.prediction_path, "rb") as f:
        results = pickle.load(f)

    cm = calculate_confusion_matrix(dataset, results, args.score_thr,
                                    args.nms_iou_thr, args.tp_iou_thr)
    os.makedirs(args.save_dir, exist_ok=True)
    np.save(os.path.join(args.save_dir, "confusion_matrix.npy"), cm)
    out = plot_confusion_matrix(
        cm, list(dataset.CLASSES) + ["background"],
        os.path.join(args.save_dir, "confusion_matrix.png"),
        color_theme=args.color_theme, normalize=True)
    print(f"saved {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
