"""Per-image evaluation of results and the best and worst prediction panels
(the command line of tools/analysis_tools/analyze_results.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.analyze_results <config> <results.pkl> \\
      <show_dir> --topk 20

Each image of the pickle ``tools.test --out`` wrote is scored by its box mAP
over IoU .5:.95 (``per_image_map``); the top-k and bottom-k images are drawn
as ground truth | prediction panels (``viz_utils.imshow_gt_det``) into
``show_dir/good`` and ``show_dir/bad``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Sequence

import numpy as np


def per_image_map(det_bboxes, gt_boxes, gt_labels, iou_thrs=None) -> float:
    """Mean AP over IoU .5:.95 for ONE image (greedy matching per class —
    the single-image specialization of the reference's eval_map loop)."""
    iou_thrs = iou_thrs if iou_thrs is not None else np.linspace(0.5, 0.95, 10)
    num_classes = len(det_bboxes)
    aps = []
    for thr in iou_thrs:
        cls_aps = []
        for c in range(num_classes):
            dets = det_bboxes[c]
            gts = gt_boxes[gt_labels == c]
            if len(gts) == 0:
                continue
            if len(dets) == 0:
                cls_aps.append(0.0)
                continue
            order = np.argsort(-dets[:, 4])
            dets = dets[order]
            iou = _iou(dets[:, :4], gts)
            taken = np.zeros(len(gts), bool)
            tp = np.zeros(len(dets))
            for i in range(len(dets)):
                j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                if iou[i, j] >= thr and not taken[j]:
                    taken[j] = True
                    tp[i] = 1
            cum_tp = np.cumsum(tp)
            recall = cum_tp / len(gts)
            precision = cum_tp / (np.arange(len(dets)) + 1)
            # 101-point interpolated AP
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                p = precision[recall >= r].max() if (recall >= r).any() else 0.0
                ap += p / 101
            cls_aps.append(ap)
        aps.append(np.mean(cls_aps) if cls_aps else 0.0)
    return float(np.mean(aps))


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    aa = np.prod(a[:, 2:4] - a[:, :2], axis=1)
    bb = np.prod(b[:, 2:4] - b[:, :2], axis=1)
    return inter / np.clip(aa[:, None] + bb[None, :] - inter, 1e-9, None)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("results", help="pickle from tools/test.py --out")
    ap.add_argument("show_dir")
    ap.add_argument("--topk", type=int, default=20)
    ap.add_argument("--show-score-thr", type=float, default=0.0,
                    help="score threshold for drawn detections (reference)")
    ap.add_argument("--cfg-options", nargs="+", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.ops import rle as rle_ops
    from nuhtc_tpu_torch.tools.analysis_tools import load_test_dataset
    from nuhtc_tpu_torch.tools.analysis_tools.viz_utils import imshow_gt_det

    _, dataset = load_test_dataset(args.config, args.cfg_options)
    with open(args.results, "rb") as f:
        results = pickle.load(f)

    scores = []
    for i, res in enumerate(results):
        bboxes = res[0] if isinstance(res, tuple) else res
        ann = dataset.get_ann_info(i)
        scores.append((per_image_map(bboxes, ann["bboxes"], ann["labels"]), i))
    scores.sort(reverse=True)

    os.makedirs(os.path.join(args.show_dir, "good"), exist_ok=True)
    os.makedirs(os.path.join(args.show_dir, "bad"), exist_ok=True)
    for tag, chunk in (("good", scores[: args.topk]), ("bad", scores[-args.topk:])):
        for s, i in chunk:
            img = dataset.load_image(i)
            ann = dataset.get_ann_info(i)
            res = results[i]
            bboxes, segms = res if isinstance(res, tuple) else (res, None)
            det_masks, det_labels, det_scores = [], [], []
            for c, bb in enumerate(bboxes):
                for k in range(len(bb)):
                    if float(bb[k, 4]) < args.show_score_thr:
                        continue
                    det_labels.append(c)
                    det_scores.append(float(bb[k, 4]))
                    if segms is not None and k < len(segms[c]):
                        det_masks.append(rle_ops.decode(segms[c][k]).astype(bool))
                    else:
                        det_masks.append(np.zeros(img.shape[:2], bool))
            gt_masks = ann.get("masks", [])
            gt_masks = [rle_ops.decode(m).astype(bool) if isinstance(m, dict) else np.asarray(m, bool)
                        for m in gt_masks]
            name = f"{s:.3f}_{i}.png"
            imshow_gt_det(
                img, gt_masks, list(ann["labels"]), det_masks, det_labels, det_scores,
                out_file=os.path.join(args.show_dir, tag, name),
            )
    print(f"saved {args.topk} good / {args.topk} bad panels to {args.show_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
