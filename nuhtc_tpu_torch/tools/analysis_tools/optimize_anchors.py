"""Anchor sizes fitted to a dataset's ground-truth boxes (port of
tools/analysis_tools/optimize_anchors.py; reference
tools/analysis_tools/optimize_anchors.py of mmdet).

    python -m nuhtc_tpu_torch.tools.analysis_tools.optimize_anchors CONFIG \\
        --algorithm k-means --input-shape 512 512 --output-dir out/

``k-means``: the darknet EM (k centres drawn from the boxes, each box to the
centre of highest shared-centre IoU, each centre to its boxes' mean, until
the assignment holds). ``differential_evolution``: scipy's, over the
flattened (w1, h1, ..., wk, hk) bounded by the input shape, minimising 1 -
the mean best IoU, with the reference's settings (best1bin, population 15,
tol 1e-4, mutation (0.5, 1), recombination 0.7, immediate updating, seed
0). The boxes are every annotation of the config's train set, rescaled by
max(image side) / input shape. The anchors are printed and written to
``{output_dir}/anchor_optimize_result.json``. Host only.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np


def bbox_iou_shared_center(whs: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """IoU of boxes sharing a centre: whs (N, 2), centers (K, 2) → (N, K)."""
    inter = np.minimum(whs[:, None, 0], centers[None, :, 0]) * np.minimum(
        whs[:, None, 1], centers[None, :, 1])
    a = whs.prod(1)[:, None] + centers.prod(1)[None, :] - inter
    return inter / np.maximum(a, 1e-9)


def collect_whs(dataset, input_shape) -> np.ndarray:
    """Every annotation's (w, h), rescaled by max(image side) / input shape."""
    whs, shapes = [], []
    for idx in range(len(dataset)):
        ann = dataset.get_ann_info(idx)
        info = dataset.img_info(idx)
        img_shape = np.array([info["width"], info["height"]], np.float64)
        for bbox in ann["bboxes"]:
            whs.append(bbox[2:4] - bbox[0:2])
            shapes.append(img_shape)
    whs = np.asarray(whs, np.float64)
    shapes = np.asarray(shapes, np.float64)
    ratios = shapes.max(1, keepdims=True) / np.asarray([input_shape], np.float64)
    return whs / ratios


def kmeans_anchors(whs: np.ndarray, num_anchors: int, iters: int, seed: int = 0, logger=print):
    """→ (anchors sorted by area, mean best IoU; None for one anchor)."""
    rng = np.random.RandomState(seed)
    centers = whs[rng.randint(0, len(whs), size=num_anchors)].copy()
    assignments = np.zeros(len(whs), np.int64)

    def maximization(assign, cen):
        new = np.zeros_like(cen)
        for i in range(len(cen)):
            m = assign == i
            if m.sum():
                new[i] = whs[m].mean(0)
        return new

    if num_anchors == 1:
        centers = maximization(assignments, centers)
        return sorted(map(tuple, centers), key=lambda x: x[0] * x[1]), None
    for i in range(iters):
        closest = bbox_iou_shared_center(whs, centers).argmax(1)
        if (closest == assignments).all():
            logger(f"K-means process has converged at iter {i}.")
            break
        assignments = closest
        centers = maximization(assignments, centers)
    avg_iou = float(bbox_iou_shared_center(whs, centers).max(1).mean())
    logger(f"Anchor cluster finish. Average IOU: {avg_iou}")
    return sorted(map(tuple, centers), key=lambda x: x[0] * x[1]), avg_iou


def de_anchors(whs: np.ndarray, num_anchors: int, iters: int, input_shape,
               strategy="best1bin", population_size=15, convergence_thr=1e-4,
               mutation=(0.5, 1), recombination=0.7, seed=0, logger=print):
    """→ (anchors sorted by area, mean best IoU)."""
    from scipy.optimize import differential_evolution

    def cost(params):
        centers = np.asarray(params, np.float64).reshape(-1, 2)
        return 1 - bbox_iou_shared_center(whs, centers).max(1).mean()

    bounds = [(0, input_shape[0]), (0, input_shape[1])] * num_anchors
    result = differential_evolution(
        cost, bounds=bounds, strategy=strategy, maxiter=iters, popsize=population_size,
        tol=convergence_thr, mutation=mutation, recombination=recombination,
        updating="immediate", seed=seed, disp=False)
    logger(f"Anchor evolution finish. Average IOU: {1 - result.fun}")
    anchors = list(zip(result.x[::2], result.x[1::2]))
    return sorted(anchors, key=lambda x: x[0] * x[1]), float(1 - result.fun)


def save_result(anchors, out_dir, logger=print):
    rounded = [[round(w), round(h)] for w, h in anchors]
    logger(f"Anchor optimize result:{rounded}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "anchor_optimize_result.json")
        with open(path, "w") as f:
            json.dump(rounded, f)
        logger(f"Result saved in {path}")
    return rounded


def num_anchors_from_config(cfg) -> int:
    """Anchors a location of the RPN's generator: scales × ratios."""
    gen = cfg.model["rpn_head"]["anchor_generator"]
    return len(gen.get("scales", [1])) * len(gen.get("ratios", [1.0]))


def train_boxes(config: str, input_shape) -> tuple:
    """(the config, the (w, h) of its train set's boxes at ``input_shape``)."""
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.data.loader import CASDataset

    cfg = Config.fromfile(config)
    train_cfg = cfg.data["train"]
    while "dataset" in train_cfg:
        train_cfg = train_cfg["dataset"]
    ds = build_dataset(dict(train_cfg))
    if isinstance(ds, CASDataset):
        ds = ds.dataset
    return cfg, collect_whs(ds, input_shape)


def main(argv: Optional[Sequence[str]] = None):
    """→ the rounded anchors."""
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.analysis_tools."
                                 "optimize_anchors", description="Optimize anchor parameters.")
    ap.add_argument("config")
    ap.add_argument("--input-shape", type=int, nargs="+", default=[608, 608])
    ap.add_argument("--algorithm", default="differential_evolution",
                    choices=["k-means", "differential_evolution"])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--num-anchors", type=int, default=None)
    ap.add_argument("--output-dir", default=None)
    args = ap.parse_args(argv)
    if len(args.input_shape) != 2:
        ap.error("--input-shape takes two numbers")
    cfg, whs = train_boxes(args.config, args.input_shape)
    num_anchors = args.num_anchors or num_anchors_from_config(cfg)
    print(f"Collected {len(whs)} bboxes.")
    if args.algorithm == "k-means":
        anchors, _ = kmeans_anchors(whs, num_anchors, args.iters)
    else:
        anchors, _ = de_anchors(whs, num_anchors, args.iters, args.input_shape)
    return save_result(anchors, args.output_dir)


if __name__ == "__main__":
    main()
