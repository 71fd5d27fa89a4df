"""PanNuke npy → COCO-RLE annotations + RGB tiles (the command line of
tools/preprocess_pannuke.py, as a module; reference
preprocessing/NuSEG_DATASET_PanNuke.ipynb + README.md:148-175).

Converts a PanNuke release (images.npy (N, 256, 256, 3), masks.npy
(N, 256, 256, 6), types.npy (N,)) into the tree ``tools.test`` reads: one
COCO json per fold with an RLE segmentation for every instance of at least 2
pixels, RGB PNG tiles, and binary semantic PNGs (0 / 255). Host code only
(numpy, ``ops.rle``, ``utils.imageio.write_png``); it runs no model.

  python -m nuhtc_tpu_torch.tools.preprocess_pannuke --images fold1/images.npy \\
      --masks fold1/masks.npy --types fold1/types.npy --fold 1 \\
      --out-dir datasets/PanNuke --coco-dir coco/PanNuke

writes <out-dir>/rgb/fold<k>_<i>.png, <out-dir>/rgb_seg/fold<k>_<i>.png,
<coco-dir>/PanNuke_annt_RLE_fold<k>.json and, with --types,
<coco-dir>/types_fold<k>.npy. A release made from a seed, without a download:
``tools.synthetic.synthetic_pannuke`` saved with ``np.save``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.data.classes import dataset_classes
from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.utils.imageio import write_png


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="PanNuke npy → COCO-RLE json + PNG tiles")
    ap.add_argument("--images", required=True)
    ap.add_argument("--masks", required=True)
    ap.add_argument("--types", default=None)
    ap.add_argument("--fold", type=int, required=True)
    ap.add_argument("--out-dir", default="datasets/PanNuke")
    ap.add_argument("--coco-dir", default="coco/PanNuke")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    images = np.load(args.images, mmap_mode="r")
    masks = np.load(args.masks, mmap_mode="r")
    types = np.load(args.types, allow_pickle=True) if args.types else None

    rgb_dir = os.path.join(args.out_dir, "rgb")
    seg_dir = os.path.join(args.out_dir, "rgb_seg")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    os.makedirs(args.coco_dir, exist_ok=True)

    coco_imgs, coco_anns = [], []
    ann_id = 1
    for i in range(len(images)):
        name = f"fold{args.fold}_{i}"
        img = np.clip(images[i], 0, 255).astype(np.uint8)
        h, w = img.shape[:2]
        write_png(os.path.join(rgb_dir, name + ".png"), img)
        m6 = masks[i]
        entry = dict(id=i, file_name=name + ".png", height=h, width=w)
        if types is not None:
            entry["type"] = str(types[i])
        coco_imgs.append(entry)
        semantic = np.zeros((h, w), np.uint8)
        for c in range(5):
            inst_map = m6[:, :, c].astype(np.int32)
            for inst_id in np.unique(inst_map):
                if inst_id == 0:
                    continue
                m = (inst_map == inst_id).astype(np.uint8)
                if m.sum() < 2:
                    continue
                semantic |= m
                r = rle_ops.encode(m)
                coco_anns.append(dict(
                    id=ann_id, image_id=i, category_id=c + 1, bbox=rle_ops.toBbox(r).tolist(),
                    area=int(rle_ops.area(r)), iscrowd=0, ismask=1,
                    segmentation=dict(size=r["size"], counts=r["counts"].decode())))
                ann_id += 1
        write_png(os.path.join(seg_dir, name + ".png"), semantic * 255)
        if (i + 1) % 200 == 0:
            print(f"\r{i + 1}/{len(images)}", end="", flush=True)
    print()
    cats = [dict(id=c + 1, name=n) for c, n in enumerate(dataset_classes("PanNukeCocoDataset"))]
    out_json = os.path.join(args.coco_dir, f"PanNuke_annt_RLE_fold{args.fold}.json")
    with open(out_json, "w") as f:
        json.dump(dict(images=coco_imgs, annotations=coco_anns, categories=cats), f)
    if types is not None:
        np.save(os.path.join(args.coco_dir, f"types_fold{args.fold}.npy"), types)
    print(f"{len(coco_anns)} annotations → {out_json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
