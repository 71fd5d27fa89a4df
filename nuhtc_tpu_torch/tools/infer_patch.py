"""CSV-listed patch inference → COCO json (the command line of
tools/infer_patch.py, as a module): detections at or above ``--score-thr``,
then greedy mask NMS (``--mask-nms-thr``, 0 turns it off), written as COCO
annotations with RLE segmentations; ``--vis-dir`` adds overlays of the first
``--vis-samples`` images.

  python -m nuhtc_tpu_torch.tools.infer_patch <csv_with_image_paths> <config> [ckpt] \\
      --out nuclei_coco.json [--img-root DIR] [--image-col COL] [--vis-dir DIR] \\
      [--device cpu]

The image column is read as text (``utils.tables.read_csv_rows`` without
parsing): a cell such as ``0001`` stays a file name. The model runs on the
first CUDA device and raises without one; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from nuhtc_tpu_torch.data.coco import DATASETS
from nuhtc_tpu_torch.eval.evaluate import mask_nms
from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.utils.imageio import read_image, write_image
from nuhtc_tpu_torch.utils.tables import columns_of, read_csv_rows
from nuhtc_tpu_torch.utils.visualize import draw_detections


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="CSV-listed patch inference → COCO json")
    ap.add_argument("csv")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--out", "--output", default="nuclei_coco.json", dest="out")
    ap.add_argument("--img-root", default="")
    ap.add_argument("--image-col", default=None,
                    help="CSV column holding image paths (reference --image-col; "
                    "default: 'image_path' if present, else the first column)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--score-thr", type=float, default=0.35,
                    help="score threshold for detections (reference default 0.35)")
    ap.add_argument("--mask-nms-thr", type=float, default=0.05,
                    help="IoU threshold for mask NMS; 0 disables (reference)")
    ap.add_argument("--mag", type=int, default=40,
                    help="input magnification; test rescale = 80/mag (reference)")
    ap.add_argument("--num-workers", type=int, default=8,
                    help="image-read threads (reference --num-workers)")
    ap.add_argument("--vis-dir", default=None,
                    help="save overlay images for the first --vis-samples "
                    "images (reference --vis-dir)")
    ap.add_argument("--vis-samples", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def _read(path: str):
    """RGB uint8, or None when the file is missing or unreadable (the image
    is then left out, as ``cv2.imread`` returning None leaves it out)."""
    try:
        return read_image(path)
    except (OSError, ValueError):
        return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import init_detector, resolve_device
    from nuhtc_tpu_torch.config import Config

    device = resolve_device(args.device, "infer_patch")
    rows = read_csv_rows(args.csv, parse=False)
    columns = columns_of(rows)
    col = args.image_col or ("image_path" if "image_path" in columns else columns[0])
    if col not in columns:
        raise ValueError(f"CSV must contain '{col}' column")
    paths = [os.path.join(args.img_root, row[col]) for row in rows]

    cfg = Config.fromfile(args.config)
    engine = init_detector(cfg, args.checkpoint, batch_size=args.batch_size,
                           scale_factor=80.0 / args.mag, device=device)
    classes = DATASETS.get(cfg.get("dataset", "PanNukeCocoDataset")).CLASSES

    if args.vis_dir:
        os.makedirs(args.vis_dir, exist_ok=True)
    vis_count = 0
    images, annotations = [], []
    ann_id = 0
    with ThreadPoolExecutor(max_workers=max(args.num_workers, 1)) as pool:
        for start in range(0, len(paths), args.batch_size):
            chunk = paths[start:start + args.batch_size]
            imgs = list(pool.map(_read, chunk))
            keep = [i for i, im in enumerate(imgs) if im is not None]
            for img_idx, res in zip((start + i for i in keep),
                                    engine.run_batch([imgs[i] for i in keep])):
                im = imgs[img_idx - start]
                h, w = im.shape[:2]
                p = paths[img_idx]
                images.append(dict(id=img_idx, file_name=os.path.basename(p), height=h, width=w))
                sel = res["scores"] >= args.score_thr
                masks = res["masks"][sel]
                labels, scores = res["labels"][sel], res["scores"][sel]
                rles = [rle_ops.encode(m) for m in masks]
                if args.mask_nms_thr > 0 and rles:
                    rles, keep_idx = mask_nms(rles, scores, thr=args.mask_nms_thr)
                    masks = masks[keep_idx]
                    labels, scores = labels[keep_idx], scores[keep_idx]
                for i, r in enumerate(rles):
                    bb = rle_ops.toBbox(r).tolist()
                    annotations.append(dict(
                        id=ann_id, image_id=img_idx, category_id=int(labels[i]) + 1, bbox=bb,
                        area=bb[2] * bb[3], score=float(scores[i]), iscrowd=0,
                        segmentation=dict(size=r["size"], counts=r["counts"].decode())))
                    ann_id += 1
                if args.vis_dir and vis_count < args.vis_samples:
                    ov = draw_detections(im, masks, labels, scores)
                    write_image(os.path.join(args.vis_dir,
                                             f"{vis_count:04d}_{os.path.basename(p)}"), ov)
                    vis_count += 1
            print(f"\r{min(start + args.batch_size, len(paths))}/{len(paths)}", end="", flush=True)
    print()
    cats = [dict(id=i + 1, name=c) for i, c in enumerate(classes)]
    with open(args.out, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=cats), f)
    print(f"{len(annotations)} nuclei → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
