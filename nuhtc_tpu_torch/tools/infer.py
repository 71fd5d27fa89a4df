"""Patch inference on a directory of tiles (the command line of tools/infer.py,
as a module): per image an overlay ``<name>_overlay.png`` and, with
``--save-json``, ``<name>.json`` (one entry per detection: bbox, score,
label, class probabilities, RLE segmentation).

  python -m nuhtc_tpu_torch.tools.infer <img_dir> <config> [checkpoint] \\
      --out <dir> [--batch-size 8] [--save-json] [--device cpu]

The model runs on the first CUDA device and raises without one; ``--device``
picks another (``cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

from nuhtc_tpu_torch.data.coco import DATASETS  # the registry, the datasets in it
from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.utils.imageio import read_image, write_png
from nuhtc_tpu_torch.utils.visualize import draw_detections


def image_paths(img_dir: str) -> list:
    """The .png, .jpg and .tif files of a directory, sorted by path."""
    return sorted(p for ext in ("*.png", "*.jpg", "*.tif")
                  for p in glob.glob(os.path.join(img_dir, ext)))


def dataset_palette(cfg):
    """The palette of the config's ``dataset``, or None (the default one)."""
    ds_name = cfg.get("dataset")
    if ds_name and ds_name in DATASETS:
        return DATASETS.get(ds_name).PALETTE
    return None


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Patch inference on a directory of tiles")
    ap.add_argument("img_dir")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--out", "--output", default="demo/imgs_infer", dest="out",
                    help="directory for overlays/jsons (reference --output)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' runs on the CPU")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--score-thr", type=float, default=0.35)
    ap.add_argument("--save-json", action="store_true", help="dump per-image detections json")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import init_detector, resolve_device
    from nuhtc_tpu_torch.config import Config

    device = resolve_device(args.device, "infer")
    paths = image_paths(args.img_dir)
    if not paths:
        print(f"no images found in {args.img_dir}")
        return 0
    os.makedirs(args.out, exist_ok=True)

    cfg = Config.fromfile(args.config)
    engine = init_detector(cfg, args.checkpoint, batch_size=args.batch_size, device=device)
    palette = dataset_palette(cfg)

    for start in range(0, len(paths), args.batch_size):
        chunk = paths[start:start + args.batch_size]
        imgs = [read_image(p) for p in chunk]
        for p, img, res in zip(chunk, imgs, engine.run_batch(imgs)):
            overlay = draw_detections(img, res["masks"], res["labels"], palette=palette)
            name = os.path.splitext(os.path.basename(p))[0]
            write_png(os.path.join(args.out, f"{name}_overlay.png"), overlay)
            if args.save_json:
                dets = []
                for i in range(len(res["scores"])):
                    r = rle_ops.encode(res["masks"][i])
                    dets.append(dict(
                        bbox=res["boxes"][i].tolist(), score=float(res["scores"][i]),
                        label=int(res["labels"][i]), prob=res["probs"][i].tolist(),
                        segmentation=dict(size=r["size"], counts=r["counts"].decode())))
                with open(os.path.join(args.out, f"{name}.json"), "w") as f:
                    json.dump(dets, f)
            print(f"{name}: {len(res['scores'])} nuclei")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
