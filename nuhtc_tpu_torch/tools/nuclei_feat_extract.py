"""Per-nucleus features from COCO prediction JSONs over tiles (the command
line of tools/nuclei_feat_extract.py, as a module).

Two input modes:

- **Directory mode**: ``<datadir>`` holds one subdirectory per slide with
  ``coco_nuclei.json`` inside (the ``infer_wsi --mode coco`` output).
  Slides go in sorted order (``--reverse`` inverts it, ``--start/--end``
  slice it); images with fewer than ``--min_num`` nuclei are left out;
  images are resized to ``--patch_size`` when their width differs; the
  instances of an image are flattened into one label map in which the
  higher annotation index wins an overlap, so occluded nuclei drop out.
  Rows land in ``<datadir>/nuclei_feat/<slide>/nuclei_feat.csv`` with
  pandas' index column (the row's place among its image's rows); a slide
  whose CSV already lists every wanted image is skipped, and one that lists
  some is resumed.
- **Single-JSON mode**: one COCO JSON in, one CSV out (and, with ``--sql``,
  the SQLite table ``nuclei_features``).

Images are read with ``utils.imageio.read_image`` and masks decoded with
``ops.rle``.

Usage:
  python -m nuhtc_tpu_torch.tools.nuclei_feat_extract <datadir> [--start I] [--end J] \\
      [--min_num 8] [--patch_size 512] [--reverse]
  python -m nuhtc_tpu_torch.tools.nuclei_feat_extract preds.json --img-root imgs/ --out feats.csv
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.ops.imgproc import resize_nearest, resize_u8
from nuhtc_tpu_torch.utils.imageio import read_image
from nuhtc_tpu_torch.utils.tables import parse_cell, write_csv_rows, write_sqlite_rows
from nuhtc_tpu_torch.wsi.features import nucleus_features

PAD = 5


def _read_rgb(path: str):
    """The image as RGB uint8, or None where it cannot be decoded (as
    ``cv2.imread`` gives None); a missing Pillow still raises."""
    try:
        return read_image(path)
    except (OSError, ValueError):
        return None


def _feat_rows_for_image(rgb, anns, cats, patch_size):
    """Resize to patch_size, flatten the instances to one label map (the
    higher annotation index wins an overlap), one row of features per
    surviving label."""
    h, w = rgb.shape[:2]
    if patch_size and w != patch_size:
        rgb = resize_u8(rgb, (patch_size, patch_size))
    lab = None
    for i, ann in enumerate(anns):
        m = rle_ops.decode(ann["segmentation"])
        if patch_size and w != patch_size:
            m = resize_nearest(m, (patch_size, patch_size))
        if lab is None:
            lab = np.zeros(m.shape, np.int32)
        lab[m > 0] = i + 1
    rows = []
    if lab is None:
        return rows
    for i, ann in enumerate(anns):
        sel = lab == i + 1
        ys, xs = np.nonzero(sel)
        if len(xs) == 0:
            continue  # fully occluded by a later instance
        x1, y1 = max(xs.min() - PAD, 0), max(ys.min() - PAD, 0)
        x2 = min(xs.max() + PAD + 1, lab.shape[1])
        y2 = min(ys.max() + PAD + 1, lab.shape[0])
        row = nucleus_features(
            rgb[y1:y2, x1:x2], sel[y1:y2, x1:x2].astype(np.uint8), offset=(x1, y1)
        )
        if row is None:
            continue
        row["cell_type"] = cats.get(ann["category_id"], ann["category_id"])
        row["annotation_id"] = ann["id"]
        row["score"] = ann.get("score", 1.0)
        rows.append(row)
    return rows


def _read_indexed_csv(path: str):
    """(index, rows as written) of a CSV with pandas' index column."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        index, rows = [], []
        for cells in reader:
            index.append(cells[0])
            rows.append(dict(zip(header[1:], cells[1:])))
    return index, rows


def _run_dir_mode(args):
    datadir = args.path
    slide_ids = sorted(
        os.path.basename(p)
        for p in glob.glob(f"{datadir}/*")
        if os.path.isdir(p) and os.path.basename(p) not in ("imgs", "nuclei_feat")
    )
    if args.reverse:
        slide_ids = slide_ids[::-1]
    slide_ids = slide_ids[args.start:args.end] if args.end is not None else slide_ids[args.start:]

    for slide_id in slide_ids:
        print(f"\nprocess: {slide_id}")
        coco_path = f"{datadir}/{slide_id}/coco_nuclei.json"
        if not os.path.exists(coco_path):
            print(f"skipped:{slide_id}\n")
            continue
        with open(coco_path) as f:
            coco = json.load(f)
        cats = {c["id"]: c.get("name", str(c["id"])) for c in coco.get("categories", [])}
        imgs = {im["id"]: im for im in coco["images"]}
        by_img = {}
        for ann in coco["annotations"]:
            by_img.setdefault(ann["image_id"], []).append(ann)
        want = [
            iid
            for iid, im in imgs.items()
            if im.get("n_objects", len(by_img.get(iid, []))) >= args.min_num
        ]

        out_csv = f"{datadir}/nuclei_feat/{slide_id}/nuclei_feat.csv"
        index, feats = [], []
        started = os.path.exists(out_csv)  # pandas' frame exists from here on
        if started:
            index, feats = _read_indexed_csv(out_csv)
            done = {parse_cell(r["img_id"]) for r in feats
                    if (parse_cell(r["img_objs"]) or 0) >= args.min_num}
            if done == set(want):
                print(f"skipped:{slide_id}\n")
                continue
            want = sorted(set(want) - done)
        else:
            os.makedirs(os.path.dirname(out_csv), exist_ok=True)

        for n, iid in enumerate(want):
            info = imgs[iid]
            # file_name relative to the JSON first, then datadir/imgs/<slide>/
            cand = [
                os.path.join(os.path.dirname(coco_path), info["file_name"]),
                os.path.join(datadir, "imgs", slide_id, info["file_name"]),
            ]
            rgb = None
            for p in cand:
                if os.path.isfile(p):
                    rgb = _read_rgb(p)
                    if rgb is not None:
                        break
            if rgb is None:
                continue
            anns = by_img.get(iid, [])
            rows = _feat_rows_for_image(rgb, anns, cats, args.patch_size)
            for r in rows:
                r["img_id"] = iid
                r["img_type"] = info.get("type", "")
                r["img_objs"] = len(anns)
                r["file_name"] = info["file_name"]
            index.extend(range(len(rows)))
            feats.extend(rows)
            started = True
            if (n + 1) % 10000 == 0 or n + 1 == len(want):
                write_csv_rows(out_csv, feats, index=index)
            print(f"\r{n + 1}/{len(want)}", end="", flush=True)
        if want and started:
            print(f"\n{len(feats)} nuclei → {out_csv}")


def _run_json_mode(args):
    with open(args.path) as f:
        coco = json.load(f)
    imgs = {im["id"]: im for im in coco["images"]}
    cats = {c["id"]: c.get("name", str(c["id"])) for c in coco.get("categories", [])}

    cache_id, cache_img = None, None
    rows = []
    for ann in coco["annotations"]:
        info = imgs[ann["image_id"]]
        if cache_id != ann["image_id"]:
            p = os.path.join(args.img_root, info["file_name"])
            cache_img = _read_rgb(p) if os.path.isfile(p) else None
            cache_id = ann["image_id"]
        if cache_img is None:
            continue
        mask = rle_ops.decode(ann["segmentation"])
        ys, xs = np.nonzero(mask)
        if len(xs) == 0:
            continue
        x1, y1 = max(xs.min() - PAD, 0), max(ys.min() - PAD, 0)
        x2 = min(xs.max() + PAD + 1, mask.shape[1])
        y2 = min(ys.max() + PAD + 1, mask.shape[0])
        row = nucleus_features(cache_img[y1:y2, x1:x2], mask[y1:y2, x1:x2], offset=(x1, y1))
        if row is None:
            continue
        row["image"] = info["file_name"]
        row["category"] = cats.get(ann["category_id"], ann["category_id"])
        row["score"] = ann.get("score", 1.0)
        row["annotation_id"] = ann["id"]
        rows.append(row)
    write_csv_rows(args.out, rows)
    if args.sql:
        write_sqlite_rows(os.path.splitext(args.out)[0] + ".db", "nuclei_features", rows)
    print(f"{len(rows)} nuclei → {args.out}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.nuclei_feat_extract")
    ap.add_argument("path", help="datadir of slide subdirs with coco_nuclei.json "
                    "(directory mode) OR a single COCO json")
    ap.add_argument("--img-root", default="", help="image root (single-json mode)")
    ap.add_argument("--out", default="nuclei_features.csv", help="(single-json mode)")
    ap.add_argument("--sql", action="store_true", help="(single-json mode)")
    ap.add_argument("--start", type=int, default=0, help="slide start index")
    ap.add_argument("--end", type=int, default=None, help="slide end index")
    ap.add_argument("--min_num", type=int, default=8, help="exclude images with fewer nuclei")
    ap.add_argument("--patch_size", type=int, default=512,
                    help="resize images to this size before features")
    ap.add_argument("--reverse", action="store_true", help="reverse slide order")
    args = ap.parse_args(argv)

    if os.path.isdir(args.path):
        _run_dir_mode(args)
    else:
        _run_json_mode(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
