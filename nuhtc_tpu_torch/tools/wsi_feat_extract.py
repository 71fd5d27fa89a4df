"""Per-nucleus morphometric features from a merged GeoJSON (the command
line of tools/wsi_feat_extract.py, as a module): each nucleus is cropped
from the slide, its polygon filled into a mask, and ``nucleus_features``
computed; rows go to a CSV (and, with ``--sql``, to the SQLite table
``nuclei_features`` beside it), their columns in the order pandas gives
them.

Usage:
  python -m nuhtc_tpu_torch.tools.wsi_feat_extract <wsi_dir> --segdir results \\
      [--mag 40] [--sql]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.ops.contours import fill_poly
from nuhtc_tpu_torch.ops.imgproc import resize_u8
from nuhtc_tpu_torch.utils.tables import write_csv_rows, write_sqlite_rows
from nuhtc_tpu_torch.wsi.features import nucleus_features
from nuhtc_tpu_torch.wsi.merge import polygon_of_feature
from nuhtc_tpu_torch.wsi.slide import SlideReader, open_slide


def slide_feature_rows(slide: SlideReader, feats_json: Sequence[dict], mag: int = 40,
                       pad: int = 5, num_workers: int = 1, bs_size: int = 1024) -> list:
    """One row of features per GeoJSON feature (those that yield a contour),
    in input order, with its label, class, score and index."""

    def one(fi_feat):
        fi, feat = fi_feat
        poly = polygon_of_feature(feat)
        x1, y1 = np.floor(poly.min(0)).astype(int) - pad
        x2, y2 = np.ceil(poly.max(0)).astype(int) + pad
        x1, y1 = max(x1, 0), max(y1, 0)
        w, h = x2 - x1, y2 - y1
        if w <= 0 or h <= 0 or w * h > 4_000_000:
            return None
        crop = slide.read_region((int(x1), int(y1)), 0, (int(w), int(h)))
        local = poly - [x1, y1]
        if mag != 40:
            # every crop and its polygon at 40x scale, so that shape and
            # texture columns do not depend on the magnification
            ratio = 40.0 / mag
            crop = resize_u8(crop, (int(h * ratio), int(w * ratio)))
            local = local * ratio
        mask = np.zeros(crop.shape[:2], np.uint8)
        fill_poly(mask, [np.round(local).astype(np.int32)], 1)
        row = nucleus_features(crop, mask, offset=(x1, y1))
        if row is None:
            return None
        props = feat.get("properties", {})
        row["label"] = props.get("label", -1)
        row["class"] = props.get("classification", {}).get("name", "")
        row["score"] = props.get("score", 0.0)
        row["nucleus_id"] = fi
        return row

    items = list(enumerate(feats_json))
    if num_workers <= 1:
        return [r for r in map(one, items) if r is not None]
    # region reads wait on I/O: a thread pool over batches of bs_size, in order
    from concurrent.futures import ThreadPoolExecutor

    rows = []
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for b0 in range(0, len(items), bs_size):
            rows.extend(r for r in pool.map(one, items[b0:b0 + bs_size]) if r is not None)
    return rows


def extract_slide_features(slide_path: str | SlideReader, geojson_path: str, out_csv: str,
                           mag: int = 40, pad: int = 5, sql: bool = False,
                           num_workers: int = 1, bs_size: int = 1024) -> int:
    """Writes the feature rows of every nucleus of ``geojson_path`` to
    ``out_csv`` (and ``<out_csv stem>.db`` with ``sql``); returns the count.
    ``slide_path`` may be an open ``SlideReader``."""
    slide = open_slide(slide_path) if isinstance(slide_path, str) else slide_path
    with open(geojson_path) as f:
        data = json.load(f)
    feats_json = data["features"] if isinstance(data, dict) else data
    rows = slide_feature_rows(slide, feats_json, mag, pad, num_workers, bs_size)
    write_csv_rows(out_csv, rows)
    if sql:
        write_sqlite_rows(os.path.splitext(out_csv)[0] + ".db", "nuclei_features", rows)
    return len(rows)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.wsi_feat_extract")
    ap.add_argument("source")
    ap.add_argument("--segdir", required=True, help="results dir containing nuclei/<slide>/")
    ap.add_argument("--mag", type=int, default=40)
    ap.add_argument("--sql", action="store_true")
    ap.add_argument("--slide_ext", default=".svs")
    ap.add_argument("--start", type=int, default=0, help="first slide index to process")
    ap.add_argument("--end", type=int, default=None, help="one-past-last slide index")
    ap.add_argument("--reverse", action="store_true", help="process slides in reverse order")
    ap.add_argument("--bs_size", type=int, default=1024, help="nuclei per worker batch")
    ap.add_argument("--num_workers", type=int, default=1, help="crop-read threads")
    args = ap.parse_args(argv)

    slides = sorted(
        f for f in os.listdir(args.source) if os.path.isfile(os.path.join(args.source, f))
    )
    slides = slides[args.start:args.end]
    if args.reverse:
        slides = slides[::-1]
    for slide_name in slides:
        slide_id = os.path.splitext(slide_name)[0]
        nd = os.path.join(args.segdir, "nuclei", slide_id)
        gj = os.path.join(nd, f"{slide_id}_merged.geojson")
        if not os.path.exists(gj):
            gj = os.path.join(nd, f"{slide_id}.geojson")
        if not os.path.exists(gj):
            print(f"skip {slide_id}: no geojson")
            continue
        out_csv = os.path.join(nd, f"{slide_id}_features.csv")
        n = extract_slide_features(
            os.path.join(args.source, slide_name), gj, out_csv, args.mag, sql=args.sql,
            num_workers=args.num_workers, bs_size=args.bs_size,
        )
        print(f"{slide_id}: {n} nuclei → {out_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
