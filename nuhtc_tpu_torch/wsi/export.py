"""Port of nuhtc_tpu/wsi/export.py. Per-nucleus export writers: QuPath GeoJSON, point GeoJSON, DSA json,
COCO json, SQLite contour DB — schema-compatible with the reference
(tools/infer_wsi.py:548-692)."""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Dict, List, Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.utils.imageio import write_png


def random_colors(n: int, seed: int = 0) -> List[List[int]]:
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, 3).tolist() for _ in range(n)]


class NucleiExporter:
    """Accumulates per-tile detections and writes the selected formats."""

    def __init__(
        self,
        slide_id: str,
        out_dir: str,
        classes: Sequence[str],
        mode: str = "qupath",
        flush_every: int = 5000,
    ):
        self.slide_id = slide_id
        self.out_dir = out_dir
        self.classes = list(classes)
        self.mode = mode
        self.flush_every = flush_every
        self.colors = random_colors(len(classes))
        os.makedirs(out_dir, exist_ok=True)
        self.geojson: List[dict] = []
        self.pointjson: List[dict] = []
        self.dsajson: List[dict] = []
        self.coco_imgs: List[dict] = []
        self.coco_anns: List[dict] = []
        self._nuclei_id = 0
        self._conn: Optional[sqlite3.Connection] = None
        if mode in ("sql", "all"):
            self._init_sql()

    # ------------------------------------------------------------------ #
    def _init_sql(self):
        path = os.path.join(self.out_dir, f"{self.slide_id}_dql.db")
        self._conn = sqlite3.connect(path)
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS contour (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                annidx INTEGER, elementidx INTEGER, type TEXT, "group" TEXT,
                score REAL, color TEXT, xmin REAL, ymin REAL, xmax REAL,
                ymax REAL, bbox_area REAL, coords_x TEXT, coords_y TEXT,
                keep INTEGER)"""
        )

    # ------------------------------------------------------------------ #
    def add_tile(
        self,
        annidx: int,
        contours: List[np.ndarray],  # (K_i, 2) slide-frame int polygons
        labels: np.ndarray,
        scores: np.ndarray,
        boxes: np.ndarray,  # slide-frame xyxy
        rles: Optional[List[dict]] = None,  # tile-frame RLEs for coco mode
        tile_hw: Optional[tuple] = None,
        tile: Optional[np.ndarray] = None,  # RGB tile pixels (coco mode)
    ):
        m = self.mode
        if m in ("qupath", "all"):
            for i, poly in enumerate(contours):
                ring = poly.reshape(-1, 2)
                ring = np.concatenate([ring, ring[:1]], axis=0)
                props = {
                    "objectType": "annotation",
                    "label": int(labels[i]),
                    "score": float(scores[i]),
                    "classification": {
                        "name": self.classes[int(labels[i])],
                        "color": self.colors[int(labels[i])],
                    },
                    "isLocked": False,
                }
                self.geojson.append(
                    {
                        "type": "Feature",
                        "geometry": {"type": "Polygon", "coordinates": [ring.tolist()]},
                        "properties": props,
                    }
                )
                cx = float(boxes[i][0] + boxes[i][2]) / 2
                cy = float(boxes[i][1] + boxes[i][3]) / 2
                self.pointjson.append(
                    {
                        "type": "Feature",
                        "geometry": {"type": "Point", "coordinates": [cx, cy]},
                        "properties": props,
                    }
                )
        if m in ("dsa", "all"):
            for i, poly in enumerate(contours):
                pts = np.pad(poly.reshape(-1, 2), ((0, 0), (0, 1)))
                self.dsajson.append(
                    {
                        "fillColor": f"rgba({self.colors[int(labels[i])][0]},"
                        f"{self.colors[int(labels[i])][1]},{self.colors[int(labels[i])][2]},0.5)",
                        "lineColor": f"rgb({self.colors[int(labels[i])][0]},"
                        f"{self.colors[int(labels[i])][1]},{self.colors[int(labels[i])][2]})",
                        "lineWidth": 2,
                        "type": "polyline",
                        "closed": True,
                        "points": pts.tolist(),
                        "label": {"value": self.classes[int(labels[i])]},
                    }
                )
        if m in ("coco", "all") and rles is not None and tile_hw is not None:
            h, w = tile_hw
            # file_name resolves relative to the json's directory (standard
            # COCO convention) — the pixels live under patches/
            self.coco_imgs.append(
                dict(file_name=f"patches/{annidx}.png", height=h, width=w,
                     id=annidx, n_objects=len(contours))
            )
            if tile is not None:
                # reference infer_wsi.py:631-634 saves the patch image next
                # to the COCO json so file_name entries resolve
                pdir = os.path.join(self.out_dir, "patches")
                os.makedirs(pdir, exist_ok=True)
                write_png(os.path.join(pdir, f"{annidx}.png"), tile)
            for i, r in enumerate(rles):
                counts = r["counts"].decode() if isinstance(r["counts"], bytes) else r["counts"]
                bb = rle_ops.toBbox(r).tolist()
                self.coco_anns.append(
                    dict(
                        bbox=bb,
                        area=bb[2] * bb[3],
                        image_id=annidx,
                        category_id=int(labels[i]),
                        id=self._nuclei_id,
                        iscrowd=0,
                        segmentation=dict(size=r["size"], counts=counts),
                    )
                )
                self._nuclei_id += 1
        if m in ("sql", "all") and self._conn is not None:
            rows = []
            for i, poly in enumerate(contours):
                ring = poly.reshape(-1, 2)
                xs, ys = ring[:, 0], ring[:, 1]
                rows.append(
                    (
                        annidx, i, "polyline", self.classes[int(labels[i])],
                        float(scores[i]), str(self.colors[int(labels[i])]),
                        float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max()),
                        float((xs.max() - xs.min()) * (ys.max() - ys.min())),
                        ",".join(map(str, xs.tolist())), ",".join(map(str, ys.tolist())), 1,
                    )
                )
            self._conn.executemany(
                """INSERT INTO contour (annidx, elementidx, type, "group", score,
                   color, xmin, ymin, xmax, ymax, bbox_area, coords_x, coords_y, keep)
                   VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)""",
                rows,
            )
        if annidx % self.flush_every == 0:
            self.flush()

    # ------------------------------------------------------------------ #
    def flush(self):
        m = self.mode
        sid = self.slide_id
        if m in ("qupath", "all"):
            with open(os.path.join(self.out_dir, f"{sid}.geojson"), "w") as f:
                json.dump(self.geojson, f)
            with open(os.path.join(self.out_dir, f"{sid}_point.geojson"), "w") as f:
                json.dump(self.pointjson, f)
        if m in ("dsa", "all"):
            with open(os.path.join(self.out_dir, f"{sid}_dsa.json"), "w") as f:
                json.dump(
                    {"description": "Seg with NuHTC-TPU automatically",
                     "elements": self.dsajson, "name": "NuHTC"}, f,
                )
        if m in ("coco", "all"):
            cats = [dict(id=i, name=c) for i, c in enumerate(self.classes)]
            with open(os.path.join(self.out_dir, "coco_nuclei.json"), "w") as f:
                json.dump(
                    {"images": self.coco_imgs, "annotations": self.coco_anns,
                     "categories": cats}, f,
                )
        if m in ("sql", "all") and self._conn is not None:
            self._conn.commit()

    def close(self):
        self.flush()
        if self._conn is not None:
            self._conn.execute("DROP TABLE IF EXISTS rtree")
            self._conn.execute(
                "CREATE VIRTUAL TABLE rtree USING rtree(id, xmin, xmax, ymin, ymax)"
            )
            self._conn.execute(
                "INSERT INTO rtree (id, xmin, xmax, ymin, ymax) "
                "SELECT id, xmin, xmax, ymin, ymax FROM contour"
            )
            self._conn.commit()
            self._conn.close()
            self._conn = None
