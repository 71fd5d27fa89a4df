"""Slide-scale cross-tile nucleus merge (port of nuhtc_tpu/wsi/merge.py; the
reference tools/nuclei_merge.py, CellViT++-derived).

Cells are swept in order of descending score; each cell not yet visited
takes its not-yet-visited neighbours whose IoU with it exceeds
``overlap_threshold`` as one group and keeps itself ('probability') or the
largest of the neighbours ('area'); the whole group is then visited.

The spatial index is a uniform bbox grid, and polygon IoU is computed by
rasterizing both rings on their joint bounding box with ``ops.contours
.fill_poly`` (``cv2.fillPoly`` pixel for pixel): the polygons are pixel
contours, so the raster IoU matches the mask IoU to pixel quantization.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from nuhtc_tpu_torch.ops.contours import fill_poly


def polygon_of_feature(feat: dict) -> np.ndarray:
    coords = feat["geometry"]["coordinates"]
    ring = np.asarray(coords[0] if isinstance(coords[0][0], (list, tuple)) else coords, np.float64)
    return ring.reshape(-1, 2)


def poly_bbox(poly: np.ndarray) -> Tuple[float, float, float, float]:
    return float(poly[:, 0].min()), float(poly[:, 1].min()), float(poly[:, 0].max()), float(poly[:, 1].max())


def poly_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def raster_iou(p1: np.ndarray, p2: np.ndarray) -> float:
    """Polygon IoU by joint-bbox rasterization. A pair whose joint bbox is
    at most 1M px is supersampled (up to 16×, a budget of ~1M raster px); a
    joint bbox over 4M px is rasterized at a reduced scale instead of
    reporting 0, so giant merged regions still merge."""
    b1, b2 = poly_bbox(p1), poly_bbox(p2)
    x1, y1 = min(b1[0], b2[0]), min(b1[1], b2[1])
    x2, y2 = max(b1[2], b2[2]), max(b1[3], b2[3])
    w, h = int(np.ceil(x2 - x1)) + 3, int(np.ceil(y2 - y1)) + 3
    if w <= 0 or h <= 0:
        return 0.0
    scale = 1.0
    if w * h <= 1_000_000:
        scale = float(min(16, max(1, int((1_000_000 / (w * h)) ** 0.5))))
        w, h = int(w * scale), int(h * scale)
    elif w * h > 4_000_000:
        scale = (4_000_000 / (w * h)) ** 0.5
        w, h = max(int(w * scale), 1), max(int(h * scale), 1)
        logging.getLogger("nuhtc_tpu_torch").debug(
            "raster_iou: joint bbox %dx%d px exceeds 4M budget; rasterizing at scale %.3f",
            int(np.ceil(x2 - x1)), int(np.ceil(y2 - y1)), scale)
    off = np.asarray([x1 - 1, y1 - 1])
    m1 = np.zeros((h, w), np.uint8)
    m2 = np.zeros((h, w), np.uint8)
    fill_poly(m1, [np.round((p1 - off) * scale).astype(np.int32)], 1)
    fill_poly(m2, [np.round((p2 - off) * scale).astype(np.int32)], 1)
    inter = int(np.logical_and(m1, m2).sum())
    union = int(np.logical_or(m1, m2).sum())
    return inter / union if union else 0.0


class GridIndex:
    """Uniform-grid bbox index (an STRtree stand-in)."""

    def __init__(self, cell: float = 128.0):
        self.cell = cell
        self.grid: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        self.bboxes: List[Tuple[float, float, float, float]] = []

    def _cells(self, bbox):
        x1, y1, x2, y2 = bbox
        for gx in range(int(x1 // self.cell), int(x2 // self.cell) + 1):
            for gy in range(int(y1 // self.cell), int(y2 // self.cell) + 1):
                yield gx, gy

    def add(self, idx: int, bbox):
        self.bboxes.append(bbox)
        for key in self._cells(bbox):
            self.grid[key].append(idx)

    def query(self, bbox) -> List[int]:
        x1, y1, x2, y2 = bbox
        out = set()
        for key in self._cells(bbox):
            out.update(self.grid.get(key, ()))
        hits = []
        for i in out:
            bx1, by1, bx2, by2 = self.bboxes[i]
            if bx1 <= x2 and bx2 >= x1 and by1 <= y2 and by2 >= y1:
                hits.append(i)
        return hits


def merge_features(
    features: Sequence[dict],
    overlap_threshold: float = 0.05,
    merge_strategy: str = "probability",
) -> List[dict]:
    """Returns the kept GeoJSON features, in score order."""
    n = len(features)
    if n == 0:
        return []
    scores = np.asarray([f.get("properties", {}).get("score", 0.0) for f in features])
    order = np.argsort(-scores, kind="stable")
    polys = [polygon_of_feature(features[i]) for i in order]
    index = GridIndex()
    for i, p in enumerate(polys):
        index.add(i, poly_bbox(p))

    visited = np.zeros(n, bool)
    kept: List[int] = []
    for qi in range(n):
        if visited[qi]:
            continue
        cand = [j for j in index.query(poly_bbox(polys[qi])) if j != qi and not visited[j]]
        submergers = []
        for j in cand:
            if raster_iou(polys[qi], polys[j]) > overlap_threshold:
                submergers.append(j)
                visited[j] = True
        visited[qi] = True
        if not submergers or merge_strategy == "probability":
            kept.append(qi)
        elif merge_strategy == "area":
            # the largest neighbour wins; the query itself is no candidate
            areas = [poly_area(polys[j]) for j in submergers]
            kept.append(submergers[int(np.argmax(areas))])
        else:
            raise ValueError(f"invalid merge strategy {merge_strategy!r}")
    return [features[order[i]] for i in sorted(kept)]


def merge_geojson_file(
    geojson_path: str,
    overlap_threshold: float = 0.05,
    merge_strategy: str = "probability",
    out_path: str | None = None,
    uniform_classification: bool = False,
) -> str:
    """Merges a GeoJSON file (a FeatureCollection or a bare list), numbers
    the kept features (``nuclei_id``) and writes them to ``out_path``
    (default ``<name>_merged<ext>`` beside the input); returns that path."""
    with open(geojson_path) as f:
        data = json.load(f)
    feats = data["features"] if isinstance(data, dict) else data
    merged = merge_features(feats, overlap_threshold, merge_strategy)
    for idx, feat in enumerate(merged):
        props = feat.setdefault("properties", {})
        props["nuclei_id"] = idx
        if uniform_classification:
            # one class for every cell, yellow
            props.setdefault("classification", {})
            props["classification"]["name"] = "uniform"
            props["classification"]["color"] = [255, 255, 0]
    if out_path is None:
        base, ext = os.path.splitext(geojson_path)
        out_path = f"{base}_merged{ext}"
    with open(out_path, "w") as f:
        json.dump(merged if isinstance(data, list) else {**data, "features": merged}, f)
    return out_path
