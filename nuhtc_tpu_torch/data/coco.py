"""COCO-format datasets for the four nuclei benchmarks (port of
nuhtc_tpu/data/coco.py).

A self-contained reader of the annotation json with the port's own RLE codec
(``ops.rle``), no pycocotools and no OpenCV: a polygon is filled by
``ops.contours.fill_poly`` (``cv2.fillPoly`` pixel for pixel), an image is
read by ``utils.imageio.read_image`` (``cv2.imread(IMREAD_COLOR)`` then
BGR → RGB: a grey PNG as three equal channels, alpha dropped) and a semantic
map by ``utils.imageio.read_gray`` (``IMREAD_GRAYSCALE``). Class lists come
from ``data.classes``; the palette of a dataset is the overlay palette's
first entries, one per class, as the JAX package lists them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from nuhtc_tpu_torch.data.classes import DEFAULT_PALETTE, DATASET_CLASSES
from nuhtc_tpu_torch.data.loader import CASDataset, SemiDataset
from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.ops.contours import fill_poly
from nuhtc_tpu_torch.registry import DATASETS
from nuhtc_tpu_torch.utils.imageio import read_gray, read_image


class COCO:
    """Minimal COCO API over an annotation json (images/annotations/categories)."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {im["id"]: im for im in data.get("images", [])}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_anns: Dict[Any, List[dict]] = {i: [] for i in self.imgs}
        seen = set()
        for ann in data.get("annotations", []):
            if ann["id"] in seen:
                raise ValueError(f"duplicate annotation id {ann['id']}")
            seen.add(ann["id"])
            self.img_anns.setdefault(ann["image_id"], []).append(ann)

    def get_img_ids(self):
        return list(self.imgs.keys())

    def get_cat_ids(self):
        return sorted(self.cats.keys())

    def load_anns(self, img_id):
        return self.img_anns.get(img_id, [])


def ann_to_rle(ann: dict, h: int, w: int) -> dict:
    """Segmentation (polygon list | uncompressed RLE | compressed RLE) → RLE.
    Each polygon is rounded to integer points and filled as ``cv2.fillPoly``
    fills it, clipped to the frame."""
    seg = ann["segmentation"]
    if isinstance(seg, list):  # polygons
        mask = np.zeros((h, w), np.uint8)
        for poly in seg:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            fill_poly(mask, [np.round(pts).astype(np.int32)], 1)
        return rle_ops.encode(mask)
    if isinstance(seg, dict):
        if isinstance(seg.get("counts"), list):  # uncompressed
            return {"size": seg["size"], "counts": np.asarray(seg["counts"], np.uint32)}
        counts = seg["counts"]
        if isinstance(counts, str):
            counts = counts.encode()
        return {"size": seg["size"], "counts": counts}
    raise ValueError(f"unsupported segmentation: {type(seg)}")


@DATASETS.register()
class WSICocoDataset:
    """Base dataset: COCO annotations + per-image ann info."""

    CLASSES = ()
    PALETTE = None

    @property
    def dataset_name(self) -> str:
        """The real dataset class name: limit/slice wrappers delegate
        attribute access here, so save paths stay stable under wrapping."""
        return type(self).__name__

    def __init__(self, ann_file: str, img_prefix: str = "", seg_prefix: Optional[str] = None,
                 pipeline: Any = None, test_mode: bool = False, filter_empty: bool = True,
                 **kwargs):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.test_mode = test_mode
        self.coco = COCO(ann_file)
        self.cat_ids = self.coco.get_cat_ids()
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        if not test_mode and filter_empty:
            self.img_ids = [i for i in self.img_ids if len(self.coco.load_anns(i)) > 0]
        self.pipeline = pipeline

    def __len__(self):
        return len(self.img_ids)

    def img_info(self, idx: int) -> dict:
        return self.coco.imgs[self.img_ids[idx]]

    def img_path(self, idx: int) -> str:
        return os.path.join(self.img_prefix, self.img_info(idx)["file_name"])

    def seg_path(self, idx: int) -> Optional[str]:
        if not self.seg_prefix:
            return None
        base = os.path.splitext(self.img_info(idx)["file_name"])[0]
        return os.path.join(self.seg_prefix, base + ".png")

    def get_ann_info(self, idx: int) -> dict:
        """bboxes (N, 4) xyxy, labels (N,), masks: list of RLE dicts."""
        info = self.img_info(idx)
        h, w = info["height"], info["width"]
        anns = self.coco.load_anns(self.img_ids[idx])
        bboxes, labels, masks, ismask = [], [], [], []
        for ann in anns:
            if ann.get("iscrowd", 0):
                continue
            x, y, bw, bh = ann["bbox"]
            if bw < 1 or bh < 1:
                continue
            bboxes.append([x, y, x + bw, y + bh])
            labels.append(self.cat2label[ann["category_id"]])
            masks.append(ann_to_rle(ann, h, w))
            ismask.append(ann.get("ismask", 1))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            masks=masks,
            ismask=np.asarray(ismask, np.int64),
            height=h,
            width=w,
        )

    def load_image(self, idx: int) -> np.ndarray:
        return read_image(self.img_path(idx))

    def load_semantic(self, idx: int) -> Optional[np.ndarray]:
        p = self.seg_path(idx)
        if p is None or not os.path.exists(p):
            return None
        return read_gray(p)

    # class-aware sampling support (reference CASDataset, dataset_wrappers.py:36)
    def build_class_index(self) -> Dict[int, List[int]]:
        by_class: Dict[int, List[int]] = {c: [] for c in range(len(self.CLASSES))}
        for idx in range(len(self)):
            anns = self.coco.load_anns(self.img_ids[idx])
            for ann in anns:
                lab = self.cat2label.get(ann["category_id"])
                if lab is not None:
                    by_class[lab].append(idx)
        return {c: sorted(set(v)) for c, v in by_class.items() if v}


@DATASETS.register()
class PanNukeCocoDataset(WSICocoDataset):
    CLASSES = DATASET_CLASSES["PanNukeCocoDataset"]
    PALETTE = DEFAULT_PALETTE[:len(CLASSES)]


@DATASETS.register()
class CoNSePCocoDataset(WSICocoDataset):
    CLASSES = DATASET_CLASSES["CoNSePCocoDataset"]
    PALETTE = DEFAULT_PALETTE[:len(CLASSES)]


@DATASETS.register()
class CoNICCocoDataset(WSICocoDataset):
    CLASSES = DATASET_CLASSES["CoNICCocoDataset"]
    PALETTE = DEFAULT_PALETTE[:len(CLASSES)]


@DATASETS.register()
class NuCLSCocoDataset(WSICocoDataset):
    CLASSES = DATASET_CLASSES["NuCLSCocoDataset"]
    PALETTE = DEFAULT_PALETTE[:len(CLASSES)]


def build_dataset(cfg: dict, default_args: dict | None = None):
    """Reference-style dataset config → dataset (handles the CASDataset and
    SemiDataset wrappers)."""
    cfg = dict(cfg)
    typ = cfg.pop("type")
    if typ == "CASDataset":
        inner = build_dataset(cfg.pop("dataset"), default_args)
        return CASDataset(inner, **cfg)
    if typ == "SemiDataset":
        sup = build_dataset(cfg.pop("sup"), default_args)
        unsup = build_dataset(cfg.pop("unsup"), default_args) if "unsup" in cfg else None
        return SemiDataset(sup, unsup, **cfg)
    cls = DATASETS.get(typ)
    # mmdet semantics: default_args fill gaps, never override explicit cfg
    for k, v in (default_args or {}).items():
        cfg.setdefault(k, v)
    return cls(**cfg)
