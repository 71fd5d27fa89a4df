"""Synthetic inputs for runs without data or a checkpoint (the smoke run and
the stage profile): blob tiles from a seed, and a lift of the objectness
logit so that random weights yield detections; and the kernels' inputs at
the main path's shapes (boxes and maps for K4, a blob mask for K3); and a
whole slide: tissue regions of that blob texture on a near-white ground;
and patch datasets in the layouts of the PanNuke and the NuCLS releases."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


def synthetic_tiles(rng: np.random.RandomState, n: int, size: int = 256) -> list:
    """``n`` uint8 (size, size, 3) tiles with dark round blobs (the repo's
    bench recipe)."""
    yy, xx = np.mgrid[:64, :64]
    blob = ((yy - 32) ** 2 + (xx - 32) ** 2 <= 150).astype(np.int16)
    tiles = []
    for _ in range(n):
        img = rng.randint(160, 230, (size, size, 3)).astype(np.int16)
        for _ in range(20):
            y, x = rng.randint(0, size - 64, 2)
            img[y:y + 64, x:x + 64, 0] -= 60 * blob
            img[y:y + 64, x:x + 64, 2] -= 30 * blob
        tiles.append(np.clip(img, 0, 255).astype(np.uint8))
    return tiles


def synthetic_slide(rng: np.random.RandomState, size: int = 2304) -> np.ndarray:
    """A uint8 (size, size, 3) H&E-like slide: near-white, almost colourless
    ground; a large irregular tissue region with a hole and a smaller second
    region, both pink with the dark blobs of ``synthetic_tiles`` at its
    density (20 per 256²). Regions are unions of random discs on a grid of
    16-pixel cells."""
    cells = size // 16
    yy, xx = np.mgrid[:cells, :cells] / float(cells)

    def discs(n, centre, spread, radius):
        out = np.zeros((cells, cells), bool)
        for _ in range(n):
            cy, cx = centre + rng.uniform(-spread, spread, 2)
            out |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(0.6, 1.0) * radius ** 2
        return out

    tissue = discs(8, np.array([0.40, 0.40]), 0.10, 0.29)
    tissue &= ~discs(2, np.array([0.40, 0.38]), 0.03, 0.09)  # the hole
    tissue |= discs(3, np.array([0.86, 0.86]), 0.02, 0.13)
    tissue = np.kron(tissue, np.ones((16, 16), bool))

    grey = rng.randint(238, 246, (size, size, 1)) + rng.randint(-1, 2, (size, size, 3))
    img = rng.randint(160, 230, (size, size, 3)).astype(np.int16)
    img[..., 1] -= 40  # pink: less green
    yb, xb = np.mgrid[:64, :64]
    blob = ((yb - 32) ** 2 + (xb - 32) ** 2 <= 150).astype(np.int16)
    for _ in range(20 * (size // 256) ** 2):
        y, x = rng.randint(0, size - 64, 2)
        img[y:y + 64, x:x + 64, 0] -= 60 * blob
        img[y:y + 64, x:x + 64, 2] -= 30 * blob
    return np.where(tissue[..., None], np.clip(img, 0, 255), grey).astype(np.uint8)


def slide_and_grid(side: int = 2304, seed: int = 0, tile: int = 256, step: int = 192):
    """The synthetic slide as an ``ArraySlide`` with levels 1 to 32, its
    tissue segmentation and tile grid (stage A), and stage A's seconds. The
    area limits are scaled for a slide this small: ``ref_patch_size=64``
    makes them 200 and 32 pixels of the level segmented, where a scanner's
    slide takes the default 512."""
    from nuhtc_tpu_torch.wsi.slide import ArraySlide
    from nuhtc_tpu_torch.wsi.tissue import grid_coords, segment_tissue

    slide = ArraySlide(synthetic_slide(np.random.RandomState(seed), side), (1, 2, 4, 8, 16, 32))
    t0 = time.perf_counter()
    seg = segment_tissue(slide, ref_patch_size=64)
    coords = grid_coords(slide, seg, tile, step)
    return slide, seg, coords, time.perf_counter() - t0


def lift_objectness(model, logit: float = 3.0) -> None:
    """Random weights score no detection above 0.35; raising each cascade
    head's positive-objectness logit lets detections through, so NMS, the
    mask head and the paste work on real boxes. A Mask R-CNN's one head
    (no objectness) gets its first class raised instead: its random scores
    sit near 1/(C+1) for every class, and a dominant class spreads them."""
    with torch.no_grad():
        heads = model.roi_head.bbox_head
        if isinstance(heads, torch.nn.ModuleList):
            for head in heads:
                head.fc_cls.bias[head.num_classes] += logit
        else:
            heads.fc_cls.bias[0] += logit


def roi_boxes(rng, b, r, extent=512.0):
    """(b, r, 4) boxes in image coordinates: nucleus-sized ones, plus tiny,
    large (> 32 cells at stride 4), border-crossing and zero-size ones."""
    xy = rng.uniform(-8, extent - 8, (b, r, 2))
    wh = rng.uniform(6, 64, (b, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    n = r // 16
    rois[:, :n, 2:] = rois[:, :n, :2] + rng.uniform(0.05, 2.0, (b, n, 2))  # tiny
    big = rng.uniform(-40, 200, (b, n, 2))
    rois[:, n:2 * n] = np.concatenate([big, big + rng.uniform(140, 500, (b, n, 2))], -1)
    rois[:, 2 * n:3 * n, :2] = rng.uniform(-60, -1, (b, n, 2))  # cross the near border
    rois[:, 2 * n:3 * n, 2:] = rng.uniform(4, 60, (b, n, 2))
    far = rng.uniform(extent - 30, extent - 2, (b, n, 2))  # cross the far border
    rois[:, 3 * n:4 * n] = np.concatenate([far, far + rng.uniform(20, 80, (b, n, 2))], -1)
    rois[:, 4 * n:5 * n, 2:] = rois[:, 4 * n:5 * n, :2]  # zero size
    rois[:, 5 * n] = [-200, -200, -150, -150]  # wholly outside
    return rois


def clustered_roi_boxes(rng, b, r, nuclei: int = 40, extent: float = 512.0):
    """(b, r, 4) boxes as a train step samples them: jittered copies of the
    boxes of ``nuclei`` nuclei a tile (16-60 px, centres within 0.3 of the
    side, sides within exp(±0.4)), so that many RoIs cover the same cells,
    and one eighth of proposals anywhere (8-120 px)."""
    out = np.zeros((b, r, 4), np.float32)
    for i in range(b):
        cx, cy = rng.uniform(20, extent - 20, (2, nuclei))
        side = rng.uniform(16, 60, nuclei)
        k = rng.randint(0, nuclei, r)
        w = side[k] * np.exp(rng.uniform(-0.4, 0.4, r))
        h = side[k] * np.exp(rng.uniform(-0.4, 0.4, r))
        x = cx[k] + rng.uniform(-0.3, 0.3, r) * side[k]
        y = cy[k] + rng.uniform(-0.3, 0.3, r) * side[k]
        out[i] = np.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
        n = r // 8
        xy = rng.uniform(0, extent - 32, (n, 2))
        out[i, :n] = np.concatenate([xy, xy + rng.uniform(8, 120, (n, 2))], -1)
    return out


def roi_stage_inputs(device, batch: int = 16, box_r: int = 1512, mask_r: int = 500,
                     channels: int = 64):
    """The RoI inputs of one forward at the main path's shapes: the two fine
    levels and the semantic map (f32; 128², 64² and 128²), the boxes of the bbox stages
    and of the mask stage, a per-RoI bias for each, and the stage calls
    (name, boxes, bias, calls per forward, roi_align_sum's arguments)."""
    rng = np.random.RandomState(4)
    maps = {name: torch.from_numpy(rng.randn(batch, side, side, channels).astype(np.float32)
                                   ).to(device)
            for name, side in (("p2", 128), ("p3", 64), ("semantic", 128))}
    box_rois = torch.from_numpy(roi_boxes(rng, batch, box_r)).to(device)
    mask_rois = torch.from_numpy(roi_boxes(rng, batch, mask_r)).to(device)
    box_bias = torch.from_numpy(rng.randn(batch, box_r, channels).astype(np.float32)).to(device)
    mask_bias = torch.from_numpy(rng.randn(batch, mask_r, channels).astype(np.float32)).to(device)
    scales = [0.25, 0.125, 0.25]
    stages = [
        ("bbox stage", box_rois, box_bias, 3, (scales, 7, [2, 2, 0], [None, None, 14])),
        ("mask stage", mask_rois, mask_bias, 1, (scales, 14, [0, 0, 0], [None, None, None])),
    ]
    return maps, box_rois, mask_rois, stages


def blob_mask(rng, b, size, n_blobs):
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((b, size, size), bool)
    for i in range(b):
        for _ in range(n_blobs):
            cy, cx = rng.randint(0, size, 2)
            r = rng.randint(3, 12)
            mask[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return mask


PANNUKE_TINTS = ((96, 70, 160), (120, 60, 140), (80, 90, 150), (60, 60, 90), (110, 80, 170))


def synthetic_pannuke(rng: np.random.RandomState, n: int, size: int = 256,
                      nuclei: tuple = (30, 60)):
    """A PanNuke release of ``n`` tiles made from ``rng``: images (n, size,
    size, 3) float64 in [0, 255], masks (n, size, size, 6) float64 (one
    instance map per class, ids from 1; channel 5 is 1 on the background)
    and types (n,) tissue names, as the release's images.npy, masks.npy and
    types.npy hold them. Each tile: a pink textured ground and ``nuclei``
    (low, high) elliptical nuclei that do not overlap, each filled with its
    class's dark tint; the first five nuclei take the five classes in turn,
    the rest are drawn with PanNuke's imbalance (neoplastic most, dead
    fewest), so every class is present in a tile unless a nucleus of the
    first five is dropped (under 12 pixels left free)."""
    tissues = ("Breast", "Colon", "Lung", "Kidney", "Prostate")
    class_p = np.asarray([0.45, 0.2, 0.2, 0.05, 0.1])
    images = np.zeros((n, size, size, 3), np.float64)
    masks = np.zeros((n, size, size, 6), np.float64)
    types = np.asarray([tissues[rng.randint(len(tissues))] for _ in range(n)])
    cells = -(-size // 8)
    for i in range(n):
        noise = np.kron(rng.randn(cells, cells, 3) * 10, np.ones((8, 8, 1)))[:size, :size]
        img = np.asarray([232.0, 201.0, 212.0]) + noise
        occupied = np.zeros((size, size), bool)
        ids = np.zeros(5, np.int64)
        for k in range(rng.randint(*nuclei)):
            c = k if k < 5 else int(rng.choice(5, p=class_p))
            cy, cx = rng.uniform(10, size - 10, 2)
            a = rng.uniform(4.0, 10.0)
            b = a * rng.uniform(0.6, 1.0)
            ang = rng.uniform(0, np.pi)
            y0, y1 = max(int(cy - a) - 1, 0), min(int(cy + a) + 2, size)
            x0, x1 = max(int(cx - a) - 1, 0), min(int(cx + a) + 2, size)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
            v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
            m = ((u / a) ** 2 + (v / b) ** 2 <= 1.0) & ~occupied[y0:y1, x0:x1]
            if m.sum() < 12:
                continue
            occupied[y0:y1, x0:x1] |= m
            ids[c] += 1
            masks[i, y0:y1, x0:x1, c][m] = ids[c]
            tint = np.asarray(PANNUKE_TINTS[c], np.float64) + rng.randn(3) * 8
            img[y0:y1, x0:x1][m] = tint + rng.randn(int(m.sum()), 3) * 6
        masks[i, :, :, 5] = ~occupied
        images[i] = np.clip(np.round(img), 0, 255)
    return images, masks, types


def synthetic_nucls(root: str, splits=(("train", 8), ("unlabeled", 8), ("test", 4)),
                    size: int = 256, seed: int = 0, fovloc: bool = False) -> dict:
    """A release in the NuCLS schema of ``configs/nuhtc/semi_base.py`` under
    ``root``: ``datasets/NuCLS/rgb`` and ``rgb_seg`` PNGs and
    ``coco/NuCLS/NuCLS_annt_RLE_<split>.json`` for each (split, tiles) of
    ``splits``, made from ``synthetic_pannuke`` tiles of one seed through
    ``tools.preprocess_pannuke``: the five PanNuke classes relabelled onto
    the eight NuCLS ones (annotation k of class c takes class (c + 5·(k mod
    2)) mod 8), every other annotation box-only (``ismask`` 0), and the
    "unlabeled" split without annotations. With ``fovloc`` each image record
    also carries a field of view, ``fovloc`` = [x1, y1, x2, y2] drawn from
    ``RandomState(seed + 1)`` (each edge up to a quarter of the tile in),
    which ``FOVCrop`` crops to; without it the files are as before. Returns
    the config options that point ``semi_base.py`` at it, the unlabelled
    split with ``filter_empty`` off (its images have no annotations)."""
    from nuhtc_tpu_torch.data.classes import dataset_classes
    from nuhtc_tpu_torch.tools import preprocess_pannuke

    rng = np.random.RandomState(seed)
    fov_rng = np.random.RandomState(seed + 1)
    os.makedirs(root, exist_ok=True)
    ds, coco = os.path.join(root, "datasets", "NuCLS"), os.path.join(root, "coco", "NuCLS")
    cats = [dict(id=c + 1, name=n) for c, n in enumerate(dataset_classes("NuCLSCocoDataset"))]
    for fold, (split, n) in enumerate(splits, start=1):
        arrays = synthetic_pannuke(rng, n, size)
        paths = [os.path.join(root, f"{name}_{split}.npy") for name in ("images", "masks")]
        for path, arr in zip(paths, arrays):
            np.save(path, arr)
        if preprocess_pannuke.main(["--images", paths[0], "--masks", paths[1], "--fold",
                                    str(fold), "--out-dir", ds, "--coco-dir", coco]) != 0:
            raise RuntimeError(f"preprocess_pannuke failed on the {split} split")
        src = os.path.join(coco, f"PanNuke_annt_RLE_fold{fold}.json")
        with open(src) as f:
            data = json.load(f)
        for k, ann in enumerate(data["annotations"]):
            ann["category_id"] = (ann["category_id"] - 1 + 5 * (k % 2)) % 8 + 1
            ann["ismask"] = 1 - k % 2
        if fovloc:
            for img in data["images"]:
                lo = fov_rng.randint(0, size // 4 + 1, 2)
                hi = size - fov_rng.randint(0, size // 4 + 1, 2)
                img["fovloc"] = [int(lo[0]), int(lo[1]), int(hi[0]), int(hi[1])]
        if split == "unlabeled":
            data["annotations"] = []
        data["categories"] = cats
        with open(os.path.join(coco, f"NuCLS_annt_RLE_{split}.json"), "w") as f:
            json.dump(data, f)
        os.remove(src)
    return {"data.train.sup.ann_file": os.path.join(coco, "NuCLS_annt_RLE_train.json"),
            "data.train.sup.img_prefix": os.path.join(ds, "rgb") + "/",
            "data.train.sup.seg_prefix": os.path.join(ds, "rgb_seg"),
            "data.train.unsup.ann_file": os.path.join(coco, "NuCLS_annt_RLE_unlabeled.json"),
            "data.train.unsup.img_prefix": os.path.join(ds, "rgb") + "/",
            "data.train.unsup.filter_empty": False,
            "data.test.ann_file": os.path.join(coco, "NuCLS_annt_RLE_test.json"),
            "data.test.img_prefix": os.path.join(ds, "rgb") + "/",
            "data.test.seg_prefix": os.path.join(ds, "rgb_seg")}
