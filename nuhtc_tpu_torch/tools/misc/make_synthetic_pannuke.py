"""A synthetic PanNuke release for the train → checkpoint → evaluation loop
without the real one (port of tools/misc/make_synthetic_pannuke.py; the
release's layout: images.npy (N, 256, 256, 3) RGB, masks.npy (N, 256, 256,
6) per-class instance maps, types.npy (N,) tissue names).

    python -m nuhtc_tpu_torch.tools.misc.make_synthetic_pannuke --out syn \\
        --n-tiles 64 [--seed 0]

A tile: a pink ground with low-frequency texture (float32 noise at 1/8 of
the side, resized by OpenCV's INTER_LINEAR, ``ops.imgproc.resize_linear_f32``),
and 8-39 elliptical nuclei of five classes in PanNuke's imbalance, each a
filled ellipse as ``cv2.ellipse`` draws it (``ops.contours.ellipse``), that
do not overlap, filled with a dark class tint. For the same seed the three
.npy files are byte-equal to the JAX tool's. Host only.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.ops.contours import ellipse
from nuhtc_tpu_torch.ops.imgproc import resize_linear_f32

TISSUES = ("Breast", "Colon", "Lung", "Kidney", "Prostate")
CLASS_P = np.asarray([0.45, 0.2, 0.2, 0.05, 0.1])  # neoplastic most, dead fewest
TINTS = np.asarray([[96, 70, 160], [120, 60, 140], [80, 90, 150], [60, 60, 90], [110, 80, 170]],
                   np.float32)


def make_tile(rng: np.random.RandomState, size: int = 256):
    """→ (image (size, size, 3) float32 in [0, 255], masks (size, size, 6)
    int32: per-class instance ids, channel 5 the background)."""
    img = np.tile(np.asarray([232, 201, 212], np.float32), (size, size, 1))
    noise = rng.randn(size // 8, size // 8, 3).astype(np.float32) * 10
    img += resize_linear_f32(noise, (size, size))
    masks = np.zeros((size, size, 6), np.int32)
    n_nuclei = rng.randint(8, 40)
    inst_ids = np.zeros(5, np.int32)
    occupied = np.zeros((size, size), bool)
    for _ in range(n_nuclei):
        c = rng.choice(5, p=CLASS_P)
        cx, cy = rng.randint(12, size - 12, 2)
        a = rng.randint(4, 14)
        b = max(int(a * rng.uniform(0.6, 1.0)), 3)
        ang = rng.uniform(0, 180)
        m = ellipse(np.zeros((size, size), np.uint8), (cx, cy), (a, b), ang, 1)
        m = m.astype(bool) & ~occupied
        if m.sum() < 12:
            continue
        occupied |= m
        inst_ids[c] += 1
        masks[:, :, c][m] = inst_ids[c]
        tint = TINTS[c] + rng.randn(3) * 8
        img[m] = tint + rng.randn(int(m.sum()), 3) * 6
    masks[:, :, 5] = (~occupied).astype(np.int32)
    return np.clip(img, 0, 255), masks


def make_release(n_tiles: int, seed: int = 0, size: int = 256):
    """→ (images, masks, types) as the tool saves them."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n_tiles, size, size, 3), np.float64)
    masks = np.zeros((n_tiles, size, size, 6), np.float64)
    types = np.asarray([TISSUES[rng.randint(len(TISSUES))] for _ in range(n_tiles)])
    for i in range(n_tiles):
        imgs[i], masks[i] = make_tile(rng, size)
    return imgs, masks, types


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.misc.make_synthetic_pannuke")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-tiles", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args(argv)
    imgs, masks, types = make_release(args.n_tiles, args.seed, args.size)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "images.npy"), imgs)
    np.save(os.path.join(args.out, "masks.npy"), masks)
    np.save(os.path.join(args.out, "types.npy"), types)
    n_inst = int(sum(len(np.unique(masks[i, :, :, c])) - 1
                     for i in range(args.n_tiles) for c in range(5)))
    print(f"{args.n_tiles} tiles, {n_inst} instances → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
