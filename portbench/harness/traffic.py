"""The one traffic generator: tiles and slides from a traffic file's
parameters and a seed. Frozen copies of the port's synthetic recipes
(``nuhtc_tpu_torch/tools/synthetic.py synthetic_tiles`` and
``tools/analysis_tools/benchmark_wsi.py synthetic_benchmark_slide``: pale
tissue with dark round blobs), with the blob count and sizes read from the
traffic file and the random stream from the seed. The same seed gives the
same tiles and slides; every seed gives the same sizes and counts."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _blob(radius2: int) -> np.ndarray:
    yy, xx = np.mgrid[:64, :64]
    return ((yy - 32) ** 2 + (xx - 32) ** 2 <= radius2).astype(np.int16)


def tiles(rng: np.random.RandomState, n: int, size: int = 256, blobs: int = 20,
          radius2: int = 150) -> List[np.ndarray]:
    """``n`` uint8 (size, size, 3) tiles, ``blobs`` dark blobs each."""
    blob = _blob(radius2)
    out = []
    for _ in range(n):
        img = rng.randint(160, 230, (size, size, 3)).astype(np.int16)
        for _ in range(blobs):
            y, x = rng.randint(0, size - 64, 2)
            img[y:y + 64, x:x + 64, 0] -= 60 * blob
            img[y:y + 64, x:x + 64, 2] -= 30 * blob
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def slide(rng: np.random.RandomState, n_tiles: int, cols: int = 8, tile: int = 256,
          blobs_per_tile: int = 20, radius2: int = 150) -> Tuple[np.ndarray, np.ndarray]:
    """→ (RGB uint8 slide of ceil(n / cols) × cols tiles, the tile origins
    (x, y) in raster order, int64 (n, 2))."""
    rows = (n_tiles + cols - 1) // cols
    hw = (rows * tile, cols * tile)
    img = rng.randint(160, 230, (hw[0], hw[1], 3), np.uint8)
    blob = _blob(radius2).astype(np.uint8)
    for _ in range(n_tiles * blobs_per_tile):
        y, x = rng.randint(0, hw[0] - 64), rng.randint(0, hw[1] - 64)
        reg = img[y:y + 64, x:x + 64].astype(np.int16)
        reg[..., 0] -= 60 * blob
        reg[..., 2] -= 30 * blob
        img[y:y + 64, x:x + 64] = np.clip(reg, 0, 255).astype(np.uint8)
    coords = np.stack([np.tile(np.arange(cols) * tile, rows)[:n_tiles],
                       np.repeat(np.arange(rows) * tile, cols)[:n_tiles]], axis=1)
    return img, coords.astype(np.int64)
