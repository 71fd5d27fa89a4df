"""Synthetic inputs for runs without data or a checkpoint (the smoke run and
the stage profile): blob tiles from a seed, and a lift of the objectness
logit so that random weights yield detections."""

from __future__ import annotations

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


def lift_objectness(model, logit: float = 3.0) -> None:
    """Random weights score no detection above 0.35; raising each cascade
    head's positive-objectness logit lets detections through, so NMS, the
    mask head and the paste work on real boxes."""
    with torch.no_grad():
        for head in model.roi_head.bbox_head:
            head.fc_cls.bias[head.num_classes] += logit
