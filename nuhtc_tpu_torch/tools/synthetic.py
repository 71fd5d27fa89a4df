"""Synthetic inputs for runs without data or a checkpoint (the smoke run and
the stage profile): blob tiles from a seed, and a lift of the objectness
logit so that random weights yield detections; and the kernels' inputs at
the main path's shapes (boxes and maps for K4, a blob mask for K3)."""

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
