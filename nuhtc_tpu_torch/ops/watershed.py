"""Distance transform and watershed on the device, batched over (N, H, W).

Port of nuhtc_tpu/ops/watershed.py (the reference's seg-head proposal path
and the ``_Lite_Fuse`` per-class instances, nuhtc/models/
htc_roi_head_cus.py:300-320, 3524-3563):

- ``edt``: jump flooding of the nearest background seed (log2(N) passes of 8
  fixed shifts, then one more pass at offset 1), the euclidean distance of
  each foreground pixel to it;
- ``watershed``: each masked pixel points at its steepest-ascent neighbour,
  marked pixels and local maxima at themselves, and ten rounds of pointer
  jumping carry every pixel to its root's marker;
- ``watershed_segmentation``: per class map blur → threshold → open (5×5,
  2) → fill holes → components (or the watershed of a distance map) → the
  first K roots' boxes and areas, filtered to ``min_area < area < HW/4``;
- ``watershed_proposals_from_dist``: the seg head's proposal variant.

Every map of a batch goes through ``label_components_raw``, ``first_roots``
and one ``component_stats`` call together, so on the card the boxes come
from K3 in one launch. ``first_roots`` computes the plain top-k (the JAX
package's per-row cap is TPU machinery with the same result).
"""

from __future__ import annotations

import torch

from nuhtc_tpu_torch.ops import morphology
from nuhtc_tpu_torch.ops.components import component_stats, first_roots, label_components_raw


def _shift2(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """x shifted by (dy, dx) over its last two dims, ``fill`` where vacated."""
    h, w = x.shape[-2:]
    x = torch.roll(x, (dy, dx), dims=(-2, -1))
    iy = torch.arange(h, device=x.device)[:, None]
    ix = torch.arange(w, device=x.device)[None, :]
    keep = (iy >= dy) & (iy < h + dy) & (ix >= dx) & (ix < w + dx)
    return torch.where(keep, x, fill)


def _grid(h: int, w: int, device):
    yy = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w)
    return yy, xx


def edt(mask: torch.Tensor) -> torch.Tensor:
    """Distance of each foreground pixel of (N, H, W) masks to the nearest
    background pixel (f32; 0 on the background)."""
    h, w = mask.shape[-2:]
    mask = mask.bool()
    yy, xx = _grid(h, w, mask.device)
    big = 1 << 20
    sy = torch.where(mask, big, yy)
    sx = torch.where(mask, big, xx)

    def dist2(syv, sxv):
        # coordinates < 2^13: squared distances < 2^27 fit int32
        dy = syv.clamp(0, h) - yy
        dx = sxv.clamp(0, w) - xx
        return torch.where(syv >= big, 1 << 29, dy * dy + dx * dx)

    step = 1
    while step < max(h, w):
        step *= 2
    steps = []
    while step >= 1:
        steps.append(step)
        step //= 2
    steps.append(1)
    for k in steps:
        best = dist2(sy, sx)
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cy = _shift2(sy, dy, dx, big)
                cx = _shift2(sx, dy, dx, big)
                d = dist2(cy, cx)
                take = d < best
                sy = torch.where(take, cy, sy)
                sx = torch.where(take, cx, sx)
                best = torch.where(take, d, best)
    d = torch.sqrt(dist2(sy, sx).float())
    return torch.where(mask, d, 0.0)


def watershed(neg_elevation: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
              jump_passes: int = 10) -> torch.Tensor:
    """Marker watershed of (N, H, W) by steepest ascent of ``-neg_elevation``
    to a marked root; ``markers`` int labels (0 = none) → int labels, 0
    outside ``mask``."""
    n, h, w = neg_elevation.shape
    mask = mask.bool()
    elev = torch.where(mask, -neg_elevation.float(), float("-inf"))
    yy, xx = _grid(h, w, elev.device)
    self_idx = (yy * w + xx).expand(n, h, w)
    best_val, parent = elev, self_idx
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nv = _shift2(elev, dy, dx, float("-inf"))
            ni = _shift2(self_idx, dy, dx, -1)
            take = nv > best_val
            best_val = torch.where(take, nv, best_val)
            parent = torch.where(take, ni, parent)
    parent = torch.where(mask & (markers == 0), parent, self_idx)
    parent = torch.where(parent < 0, self_idx, parent).reshape(n, h * w).long()
    for _ in range(jump_passes):
        parent = parent.gather(1, parent)
    labels = markers.reshape(n, h * w).gather(1, parent).reshape(n, h, w)
    return torch.where(mask, labels, 0)


def _prepared_mask(logits: torch.Tensor, thres: float) -> torch.Tensor:
    """blur → threshold → open (5×5, 2 iterations) → fill holes."""
    mask = morphology.gaussian_blur5(logits) > thres
    mask = morphology.binary_open(mask, ksize=5, iterations=2) > 0.5
    return morphology.fill_holes(mask)


def watershed_segmentation(seg_logits: torch.Tensor, dist: torch.Tensor | None = None,
                           max_instances: int = 256, min_area: int = 10, thres: float = 0.0,
                           score: float = 0.36):
    """Per-map watershed instances of (N, H, W) class logits (the
    ``_Lite_Fuse`` result; N is batch × classes), ``dist`` an optional
    distance map broadcast to (N, H, W).

    Without ``dist`` the instances are the components of each prepared mask
    (every foreground pixel has EDT ≥ 1, so the reference's markers EDT >
    0.25 are the mask itself); with it, markers are ``dist > 0.25`` within
    the mask and instances its watershed over ``-dist``.

    Returns boxes5 (N, K, 5) [x1, y1, x2+1, y2+1, score] f32, valid (N, K),
    inst (N, H, W) int32 instance maps (id = root linear index + 1, 0 =
    background) and roots (N, K) int32 (H·W on empty slots): instance k of
    map i is ``inst[i] == roots[i, k] + 1``."""
    n_maps, h, w = seg_logits.shape
    n = h * w
    mask = _prepared_mask(seg_logits, thres)
    if dist is None:
        raw = label_components_raw(mask)
        inst = torch.where(mask, raw + 1, 0)
    else:
        dist = dist.float().expand(n_maps, h, w)
        marker_mask = (dist > 0.25) & mask
        raw = label_components_raw(marker_mask)
        inst = watershed(-dist, torch.where(marker_mask, raw + 1, 0), mask)
        raw = torch.where(inst > 0, inst - 1, n)
        mask = inst > 0
    roots, valid = first_roots(raw, mask, max_instances)
    boxes, areas = component_stats(raw, roots)
    valid = valid & (areas > min_area) & (areas < n / 4)
    boxes5 = torch.cat([boxes, torch.full_like(boxes[..., :1], score)], dim=-1)
    boxes5 = torch.where(valid[..., None], boxes5, 0.0)
    return boxes5, valid, inst.to(torch.int32), torch.where(valid, roots, n)


def watershed_proposals_from_dist(seg_logits: torch.Tensor, dist_logits: torch.Tensor,
                                  max_components: int = 512, min_area: int = 10,
                                  dist_thr: float = 0.25):
    """The seg head's proposals of (N, H, W) binary-seg and distance logits:
    markers ``sigmoid(blur(dist)) > dist_thr`` within the prepared seg
    mask, the watershed over the negated distance, the boxes of the first
    K markers' basins → (boxes5 (N, K, 5) [x1, y1, x2+1, y2+1, 1], valid)."""
    h, w = seg_logits.shape[-2:]
    mask = _prepared_mask(seg_logits, 0.0)
    dist = torch.sigmoid(morphology.gaussian_blur5(dist_logits))
    marker_mask = (dist > dist_thr) & mask
    raw = label_components_raw(marker_mask)
    inst = watershed(-dist, torch.where(marker_mask, raw + 1, 0), mask)
    roots, valid = first_roots(raw, marker_mask, max_components)
    boxes, areas = component_stats(inst, torch.where(valid, roots + 1, -1))
    valid = valid & (areas > min_area) & (areas < h * w / 4)
    boxes5 = torch.cat([boxes, torch.ones_like(boxes[..., :1])], dim=-1)
    return torch.where(valid[..., None], boxes5, 0.0), valid
