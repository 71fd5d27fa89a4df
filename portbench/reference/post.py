"""The frozen reference of a slide's per-tile post-processing: margin and
area filter, greedy mask NMS (IoU > 0.05, score-descending), and each kept
mask's first contour (``find_contours``: OpenCV's border following,
RETR_TREE, CHAIN_APPROX_SIMPLE), mapped to the slide frame.

A frozen copy of ``nuhtc_tpu_torch/wsi/infer.py postprocess_tile``,
``eval/evaluate.py mask_nms`` and ``ops/contours.py find_contours`` as they
stood when the benchmark was defined. The port takes the masks' IoU from
their run-length codes; here it is taken from the masks themselves, which
gives the same numbers. It imports nothing of the port.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

RETR_EXTERNAL = 0
RETR_CCOMP = 2
RETR_TREE = 3
CHAIN_APPROX_NONE = 1
CHAIN_APPROX_SIMPLE = 2

_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def _trace(f, y0: int, x0: int, is_hole: bool, nbd: int, simple: bool) -> list:
    """Follows one border of the padded label image ``f`` (a list of row
    lists: 0 background, 1 unvisited foreground, ±n visited by border n,
    negative where the border passed with background examined on its east
    side) from (y0, x0), marks it with ``nbd`` and returns its (x, y) points."""
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        if f[y0 + _DY[s]][x0 + _DX[s]] != 0 or s == s_end:
            break
    if f[y0 + _DY[s]][x0 + _DX[s]] == 0:  # a single pixel
        f[y0][x0] = -nbd
        return [(x0, y0)]
    y1, x1 = y0 + _DY[s], x0 + _DX[s]
    pts = []
    y3, x3 = y0, x0
    prev_s = s ^ 4
    while True:
        s_end = s
        while True:  # the next foreground neighbour, counter-clockwise
            s += 1
            y4, x4 = y3 + _DY[s & 7], x3 + _DX[s & 7]
            if f[y4][x4] != 0:
                break
        s &= 7
        # the search passed east (code 8) and found background there
        if 1 <= s <= s_end:
            f[y3][x3] = -nbd
        elif f[y3][x3] == 1:
            f[y3][x3] = nbd
        if s != prev_s or not simple:
            pts.append((x3, y3))
            prev_s = s
        if y4 == y0 and x4 == x0 and y3 == y1 and x3 == x1:
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return pts


def find_contours(mask: np.ndarray, mode: int = RETR_TREE, method: int = CHAIN_APPROX_SIMPLE,
                  ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
    """``cv2.findContours(mask, mode, method)`` for ``RETR_EXTERNAL``,
    ``RETR_CCOMP`` and ``RETR_TREE`` with ``CHAIN_APPROX_NONE`` or
    ``CHAIN_APPROX_SIMPLE``. ``RETR_EXTERNAL`` gives the top level of the
    tree, in the tree's order.

    Returns (contours, hierarchy): a list of (P, 1, 2) int32 arrays of
    (x, y) points and a (1, N, 4) int32 array of [next, previous, first
    child, parent] indices, or ``([], None)`` when the mask is empty. Any
    non-zero pixel is foreground."""
    if mode == RETR_EXTERNAL:
        found, tree = find_contours(mask, RETR_TREE, method)
        if tree is None:
            return found, tree
        top = [i for i in range(len(found)) if tree[0, i, 3] == -1]
        k = len(top)
        hierarchy = np.full((1, k, 4), -1, np.int32)
        hierarchy[0, :, 0] = np.where(np.arange(k) + 1 < k, np.arange(k) + 1, -1)
        hierarchy[0, :, 1] = np.arange(k) - 1
        return [found[i] for i in top], hierarchy
    if mode not in (RETR_CCOMP, RETR_TREE):
        raise ValueError(f"find_contours: mode {mode} is not RETR_EXTERNAL, RETR_CCOMP or "
                         "RETR_TREE")
    if method not in (CHAIN_APPROX_NONE, CHAIN_APPROX_SIMPLE):
        raise ValueError(f"find_contours: method {method} is not CHAIN_APPROX_NONE or _SIMPLE")
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D mask, got shape {mask.shape}")
    fg = mask != 0
    rows = np.flatnonzero(fg.any(1))
    if len(rows) == 0:
        return [], None
    cols = np.flatnonzero(fg.any(0))
    oy, ox = int(rows[0]), int(cols[0])
    # the bounding box with a zero frame: nothing outside it can start or
    # bend a border, and raster order inside it is that of the whole image
    crop = np.pad(fg[oy:rows[-1] + 1, ox:cols[-1] + 1], 1).astype(np.int8)
    # a border can only start where a row changes value: 0→1 an outer
    # border (at the 1), 1→0 a hole border (at the 1 left of the 0)
    d = np.diff(crop, axis=1)
    ys, xs = np.nonzero(d)
    kinds = d[ys, xs]
    f = crop.astype(np.int32).tolist()
    simple = method == CHAIN_APPROX_SIMPLE

    # border 1 is the frame; parents and kinds by border number
    parent = [0, 0]
    hole = [False, True]
    points: List[list] = [[], []]
    nbd = 1
    for y, x, kind in zip(ys.tolist(), xs.tolist(), kinds.tolist()):
        row = f[y]
        if kind == 1:
            x += 1  # the 1 right of the change
            if row[x] != 1:
                continue
            is_hole = False
        else:
            if row[x] < 1:
                continue
            is_hole = True
        # the border met last on this row: the last visited pixel left of the start
        lnbd = 1
        for xx in range(x if is_hole else x - 1, 0, -1):
            v = row[xx]
            if v != 0 and v != 1:
                lnbd = abs(v)
                break
        nbd += 1
        if not is_hole and mode == RETR_CCOMP:
            par = 1
        else:
            par = parent[lnbd] if hole[lnbd] == is_hole else lnbd
        parent.append(par)
        hole.append(is_hole)
        points.append(_trace(f, y, x, is_hole, nbd, simple))

    # siblings newest first, contours in pre-order of the tree
    children: List[list] = [[] for _ in range(nbd + 1)]
    for b in range(nbd, 1, -1):
        children[parent[b]].append(b)
    order: List[int] = []
    stack = children[1][::-1]
    while stack:
        b = stack.pop()
        order.append(b)
        stack.extend(children[b][::-1])
    index = {b: i for i, b in enumerate(order)}
    index[1] = -1
    hierarchy = np.full((1, len(order), 4), -1, np.int32)
    for b in order:
        sibs = children[parent[b]]
        k = sibs.index(b)
        hierarchy[0, index[b]] = (
            index[sibs[k + 1]] if k + 1 < len(sibs) else -1,
            index[sibs[k - 1]] if k > 0 else -1,
            index[children[b][0]] if children[b] else -1,
            index[parent[b]],
        )
    shift = np.array([ox - 1, oy - 1], np.int32)
    contours = [np.asarray(points[b], np.int32).reshape(-1, 1, 2) + shift for b in order]
    return contours, hierarchy




def mask_iou(masks: np.ndarray) -> np.ndarray:
    """(n, H, W) binary masks → (n, n) IoU (0 where both are empty)."""
    flat = masks.reshape(len(masks), -1).astype(np.float64)
    inter = flat @ flat.T
    area = flat.sum(1)
    union = area[:, None] + area[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mask_nms(masks: np.ndarray, scores: np.ndarray, thr: float = 0.05) -> np.ndarray:
    """Greedy suppression, score-descending → kept original indices."""
    n = len(masks)
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(scores)[::-1]
    iou = mask_iou(masks[order])
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        keep[i + 1:] &= ~(iou[i, i + 1:] > thr)
    return order[keep]


def postprocess_tile(result: dict, coord: Tuple[int, int], tile_size: int, margin: int = 0,
                     min_area: int = 10, nms_thr: float = 0.05, score_thr: float = 0.0):
    """One tile's detections (boxes, scores, labels, masks) → its nuclei:
    (contours [(K, 2) slide-frame points], labels, scores)."""
    boxes, masks = result["boxes"], result["masks"]
    labels, scores = result["labels"], result["scores"]
    m = margin
    if len(boxes) == 0:
        return [], labels, scores
    areas = masks.reshape(len(masks), -1).sum(axis=1)
    sel = ((boxes[:, 0] >= m) & (boxes[:, 1] >= m) & (boxes[:, 2] <= tile_size - m)
           & (boxes[:, 3] <= tile_size - m) & (areas >= min_area) & (scores >= score_thr))
    masks, labels, scores = masks[sel], labels[sel], scores[sel]
    if len(masks) == 0:
        return [], labels, scores
    keep = mask_nms(masks, scores, thr=nms_thr)
    masks, labels, scores = masks[keep], labels[keep], scores[keep]
    contours, final = [], []
    for i, mm in enumerate(masks):
        found, _ = find_contours(mm)
        if not found:
            continue
        cont = found[0].reshape(-1, 2)
        if len(cont) < 3:
            continue
        contours.append(cont + np.asarray(coord))
        final.append(i)
    final = np.asarray(final, np.int64)
    return contours, labels[final], scores[final]
