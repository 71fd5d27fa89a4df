"""Contour geometry in numpy, equal to OpenCV's on integer inputs.

The whole-slide path of the JAX package leans on OpenCV for a handful of
geometric functions. The port carries its own, each written to give the
result ``cv2`` (5.0.0) gives, point for point:

- ``find_contours``: border following after Suzuki and Abe (1985) with
  OpenCV's conventions: the image is padded by a zero frame (so pixels on
  the image's edge are foreground like any other), an outer border starts at
  its first pixel in raster order and runs counter-clockwise on the screen
  (down first), a hole border starts at the pixel left of the hole's first
  pixel and runs the other way round; contours come out in pre-order of the
  border tree with the border found **last** among siblings first;
  ``CHAIN_APPROX_SIMPLE`` keeps a point wherever the chain code changes, and
  the start point is kept only when the first step differs from the way the
  border returns to it;
- ``contour_area`` (Green's formula), ``bounding_rect``,
  ``point_polygon_test`` (the sign-only integer form) and ``draw_contours``.

Only the two retrieval modes the path uses are offered: ``RETR_CCOMP`` (two
levels: outer borders, each with the holes of its component) and
``RETR_TREE``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# the values OpenCV gives these names
RETR_CCOMP = 2
RETR_TREE = 3
CHAIN_APPROX_NONE = 1
CHAIN_APPROX_SIMPLE = 2

# chain codes 0..7: east, north-east, north, ... counter-clockwise on the screen
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
    """``cv2.findContours(mask, mode, method)`` for ``RETR_CCOMP`` and
    ``RETR_TREE`` with ``CHAIN_APPROX_NONE`` or ``CHAIN_APPROX_SIMPLE``.

    Returns (contours, hierarchy): a list of (P, 1, 2) int32 arrays of
    (x, y) points and a (1, N, 4) int32 array of [next, previous, first
    child, parent] indices, or ``([], None)`` when the mask is empty. Any
    non-zero pixel is foreground."""
    if mode not in (RETR_CCOMP, RETR_TREE):
        raise ValueError(f"find_contours: mode {mode} is not RETR_CCOMP or RETR_TREE")
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


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea``: half the absolute sum of the cross products of
    consecutive points; 0.0 for fewer than two points."""
    p = np.asarray(contour).reshape(-1, 2).astype(np.float64)
    if len(p) == 0:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return float(abs((q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]).sum()) * 0.5)


def bounding_rect(contour: np.ndarray) -> Tuple[int, int, int, int]:
    """``cv2.boundingRect`` of an integer point set: (x, y, w, h) with
    w = max − min + 1."""
    p = np.asarray(contour).reshape(-1, 2)
    if len(p) == 0:
        return 0, 0, 0, 0
    x0, y0 = p.min(0)
    x1, y1 = p.max(0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def point_polygon_test(contour: np.ndarray, pt: Sequence[int]) -> int:
    """``cv2.pointPolygonTest(contour, pt, False)`` for an integer point and
    an integer contour: +1 inside, −1 outside, 0 on an edge or a vertex
    (OpenCV's integer branch: a ray to the right, crossings counted by the
    sign of a 64-bit cross product)."""
    cnt = np.asarray(contour).reshape(-1, 2).astype(np.int64)
    if len(cnt) == 0:
        return -1
    px, py = int(pt[0]), int(pt[1])
    vx, vy = cnt[:, 0], cnt[:, 1]
    ux, uy = np.roll(vx, 1), np.roll(vy, 1)  # the edge runs from u to v
    skipped = ((uy <= py) & (vy <= py)) | ((uy > py) & (vy > py)) | ((ux < px) & (vx < px))
    on_flat = (py == vy) & ((px == vx) | ((py == uy) & (((ux <= px) & (px <= vx))
                                                        | ((vx <= px) & (px <= ux)))))
    if (skipped & on_flat).any():
        return 0
    dist = (py - uy) * (vx - ux) - (px - ux) * (vy - uy)
    live = ~skipped
    if (live & (dist == 0)).any():
        return 0
    dist = np.where(vy < uy, -dist, dist)
    return 1 if int((live & (dist > 0)).sum()) % 2 else -1


def _line_pixels(x0: int, y0: int, x1: int, y1: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 8-connected pixels of a segment as OpenCV's line iterator visits
    them: Bresenham from the left end point, one pixel per step along the
    longer axis, a tie on the other axis staying on the start's side."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, ady = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    n = max(dx, ady)
    k = np.arange(n + 1, dtype=np.int64)
    if n == 0:
        return k + x0, k + y0
    if ady > dx:
        return x0 + (2 * k * dx + ady - 1) // (2 * ady), y0 + sy * k
    return x0 + k, y0 + sy * ((2 * k * ady + dx - 1) // (2 * dx))


def draw_contours(img: np.ndarray, contours: Sequence[np.ndarray], color, thickness: int = 1,
                  ) -> np.ndarray:
    """Draws every contour as a closed polyline into ``img`` (in place, and
    returned), clipped to the image.

    With ``thickness`` 1 the pixels are those of ``cv2.drawContours`` exactly
    for segments of any slope whose end points lie inside the image (OpenCV
    clips a segment that leaves the image before it walks it; here it is
    clipped pixel by pixel). A thicker line is **not** held to OpenCV's bit
    for bit: OpenCV fills a rotated rectangle of half-width
    ``(thickness + 1) // 2``, edges included, and rounds the caps; here every
    pixel within that half-width of a segment is covered, a slanted
    segment's band widened by the pixels its edge touches. On seeded blob
    contours the coloured pixels overlap OpenCV's with an IoU ≥ 0.97 at
    thickness 2, 8, 16 and 32 (what the tissue preview draws at power-of-two
    downsamples) and ≥ 0.85 at 3 to 6 (tests/test_torch_contours.py)."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    for cont in contours:
        p = np.asarray(cont).reshape(-1, 2).astype(np.int64)
        if len(p) == 0:
            continue
        q = np.roll(p, -1, axis=0)
        if thickness <= 1:
            for (x0, y0), (x1, y1) in zip(p.tolist(), q.tolist()):
                xs, ys = _line_pixels(x0, y0, x1, y1)
                ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
                img[ys[ok], xs[ok]] = color
            continue
        r = (thickness + 1) // 2
        pad = r + 2
        for (x0, y0), (x1, y1) in zip(p.tolist(), q.tolist()):
            xa, xb = max(min(x0, x1) - pad, 0), min(max(x0, x1) + pad + 1, w)
            ya, yb = max(min(y0, y1) - pad, 0), min(max(y0, y1) + pad + 1, h)
            if xa >= xb or ya >= yb:
                continue
            yy, xx = np.mgrid[ya:yb, xa:xb]
            cover = ((xx - x0) ** 2 + (yy - y0) ** 2 <= r * r) | (
                (xx - x1) ** 2 + (yy - y1) ** 2 <= r * r)
            dx, dy = x1 - x0, y1 - y0
            if dx or dy:
                length = float(np.hypot(dx, dy))
                along = ((xx - x0) * dx + (yy - y0) * dy) / length
                across = np.abs((xx - x0) * dy - (yy - y0) * dx) / length
                # a slanted edge of the filled rectangle takes in the pixels it touches
                reach = r + min(abs(dx), abs(dy)) / length
                cover |= (along >= 0) & (along <= length) & (across <= reach)
            img[ya:yb, xa:xb][cover] = color
    return img
