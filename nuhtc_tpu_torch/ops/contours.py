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
  ``point_polygon_test`` (the sign-only integer form), ``draw_contours``
  (thin outlines, or filled with an offset), ``rectangle`` and the filled
  ``circle`` of the corruption catalog;
- for the offline slide tools: ``fill_poly`` (OpenCV's edge-list scan
  conversion in 16.16 fixed point, with its clipping), ``convex_hull`` and
  ``fill_convex_poly`` (integer or fixed-point vertices), ``arc_length``,
  contour and image moments, Hu moments, and ``fit_ellipse``, which holds
  to a stated tolerance instead;
- the filled ``ellipse`` of the synthetic PanNuke tool: OpenCV's polygon
  from its sine table in 16.16 fixed point, filled as a convex polygon.

The retrieval modes offered are ``RETR_EXTERNAL`` (the outer borders that
lie in no hole), ``RETR_CCOMP`` (two levels: outer borders, each with the
holes of its component) and ``RETR_TREE``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# the values OpenCV gives these names
RETR_EXTERNAL = 0
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


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to the image [0, w) × [0, h): the end points
    moved onto the border, each coordinate by a double product truncated to
    an integer, the second end point after the first; returns (inside, x1,
    y1, x2, y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y, with_y=True):
        return (x < 0) + (x > right) * 2 + ((y < 0) * 4 + (y > bottom) * 8 if with_y else 0)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = code(x1, y1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = code(x2, y2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _outside(w: int, h: int, x: int, y: int) -> bool:
    return not (0 <= x < w and 0 <= y < h)


def _draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """``cv2.line`` at thickness 1, 8-connected: the segment is clipped to
    the image first (``_clip_line``) and the clipped segment walked."""
    h, w = img.shape[:2]
    if _outside(w, h, x0, y0) or _outside(w, h, x1, y1):
        inside, x0, y0, x1, y1 = _clip_line(w, h, x0, y0, x1, y1)
        if not inside:
            return
    xs, ys = _line_pixels(x0, y0, x1, y1)
    img[ys, xs] = color


_XY_SHIFT = 16


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _poly_edges(img: np.ndarray, polys: Sequence[np.ndarray], color, offset) -> list:
    """Draws every edge of the rings as an 8-connected line and returns the
    non-horizontal edges as (y0, y1, x at y0, dx per row), x in 16.16 fixed
    point. An edge with an end point outside the image takes its x (and,
    unless the clipped segment is one row, its y) from the clipped segment."""
    h, w = img.shape[:2]
    ox, oy = int(offset[0]), int(offset[1])
    edges = []
    for poly in polys:
        p = np.asarray(poly).reshape(-1, 2).astype(np.int64)
        if len(p) == 0:
            continue
        p = (p + [ox, oy]).tolist()
        xa, ya = p[-1]
        for xb, yb in p:
            _draw_line(img, xa, ya, xb, yb, color)
            ca, cb, cya, cyb = xa, xb, ya, yb
            if _outside(w, h, xa, ya) or _outside(w, h, xb, yb):
                _, ca, ty0, cb, ty1 = _clip_line(w, h, xa, ya, xb, yb)
                if ty0 != ty1:
                    cya, cyb = ty0, ty1
            if ya != yb:
                ca, cb = ca << _XY_SHIFT, cb << _XY_SHIFT
                dx = _cdiv(cb - ca, cyb - cya)
                if ya < yb:
                    edges.append((ya, yb, ca + (ya - cya) * dx, dx))
                else:
                    edges.append((yb, ya, cb + (yb - cyb) * dx, dx))
            xa, ya = xb, yb
    return edges


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray], color, offset=(0, 0)) -> np.ndarray:
    """``cv2.fillPoly(img, polys, color, cv2.LINE_8, 0, offset)`` on integer
    rings, in place (and returned): every edge is drawn as an 8-connected
    line (``cv2.line``, clipped as OpenCV clips), then each row is filled
    between consecutive crossings of the edges active on it (even-odd over
    all rings together; an edge is active on rows y0 ≤ y < y1), from
    ``ceil(left)`` to ``floor(right)``. A crossing's x is OpenCV's 16.16
    fixed point: from the vertex, the slope a truncated division; an edge
    that leaves the image starts from its clipped end points instead. Equal
    to cv2 5.0.0 pixel for pixel, rings inside the image and across its
    border alike (tests/test_torch_shape_ops.py)."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    edges = _poly_edges(img, polys, color, offset)
    if len(edges) < 2:
        return img
    y0, y1, x0, dx = np.asarray(edges, np.int64).T
    xe = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), xe.max()) < 0
            or min(x0.min(), xe.min()) >= (w << _XY_SHIFT)):
        return img
    lo, hi = np.maximum(y0, 0), np.minimum(y1, h)
    n = np.maximum(hi - lo, 0)
    if n.sum() == 0:
        return img
    which = np.repeat(np.arange(len(n)), n)
    ys = np.repeat(lo, n) + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    xs = x0[which] + (ys - y0[which]) * dx[which]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # consecutive crossings of a row pair up: every row crosses an even number
    left = (xs[0::2] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    right = xs[1::2] >> _XY_SHIFT
    rows = ys[0::2]
    ok = (left < w) & (right >= 0)
    left, right, rows = np.maximum(left[ok], 0), np.minimum(right[ok], w - 1), rows[ok]
    ok = left <= right
    cover = np.zeros((h, w + 1), np.int32)
    np.add.at(cover, (rows[ok], left[ok]), 1)
    np.add.at(cover, (rows[ok], right[ok] + 1), -1)
    img[np.cumsum(cover, axis=1)[:, :w] > 0] = color
    return img


_THICK_CHUNK = 1 << 20  # candidate pixels of a thick outline drawn in one pass


def draw_contours(img: np.ndarray, contours: Sequence[np.ndarray], color, thickness: int = 1,
                  offset=(0, 0)) -> np.ndarray:
    """Draws every contour, moved by ``offset``, as a closed polyline into
    ``img`` (in place, and returned), clipped to the image.

    A negative ``thickness`` fills them instead: ``cv2.drawContours(img,
    contours, -1, color, -1, offset=offset)`` is ``fill_poly`` of all of them
    together (even-odd), pixel for pixel.

    With ``thickness`` 1 the pixels are those of ``cv2.drawContours`` exactly,
    a segment that leaves the image clipped first as OpenCV clips it. A thicker line is **not** held to OpenCV's bit
    for bit: OpenCV fills a rotated rectangle of half-width
    ``(thickness + 1) // 2``, edges included, and rounds the caps; here every
    pixel within that half-width of a segment is covered, a slanted
    segment's band widened by the pixels its edge touches. On seeded blob
    contours the coloured pixels overlap OpenCV's with an IoU ≥ 0.97 at
    thickness 2, 8, 16 and 32 (what the tissue preview draws at power-of-two
    downsamples) and ≥ 0.85 at 3 to 6 (tests/test_torch_contours.py)."""
    if thickness < 0:
        return fill_poly(img, contours, color, offset)
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    rings = [np.asarray(c).reshape(-1, 2).astype(np.int64) + np.asarray(offset, np.int64)
             for c in contours]
    rings = [p for p in rings if len(p)]
    if thickness <= 1:
        for p in rings:
            for (x0, y0), (x1, y1) in zip(p.tolist(), np.roll(p, -1, axis=0).tolist()):
                _draw_line(img, x0, y0, x1, y1, color)
        return img
    if not rings:
        return img
    # every segment of every ring at once: its padded box, clipped to the image
    r = (thickness + 1) // 2
    pad = r + 2
    p = np.concatenate(rings)
    q = np.concatenate([np.roll(ring, -1, axis=0) for ring in rings])
    x0, y0, x1, y1 = p[:, 0], p[:, 1], q[:, 0], q[:, 1]
    xa = np.maximum(np.minimum(x0, x1) - pad, 0)
    ya = np.maximum(np.minimum(y0, y1) - pad, 0)
    nw = np.minimum(np.maximum(x0, x1) + pad + 1, w) - xa
    nh = np.minimum(np.maximum(y0, y1) + pad + 1, h) - ya
    live = (nw > 0) & (nh > 0)
    x0, y0, x1, y1, xa, ya, nw = (a[live] for a in (x0, y0, x1, y1, xa, ya, nw))
    dx, dy = x1 - x0, y1 - y0
    length = np.hypot(dx, dy)
    seg = length > 0
    length = np.where(seg, length, 1.0)
    # a slanted edge of the filled rectangle takes in the pixels it touches
    reach = r + np.minimum(np.abs(dx), np.abs(dy)) / length
    size = nw * nh[live]
    ends = np.cumsum(size)
    start = 0
    while start < len(size):  # a bounded number of candidate pixels a pass
        stop = max(int(np.searchsorted(ends, ends[start] - size[start] + _THICK_CHUNK,
                                       "right")), start + 1)
        n = size[start:stop]
        s = np.repeat(np.arange(start, stop), n)
        local = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        xx, yy = xa[s] + local % nw[s], ya[s] + local // nw[s]
        ux, uy, vx, vy = xx - x0[s], yy - y0[s], xx - x1[s], yy - y1[s]
        cover = (ux ** 2 + uy ** 2 <= r * r) | (vx ** 2 + vy ** 2 <= r * r)
        along = (ux * dx[s] + uy * dy[s]) / length[s]
        across = np.abs(ux * dy[s] - uy * dx[s]) / length[s]
        cover |= seg[s] & (along >= 0) & (along <= length[s]) & (across <= reach[s])
        img[yy[cover], xx[cover]] = color
        start = stop
    return img


def rectangle(img: np.ndarray, pt1: Sequence[int], pt2: Sequence[int], color,
              thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)``, in place (and
    returned): OpenCV draws the closed polyline pt1 → (x2, y1) → pt2 → (x1, y2),
    which is ``draw_contours`` of that ring; at thickness 1 pixel for pixel
    (each side clipped as ``cv2.line`` clips it), filled at a negative
    thickness, and a thicker outline held as ``draw_contours`` holds one."""
    (x1, y1), (x2, y2) = (int(v) for v in pt1), (int(v) for v in pt2)
    ring = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.int64)
    return draw_contours(img, [ring], color, thickness)


def circle(img: np.ndarray, center: Sequence[int], radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` (filled, LINE_8), in
    place (and returned): OpenCV's midpoint walk over one octant, each step
    filling the four horizontal spans it reaches, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = (int(v) for v in center)
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1

    def span(y, x1, x2):
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if 0 <= y < h and x1 <= x2:
            img[y, x1:x2 + 1] = color

    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def convex_hull(points: np.ndarray) -> np.ndarray:
    """The vertices of the convex hull of integer points, (K, 1, 2) int32,
    collinear points dropped, clockwise on the screen (y down), as
    ``cv2.convexHull(points)`` has them. OpenCV's Sklansky scan starts the
    ring where the indices into ``points`` run monotonically; the start
    here is the vertex with the least (x, y). The set of vertices, their
    cyclic order and what ``fill_convex_poly`` fills from them are OpenCV's
    (tests/test_torch_shape_ops.py)."""
    pts = sorted(set(map(tuple, np.asarray(points).reshape(-1, 2).astype(np.int64).tolist())))
    if len(pts) <= 2:
        return np.asarray(pts[::-1], np.int32).reshape(-1, 1, 2)

    def turn(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    upper: list = []
    for q in pts:
        while len(lower) >= 2 and turn(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in reversed(pts):
        while len(upper) >= 2 and turn(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1], np.int32).reshape(-1, 1, 2)


def _line_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """OpenCV's ``Line2``: an 8-connected segment between 16.16 fixed-point
    end points, clipped to the image (``_clip_line`` on the scaled size),
    walked one pixel a step along the longer axis from the lower end with
    the other coordinate stepped by a truncated fixed-point slope and
    rounded half up, plus the rounded far end point."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    half = 1 << (_XY_SHIFT - 1)
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _cdiv(dy << _XY_SHIFT, abs(dx) | 1)
        k = np.arange(((x2 - x1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs, ys = ((x1 + half) >> _XY_SHIFT) + k, (y1 + half + k * step) >> _XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _cdiv(dx << _XY_SHIFT, abs(dy) | 1)
        k = np.arange(((y2 - y1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs, ys = (x1 + half + k * step) >> _XY_SHIFT, ((y1 + half) >> _XY_SHIFT) + k
    xs = np.append(xs, (x2 + half) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + half) >> _XY_SHIFT)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def fill_convex_poly(img: np.ndarray, points: np.ndarray, color, shift: int = 0) -> np.ndarray:
    """``cv2.fillConvexPoly(img, points, color, cv2.LINE_8, shift)`` for
    integer vertices with ``shift`` fractional bits, in place (and
    returned): the edges drawn as lines (``cv2.line``'s walk, or at a
    non-zero shift the fixed-point walk ``_line_fixed``), then each row
    filled between a left and a right chain walked down from the topmost
    vertex, each chain's x in 16.16 fixed point with a rounded slope, both
    ends rounded half up."""
    v = np.asarray(points).reshape(-1, 2).astype(np.int64).tolist()
    n = len(v)
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    if n == 0:
        return img
    up = _XY_SHIFT - shift
    xa, ya = v[-1]
    for xb, yb in v:
        if shift:
            _line_fixed(img, xa << up, ya << up, xb << up, yb << up, color)
        else:
            _draw_line(img, xa, ya, xb, yb, color)
        xa, ya = xb, yb
    delta = (1 << shift) >> 1
    xs = [q[0] for q in v]
    ys = [q[1] for q in v]
    imin = min(range(n), key=lambda i: (ys[i], i))
    ymin, ymax = (ys[imin] + delta) >> shift, (max(ys) + delta) >> shift
    if (n < 3 or (max(xs) + delta) >> shift < 0 or ymax < 0
            or (min(xs) + delta) >> shift >= w or ymin >= h):
        return img
    ymax = min(ymax, h - 1)
    one, half = 1 << _XY_SHIFT, 1 << (_XY_SHIFT - 1)
    # per chain: [vertex index, step, x, dx, the row where the edge ends]
    chains = [[imin, 1, -one, 0, ymin], [imin, n - 1, -one, 0, ymin]]
    budget = n  # edges left to take, over both chains
    y = ymin
    while True:
        for c in chains:
            if y < c[4]:
                continue
            i0, step = c[0], c[1]
            i1 = (i0 + step) % n
            while budget > 0:
                budget -= 1
                ty = (v[i1][1] + delta) >> shift
                if ty > y:
                    x0, x1 = v[i0][0] << up, v[i1][0] << up
                    c[:] = [i1, step, x0, _cdiv((x1 - x0) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                i0, i1 = i1, (i1 + step) % n
            else:
                budget -= 1
        if budget < 0:
            break
        if y >= 0:
            left, right = sorted((chains[0][2], chains[1][2]))
            x1, x2 = (left + half) >> _XY_SHIFT, (right + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        chains[0][2] += chains[0][3]
        chains[1][2] += chains[1][3]
        y += 1
        if y > ymax:
            break
    return img


# OpenCV's sine table for whole degrees 0..450, sin rounded to 7 decimals,
# as float32 (drawing.cpp ``SinTable``; cos(a) is entry 450 - a)
_SIN_TABLE = [float(np.float32(round(math.sin(math.radians(a)), 7))) for a in range(451)]


def ellipse(img: np.ndarray, center: Sequence[int], axes: Sequence[int], angle: float,
            color) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)`` (filled,
    LINE_8), in place (and returned). As OpenCV draws it: the angle rounded
    to whole degrees; the outline sampled every 5, 18, 30 or 90 degrees (by
    the larger semi-axis: ≥ 15, ≥ 10, ≥ 3, smaller) from the sine table, in
    doubles on the 16.16 fixed-point centre and axes; each point rounded to
    an integer in 16.16 and repeats dropped; then ``fill_convex_poly`` of the
    points with shift 16."""
    cx, cy = (int(c) << _XY_SHIFT for c in center)
    ax, ay = (abs(int(a)) << _XY_SHIFT for a in axes)
    rot = int(round(float(angle)))
    while rot < 0:
        rot += 360
    while rot > 360:
        rot -= 360
    big = (max(ax, ay) + (1 << (_XY_SHIFT - 1))) >> _XY_SHIFT
    step = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    alpha, beta = _SIN_TABLE[450 - rot], _SIN_TABLE[rot]
    pts: list = []
    for i in range(0, 360 + step, step):
        a = min(i, 360)
        x, y = ax * _SIN_TABLE[450 - a], ay * _SIN_TABLE[a]
        px, py = cx + x * alpha - y * beta, cy + x * beta + y * alpha
        q = []
        for c in (px, py):
            r = int(round(c / (1 << _XY_SHIFT))) << _XY_SHIFT
            q.append(r + int(round(c - r)))
        if not pts or pts[-1] != q:
            pts.append(q)
    if len(pts) == 1:
        pts = [[cx, cy], [cx, cy]]
    return fill_convex_poly(img, np.asarray(pts, np.int64), color, shift=_XY_SHIFT)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    """``cv2.arcLength``: the sum of the segment lengths, each computed in
    float32 (OpenCV's ``sqrt`` of a float) and summed in double."""
    p = np.asarray(contour).reshape(-1, 2).astype(np.float32)
    if len(p) <= 1:
        return 0.0
    prev = np.roll(p, 1, axis=0) if closed else p[:-1]
    d = p if closed else p[1:]
    seg = np.sqrt((d[:, 0] - prev[:, 0]) ** 2 + (d[:, 1] - prev[:, 1]) ** 2)
    total = 0.0
    for v in seg.tolist():
        total += v
    return total


_MOMENT_KEYS = ("m00", "m10", "m01", "m20", "m11", "m02", "m30", "m21", "m12", "m03",
                "mu20", "mu11", "mu02", "mu30", "mu21", "mu12", "mu03",
                "nu20", "nu11", "nu02", "nu30", "nu21", "nu12", "nu03")


def _complete_moments(m: dict) -> dict:
    """OpenCV's ``completeMomentState``: central and normalised moments from
    the spatial ones, in its order of operations."""
    cx = cy = inv_m00 = 0.0
    if abs(m["m00"]) > np.finfo(np.float64).eps:
        inv_m00 = 1.0 / m["m00"]
        cx, cy = m["m10"] * inv_m00, m["m01"] * inv_m00
    mu20 = m["m20"] - m["m10"] * cx
    mu11 = m["m11"] - m["m10"] * cy
    mu02 = m["m02"] - m["m01"] * cy
    m["mu20"], m["mu11"], m["mu02"] = mu20, mu11, mu02
    m["mu30"] = m["m30"] - cx * (3 * mu20 + cx * m["m10"])
    mu11 += mu11
    m["mu21"] = m["m21"] - cx * (mu11 + cx * m["m01"]) - cy * mu20
    m["mu12"] = m["m12"] - cy * (mu11 + cy * m["m10"]) - cx * mu02
    m["mu03"] = m["m03"] - cy * (3 * mu02 + cy * m["m01"])
    inv_sqrt = math.sqrt(abs(inv_m00))
    s2 = inv_m00 * inv_m00
    s3 = s2 * inv_sqrt
    for k in ("20", "11", "02"):
        m["nu" + k] = m["mu" + k] * s2
    for k in ("30", "21", "12", "03"):
        m["nu" + k] = m["mu" + k] * s3
    return {k: m[k] for k in _MOMENT_KEYS}


def contour_moments(contour: np.ndarray) -> dict:
    """``cv2.moments`` of an integer contour (a polygon, Green's formula):
    the sums are exact integers in double, so the spatial moments are
    OpenCV's bit for bit; all zero when the polygon's area is under float32's
    epsilon."""
    p = np.asarray(contour).reshape(-1, 2).astype(np.float64).tolist()
    m = dict.fromkeys(_MOMENT_KEYS, 0.0)
    if not p:
        return m
    a = [0.0] * 10  # a00 a10 a01 a20 a11 a02 a30 a21 a12 a03
    xi_1, yi_1 = p[-1]
    xi_12, yi_12 = xi_1 * xi_1, yi_1 * yi_1
    for xi, yi in p:
        xi2, yi2 = xi * xi, yi * yi
        dxy = xi_1 * yi - xi * yi_1
        xii_1, yii_1 = xi_1 + xi, yi_1 + yi
        a[0] += dxy
        a[1] += dxy * xii_1
        a[2] += dxy * yii_1
        a[3] += dxy * (xi_1 * xii_1 + xi2)
        a[4] += dxy * (xi_1 * (yii_1 + yi_1) + xi * (yii_1 + yi))
        a[5] += dxy * (yi_1 * yii_1 + yi2)
        a[6] += dxy * xii_1 * (xi_12 + xi2)
        a[9] += dxy * yii_1 * (yi_12 + yi2)
        a[7] += dxy * (xi_12 * (3 * yi_1 + yi) + 2 * xi * xi_1 * yii_1 + xi2 * (yi_1 + 3 * yi))
        a[8] += dxy * (yi_12 * (3 * xi_1 + xi) + 2 * yi * yi_1 * xii_1 + yi2 * (xi_1 + 3 * xi))
        xi_1, yi_1, xi_12, yi_12 = xi, yi, xi2, yi2
    if abs(a[0]) <= np.finfo(np.float32).eps:
        return m
    sign = 1.0 if a[0] > 0 else -1.0
    scale = (0.5, 1 / 6, 1 / 6, 1 / 12, 1 / 24, 1 / 12, 0.05, 1 / 60, 1 / 60, 0.05)
    for k, v, s in zip(_MOMENT_KEYS[:10], a, scale):
        m[k] = v * (sign * s)
    return _complete_moments(m)


def image_moments(img: np.ndarray, binary: bool = False) -> dict:
    """``cv2.moments(img, binaryImage=binary)`` of a 2-D image: the sums of
    xᵖ yᵠ I(x, y) in double (any non-zero pixel counts 1 when ``binary``).
    For an integer image the sums are exact and equal OpenCV's; for a float
    image OpenCV sums in tiles of 32 rows and columns, so they agree to the
    last few bits (1e-12 relative on the tests' images). As in OpenCV, a
    float32 or int32 array of two columns is a point set, not an image: its
    rows are the vertices of a polygon (``contour_moments``)."""
    a = np.asarray(img)
    if a.ndim == 2 and a.shape[1] == 2 and a.dtype in (np.float32, np.int32) and not binary:
        return contour_moments(a)
    a = (a != 0).astype(np.float64) if binary else a.astype(np.float64)
    h, w = a.shape
    x = np.arange(w, dtype=np.float64)
    y = np.arange(h, dtype=np.float64)
    rows = np.stack([a.sum(1), a @ x, a @ (x * x), a @ (x * x * x)], 1)  # per row: x⁰..x³
    m = dict.fromkeys(_MOMENT_KEYS, 0.0)
    for (p, q), k in zip(((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2), (3, 0), (2, 1),
                          (1, 2), (0, 3)), _MOMENT_KEYS[:10]):
        m[k] = float((rows[:, p] * y ** q).sum())
    return _complete_moments(m)


def hu_moments(m: dict) -> np.ndarray:
    """``cv2.HuMoments(m).ravel()``: the seven invariants from the
    normalised moments, in OpenCV's order of operations."""
    t0, t1 = m["nu30"] + m["nu12"], m["nu21"] + m["nu03"]
    q0, q1 = t0 * t0, t1 * t1
    n4 = 4 * m["nu11"]
    s, d = m["nu20"] + m["nu02"], m["nu20"] - m["nu02"]
    hu = [0.0] * 7
    hu[0] = s
    hu[1] = d * d + n4 * m["nu11"]
    hu[3] = q0 + q1
    hu[5] = d * (q0 - q1) + n4 * t0 * t1
    t0 *= q0 - 3 * q1
    t1 *= 3 * q0 - q1
    q0, q1 = m["nu30"] - 3 * m["nu12"], 3 * m["nu21"] - m["nu03"]
    hu[2] = q0 * q0 + q1 * q1
    hu[4] = q0 * t0 + q1 * t1
    hu[6] = q1 * t0 - q0 * t1
    return np.asarray(hu, np.float64)


def _sv_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Least squares by SVD with OpenCV's cut-off (``SVBackSubst``): singular
    values at or under 2·DBL_EPSILON times their sum are dropped."""
    u, w, vt = np.linalg.svd(a, full_matrices=False)
    keep = np.abs(w) > 2 * np.finfo(np.float64).eps * w.sum()
    inv = np.where(keep, 1.0 / np.where(keep, w, 1.0), 0.0)
    return vt.T @ (inv * (u.T @ b))


def fit_ellipse(points: np.ndarray):
    """``cv2.fitEllipse`` of five or more points: ((cx, cy), (width,
    height), angle in degrees), width ≤ height, as floats.

    OpenCV's direct least-squares fit (Weiss's method, as ``fitEllipse``
    runs it): points in float32 centred on their mean and scaled to a
    summed L1 spread of 100; the conic ``-Ax² - By² - Cxy + Dx + Ey = 1e4``
    by SVD, the centre from its gradient, then ``A, B, C`` again about that
    centre; the axes from the eigen-form, swapped so that width ≤ height, the
    angle ``90 + θ`` after a swap and 0 without one. Where the design matrix
    is nearly singular (all points on one or two rows or columns) OpenCV
    nudges the points: here by the fixed ±eps pattern of its older releases,
    whereas OpenCV 5.0.0 draws the nudges from a random generator, so that
    its own result changes from call to call. On every point set that spans
    three rows and three columns and on which two calls of cv2 5.0.0 agree,
    this fit is within 1e-4 relative on the axes, 1e-3° on the angle taken
    modulo 180 (0° and 180° are one ellipse; OpenCV picks between them by
    the sign of a zero) and 1e-3 px on the centre
    (tests/test_torch_shape_ops.py)."""
    p = np.asarray(points).reshape(-1, 2).astype(np.float32)
    n = len(p)
    if n < 5:
        raise ValueError(f"fit_ellipse needs at least 5 points, got {n}")
    c = np.zeros(2, np.float32)
    for q in p:  # float32 running sum, as OpenCV's Point2f
        c = (c + q).astype(np.float32)
    c = (c / np.float32(n)).astype(np.float32)
    spread = 0.0
    for dx, dy in (p - c).tolist():
        spread += abs(dx) + abs(dy)
    f32_eps = float(np.finfo(np.float32).eps)
    scale = 100.0 / (spread if spread > f32_eps else f32_eps)

    def design(pts):
        d = (pts - c).astype(np.float32).astype(np.float64) * scale
        px, py = d[:, 0], d[:, 1]
        return px, py, np.stack([-px * px, -py * py, -px * py, px, py], 1)

    px, py, a = design(p)
    w = np.linalg.svd(a, compute_uv=False)
    if w[0] * f32_eps > w[-1]:
        eps = np.float32(spread / (n * 2) * 1e-3)
        i = np.arange(n)
        ofs = np.stack([(i & 1) * 2 - 1, (i & 2) - 1], 1).astype(np.float32) * eps
        px, py, a = design((p + ofs).astype(np.float32))
    g = _sv_solve(a, np.full(n, 10000.0))
    centre = _sv_solve(np.array([[2 * g[0], g[2]], [g[2], 2 * g[1]]]), g[3:5])
    ex, ey = px - centre[0], py - centre[1]
    g = _sv_solve(np.stack([ex * ex, ey * ey, ex * ey], 1), np.ones(n))
    theta = -0.5 * math.atan2(g[2], g[1] - g[0])
    t = g[2] / math.sin(-2.0 * theta) if abs(g[2]) > 1e-8 else g[1] - g[0]
    axes = []
    for r in (abs(g[0] + g[1] - t), abs(g[0] + g[1] + t)):
        axes.append(math.sqrt(2.0 / r) if r > 1e-8 else r)
    f32 = np.float32
    cx = float(f32(f32(centre[0] / scale) + c[0]))
    cy = float(f32(f32(centre[1] / scale) + c[1]))
    width, height = float(f32(axes[0] * 2 / scale)), float(f32(axes[1] * 2 / scale))
    angle = 0.0
    if width > height:
        width, height = height, width
        angle = float(f32(90 + theta * 180 / math.pi))
    if angle < -180:
        angle += 360
    if angle > 360:
        angle -= 360
    return (cx, cy), (width, height), angle
