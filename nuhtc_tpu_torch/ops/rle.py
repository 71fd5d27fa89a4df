"""COCO-compatible RLE mask API (port of nuhtc_tpu/ops/rle.py).

Equivalents of the pycocotools.mask functions the engine, the slide path and
the evaluation use (encode/decode/area/toBbox/iou/merge), implemented from
the RLE format spec: in numpy (the plain version, ``*_plain``), and in the
port's host C library (``csrc/rle.c``, built and loaded by
``kernels.host()``). Both give the same results. The library runs wherever
a C compiler is installed, the numpy code where none is.

RLE dict format matches pycocotools: {"size": [h, w], "counts": bytes}.

For (n, h, w) masks held whole, as the slide's post-processing gets them:
``extents`` (each mask's area and pixel box, in one pass), ``intersections``
(the pixels two masks share, counted over the overlap of their boxes) and
``encode_crop`` (``encode``'s bytes from a mask's crop and its offset), each
with its numpy version (``*_plain``) beside it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np

from nuhtc_tpu_torch import kernels


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _np_counts_from_mask(mask: np.ndarray) -> np.ndarray:
    flat = np.asfortranarray(mask).ravel(order="F").astype(np.uint8)
    flat = (flat > 0).astype(np.uint8)
    if flat.size == 0:
        return np.zeros(1, np.uint32)
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds)
    if flat[0] == 1:  # runs must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts.astype(np.uint32)


def _np_mask_from_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts.astype(np.int64))
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[: h * w].reshape((h, w), order="F")


def _np_string_encode(counts: np.ndarray) -> bytes:
    out = bytearray()
    counts = counts.astype(np.int64)
    for i, c in enumerate(counts):
        x = int(c if i <= 2 else c - counts[i - 2])
        more = True
        while more:
            piece = x & 0x1F
            x >>= 5
            more = (x != -1) if (piece & 0x10) else (x != 0)
            if more:
                piece |= 0x20
            out.append(piece + 48)
    return bytes(out)


def _np_string_decode(s: bytes) -> np.ndarray:
    counts: List[int] = []
    p = 0
    n = len(s)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            p += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def encode_plain(mask: np.ndarray) -> Dict:
    h, w = mask.shape
    return {"size": [h, w], "counts": _np_string_encode(_np_counts_from_mask(mask))}


def _string_encode(lib, counts: np.ndarray, m: int) -> bytes:
    buf = ctypes.create_string_buffer(6 * m + 16)
    n = lib.rle_string_encode(_ptr(counts), m, buf, len(buf))
    return buf.raw[:n]


def encode(mask: np.ndarray) -> Dict:
    """Binary mask (H, W) → RLE dict with compressed bytes counts."""
    lib = kernels.host()
    if lib is None:
        return encode_plain(mask)
    h, w = mask.shape
    flat = np.ascontiguousarray(np.asarray(mask).ravel(order="F"), np.uint8)
    counts = np.empty(h * w + 2, np.uint32)
    m = lib.rle_encode(_ptr(flat), h, w, _ptr(counts), len(counts))
    return {"size": [h, w], "counts": _string_encode(lib, counts, m)}


def _u8(a: np.ndarray) -> np.ndarray:
    """``a`` as uint8 (any non-zero value 1 where it was not uint8 or bool)
    with its rows contiguous, copied only where it has to be."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        a = a.view(np.uint8)
    elif a.dtype != np.uint8:
        a = (a != 0).view(np.uint8)
    if a.strides[-1] != 1 or min(a.strides) < 0:
        a = np.ascontiguousarray(a)
    return a


def _counts_from_crop(crop: np.ndarray, y0: int, x0: int, h: int, w: int) -> np.ndarray:
    xs, ys = np.nonzero(np.asarray(crop).T)  # column-major order
    p = (x0 + xs.astype(np.int64)) * h + (y0 + ys)  # ascending
    if len(p) == 0:
        return np.asarray([h * w], np.uint32)
    breaks = np.flatnonzero(np.diff(p) != 1)
    starts = p[np.concatenate([[0], breaks + 1])]
    ends = p[np.concatenate([breaks, [len(p) - 1]])] + 1
    counts = np.stack([starts - np.concatenate([[0], ends[:-1]]), ends - starts], 1).ravel()
    if ends[-1] < h * w:
        counts = np.append(counts, h * w - ends[-1])
    return counts.astype(np.uint32)


def _crop_checked(crop, y0: int, x0: int, size: Sequence[int]) -> np.ndarray:
    crop = np.asarray(crop)
    h, w = size
    ch, cw = crop.shape
    if y0 < 0 or x0 < 0 or y0 + ch > h or x0 + cw > w:
        raise ValueError(f"a {ch}x{cw} crop at ({y0}, {x0}) is not inside {h}x{w}")
    return crop


def encode_crop_plain(crop: np.ndarray, y0: int, x0: int, size: Sequence[int]) -> Dict:
    crop = _crop_checked(crop, y0, x0, size)
    h, w = size
    return {"size": [h, w], "counts": _np_string_encode(_counts_from_crop(crop, y0, x0, h, w))}


def encode_crop(crop: np.ndarray, y0: int, x0: int, size: Sequence[int]) -> Dict:
    """``encode`` of the ``size`` = (h, w) mask that is ``crop`` at row
    ``y0``, column ``x0`` and zero elsewhere, byte for byte, read from the
    crop alone."""
    lib = kernels.host()
    if lib is None:
        return encode_crop_plain(crop, y0, x0, size)
    crop = _u8(_crop_checked(crop, y0, x0, size))
    h, w = size
    ch, cw = crop.shape
    counts = np.empty(2 * ch * cw + 2, np.uint32)
    m = lib.rle_encode_crop(_ptr(crop), crop.strides[0], ch, cw, y0, x0, h, w, _ptr(counts),
                            len(counts))
    return {"size": [h, w], "counts": _string_encode(lib, counts, m)}


def extents_plain(masks: np.ndarray):
    fg = np.asarray(masks) != 0
    n, h, w = fg.shape
    area = fg.sum((1, 2), dtype=np.int64)
    rows, cols = fg.any(2), fg.any(1)
    box = np.stack([rows.argmax(1), h - rows[:, ::-1].argmax(1),
                    cols.argmax(1), w - cols[:, ::-1].argmax(1)], 1).astype(np.int64)
    box[area == 0] = 0
    return area, box


def extents(masks: np.ndarray):
    """(n, h, w) masks → (area (n,), box (n, 4)), int64: each mask's
    non-zero pixels (its sum, on 0/1 masks) and the rows and columns they
    span, [y0, y1, x0, x1) with the ends exclusive (all 0 for an empty
    mask). The library reads the masks once."""
    lib = kernels.host()
    if lib is None:
        return extents_plain(masks)
    masks = np.ascontiguousarray(_u8(masks))
    n, h, w = masks.shape
    area = np.empty(n, np.int64)
    box = np.empty((n, 4), np.int64)
    lib.mask_extents(_ptr(masks), n, h, w, _ptr(area), _ptr(box))
    return area, box


def intersections_plain(masks: np.ndarray, box: np.ndarray, first: np.ndarray,
                        second: np.ndarray) -> np.ndarray:
    out = np.zeros(len(first), np.int64)
    for k, (i, j) in enumerate(zip(np.asarray(first).tolist(), np.asarray(second).tolist())):
        y0, x0 = max(box[i, 0], box[j, 0]), max(box[i, 2], box[j, 2])
        y1, x1 = min(box[i, 1], box[j, 1]), min(box[i, 3], box[j, 3])
        if y0 < y1 and x0 < x1:
            out[k] = np.count_nonzero((masks[i, y0:y1, x0:x1] != 0)
                                      & (masks[j, y0:y1, x0:x1] != 0))
    return out


def intersections(masks: np.ndarray, box: np.ndarray, first: np.ndarray,
                  second: np.ndarray) -> np.ndarray:
    """The pixels masks ``first[k]`` and ``second[k]`` of (n, h, w)
    ``masks`` share, int64, counted over the overlap of their boxes ``box``
    (as ``extents`` gives them: no mask has a pixel outside its box)."""
    lib = kernels.host()
    if lib is None:
        return intersections_plain(masks, box, first, second)
    masks = np.ascontiguousarray(_u8(masks))
    n, h, w = masks.shape
    box = np.ascontiguousarray(box, np.int64)
    first = np.ascontiguousarray(first, np.int64)
    second = np.ascontiguousarray(second, np.int64)
    pairs = np.concatenate([first, second])
    if (box.shape != (n, 4) or len(first) != len(second)
            or (n and (box.min() < 0 or box[:, 1].max() > h or box[:, 3].max() > w))
            or (len(pairs) and (pairs.min() < 0 or pairs.max() >= n))):
        raise ValueError("intersections: a box inside the frame for each mask, and pairs of "
                         "mask indices")
    out = np.empty(len(first), np.int64)
    lib.mask_pair_inter(_ptr(masks), h, w, _ptr(box), _ptr(first), _ptr(second), len(first),
                        _ptr(out))
    return out


def _counts_of(rle: Dict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (list, tuple, np.ndarray)):
        return np.asarray(c, np.uint32)
    if isinstance(c, str):
        c = c.encode()
    lib = kernels.host()
    if lib is None:
        return _np_string_decode(c)
    counts = np.empty(len(c) + 4, np.uint32)
    m = lib.rle_string_decode(c, len(c), _ptr(counts), len(counts))
    if m < 0:
        raise ValueError("malformed RLE counts string")
    return counts[:m]


def decode_plain(rle: Dict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        c = _np_string_decode(c.encode() if isinstance(c, str) else c)
    return _np_mask_from_counts(np.asarray(c, np.uint32), *rle["size"])


def decode(rle: Dict) -> np.ndarray:
    lib = kernels.host()
    if lib is None:
        return decode_plain(rle)
    h, w = rle["size"]
    counts = _counts_of(rle)
    mask = np.zeros(h * w, np.uint8)
    lib.rle_decode(_ptr(np.ascontiguousarray(counts)), len(counts), _ptr(mask), h * w)
    return mask.reshape((h, w), order="F")


def area(rle: Dict) -> int:
    counts = _counts_of(rle)
    return int(counts[1::2].sum())


def toBbox(rle: Dict) -> np.ndarray:
    """[x, y, w, h] tight bbox."""
    h, w = rle["size"]
    counts = _counts_of(rle).astype(np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    fg = np.arange(len(counts)) % 2 == 1
    s, e = starts[fg], ends[fg] - 1
    if len(s) == 0 or counts[fg].sum() == 0:
        return np.zeros(4)
    cols_s, cols_e = s // h, e // h
    x1, x2 = cols_s.min(), cols_e.max()
    if (cols_s == cols_e).all():
        y1, y2 = (s % h).min(), (e % h).max()
    else:
        # a run spanning a column boundary covers rows r1..h-1 and 0..r2
        y1, y2 = 0, h - 1
    return np.array([x1, y1, x2 - x1 + 1, y2 - y1 + 1], np.float64)


def _flatten(counts: List[np.ndarray]):
    lengths = np.asarray([len(c) for c in counts], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    return np.concatenate(counts).astype(np.uint32), offsets, lengths


def iou(dt: Sequence[Dict], gt: Sequence[Dict], iscrowd: Sequence[int] | None = None) -> np.ndarray:
    """Pairwise IoU matrix (len(dt), len(gt)); iscrowd → IoF for that gt.
    The library sweeps each pair's runs; without it, ``iou_plain``."""
    nd, ng = len(dt), len(gt)
    lib = kernels.host()
    if nd == 0 or ng == 0 or lib is None:
        return iou_plain(dt, gt, iscrowd)
    crowd = np.asarray(iscrowd if iscrowd is not None else [0] * ng, np.uint8)
    d_flat, d_off, d_len = _flatten([_counts_of(r) for r in dt])
    g_flat, g_off, g_len = (d_flat, d_off, d_len) if gt is dt else _flatten(
        [_counts_of(r) for r in gt])
    out = np.zeros(nd * ng, np.float64)
    lib.rle_iou(_ptr(d_flat), _ptr(d_off), _ptr(d_len), nd, _ptr(g_flat), _ptr(g_off),
                _ptr(g_len), ng, _ptr(crowd), _ptr(out))
    return out.reshape(nd, ng)


def iou_plain(dt: Sequence[Dict], gt: Sequence[Dict], iscrowd: Sequence[int] | None = None,
              ) -> np.ndarray:
    """``iou`` in numpy: intersections are counted as products of the decoded
    0/1 masks over the pixels that both sets touch, in float32 while every
    count stays below 2^24 (exact there), in float64 above."""
    nd, ng = len(dt), len(gt)
    if nd == 0 or ng == 0:
        return np.zeros((nd, ng))
    crowd = np.asarray(iscrowd if iscrowd is not None else [0] * ng, np.uint8)
    h, w = dt[0]["size"]
    dmasks = np.stack([decode_plain(r).ravel() for r in dt]).astype(bool)
    same = gt is dt
    gmasks = dmasks if same else np.stack([decode_plain(r).ravel() for r in gt]).astype(bool)
    da = dmasks.sum(1, dtype=np.int64).astype(np.float64)[:, None]
    ga = gmasks.sum(1, dtype=np.int64).astype(np.float64)[None, :]
    both = np.flatnonzero(dmasks.any(0) & gmasks.any(0))
    ftype = np.float32 if h * w < (1 << 24) else np.float64
    dsel = dmasks[:, both].astype(ftype)
    gsel = dsel if same else gmasks[:, both].astype(ftype)
    inter = (dsel @ gsel.T).astype(np.float64)
    union = np.where(crowd[None, :] > 0, da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def merge(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    """Union (or intersection) of RLEs (decode-merge-encode)."""
    h, w = rles[0]["size"]
    acc = None
    for r in rles:
        m = decode(r)
        acc = m if acc is None else ((acc & m) if intersect else (acc | m))
    return encode(acc.astype(np.uint8))
