"""COCO-compatible RLE mask API (port of nuhtc_tpu/ops/rle.py).

Equivalents of the pycocotools.mask functions the engine, the slide path and
the evaluation use (encode/decode/area/toBbox/iou/merge), implemented from
the RLE format spec: in numpy (the plain version, ``*_plain``), and in the
port's host C library (``csrc/rle.c``, built and loaded by
``kernels.host()``). Both give the same results. The library runs wherever
a C compiler is installed, the numpy code where none is.

RLE dict format matches pycocotools: {"size": [h, w], "counts": bytes}.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np

from nuhtc_tpu_torch import kernels


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


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


def encode(mask: np.ndarray) -> Dict:
    """Binary mask (H, W) → RLE dict with compressed bytes counts."""
    lib = kernels.host()
    if lib is None:
        return encode_plain(mask)
    h, w = mask.shape
    flat = np.ascontiguousarray(np.asarray(mask).ravel(order="F"), np.uint8)
    counts = np.empty(h * w + 2, np.uint32)
    m = lib.rle_encode(_ptr(flat), h, w, _ptr(counts), len(counts))
    buf = ctypes.create_string_buffer(6 * m + 16)
    n = lib.rle_string_encode(_ptr(counts), m, buf, len(buf))
    return {"size": [h, w], "counts": buf.raw[:n]}


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
