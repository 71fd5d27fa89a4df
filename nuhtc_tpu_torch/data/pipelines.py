"""Host-side test-time preprocessing (port of nuhtc_tpu/data/pipelines.py
``preprocess_test_image``): Resize ×scale_factor, Normalize, Pad(size_divisor).

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``. The port
needs no OpenCV: ``resize_linear_u8`` reproduces that resize for uint8 images
in numpy, with OpenCV's arithmetic (half-pixel centres, coefficients rounded
to 1/2048, a horizontal pass in integers, then the vertical pass rounded to
nearest).
"""

from __future__ import annotations

import numpy as np

# reference img_norm_cfg (RGB)
IMG_NORM = dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375))

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(dst: int, src: int, snap_border: bool):
    """Per output index: the two source indices (clamped to the image) and
    their coefficients as integers of scale 2^11. OpenCV treats the border
    differently on the two axes: along x a tap that starts outside the image
    snaps onto the border pixel (fraction 0, ``snap_border``); along y the
    fraction stays and both taps read the clamped row."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int32)
    f = f - lo.astype(np.float32)
    if snap_border:
        f[(lo < 0) | (lo >= src - 1)] = 0.0
    i0 = np.clip(lo, 0, src - 1)
    i1 = np.clip(lo + 1, 0, src - 1)
    one = np.float32(1 << _COEF_BITS)
    c0 = np.rint((np.float32(1.0) - f) * one).astype(np.int32)
    c1 = np.rint(f * one).astype(np.int32)
    return i0, i1, c0, c1


def resize_linear_u8(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W, C) image to ``out_hw``, as
    ``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` computes it."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_linear_u8 takes a uint8 (H, W, C) image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    oh, ow = out_hw
    x0, x1, a0, a1 = _linear_taps(ow, w, snap_border=True)
    y0, y1, b0, b1 = _linear_taps(oh, h, snap_border=False)
    src = img.astype(np.int32)
    rows = np.take(src, x0, axis=1) * a0[None, :, None]  # (H, ow, C), scale 2^11
    rows += np.take(src, x1, axis=1) * a1[None, :, None]
    rows >>= 4
    out = np.take(rows, y0, axis=0)
    out *= b0[:, None, None]
    out >>= 16
    bottom = np.take(rows, y1, axis=0)
    bottom *= b1[:, None, None]
    bottom >>= 16
    out += bottom
    out += 2
    out >>= 2
    return out.astype(np.uint8)


def preprocess_test_image(img: np.ndarray, scale_factor: float = 2.0, mean=IMG_NORM["mean"],
                          std=IMG_NORM["std"], size_divisor: int = 32) -> np.ndarray:
    """RGB uint8 (H, W, 3) → normalized, rescaled, zero-padded float32."""
    h, w = img.shape[:2]
    if scale_factor != 1.0:
        img = resize_linear_u8(img, (int(h * scale_factor + 0.5), int(w * scale_factor + 0.5)))
    img = (img.astype(np.float32) - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    ph = (-img.shape[0]) % size_divisor
    pw = (-img.shape[1]) % size_divisor
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
    return img
