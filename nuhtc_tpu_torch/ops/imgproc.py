"""The uint8 image operations of tissue segmentation, in numpy (and
scipy.ndimage for the median), each equal to OpenCV's bit for bit:
saturation of RGB→HSV, median blur, fixed and Otsu thresholds, the
morphological close with an even kernel, and the bilinear resize of the
stitched preview."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nuhtc_tpu_torch.data.pipelines import resize_linear_u8

_HSV_SHIFT = 12
# OpenCV's table of (255 << 12) / v, rounded half to even; v = 0 gives 0
_SDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64)).astype(np.int64)


def rgb_to_saturation_u8(img: np.ndarray) -> np.ndarray:
    """The S channel of ``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` for a uint8
    (H, W, 3) image: (max − min) · 255 / max in OpenCV's fixed point, a table
    of reciprocals scaled by 2¹² and a rounding shift, not a float division."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"rgb_to_saturation_u8 takes a uint8 (H, W, 3) image, got "
                         f"{img.dtype} {img.shape}")
    v = img.max(-1)
    diff = (v - img.min(-1)).astype(np.int64)
    return ((diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT).astype(np.uint8)


def median_blur_u8(x: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(x, k)`` of a uint8 (H, W) image: the median of the
    k × k neighbourhood, the border replicated."""
    from scipy import ndimage

    if x.dtype != np.uint8 or x.ndim != 2 or k % 2 != 1:
        raise ValueError(f"median_blur_u8 takes a uint8 (H, W) image and an odd k, got "
                         f"{x.dtype} {x.shape}, k={k}")
    if k == 1:
        return x.copy()
    return ndimage.median_filter(x, size=k, mode="nearest")


def threshold_binary(x: np.ndarray, thresh: float, maxval: int = 255) -> np.ndarray:
    """``cv2.threshold(x, thresh, maxval, cv2.THRESH_BINARY)[1]`` for uint8."""
    return np.where(x > int(np.floor(thresh)), np.uint8(maxval), np.uint8(0))


def otsu_threshold_value(x: np.ndarray) -> int:
    """The threshold OpenCV's Otsu picks for a uint8 image: its walk over the
    256-bin histogram in doubles, the first of equal maxima winning."""
    hist = np.bincount(x.ravel(), minlength=256).astype(np.float64)
    scale = 1.0 / x.size
    mu = float((np.arange(256) * hist).sum()) * scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = 0.0
    max_sigma, max_val = 0.0, 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, i
    return max_val


def threshold_otsu(x: np.ndarray, maxval: int = 255) -> np.ndarray:
    """``cv2.threshold(x, 0, maxval, cv2.THRESH_OTSU + cv2.THRESH_BINARY)[1]``."""
    return threshold_binary(x, otsu_threshold_value(x), maxval)


def _window_reduce(x: np.ndarray, k: int, reduce, fill: int) -> np.ndarray:
    """max or min over the k × k window whose anchor is (k // 2, k // 2), as
    OpenCV places it: offsets −k//2 … k−1−k//2 on both axes, so an even
    window leans up and to the left; outside the image counts as ``fill``."""
    a = k // 2
    h, w = x.shape
    p = np.pad(x, ((a, k - 1 - a), (a, k - 1 - a)), constant_values=fill)
    out = p[:h, :w].copy()
    for dy in range(k):
        for dx in range(k):
            if dy or dx:
                reduce(out, p[dy:dy + h, dx:dx + w], out=out)
    return out


def morph_close(x: np.ndarray, k: int) -> np.ndarray:
    """``cv2.morphologyEx(x, cv2.MORPH_CLOSE, np.ones((k, k)))`` for uint8:
    a dilation, then an erosion, both over the same window anchored at
    (k // 2, k // 2). With an even k neither pass is centred and the two do
    not mirror each other, so this is not a symmetric close. The border
    never wins: 0 outside for the dilation, 255 for the erosion."""
    if x.dtype != np.uint8 or x.ndim != 2:
        raise ValueError(f"morph_close takes a uint8 (H, W) image, got {x.dtype} {x.shape}")
    return _window_reduce(_window_reduce(x, k, np.maximum, 0), k, np.minimum, 255)


def resize_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (the default ``INTER_LINEAR``) of a uint8
    (H, W, C) image, with OpenCV's two special cases: an equal size is a
    copy, and an exact halving of both axes is the rounded mean of each
    2 × 2 block (OpenCV switches to its area method there)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return img.copy()
    if (h, w) == (2 * oh, 2 * ow):
        s = img.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    return resize_linear_u8(img, (oh, ow))
