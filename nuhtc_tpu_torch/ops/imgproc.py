"""The image operations of the whole-slide path, in numpy (and
scipy.ndimage for the median and Canny's hysteresis), each equal to
OpenCV's bit for bit unless its docstring states a tolerance: saturation of
RGB→HSV, median blur, fixed and Otsu thresholds, the morphological close
with an even kernel and the bilinear resize of tissue segmentation; for the
offline tools the gray and LAB conversions (LAB → RGB within a few levels),
3 × 3 Sobel, Canny, the Gaussian blur, ``addWeighted`` and the
nearest-neighbour resize; for the corruption catalog ``filter2D``,
``getRotationMatrix2D``, ``warpAffine`` and ``remap`` (bilinear), the float32
bilinear resize and RGB ↔ HSV.

Where OpenCV computes in float32 with fused multiply-adds (its Gaussian and
``filter2D`` accumulations, the bilinear taps of ``warpAffine``, ``remap``
and the float resize, HSV → RGB), the fused operation is formed here in
float64, where the product of two float32 values is exact, and rounded once
to float32 (``_fma``)."""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Tuple

import numpy as np

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
    from nuhtc_tpu_torch.data.pipelines import resize_linear_u8

    h, w = img.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return img.copy()
    if (h, w) == (2 * oh, 2 * ow):
        s = img.astype(np.int32)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2] + 2) >> 2
                ).astype(np.uint8)
    return resize_linear_u8(img, (oh, ow))


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for uint8: OpenCV's 15-bit
    fixed point, (9798 R + 19235 G + 3735 B + 2¹⁴) >> 15."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"rgb_to_gray_u8 takes a uint8 (H, W, 3) image, got {img.dtype} {img.shape}")
    s = img.astype(np.int32)
    return ((s[..., 0] * 9798 + s[..., 1] * 19235 + s[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


def equalize_hist_u8(x: np.ndarray) -> np.ndarray:
    """``cv2.equalizeHist`` of a uint8 (H, W) image: the cumulative histogram
    above the lowest occupied level i, times the float32 scale 255 / (N -
    hist[i]), rounded half to even; a constant image stays as it is."""
    if x.dtype != np.uint8 or x.ndim != 2:
        raise ValueError(f"equalize_hist_u8 takes a uint8 (H, W) image, got {x.dtype} {x.shape}")
    hist = np.bincount(x.reshape(-1), minlength=256)
    lo = int(np.argmax(hist > 0))
    if hist[lo] == x.size:
        return x.copy()
    scale = np.float32(255.0) / np.float32(x.size - hist[lo])
    lut = np.zeros(256, np.float32)
    lut[lo + 1:] = np.cumsum(hist[lo + 1:]).astype(np.float32) * scale
    return np.clip(np.rint(lut), 0, 255).astype(np.uint8)[x]


def _sobel(x: np.ndarray, border: str) -> Tuple[np.ndarray, np.ndarray]:
    """The 3 × 3 Sobel derivatives (d/dx, d/dy) of a 2-D image as int32."""
    p = _pad(x.astype(np.int32), 1, border)
    h, w = x.shape
    s = lambda dy, dx: p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]  # noqa: E731
    gx = (s(-1, 1) - s(-1, -1)) + 2 * (s(0, 1) - s(0, -1)) + (s(1, 1) - s(1, -1))
    gy = (s(1, -1) - s(-1, -1)) + 2 * (s(1, 0) - s(-1, 0)) + (s(1, 1) - s(-1, 1))
    return gx, gy


def sobel3(gray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(``cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3)``, ``cv2.Sobel(gray,
    cv2.CV_32F, 0, 1, ksize=3)``) of a uint8 (H, W) image: the border is
    BORDER_REFLECT_101, and the float32 values are exact integers."""
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"sobel3 takes a uint8 (H, W) image, got {gray.dtype} {gray.shape}")
    gx, gy = _sobel(gray, "reflect")
    return gx.astype(np.float32), gy.astype(np.float32)


# tan(22.5°) in OpenCV's 15-bit fixed point, for Canny's direction test
_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


def canny(gray: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(gray, low, high)`` (aperture 3, L1 gradient) of a uint8
    (H, W) image, 255 on edges: Sobel derivatives over a replicated border,
    magnitude |dx| + |dy|, non-maximum suppression with OpenCV's fixed-point
    direction test and its tie rule (a pixel must beat the neighbour before
    it along the direction and at least equal the one after; the diagonal
    case must beat both), 0 outside the image; then hysteresis: a maximum
    above ``low`` is an edge where it is 8-connected through such maxima to
    one above ``high``."""
    from scipy import ndimage

    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"canny takes a uint8 (H, W) image, got {gray.dtype} {gray.shape}")
    lo, hi = int(math.floor(low)), int(math.floor(high))
    if lo > hi:
        lo, hi = hi, lo
    gx, gy = _sobel(gray, "edge")
    mag = np.abs(gx) + np.abs(gy)
    h, w = gray.shape
    m = np.pad(mag, 1)  # magnitude 0 outside the image

    def at(dy, dx):
        return m[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    ax = np.abs(gx).astype(np.int64)
    ay = np.abs(gy).astype(np.int64) << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_CANNY_SHIFT + 1))
    horiz = ay < tg22x
    vert = ~horiz & (ay > tg67x)
    diag = ~horiz & ~vert
    s = np.where((gx ^ gy) < 0, -1, 1)
    keep = np.where(horiz, (mag > at(0, -1)) & (mag >= at(0, 1)), False)
    keep |= vert & (mag > at(-1, 0)) & (mag >= at(1, 0))
    up_left, up_right = at(-1, -1), at(-1, 1)
    down_left, down_right = at(1, -1), at(1, 1)
    # s = 1: the row above at x − 1 and the row below at x + 1; s = −1 the other diagonal
    before = np.where(s > 0, up_left, up_right)
    after = np.where(s > 0, down_right, down_left)
    keep |= diag & (mag > before) & (mag > after)
    cand = keep & (mag > lo)
    strong = cand & (mag > hi)
    labels, n = ndimage.label(cand, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros((h, w), np.uint8)
    hit = np.zeros(n + 1, bool)
    hit[labels[strong]] = True
    hit[0] = False
    return np.where(hit[labels], np.uint8(255), np.uint8(0))


def _reflect_index(n: int, r: int) -> np.ndarray:
    """Source indices of an axis of length n padded by r on both sides with
    BORDER_REFLECT_101 (a single row or column repeats)."""
    if n == 1:
        return np.zeros(n + 2 * r, np.int64)
    idx = np.abs(np.arange(-r, n + r)) % (2 * n - 2)
    return np.where(idx >= n, 2 * n - 2 - idx, idx)


def _pad(x: np.ndarray, r: int, mode: str) -> np.ndarray:
    """Pads the two first axes by r: "reflect" is OpenCV's BORDER_REFLECT_101,
    "edge" its BORDER_REPLICATE."""
    for axis in (0, 1):
        if mode == "reflect":
            x = np.take(x, _reflect_index(x.shape[axis], r), axis=axis)
        else:
            pads = [(0, 0)] * x.ndim
            pads[axis] = (r, r)
            x = np.pad(x, pads, mode="edge")
    return x


def _separable(x: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Rows with ``kx``, then columns with ``ky``, BORDER_REFLECT_101, in the
    dtype of the kernels."""
    rx, ry = len(kx) // 2, len(ky) // 2
    h, w = x.shape[:2]
    p = np.take(x.astype(kx.dtype), _reflect_index(w, rx), axis=1)
    rows = sum(kx[i] * p[:, i:i + w] for i in range(len(kx)))
    q = np.take(rows, _reflect_index(h, ry), axis=0)
    return sum(ky[i] * q[i:i + h] for i in range(len(ky)))


# OpenCV's fixed kernels for an automatic sigma at these sizes
_SMALL_GAUSSIAN = {1: (1.0,), 3: (0.25, 0.5, 0.25), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
                   7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
                   9: tuple(v / 256 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4))}


def _gaussian_taps(n: int, sigma: float) -> np.ndarray:
    """``getGaussianKernelBitExact``: the fixed table for an automatic sigma
    up to 9, else exp(−x²/2σ²) over the n taps, normalised, in float64."""
    if sigma <= 0 and n in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[n])
    # an automatic sigma is OpenCV's mulAdd(n, 0.15, 0.35): one rounding
    s = sigma if sigma > 0 else float(Fraction(n) * Fraction(0.15) + Fraction(0.35))
    scale2 = -0.125 / (s * s)
    vals = [math.exp(float(x * x) * scale2) for x in range(1 - n, 0, 2)]
    mul = 1.0 / (2 * sum(vals) + 1.0)
    side = [v * mul for v in vals]
    return np.asarray(side + [mul] + side[::-1])


def _gaussian_kernel_q8(n: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV's bit-exact uint8 kernel: 8 fractional bits, the taps of one
    side rounded in turn with error diffusion (each carries the rounding
    error of the one before), the centre what makes the sum exactly 1."""
    taps, err = [], 0.0
    for v in _gaussian_taps(n, sigma)[:n // 2]:
        adj = v * 256 + err
        q = int(np.rint(adj))
        err = adj - q
        taps.append(q)
    return np.asarray(taps + [256 - 2 * sum(taps)] + taps[::-1], np.int64)


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add a·b + c, rounded once (float64 holds a
    float32 product exactly)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _gaussian_f32(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """OpenCV's float32 separable Gaussian (``RowFilter`` with ``RowVec_32f``,
    then ``SymmColumnFilter`` with ``SymmColumnVec_32f``), as an x86-64 host
    with AVX2 runs it. Each row value is a left-to-right chain of fused
    multiply-adds over the float32 taps, but for the last (W·C) mod 4 values
    of a row, which OpenCV multiplies and adds without fusing; each column
    value is the centre tap times the centre, then per distance d the fused
    multiply-add of tap d with the float32 sum of the rows d above and d
    below, but for the last (W·C) mod 8 values, again without fusing."""
    n = len(k)
    r = n // 2
    h, w = img.shape[:2]
    p = np.take(img.astype(np.float32), _reflect_index(w, r), axis=1)
    rows = np.zeros(img.shape, np.float32)
    for i in range(n):
        rows = _fma(p[:, i:i + w], k[i], rows)
    tail = _scalar_tail(img.shape, 4)
    plain = p[:, 0:w][:, tail] * k[0]
    for i in range(1, n):
        plain += p[:, i:i + w][:, tail] * k[i]
    rows[:, tail] = plain
    q = np.take(rows, _reflect_index(h, r), axis=0)
    out = _fma(q[r:r + h], k[r], np.float32(0))
    tail = _scalar_tail(img.shape, 8)
    plain = q[r:r + h][:, tail] * k[r]
    for d in range(1, r + 1):
        out = _fma(q[r + d:r + d + h] + q[r - d:r - d + h], k[r + d], out)
        plain += (q[r + d:r + d + h][:, tail] + q[r - d:r - d + h][:, tail]) * k[r + d]
    out[:, tail] = plain
    return out


def _gaussian3_f32(img: np.ndarray) -> np.ndarray:
    """The float32 3 × 3 Gaussian of sigma 0 (BORDER_REFLECT_101)."""
    h, w = img.shape[:2]
    q, half = np.float32(0.25), np.float32(0.5)
    p = np.take(img, _reflect_index(w, 1), axis=1)
    rows = (p[:, 0:w] + p[:, 2:w + 2]) * q + p[:, 1:w + 1] * half
    p = np.take(rows, _reflect_index(h, 1), axis=0)
    return (p[0:h] + p[2:h + 2]) * q + p[1:h + 1] * half


def gaussian_blur(img: np.ndarray, ksize: Tuple[int, int], sigma: float = 0.0) -> np.ndarray:
    """``cv2.GaussianBlur(img, ksize, sigma)`` (BORDER_REFLECT_101) of a
    float64, float32 or uint8 image, (H, W) or (H, W, C). ``ksize`` is
    (width, height), both odd, or (0, 0) to take it from ``sigma`` as OpenCV
    does (round(σ·6 + 1) for uint8, round(σ·8 + 1) otherwise, made odd); a
    sigma of 0 takes σ from the size.

    uint8: OpenCV's bit-exact fixed point (8-bit taps rounded with error
    diffusion, rows then columns in integers, one rounding shift), equal to
    cv2 5.0.0 at every size. float32 3 × 3 with sigma 0: OpenCV's small
    symmetric filters with the taps (1/4, 1/2, 1/4), (a + c)/4 + b/2 along
    rows, then along columns (each product exact, so fused or not is the
    same), equal to cv2 5.0.0. float32: OpenCV's chains of fused
    multiply-adds (``_gaussian_f32``) for sizes of at least 7 (other small
    float32 kernels take other code there and are refused here); equal to
    cv2 5.0.0 where W·C is a multiple of 4 (the catalog's tiles), else
    within 1e-7 of it on the last W·C mod 4 values of some rows, where
    OpenCV's scalar code does not always sum as ``_gaussian_f32`` does. float64: the separable product in doubles, within 1e-15 of
    OpenCV's (the order of the sums differs)."""
    kw, kh = int(ksize[0]), int(ksize[1])
    if (kw, kh) == (0, 0):
        if sigma <= 0:
            raise ValueError("gaussian_blur needs a kernel size or a positive sigma")
        kw = kh = int(np.rint(sigma * (3 if img.dtype == np.uint8 else 4) * 2 + 1)) | 1
    if kw % 2 != 1 or kh % 2 != 1:
        raise ValueError(f"gaussian_blur takes odd kernel sizes, got {ksize}")
    if img.dtype == np.uint8:
        v = _separable(img, _gaussian_kernel_q8(kw, sigma), _gaussian_kernel_q8(kh, sigma))
        return np.clip((v + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
    if img.dtype == np.float32:
        if (kw, kh) == (3, 3) and sigma <= 0:
            return _gaussian3_f32(img)
        if kw != kh or kw < 7:
            raise ValueError(f"gaussian_blur takes float32 with equal sizes of at least 7, "
                             f"got {ksize}")
        return _gaussian_f32(img, _gaussian_taps(kw, sigma).astype(np.float32))
    if img.dtype != np.float64:
        raise ValueError(f"gaussian_blur takes float64, float32 or uint8, got {img.dtype}")
    return _separable(img, _gaussian_taps(kw, sigma), _gaussian_taps(kh, sigma))


def add_weighted_u8(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                    gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` for uint8 images, as
    OpenCV's vector code computes it: the weights rounded to float32, then
    two fused multiply-adds in float32, fma(a, alpha, fma(b, beta, gamma)),
    rounded half to even and saturated (each fma is exact in float64 and
    rounded once to float32)."""
    f, d = np.float32, np.float64
    inner = (b.astype(d) * d(f(beta)) + d(f(gamma))).astype(f)
    v = (a.astype(d) * d(f(alpha)) + inner.astype(d)).astype(f)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``: source
    index floor(i · (1 / (dst / src))) per axis in doubles, as OpenCV forms
    the step, clamped to the last."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
    return img[ys][:, xs]


# sRGB → XYZ (D65) and the D65 white point, as OpenCV's colour conversions use them
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_WHITE = np.array([0.950456, 1.0, 1.088754])
_LAB_SHIFT, _LAB_SHIFT2, _GAMMA_SCALE = 12, 15, 255 * 8


def _lab_tables():
    """OpenCV's tables for uint8 RGB → LAB: the sRGB gamma of each byte on a
    scale of 255·2³, the cube root (or its linear foot) of 255·2³·1.5 levels
    on a scale of 2¹⁵ — a float64 root rounded to float32, as OpenCV's
    softfloat ``cbrt`` gives it — and the XYZ matrix over the white point in
    12 bits."""
    x = np.arange(256) / 255.0
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    gamma_b = np.rint(_GAMMA_SCALE * gamma).astype(np.int64)
    t = np.arange(_GAMMA_SCALE * 3 // 2) / _GAMMA_SCALE
    root = np.cbrt(t).astype(np.float32).astype(np.float64)
    cbrt_b = np.rint((1 << _LAB_SHIFT2) * np.where(t < 0.008856, t * 7.787 + 16 / 116, root)
                     ).astype(np.int64)
    coeffs = np.rint((1 << _LAB_SHIFT) * _RGB2XYZ / _WHITE[:, None]).astype(np.int64)
    return gamma_b, cbrt_b, coeffs


def _descale(v: np.ndarray, n: int) -> np.ndarray:
    return (v + (1 << (n - 1))) >> n


def rgb_to_lab_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2LAB)`` for uint8, through OpenCV's
    integer tables (``_lab_tables``): equal to cv2 5.0.0 on all 2²⁴ colours
    (tests/test_torch_shape_ops.py samples them)."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"rgb_to_lab_u8 takes a uint8 (..., 3) image, got {img.dtype} {img.shape}")
    gamma_b, cbrt_b, c = _lab_tables()
    rgb = gamma_b[img.astype(np.int64)]
    fx, fy, fz = (cbrt_b[_descale(rgb @ c[i], _LAB_SHIFT)] for i in range(3))
    s2 = _LAB_SHIFT2
    lum = _descale((116 * 255 + 50) // 100 * fy - (16 * 255 * (1 << s2) + 50) // 100, s2)
    a = _descale(500 * (fx - fy) + 128 * (1 << s2), s2)
    b = _descale(200 * (fy - fz) + 128 * (1 << s2), s2)
    return np.clip(np.stack([lum, a, b], -1), 0, 255).astype(np.uint8)


def lab_to_rgb_u8(lab: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)`` for uint8, **not** bit for
    bit: OpenCV goes through integer tables of its own, here the conversion
    is computed in float64 (L·100/255, a − 128, b − 128 → XYZ → linear RGB
    clipped to [0, 1] → sRGB gamma → rounded). Within 3 levels of cv2 5.0.0
    on all 2²⁴ inputs and within 2 on the LAB bytes of all RGB colours,
    where 18 % of the colours differ by one level in some channel."""
    if lab.dtype != np.uint8 or lab.shape[-1] != 3:
        raise ValueError(f"lab_to_rgb_u8 takes a uint8 (..., 3) image, got {lab.dtype} {lab.shape}")
    v = lab.astype(np.float64)
    lum, a, b = v[..., 0] * (100 / 255), v[..., 1] - 128, v[..., 2] - 128
    low = lum <= 8
    y = np.where(low, lum / 903.3, ((lum + 16) / 116) ** 3)
    fy = np.where(low, 7.787 * y + 16 / 116, (lum + 16) / 116)

    def finv(t):
        return np.where(t > 0.206893, t ** 3, (t - 16 / 116) / 7.787)

    xyz = np.stack([finv(fy + a / 500) * _WHITE[0], y, finv(fy - b / 200) * _WHITE[2]], -1)
    lin = np.clip(xyz @ np.linalg.inv(_RGB2XYZ).T, 0, 1)
    srgb = np.where(lin <= 0.0031308, 12.92 * lin, 1.055 * lin ** (1 / 2.4) - 0.055)
    return np.clip(np.rint(srgb * 255), 0, 255).astype(np.uint8)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)``: correlation (not convolution) with
    a float32 kernel anchored at (kh // 2, kw // 2), BORDER_REFLECT_101, of a
    uint8 or float32 image, (H, W) or (H, W, C). As OpenCV's direct path:
    the non-zero taps in raster order, each a float32 fused multiply-add
    onto the running sum, but for the last values of each row, which OpenCV
    sums in scalar code without fusing (``_scalar_tail``); uint8 rounded
    half to even and saturated. Equal to cv2 5.0.0 for kernels of fewer than
    130 taps.

    With 130 taps or more (13 × 13 and up) OpenCV correlates through its
    DFT, which is not reproduced: the sum is taken in float64 and rounded,
    for float32 within 4e-7 of cv2 5.0.0 on values in [0, 1], for uint8
    within 1 level on the few pixels that lie within 1e-5 of a half
    (tests/test_torch_corruptions.py)."""
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"filter2d takes uint8 or float32, got {img.dtype}")
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    src = img.astype(np.float32)
    p = np.take(np.take(src, _border_index(h, ay, kh - 1 - ay, "reflect101"), axis=0),
                _border_index(w, ax, kw - 1 - ax, "reflect101"), axis=1)
    taps = [(dy, dx) for dy in range(kh) for dx in range(kw) if k[dy, dx] != 0]
    if kh * kw >= 130:
        acc = np.zeros(img.shape, np.float64)
        for dy, dx in taps:
            acc += p[dy:dy + h, dx:dx + w].astype(np.float64) * float(k[dy, dx])
        s = acc.astype(np.float32) if img.dtype == np.float32 else acc
    else:
        s = np.zeros(img.shape, np.float32)
        tail = _scalar_tail(img.shape, 4 if img.dtype == np.uint8 else 8)
        plain = np.zeros(img[:, tail].shape, np.float32)
        for dy, dx in taps:
            s = _fma(p[dy:dy + h, dx:dx + w], k[dy, dx], s)
            plain += p[dy:dy + h, dx:dx + w][:, tail] * k[dy, dx]
        s[:, tail] = plain
    if img.dtype == np.uint8:
        return np.clip(np.rint(s), 0, 255).astype(np.uint8)
    return s


def _scalar_tail(shape, step: int) -> np.ndarray:
    """The (W[, C]) positions of an (H, W[, C]) image whose values OpenCV's
    ``filter2D`` sums in scalar code: on an x86-64 host with AVX2 its vector
    code takes each row's W·C values ``step`` at a time (4 for uint8, 8 for
    float32) and leaves the rest."""
    w, c = shape[1], (shape[2] if len(shape) > 2 else 1)
    flat = np.arange(w * c).reshape((w, c) if len(shape) > 2 else (w,))
    return flat >= (w * c) // step * step


def _border_index(n: int, before: int, after: int, mode: str) -> np.ndarray:
    """Source indices of an axis of length n padded by ``before`` and
    ``after``: "reflect101" is BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba),
    "reflect" BORDER_REFLECT (fedcba|abcdefgh|hgfedcb)."""
    return _border(np.arange(-before, n + after), n, mode)


def _border(i: np.ndarray, n: int, mode: str) -> np.ndarray:
    if n == 1:
        return np.zeros_like(i)
    if mode == "reflect101":
        i = np.abs(i) % (2 * n - 2)
        return np.where(i >= n, 2 * n - 2 - i, i)
    i = np.mod(i, 2 * n)
    return np.where(i >= n, 2 * n - 1 - i, i)


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64, the
    angle in degrees counter-clockwise, the centre rounded to float32 as
    OpenCV's ``Point2f`` holds it."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _bilinear(p00, p01, p10, p11, a, b) -> np.ndarray:
    """OpenCV's float32 bilinear step: two fused lerps along x, one along y."""
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    return _fma(b, v1 - v0, v0)


def _split_coord(s: np.ndarray):
    i = np.floor(s).astype(np.int64)
    return i, (s - i.astype(np.float32)).astype(np.float32)


def _invert_affine_f32(m: np.ndarray) -> np.ndarray:
    """OpenCV's inverse of a 2×3 affine (in doubles), rounded to float32."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[1], m[3], m[4] = a11, m[1] * -det, m[3] * -det, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return np.asarray(m, np.float32)


_WARP_VECTOR_PIXELS = 16  # the pixels of one vector step of cv2 5.0.0's warpAffine


def _warp_source(m: np.ndarray, dsize: Tuple[int, int]):
    """Per output pixel the float32 source point of ``cv2.warpAffine``: the
    first 16·⌊W/16⌋ pixels of a row come from OpenCV's vector code, which
    forms fma(x, m00, y·m01 + m02), the rest from its scalar code, which
    forms fma(x, m00, y·m01) + m02 (float32 throughout)."""
    f = _invert_affine_f32(m)
    ow, oh = dsize
    yy, xx = np.mgrid[:oh, :ow].astype(np.float32)
    vector = xx < ow - ow % _WARP_VECTOR_PIXELS

    def axis(c0, c1, c2):
        scalar = (_fma(xx, c0, yy * c1) + c2).astype(np.float32)
        vec = _fma(xx, c0, (yy * c1 + c2).astype(np.float32))
        return np.where(vector, vec, scalar)

    return axis(f[0], f[1], f[2]), axis(f[3], f[4], f[5])


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize)`` (INTER_LINEAR, BORDER_CONSTANT 0) of
    a float32 (H, W) or (H, W, C) image; ``dsize`` is (width, height).
    OpenCV inverts the matrix in doubles, rounds it to float32, forms each
    output pixel's source point as ``_warp_source`` says, then ``_bilinear``
    with 0 outside the image. Equal to cv2 5.0.0."""
    if img.dtype != np.float32 or img.ndim not in (2, 3):
        raise ValueError(f"warp_affine takes a float32 (H, W[, C]) image, got {img.dtype} "
                         f"{img.shape}")
    sx, sy = _warp_source(m, dsize)
    ix, a = _split_coord(sx)
    iy, b = _split_coord(sy)
    h, w = img.shape[:2]
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]

    def tap(y, x):
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        if img.ndim == 3:
            inside = inside[..., None]
        return np.where(inside, img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)], np.float32(0))

    return _bilinear(tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1), a, b)


def warp_affine_nearest(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                        border_value: int = 0) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=cv2.INTER_NEAREST,
    borderValue=border_value)`` of a (H, W) image: the source point of
    ``_warp_source`` rounded half to even; a point outside the image takes
    ``border_value``. Equal to cv2 5.0.0."""
    if img.ndim != 2:
        raise ValueError(f"warp_affine_nearest takes an (H, W) image, got {img.shape}")
    sx, sy = _warp_source(m, dsize)
    ix, iy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
    h, w = img.shape
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out = img[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
    return np.where(inside, out, np.asarray(border_value).astype(img.dtype))


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REFLECT)`` of a uint8 (H, W) or (H, W, C) image
    with float32 maps: cv2 5.0.0 takes the source point as given (no 1/32
    grid), reflects each of the four taps that leaves the image on its own
    (BORDER_REFLECT, the edge pixel repeated), interpolates in float32
    (``_bilinear``), rounds half to even and saturates. Equal to cv2 5.0.0."""
    if img.dtype != np.uint8:
        raise ValueError(f"remap takes a uint8 image, got {img.dtype}")
    h, w = img.shape[:2]
    ix, a = _split_coord(np.asarray(map_x, np.float32))
    iy, b = _split_coord(np.asarray(map_y, np.float32))
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    x0, x1 = _border(ix, w, "reflect"), _border(ix + 1, w, "reflect")
    y0, y1 = _border(iy, h, "reflect"), _border(iy + 1, h, "reflect")
    s = img.astype(np.float32)
    v = _bilinear(s[y0, x0], s[y0, x1], s[y1, x0], s[y1, x1], a, b)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def resize_linear_f32(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) of a float32 (H, W) or
    (H, W, C) image, as cv2 5.0.0 computes it: half-pixel centres, the
    fraction of each source coordinate taken in doubles and rounded to
    float32 (along x a tap starting outside the image snaps onto the border
    pixel; along y both rows are clamped), then a fused lerp along x and one
    along y. Equal to cv2 5.0.0."""
    if img.dtype != np.float32:
        raise ValueError(f"resize_linear_f32 takes float32, got {img.dtype}")
    h, w = img.shape[:2]
    oh, ow = out_hw

    def taps(dst, src, snap):
        f = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
        i = np.floor(f).astype(np.int64)
        frac = (f - i).astype(np.float32)
        if snap:
            frac[(i < 0) | (i >= src - 1)] = 0.0
        return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), frac

    x0, x1, a = taps(ow, w, True)
    y0, y1, b = taps(oh, h, False)
    shape = (1, ow) + (1,) * (img.ndim - 2)
    a = a.reshape(shape)
    rows = _fma(a, img[:, x1] - img[:, x0], img[:, x0])
    b = b.reshape((oh, 1) + (1,) * (img.ndim - 2))
    return _fma(b, rows[y1] - rows[y0], rows[y0])


# OpenCV's tables for uint8 RGB → HSV: (255 << 12) / v for S (``_SDIV``
# above) and (180 << 12) / (6 · diff) for H, rounded half to even
_HDIV = np.zeros(256, np.int64)
_HDIV[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64))
                    ).astype(np.int64)


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` for uint8, H in [0, 180):
    OpenCV's integer tables and 12-bit rounding shifts. Equal to cv2 5.0.0
    on all 2²⁴ colours."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"rgb_to_hsv_u8 takes a uint8 (..., 3) image, got {img.dtype} {img.shape}")
    s = img.astype(np.int64)
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    sat = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    hue = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hue = (hue * _HDIV[diff] + half) >> _HSV_SHIFT
    hue = np.where(hue < 0, hue + 180, hue)
    return np.stack([hue, sat, v], -1).astype(np.uint8)


# the table entries (v, v(1 − s), v(1 − s·f), v(1 − s(1 − f))) that give B, G, R per sector
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` for a uint8 (..., W, 3)
    image, H in [0, 180): OpenCV's float32 route (S and V over 255,
    H · 6/180 modulo 6 split into a sector and a fraction, v(1 − s·f) and
    v(1 − s(1 − f)) with the inner term a fused multiply-add), each channel
    times 255. cv2 5.0.0 on an x86-64 host with AVX2 converts the first
    32·⌊W/32⌋ pixels of each row in vector code, which truncates, and the
    rest of the row in scalar code, which rounds half to even; so does this
    function. Equal to cv2 5.0.0 on all 2²⁴ inputs at widths 1 and 64."""
    if hsv.dtype != np.uint8 or hsv.ndim < 2 or hsv.shape[-1] != 3:
        raise ValueError(f"hsv_to_rgb_u8 takes a uint8 (..., W, 3) image, got {hsv.dtype} "
                         f"{hsv.shape}")
    f32, one = np.float32, np.float32(1)
    h = hsv[..., 0].astype(f32)
    s = hsv[..., 1].astype(f32) * f32(1 / 255)
    v = hsv[..., 2].astype(f32) * f32(1 / 255)
    h = np.fmod(h * f32(6 / 180), f32(6))
    sector = np.floor(h).astype(np.int64)
    frac = (h - sector.astype(f32)).astype(f32)
    off = (sector < 0) | (sector >= 6)
    sector, frac = np.where(off, 0, sector), np.where(off, f32(0), frac)
    tab = np.stack([v, v * (one - s), v * _fma(-s, frac, one),
                    v * _fma(-s, one - frac, one)], -1).astype(f32)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255)
    w = hsv.shape[-2]
    vector = (np.arange(w) < w - w % _HSV_VECTOR_PIXELS)[:, None]
    return np.clip(np.where(vector, np.floor(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)


_HSV_VECTOR_PIXELS = 32  # the pixels of one vector step of cv2's HSV → RGB
