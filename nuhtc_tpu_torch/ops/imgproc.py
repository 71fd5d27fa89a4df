"""The image operations of the whole-slide path, in numpy (and
scipy.ndimage for the median and Canny's hysteresis), each equal to
OpenCV's bit for bit unless its docstring states a tolerance: saturation of
RGB→HSV, median blur, fixed and Otsu thresholds, the morphological close
with an even kernel and the bilinear resize of tissue segmentation; for the
offline tools the gray and LAB conversions (LAB → RGB within a few levels),
3 × 3 Sobel, Canny, the Gaussian blur (uint8 at large sizes within 2),
``addWeighted`` and the nearest-neighbour resize."""

from __future__ import annotations

import math
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


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for uint8: OpenCV's 15-bit
    fixed point, (9798 R + 19235 G + 3735 B + 2¹⁴) >> 15."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"rgb_to_gray_u8 takes a uint8 (H, W, 3) image, got {img.dtype} {img.shape}")
    s = img.astype(np.int32)
    return ((s[..., 0] * 9798 + s[..., 1] * 19235 + s[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


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


def _auto_sigma(n: int) -> float:
    return ((n - 1) * 0.5 - 1) * 0.3 + 0.8


def gaussian_kernel(n: int) -> np.ndarray:
    """``cv2.getGaussianKernel(n, 0)`` in float64: the fixed table up to 9,
    else exp(−x²/2σ²) normalised, σ = 0.3((n − 1)/2 − 1) + 0.8."""
    if n in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[n])
    x = np.arange(n) - (n - 1) * 0.5
    s = _auto_sigma(n)
    k = np.exp(-0.5 / (s * s) * x * x)
    return k / k.sum()


def _gaussian_kernel_q8(n: int) -> np.ndarray:
    """OpenCV's bit-exact uint8 kernel: 8 fractional bits, each tap rounded,
    the centre what makes the sum exactly 1."""
    if n in _SMALL_GAUSSIAN:
        return np.rint(np.asarray(_SMALL_GAUSSIAN[n]) * 256).astype(np.int64)
    s = _auto_sigma(n)
    vals = [math.exp((x * x) * (-0.125 / (s * s))) for x in range(1 - n, 0, 2)]
    total = 2 * sum(vals) + 1.0
    taps = [int(np.rint(v / total * 256)) for v in vals]
    return np.asarray(taps + [256 - 2 * sum(taps)] + taps[::-1], np.int64)


def gaussian_blur(img: np.ndarray, ksize: Tuple[int, int]) -> np.ndarray:
    """``cv2.GaussianBlur(img, ksize, 0)`` (σ from the kernel size,
    BORDER_REFLECT_101) of a float64 or uint8 image, (H, W) or (H, W, C);
    ``ksize`` is (width, height), both odd.

    float64: the separable product in doubles, within 1e-15 of OpenCV's
    (the order of the sums differs). uint8 with both sizes ≤ 11: OpenCV's
    bit-exact fixed point (8-bit taps, rows then columns in integers, one
    rounding shift), equal to cv2 5.0.0. uint8 with a size ≥ 13: OpenCV takes
    another integer route there, which is not reproduced; here the float64
    product is rounded, within 1 of cv2 5.0.0 at sizes 17 and 33 and within 2
    at 13 (tests/test_torch_shape_ops.py)."""
    kw, kh = int(ksize[0]), int(ksize[1])
    if kw % 2 != 1 or kh % 2 != 1:
        raise ValueError(f"gaussian_blur takes odd kernel sizes, got {ksize}")
    if img.dtype == np.uint8:
        if max(kw, kh) <= 11:
            v = _separable(img, _gaussian_kernel_q8(kw), _gaussian_kernel_q8(kh))
            return np.clip((v + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
        v = _separable(img, gaussian_kernel(kw), gaussian_kernel(kh))
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    if img.dtype != np.float64:
        raise ValueError(f"gaussian_blur takes float64 or uint8, got {img.dtype}")
    return _separable(img, gaussian_kernel(kw), gaussian_kernel(kh))


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
