"""Host-side pipelines (port of nuhtc_tpu/data/pipelines.py): test-time
preprocessing (``preprocess_test_image``: Resize ×scale_factor, Normalize,
Pad(size_divisor)); the image-corruption catalog (``CORRUPTIONS``,
``CORRUPTION_GROUPS``), which the robustness run and ``RandCorrupt`` apply;
and the train transforms the shipped configs use (PhotoMetricDistortion,
Resize, RandomFlip, RandTranslate/RandRotate/RandShear + RecomputeBox,
OneOf, Sequential, ShuffledSequential, RandCorrupt, RandPosterize,
Normalize, Pad, SegRescale, RandomCrop, CusRandomCrop, FOVCrop) and the
rest of that module's (the color ops AutoContrast, RandEqualize,
RandSolarize, RandColor, RandBrightness, RandContrast, RandSharpness;
RandErase; Resize_Scale, SmartResize; MultiBranch), built by name from a
config's ``train_pipeline`` (``build_train_pipeline``) and run with one
``np.random.RandomState`` (``run_pipeline``), drawing as the JAX package
draws.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``. The port
needs no OpenCV: ``resize_linear_u8`` reproduces that resize for uint8 images
in numpy, with OpenCV's arithmetic (half-pixel centres, coefficients rounded
to 1/2048, a horizontal pass in integers, then the vertical pass rounded to
nearest).
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.ops import imgproc
from nuhtc_tpu_torch.ops.contours import circle
from nuhtc_tpu_torch.registry import PIPELINES

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


# --- the corruption catalog (19 types of the ``imagecorruptions`` benchmark) ---
#
# Each function takes a uint8 RGB image, a severity in 1..5 and the caller's
# ``np.random.RandomState``, and returns the corrupted image (float or
# uint8; the caller clips and casts). The draws are the JAX package's draws
# in the same order, so equal seeds give equal images. The OpenCV calls are
# the port's numpy versions (``ops.imgproc``, ``ops.contours.circle``),
# equal to cv2 5.0.0 but in two places: ``jpeg_compression`` goes through
# Pillow's JPEG codec, and ``snow`` filters float32 with a kernel of 130 taps
# or more at severities 4 and 5, where OpenCV switches to a DFT
# (``imgproc.filter2d``). tests/test_torch_corruptions.py states both bounds.


def _corrupt_gaussian_noise(img, sev, rng):
    return np.clip(img.astype(np.float32) + rng.randn(*img.shape) * (4 + 4 * sev), 0, 255)


def _corrupt_shot_noise(img, sev, rng):
    lam = 60.0 / sev  # photons per unit intensity
    return np.clip(rng.poisson(img.astype(np.float32) / 255.0 * lam) / lam * 255.0, 0, 255)


def _corrupt_impulse_noise(img, sev, rng):
    out = img.astype(np.float32).copy()
    p = 0.01 * sev
    m = rng.rand(*img.shape[:2])
    out[m < p / 2] = 0.0
    out[(m >= p / 2) & (m < p)] = 255.0
    return out


def _corrupt_gaussian_blur(img, sev, rng):
    return imgproc.gaussian_blur(img, (0, 0), 0.5 * sev)


def _corrupt_defocus_blur(img, sev, rng):
    r = sev + 1
    k = np.zeros((2 * r + 1, 2 * r + 1), np.float32)
    circle(k, (r, r), r, 1.0)
    k /= k.sum()
    return imgproc.filter2d(img, k)


def _line_kernel(n: int, angle: float, vertical: bool) -> np.ndarray:
    """A one-pixel line through the centre of an n × n kernel (a row, or a
    column), rotated by ``angle`` degrees and normalised."""
    k = np.zeros((n, n), np.float32)
    if vertical:
        k[:, n // 2] = 1.0
    else:
        k[n // 2, :] = 1.0 / n
    rot = imgproc.get_rotation_matrix_2d((n / 2 - 0.5, n / 2 - 0.5), angle, 1.0)
    k = imgproc.warp_affine(k, rot, (n, n))
    return k / max(k.sum(), 1e-6)


def _corrupt_motion_blur(img, sev, rng):
    return imgproc.filter2d(img, _line_kernel(2 * sev + 3, rng.uniform(0, 180), False))


def _corrupt_zoom_blur(img, sev, rng):
    h, w = img.shape[:2]
    acc = img.astype(np.float32).copy()
    cnt = 1
    for z in np.arange(1.0, 1.0 + 0.04 * sev, 0.01)[1:]:
        zh, zw = int(np.ceil(h * z)), int(np.ceil(w * z))
        big = imgproc.resize_u8(img, (zh, zw))
        y0, x0 = (zh - h) // 2, (zw - w) // 2
        acc += big[y0:y0 + h, x0:x0 + w].astype(np.float32)
        cnt += 1
    return np.clip(acc / cnt, 0, 255)


def _corrupt_jpeg(img, sev, rng):
    """JPEG at quality max(10, 60 − 12·sev) through Pillow (imported here;
    ImportError where it is missing). OpenCV encodes the array as BGR, so
    the channels are swapped around the codec as OpenCV's would see them."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("jpeg_compression needs Pillow (PIL), which is not installed") from e
    import io

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(
        buf, format="JPEG", quality=max(10, 60 - 12 * sev))
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))[..., ::-1].copy()


def _corrupt_pixelate(img, sev, rng):
    h, w = img.shape[:2]
    f = 1.0 - 0.15 * sev
    small = imgproc.resize_u8(img, (max(1, int(h * f)), max(1, int(w * f))))
    return imgproc.resize_nearest(small, (h, w))


def _corrupt_brightness(img, sev, rng):
    return np.clip(img.astype(np.float32) + 20.0 * sev, 0, 255)


def _corrupt_contrast(img, sev, rng):
    f = 1.0 - 0.15 * sev
    mean = img.astype(np.float32).mean(axis=(0, 1), keepdims=True)
    return np.clip((img.astype(np.float32) - mean) * f + mean, 0, 255)


def _corrupt_saturate(img, sev, rng):
    hsv = imgproc.rgb_to_hsv_u8(img).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * (1.0 + 0.2 * sev), 0, 255)
    return imgproc.hsv_to_rgb_u8(hsv.astype(np.uint8))


def _corrupt_speckle_noise(img, sev, rng):
    # multiplicative gaussian noise (imagecorruptions speckle_noise)
    f = img.astype(np.float32)
    return np.clip(f + f * rng.randn(*img.shape) * (0.06 + 0.04 * sev), 0, 255)


def _corrupt_glass_blur(img, sev, rng):
    # local pixel shuffling between two light blurs (imagecorruptions glass_blur)
    out = imgproc.gaussian_blur(img, (0, 0), 0.3 + 0.2 * sev)
    h, w = out.shape[:2]
    d = sev  # the largest displacement
    for _ in range(2):
        dx = rng.randint(-d, d + 1, (h, w))
        dy = rng.randint(-d, d + 1, (h, w))
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        out = out[np.clip(yy + dy, 0, h - 1), np.clip(xx + dx, 0, w - 1)]
    return imgproc.gaussian_blur(out, (0, 0), 0.3 + 0.2 * sev)


def _plasma(h, w, rng, roughness=0.8):
    """A diamond-square-style fractal cloud in [0, 1] (the fog and frost base)."""
    size = 1
    while size < max(h, w):
        size *= 2
    grid = rng.rand(2, 2).astype(np.float32)
    scale = 1.0
    while grid.shape[0] < size + 1:
        n = (grid.shape[0] - 1) * 2 + 1
        up = imgproc.resize_linear_f32(grid, (n, n))
        scale *= roughness
        grid = up + (rng.rand(n, n).astype(np.float32) - 0.5) * scale
    g = grid[:h, :w]
    g -= g.min()
    return g / max(g.max(), 1e-6)


def _corrupt_fog(img, sev, rng):
    h, w = img.shape[:2]
    fog = _plasma(h, w, rng)[..., None]
    amount = 0.12 * sev
    f = img.astype(np.float32) / 255.0
    out = f * (1 - amount * fog) + amount * fog * 0.9
    return np.clip(out * 255.0, 0, 255)


def _corrupt_frost(img, sev, rng):
    # a crystalline overlay synthesised from a thresholded plasma texture
    # (imagecorruptions composites frost photographs; no asset files here)
    h, w = img.shape[:2]
    tex = _plasma(h, w, rng, roughness=0.9)
    crystal = np.clip((tex - 0.55) * 4.0, 0, 1)[..., None]
    amount = 0.1 + 0.08 * sev
    f = img.astype(np.float32) / 255.0
    out = f * (1 - amount * crystal) + amount * crystal * np.array([0.9, 0.95, 1.0])
    return np.clip(out * 255.0, 0, 255)


def _corrupt_snow(img, sev, rng):
    # sparse bright specks, motion-blurred into flakes, under a whitening veil
    h, w = img.shape[:2]
    layer = (rng.rand(h, w) < 0.002 * sev).astype(np.float32)
    n = 2 * sev + 5
    k = _line_kernel(n, rng.uniform(-30, 30), True)
    flakes = np.clip(imgproc.filter2d(layer, k) * n * 0.8, 0, 1)[..., None]
    f = img.astype(np.float32) / 255.0
    veil = 0.04 * sev
    out = (f * (1 - veil) + veil) * (1 - flakes) + flakes
    return np.clip(out * 255.0, 0, 255)


def _corrupt_spatter(img, sev, rng):
    # liquid blobs: blurred noise thresholded into droplets (imagecorruptions
    # spatter's water mode), darkening where they land
    h, w = img.shape[:2]
    liquid = imgproc.gaussian_blur(rng.rand(h, w).astype(np.float32), (0, 0), 3.0)
    thr = 1.0 - 0.04 * sev - 0.62
    m = np.clip((liquid - thr) * 8.0, 0, 1)[..., None]
    f = img.astype(np.float32) / 255.0
    tint = f * np.array([0.75, 0.85, 0.95])
    out = f * (1 - 0.6 * m) + tint * (0.6 * m)
    return np.clip(out * 255.0, 0, 255)


def _corrupt_elastic(img, sev, rng):
    h, w = img.shape[:2]
    alpha = 2.0 * sev
    dx = imgproc.gaussian_blur(rng.rand(h, w).astype(np.float32) * 2 - 1, (0, 0), 8) * alpha
    dy = imgproc.gaussian_blur(rng.rand(h, w).astype(np.float32) * 2 - 1, (0, 0), 8) * alpha
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return imgproc.remap(img, xx + dx, yy + dy)


# name → function, in the JAX package's order
CORRUPTIONS = {
    "gaussian_noise": _corrupt_gaussian_noise,
    "shot_noise": _corrupt_shot_noise,
    "impulse_noise": _corrupt_impulse_noise,
    "speckle_noise": _corrupt_speckle_noise,
    "gaussian_blur": _corrupt_gaussian_blur,
    "glass_blur": _corrupt_glass_blur,
    "defocus_blur": _corrupt_defocus_blur,
    "motion_blur": _corrupt_motion_blur,
    "zoom_blur": _corrupt_zoom_blur,
    "snow": _corrupt_snow,
    "frost": _corrupt_frost,
    "fog": _corrupt_fog,
    "spatter": _corrupt_spatter,
    "jpeg_compression": _corrupt_jpeg,
    "pixelate": _corrupt_pixelate,
    "brightness": _corrupt_brightness,
    "contrast": _corrupt_contrast,
    "saturate": _corrupt_saturate,
    "elastic_transform": _corrupt_elastic,
}

# the groups of the corruption benchmark (mmdet's test_robustness lists)
CORRUPTION_GROUPS = {
    "noise": ["gaussian_noise", "shot_noise", "impulse_noise"],
    "blur": ["defocus_blur", "glass_blur", "motion_blur", "zoom_blur"],
    "weather": ["snow", "frost", "fog", "brightness"],
    "digital": ["contrast", "elastic_transform", "pixelate", "jpeg_compression"],
    "holdout": ["speckle_noise", "gaussian_blur", "spatter", "saturate"],
}
CORRUPTION_GROUPS["benchmark"] = (
    CORRUPTION_GROUPS["noise"] + CORRUPTION_GROUPS["blur"]
    + CORRUPTION_GROUPS["weather"] + CORRUPTION_GROUPS["digital"]
)
CORRUPTION_GROUPS["all"] = CORRUPTION_GROUPS["benchmark"] + CORRUPTION_GROUPS["holdout"]


# --------------------------------------------------------------------------- #
# train transforms: a ``results`` dict of img (H, W, 3) RGB f32, gt_bboxes
# (N, 4), gt_labels (N,), gt_masks (N, H, W) u8, gt_semantic_seg (H, W) u8;
# each OpenCV call of the JAX package is its numpy version in ops/imgproc.py
# --------------------------------------------------------------------------- #
@PIPELINES.register()
class PhotoMetricDistortion:
    """Random brightness, contrast, saturation and hue (mmdet semantics)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=9):
        self.bd = brightness_delta
        self.cl, self.cu = contrast_range
        self.sl, self.su = saturation_range
        self.hd = hue_delta

    def __call__(self, results, rng: np.random.RandomState):
        img = results["img"].astype(np.float32)
        if rng.randint(2):
            img += rng.uniform(-self.bd, self.bd)
        mode = rng.randint(2)
        if mode == 1 and rng.randint(2):
            img *= rng.uniform(self.cl, self.cu)
        # the coin flips first; the uint8 HSV round trip only when one fires
        do_sat = rng.randint(2)
        sat = rng.uniform(self.sl, self.su) if do_sat else 1.0
        do_hue = rng.randint(2)
        hue = rng.uniform(-self.hd, self.hd) if do_hue else 0.0
        if do_sat or do_hue:
            hsv = imgproc.rgb_to_hsv_u8(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
            if do_sat:
                hsv[..., 1] *= sat
            if do_hue:
                hsv[..., 0] = (hsv[..., 0] + hue) % 180
            img = imgproc.hsv_to_rgb_u8(np.clip(hsv, 0, 255).astype(np.uint8)).astype(np.float32)
        if mode == 0 and rng.randint(2):
            img *= rng.uniform(self.cl, self.cu)
        results["img"] = np.clip(img, 0, 255)
        return results


@PIPELINES.register()
class Resize:
    def __init__(self, img_scale=(512, 512), keep_ratio=True):
        self.img_scale = img_scale
        self.keep_ratio = keep_ratio

    def __call__(self, results, rng=None, img_scale=None):
        img_scale = img_scale if img_scale is not None else self.img_scale
        img = results["img"]
        h, w = img.shape[:2]
        if self.keep_ratio:
            scale = min(img_scale[0] / h, img_scale[1] / w)
            nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        else:
            nh, nw = img_scale
        sy, sx = nh / h, nw / w
        results["img"] = imgproc.resize_linear_f32(img.astype(np.float32), (nh, nw))
        results["scale_factor"] = np.array([sx, sy, sx, sy], np.float32)
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            results["gt_bboxes"] = results["gt_bboxes"] * results["scale_factor"]
        if "gt_masks" in results and len(results["gt_masks"]):
            results["gt_masks"] = np.stack(
                [imgproc.resize_nearest(m, (nh, nw)) for m in results["gt_masks"]])
        if results.get("gt_semantic_seg") is not None:
            results["gt_semantic_seg"] = imgproc.resize_nearest(results["gt_semantic_seg"],
                                                                 (nh, nw))
        return results


@PIPELINES.register()
class RandomFlip:
    def __init__(self, flip_ratio=0.5, direction=("horizontal", "vertical", "diagonal")):
        self.flip_ratio = flip_ratio
        self.direction = [direction] if isinstance(direction, str) else list(direction)

    def __call__(self, results, rng: np.random.RandomState):
        if rng.rand() >= self.flip_ratio:
            return results
        d = self.direction[rng.randint(len(self.direction))]
        h, w = results["img"].shape[:2]

        def flip(x):
            if d == "horizontal":
                return np.ascontiguousarray(x[:, ::-1])
            if d == "vertical":
                return np.ascontiguousarray(x[::-1])
            return np.ascontiguousarray(x[::-1, ::-1])

        results["img"] = flip(results["img"])
        if results.get("gt_semantic_seg") is not None:
            results["gt_semantic_seg"] = flip(results["gt_semantic_seg"])
        if "gt_masks" in results and len(results["gt_masks"]):
            results["gt_masks"] = np.stack([flip(m) for m in results["gt_masks"]])
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            b = results["gt_bboxes"].copy()
            if d in ("horizontal", "diagonal"):
                b[:, [0, 2]] = w - results["gt_bboxes"][:, [2, 0]]
                results["gt_bboxes"] = b.copy()
            if d in ("vertical", "diagonal"):
                b = results["gt_bboxes"].copy()
                b[:, [1, 3]] = h - results["gt_bboxes"][:, [3, 1]]
                results["gt_bboxes"] = b
        return results


def _warp_all(results, mat: np.ndarray, seg_ignore_label: int = 0):
    """A 2×3 affine on the image (bilinear), the semantic map (nearest,
    ``seg_ignore_label`` outside) and the masks (nearest, 0 outside); the
    boxes are recomputed by RecomputeBox."""
    img = results["img"]
    h, w = img.shape[:2]
    results["img"] = imgproc.warp_affine(img.astype(np.float32), mat, (w, h))
    if results.get("gt_semantic_seg") is not None:
        results["gt_semantic_seg"] = imgproc.warp_affine_nearest(
            results["gt_semantic_seg"], mat, (w, h), border_value=seg_ignore_label)
    if "gt_masks" in results and len(results["gt_masks"]):
        results["gt_masks"] = np.stack(
            [imgproc.warp_affine_nearest(m, mat, (w, h)) for m in results["gt_masks"]])
    return results


@PIPELINES.register()
class RandTranslate:
    def __init__(self, x=None, y=None, seg_ignore_label=0):
        self.x, self.y, self.ignore = x, y, seg_ignore_label

    def __call__(self, results, rng: np.random.RandomState):
        h, w = results["img"].shape[:2]
        tx = rng.uniform(*self.x) * w if self.x else 0.0
        ty = rng.uniform(*self.y) * h if self.y else 0.0
        return _warp_all(results, np.float32([[1, 0, tx], [0, 1, ty]]), self.ignore)


@PIPELINES.register()
class RandRotate:
    def __init__(self, angle=(-10, 10), seg_ignore_label=0):
        self.angle, self.ignore = angle, seg_ignore_label

    def __call__(self, results, rng: np.random.RandomState):
        h, w = results["img"].shape[:2]
        mat = imgproc.get_rotation_matrix_2d((w / 2, h / 2), rng.uniform(*self.angle), 1.0)
        return _warp_all(results, mat.astype(np.float32), self.ignore)


@PIPELINES.register()
class RandShear:
    def __init__(self, x=None, y=None, seg_ignore_label=0):
        self.x, self.y, self.ignore = x, y, seg_ignore_label

    def __call__(self, results, rng: np.random.RandomState):
        sx = math.tan(math.radians(rng.uniform(*self.x))) if self.x else 0.0
        sy = math.tan(math.radians(rng.uniform(*self.y))) if self.y else 0.0
        return _warp_all(results, np.float32([[1, sx, 0], [sy, 1, 0]]), self.ignore)


@PIPELINES.register()
class RecomputeBox:
    """Boxes from the warped masks; instances whose mask emptied are dropped
    from every per-instance array; box-only trailing instances (fewer masks
    than boxes) keep their boxes."""

    def __call__(self, results, rng=None):
        masks = results.get("gt_masks")
        if masks is None or len(masks) == 0:
            return results
        n_masked = len(masks)
        keep, boxes = [], []
        for i, m in enumerate(masks):
            ys, xs = np.nonzero(m)
            if len(xs) == 0:
                continue
            keep.append(i)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        keep = np.asarray(keep, np.int64)
        n_orig = len(results["gt_bboxes"])
        tail = np.arange(n_masked, n_orig, dtype=np.int64)
        keep_all = np.concatenate([keep, tail])
        results["gt_masks"] = masks[keep] if len(keep) else masks[:0]
        new_boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        results["gt_bboxes"] = np.concatenate(
            [new_boxes, results["gt_bboxes"][tail]], axis=0).astype(np.float32)
        results["gt_labels"] = results["gt_labels"][keep_all]
        if "ismask" in results and results["ismask"] is not None \
                and len(results["ismask"]) == n_orig:
            results["ismask"] = np.asarray(results["ismask"])[keep_all]
        return results


@PIPELINES.register()
class OneOf:
    def __init__(self, transforms: Sequence, rng_build=None):
        self.transforms = [build_transform(t) for t in transforms]

    def __call__(self, results, rng: np.random.RandomState):
        t = self.transforms[rng.randint(len(self.transforms))]
        if isinstance(t, list):
            for tt in t:
                results = tt(results, rng)
            return results
        return t(results, rng)


@PIPELINES.register()
class Sequential:
    def __init__(self, transforms: Sequence, record=False):
        self.transforms = [build_transform(t) for t in transforms]

    def __call__(self, results, rng: np.random.RandomState):
        for t in self.transforms:
            results = t(results, rng)
        return results


@PIPELINES.register()
class ShuffledSequential(Sequential):
    def __call__(self, results, rng: np.random.RandomState):
        for i in rng.permutation(len(self.transforms)):
            results = self.transforms[i](results, rng)
        return results


@PIPELINES.register()
class RandCorrupt:
    """One corruption of the catalog at probability ``prob`` (reference
    rand_aug.py:979): ``corruption`` None (every type), a name or a list;
    ``severity`` an int or a (lo, hi) range."""

    def __init__(self, prob=0.5, severity=1, corruption=None, corruptions=None):
        self.prob = prob
        self.severity = (severity, severity) if isinstance(severity, int) else tuple(severity)
        names = corruption if corruption is not None else corruptions
        if isinstance(names, str):
            names = [names]
        self.names = [n for n in (names or CORRUPTIONS) if n in CORRUPTIONS]

    def __call__(self, results, rng: np.random.RandomState):
        if rng.rand() >= self.prob:
            return results
        img = np.clip(results["img"], 0, 255).astype(np.uint8)
        sev = rng.randint(self.severity[0], self.severity[1] + 1)
        name = self.names[rng.randint(len(self.names))]
        img = CORRUPTIONS[name](img, sev, rng)
        results["img"] = np.clip(img, 0, 255).astype(np.float32)
        return results


@PIPELINES.register()
class RandPosterize:
    """Bit-depth reduction to ``4 - magnitude`` bits (reference rand_aug.py:202)."""

    def __init__(self, prob=0.5, magnitude_limit=4):
        self.prob = prob
        self.magnitude_limit = magnitude_limit

    def __call__(self, results, rng: np.random.RandomState):
        if rng.rand() >= self.prob:
            return results
        bits = max(4 - rng.randint(0, self.magnitude_limit + 1), 1)
        keep = np.uint8(0xFF & ~((1 << (8 - bits)) - 1))
        img = np.clip(results["img"], 0, 255).astype(np.uint8)
        results["img"] = (img & keep).astype(np.float32)
        return results


@PIPELINES.register()
class Normalize:
    def __init__(self, mean=IMG_NORM["mean"], std=IMG_NORM["std"], to_rgb=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, results, rng=None):
        results["img"] = (results["img"].astype(np.float32) - self.mean) / self.std
        return results


@PIPELINES.register()
class Pad:
    def __init__(self, size_divisor=32):
        self.d = size_divisor

    def __call__(self, results, rng=None):
        img = results["img"]
        ph = (-img.shape[0]) % self.d
        pw = (-img.shape[1]) % self.d
        if ph or pw:
            results["img"] = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            if results.get("gt_semantic_seg") is not None:
                results["gt_semantic_seg"] = np.pad(results["gt_semantic_seg"],
                                                    ((0, ph), (0, pw)))
            if "gt_masks" in results and len(results["gt_masks"]):
                results["gt_masks"] = np.pad(results["gt_masks"], ((0, 0), (0, ph), (0, pw)))
        return results


@PIPELINES.register()
class SegRescale:
    def __init__(self, scale_factor=0.25):
        self.f = scale_factor

    def __call__(self, results, rng=None):
        seg = results.get("gt_semantic_seg")
        if seg is not None:
            h, w = seg.shape
            results["gt_semantic_seg"] = imgproc.resize_nearest(
                seg, (int(h * self.f), int(w * self.f)))
        return results


def _crop_instances(results, y0, x0, ch, cw, allow_negative_crop=False):
    """Crops the image, the masks and the semantic map to ``[y0:y0+ch,
    x0:x0+cw]`` (mmdet ``RandomCrop._crop_data``): the boxes shift into the
    crop and clip to it, instances whose box becomes empty go from the
    labels, masks and ``ismask`` by one keep set (the kept indices stay
    sorted, so where masks are a prefix of the boxes, as in NuCLS, they stay
    one). None when no box is left and ``allow_negative_crop`` is false: the
    loader then draws another sample."""

    def crop(x):
        return np.ascontiguousarray(x[y0:y0 + ch, x0:x0 + cw])

    boxes = results.get("gt_bboxes")
    if boxes is not None and len(boxes):
        b = boxes - np.array([x0, y0, x0, y0], np.float32)
        b[:, 0::2] = np.clip(b[:, 0::2], 0, cw)
        b[:, 1::2] = np.clip(b[:, 1::2], 0, ch)
        valid = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        if not valid.any() and not allow_negative_crop:
            return None
        keep = np.nonzero(valid)[0]
        results["gt_bboxes"] = b[keep].astype(np.float32)
        if "gt_labels" in results and len(results["gt_labels"]) == len(boxes):
            results["gt_labels"] = np.asarray(results["gt_labels"])[keep]
        if results.get("ismask") is not None and len(results["ismask"]) == len(boxes):
            results["ismask"] = np.asarray(results["ismask"])[keep]
        masks = results.get("gt_masks")
        if masks is not None and len(masks):
            mask_keep = keep[keep < len(masks)]
            results["gt_masks"] = (np.stack([crop(masks[i]) for i in mask_keep]) if len(mask_keep)
                                   else masks[:0, y0:y0 + ch, x0:x0 + cw])
    results["img"] = crop(results["img"])
    if results.get("gt_semantic_seg") is not None:
        results["gt_semantic_seg"] = crop(results["gt_semantic_seg"])
    return results


def _truthy(v):
    """The configs pass ``allow_negative_crop='True'``, a string: bool()."""
    return bool(v)


@PIPELINES.register()
class RandomCrop:
    """mmdet RandomCrop, ``absolute`` crop type: a ``crop_size`` (h, w)
    window, cut to the image's size on a short axis, at y then x drawn by
    ``rng.randint``. None when the crop holds no box and negative crops are
    not allowed."""

    def __init__(self, crop_size=(256, 256), crop_type="absolute", allow_negative_crop=False,
                 bbox_clip_border=True):
        if crop_type != "absolute":
            raise NotImplementedError(f"crop_type={crop_type!r}: only 'absolute' is ported")
        if not bbox_clip_border:
            raise NotImplementedError("bbox_clip_border=False is not ported")
        self.crop_size = crop_size
        self.allow_negative_crop = _truthy(allow_negative_crop)

    def __call__(self, results, rng: np.random.RandomState):
        h, w = results["img"].shape[:2]
        ch, cw = min(self.crop_size[0], h), min(self.crop_size[1], w)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        return _crop_instances(results, y0, x0, ch, cw, self.allow_negative_crop)


@PIPELINES.register()
class CusRandomCrop(RandomCrop):
    """The reference's RandomCrop with ``ismask`` kept in step, which
    ``_crop_instances`` does for every crop."""


@PIPELINES.register()
class FOVCrop:
    """Crops to the image's field of view, ``img_info['fovloc']`` = (x1, y1,
    x2, y2), clamped to the image (at least one cell); an image without one
    passes unchanged."""

    def __init__(self, allow_negative_crop=False, bbox_clip_border=True):
        self.allow_negative_crop = _truthy(allow_negative_crop)

    def __call__(self, results, rng=None):
        fovloc = (results.get("img_info") or {}).get("fovloc")
        if fovloc is None:
            return results
        x1, y1, x2, y2 = (int(v) for v in fovloc)
        h, w = results["img"].shape[:2]
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(max(x2, x1 + 1), w), min(max(y2, y1 + 1), h)
        return _crop_instances(results, y1, x1, y2 - y1, x2 - x1, self.allow_negative_crop)


# --------------------------------------------------------------------------- #
# color ops, cutout, resize variants and the semi-supervised views
# (reference rand_aug.py:120-263, 770-863, 1038; resize_scale.py)
# --------------------------------------------------------------------------- #
@PIPELINES.register()
class AutoContrast:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        img = np.clip(results["img"], 0, 255)
        lo, hi = img.min(), img.max()
        if hi > lo:
            results["img"] = (img - lo) * (255.0 / (hi - lo))
        return results


@PIPELINES.register()
class RandEqualize:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        img = np.clip(results["img"], 0, 255).astype(np.uint8)
        results["img"] = np.stack([imgproc.equalize_hist_u8(img[..., c]) for c in range(3)],
                                  -1).astype(np.float32)
        return results


@PIPELINES.register()
class RandSolarize:
    def __init__(self, prob=0.5, threshold=128):
        self.prob, self.threshold = prob, threshold

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        img = np.clip(results["img"], 0, 255)
        # as the JAX package reads its test: a scalar threshold draws
        # uniform(0, threshold), a sequence is used as it is
        thr = self.threshold if hasattr(self.threshold, "__len__") else rng.uniform(
            0, self.threshold)
        results["img"] = np.where(img >= thr, 255.0 - img, img)
        return results


@PIPELINES.register()
class RandColor:
    """Random color jitter towards grayscale (PIL Color enhance analog)."""

    def __init__(self, prob=0.5, factor=(0.5, 1.5)):
        self.prob, self.factor = prob, factor

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        img = np.clip(results["img"], 0, 255)
        gray = imgproc.rgb_to_gray_u8(img.astype(np.uint8)).astype(np.float32)[..., None]
        f = rng.uniform(*self.factor)
        results["img"] = np.clip(gray + f * (img - gray), 0, 255)
        return results


@PIPELINES.register()
class RandBrightness:
    def __init__(self, prob=0.5, factor=(0.5, 1.5)):
        self.prob, self.factor = prob, factor

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        results["img"] = np.clip(results["img"] * rng.uniform(*self.factor), 0, 255)
        return results


@PIPELINES.register()
class RandContrast:
    def __init__(self, prob=0.5, factor=(0.5, 1.5)):
        self.prob, self.factor = prob, factor

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        img = np.clip(results["img"], 0, 255)
        mean = img.mean()
        results["img"] = np.clip(mean + rng.uniform(*self.factor) * (img - mean), 0, 255)
        return results


@PIPELINES.register()
class RandSharpness:
    def __init__(self, prob=0.5, factor=(0.0, 2.0)):
        self.prob, self.factor = prob, factor

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        img = np.clip(results["img"], 0, 255).astype(np.float32)
        blur = imgproc.gaussian_blur(img, (3, 3), 0)
        f = rng.uniform(*self.factor)
        results["img"] = np.clip(blur + f * (img - blur), 0, 255)
        return results


@PIPELINES.register()
class RandErase:
    """Random rectangular cutouts: each patch is erased from the image (fill
    128), from every gt mask and from the semantic map (fill 0), so that no
    gt supervises nuclei inside a featureless cutout."""

    def __init__(self, prob=0.7, n_iterations=(1, 5), size=(0.0, 0.2), squared=True,
                 img_fill_val=128):
        self.prob, self.n_iterations, self.size, self.squared = prob, n_iterations, size, squared
        self.img_fill_val = img_fill_val

    def __call__(self, results, rng):
        if rng.rand() >= self.prob:
            return results
        img = results["img"]
        h, w = img.shape[:2]
        for _ in range(rng.randint(self.n_iterations[0], self.n_iterations[1] + 1)):
            sw = rng.uniform(*self.size)
            sh = sw if self.squared else rng.uniform(*self.size)
            ph, pw = max(int(h * sh), 1), max(int(w * sw), 1)
            y0, x0 = rng.randint(0, max(h - ph, 1)), rng.randint(0, max(w - pw, 1))
            img[y0:y0 + ph, x0:x0 + pw] = self.img_fill_val
            masks = results.get("gt_masks")
            if masks is not None and len(masks):
                masks[:, y0:y0 + ph, x0:x0 + pw] = 0
            if results.get("gt_semantic_seg") is not None:
                results["gt_semantic_seg"][y0:y0 + ph, x0:x0 + pw] = 0
        results["img"] = img
        return results


@PIPELINES.register()
class Resize_Scale(Resize):
    """Resize by a fixed scale factor, keeping the ratio."""

    def __init__(self, scale_factor=2.0):
        super().__init__(img_scale=None, keep_ratio=True)
        self.scale_factor = scale_factor

    def __call__(self, results, rng=None):
        h, w = results["img"].shape[:2]
        target = (int(h * self.scale_factor + 0.5), int(w * self.scale_factor + 0.5))
        return super().__call__(results, rng, img_scale=target)


@PIPELINES.register()
class SmartResize(Resize):
    """Resize to a target, keeping the ratio (the reference's name)."""


@PIPELINES.register()
class MultiBranch:
    """Several augmented views of one sample (the teacher/student branches
    of semi-supervised training): each branch's pipeline runs on its own
    deep copy, in the order the branches are given, drawing from the one
    ``rng``. Returns a dict of the branches' results."""

    def __init__(self, **branches):
        self.branches = {k: build_train_pipeline(v) for k, v in branches.items()}

    def __call__(self, results, rng):
        return {name: run_pipeline(p, copy.deepcopy(results), rng)
                for name, p in self.branches.items()}


# the reference's loading and formatting steps: the loader does their work
_SKIP = {"LoadImageFromFile", "LoadAnnotations", "CusLoadAnnotations",
         "DefaultFormatBundle", "Collect", "MultiScaleFlipAug", "ImageToTensor"}


def build_transform(cfg):
    if isinstance(cfg, list):
        return [build_transform(c) for c in cfg]
    cfg = dict(cfg)
    typ = cfg.pop("type")
    if typ in _SKIP:
        return None
    return PIPELINES.get(typ)(**cfg)


def build_train_pipeline(cfgs: List[dict]) -> List:
    return [t for t in (build_transform(c) for c in cfgs) if t is not None]


def run_pipeline(transforms: List, results: dict,
                 rng: np.random.RandomState) -> Optional[dict]:
    """A transform that returns None rejects the sample; the caller then
    draws another index."""
    for t in transforms:
        results = t(results, rng)
        if results is None:
            return None
    return results
