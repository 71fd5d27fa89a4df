"""Score-heatmap rendering + legacy patch generation over a slide (port of
nuhtc_tpu/wsi/heatmap.py).

Behavioural ports of the reference ``WholeSlideImage.visHeatmap`` /
``block_blending`` / ``get_seg_mask`` and the legacy patch generator
``_getPatchGenerator``, plus the small score utilities ``to_percentiles``,
``screen_coords`` and the white/black patch filters. Host code on numpy and
the port's own OpenCV-equal operations (``ops.contours``, ``ops.imgproc``).

The default colour map, matplotlib's "coolwarm", travels with the module as
a table (``COOLWARM_U8``, made once from matplotlib 3.10.8), so that the
default heatmap renders without matplotlib; any other map name imports
matplotlib and raises ImportError by name when it is missing.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from nuhtc_tpu_torch.ops import contours as cnt
from nuhtc_tpu_torch.ops.imgproc import (
    add_weighted_u8, gaussian_blur, resize_u8, rgb_to_saturation_u8)
from nuhtc_tpu_torch.wsi.slide import SlideReader
from nuhtc_tpu_torch.wsi.tissue import TissueSegmentation, _four_pt_check, _in_holes

# matplotlib 3.10.8's "coolwarm" (N = 256): (lut * 255)[:, :3] as uint8, row by row
COOLWARM_U8 = np.frombuffer(bytes.fromhex(
    "3a4cc03b4dc13c4fc33e51c43f53c64054c74156c94258ca435acc455bcd465dcf475fd0"
    "4860d14962d34b64d44c66d64d67d74e69d8506bda516cdb526edc5370dd5571de5673e0"
    "5775e15876e25a78e35b79e45c7be55d7de65f7ee76080e86182ea6383ea6485eb6586ec"
    "6788ed6889ee698bef6b8df06c8ef16d90f16f91f27093f37194f47395f47497f57598f6"
    "779af6789bf77a9df87b9ef87ca0f97ea1f97fa2fa80a4fa82a5fb83a6fb85a8fb86a9fc"
    "87aafc89acfc8aadfd8baefd8daffd8eb1fd90b2fe91b3fe92b4fe94b5fe95b7fe97b8fe"
    "98b9fe99bafe9bbbfe9cbcfe9dbdfe9fbefea0bffea2c0fea3c1fea4c2fea6c3fda7c4fd"
    "a8c5fdaac6fdabc7fcacc8fcaec9fcafcafbb0cbfbb2cbfbb3ccfab4cdfab6cef9b7cff9"
    "b8cff8b9d0f8bbd1f7bcd1f6bdd2f6bed3f5c0d3f5c1d4f4c2d4f3c3d5f2c5d5f2c6d6f1"
    "c7d6f0c8d7efc9d7eecad8eeccd8edcdd9ecced9ebcfd9ead0dae9d1dae8d2dae7d3dbe6"
    "d5dbe5d6dbe4d7dbe2d8dbe1d9dce0dadcdfdbdcdedcdcdddddcdbdedbdadfdbd9e0dad7"
    "e1dad6e2d9d4e3d9d3e4d8d1e5d8d0e6d7cfe7d6cde7d6cce8d5cae9d4c9ead3c7ebd3c6"
    "ecd2c4ecd1c3edd0c1edcfc0eecfbeefcebcefcdbbf0ccb9f1cbb8f1cab6f2c9b5f2c8b3"
    "f2c7b2f3c6b0f3c5aff4c4adf4c3abf4c2aaf5c1a8f5c0a7f5bfa5f6bda4f6bca2f6bba0"
    "f6ba9ff6b99df6b79cf6b69af7b598f7b397f7b295f7b194f7b092f7ae91f7ad8ff6ab8d"
    "f6aa8cf6a98af6a789f6a687f6a486f6a384f5a182f5a081f59e7ff49d7ef49b7cf49a7b"
    "f39879f39678f39576f29375f29173f19072f18e70f08d6ff08b6def896cee876aee8669"
    "ed8467ec8266ec8064eb7f63ea7d61ea7b60e9795ee8775de7755ce6745ae67259e57057"
    "e46e56e36c54e26a53e16852e06650df644fde624edd604cdc5e4bdb5c4ada5a48d95847"
    "d85646d75444d65243d44f42d34d40d24b3fd1493ecf463dce443ccd423acc3f39ca3d38"
    "c93b37c83835c63534c53233c43032c22d31c12a30bf282ebe232dbc1f2cbb1a2bb9162a"
    "b81129b60d28b50827b30326"
), np.uint8).reshape(256, 3)


def to_percentiles(scores: np.ndarray) -> np.ndarray:
    """Rank-average percentile scores in [0, 100]."""
    from scipy.stats import rankdata

    return rankdata(scores, "average") / len(scores) * 100


def screen_coords(scores, coords, top_left, bot_right):
    """Keep the (score, coord) pairs inside the box."""
    top_left = np.asarray(top_left)
    bot_right = np.asarray(bot_right)
    mask = np.logical_and(
        np.all(coords >= top_left, axis=1), np.all(coords <= bot_right, axis=1)
    )
    return scores[mask], coords[mask]


def is_white_patch(patch: np.ndarray, sat_thresh: int = 5) -> bool:
    """A patch whose HSV saturation is low everywhere."""
    return bool((rgb_to_saturation_u8(patch) < sat_thresh).all())


def is_black_patch(patch: np.ndarray, rgb_thresh: int = 40) -> bool:
    """A uniformly dark patch."""
    return bool((patch < rgb_thresh).all())


def get_seg_mask(
    seg: TissueSegmentation,
    region_size: Tuple[int, int],  # (w, h) at the vis level
    scale: float,
    use_holes: bool = False,
    offset: Tuple[int, int] = (0, 0),  # level-0 top-left of the region
) -> np.ndarray:
    """Rasterize the tissue contours into a bool mask at the vis level:
    contours filled in order of descending area, each one's holes carved out
    after it when ``use_holes``."""
    mask = np.zeros((region_size[1], region_size[0]), np.uint8)
    conts = [np.array(c * scale, np.int32) for c in seg.contours]
    holes = [[np.array(h * scale, np.int32) for h in hs] for hs in seg.holes]
    off = tuple((np.asarray(offset, np.float64) * scale * -1).astype(np.int32))
    order = sorted(range(len(conts)), key=lambda i: cnt.contour_area(conts[i]), reverse=True)
    for i in order:
        cnt.draw_contours(mask, [conts[i]], 1, thickness=-1, offset=off)
        if use_holes and holes[i]:
            cnt.draw_contours(mask, holes[i], 0, thickness=-1, offset=off)
    return mask.astype(bool)


def _table_colormap(table: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
    """A float → uint8 RGB map that indexes ``table`` as matplotlib's
    ``Colormap.__call__`` indexes its look-up table: int(x · N), x = 1 at
    N − 1, below 0 the first colour, from 1 up the last, NaN black."""
    n = len(table)
    lut = np.concatenate([table, table[:1], table[-1:], np.zeros((1, 3), np.uint8)])

    def colormap(x: np.ndarray) -> np.ndarray:
        xa = np.array(x, np.float64) * n
        xa[xa == n] = n - 1
        under, over, bad = xa < 0, xa >= n, np.isnan(xa)
        with np.errstate(invalid="ignore"):
            idx = xa.astype(np.int64)
        idx[under], idx[over], idx[bad] = n, n + 1, n + 2
        return lut[idx]

    return colormap


def _cmap(name: str) -> Callable[[np.ndarray], np.ndarray]:
    """The colour map ``name`` as a float → uint8 RGB function, equal to
    ``(matplotlib.pyplot.get_cmap(name)(x) * 255)[..., :3].astype(np.uint8)``."""
    if name == "coolwarm":
        return _table_colormap(COOLWARM_U8)
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"matplotlib is needed for the colour map {name!r} (only "
                          f"'coolwarm' is built in)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap(name)
    return lambda x: (cmap(x) * 255)[..., :3].astype(np.uint8)


def block_blend(
    slide: SlideReader,
    img: np.ndarray,
    vis_level: int,
    top_left: Tuple[int, int],
    bot_right: Tuple[int, int],
    alpha: float = 0.5,
    blank_canvas: bool = False,
    block_size: int = 1024,
) -> np.ndarray:
    """Alpha-blend the rendered heatmap with the slide (or a white canvas)
    in bounded blocks, so that a giant region never holds a second full
    copy."""
    downsample = int(slide.level_downsamples[vis_level])
    h, w = img.shape[:2]
    bx, by = min(block_size, w), min(block_size, h)
    for x_start in range(top_left[0], bot_right[0], bx * downsample):
        for y_start in range(top_left[1], bot_right[1], by * downsample):
            x_img = int((x_start - top_left[0]) / downsample)
            y_img = int((y_start - top_left[1]) / downsample)
            x_end, y_end = min(w, x_img + bx), min(h, y_img + by)
            if x_end == x_img or y_end == y_img:
                continue
            block = img[y_img:y_end, x_img:x_end]
            size = (x_end - x_img, y_end - y_img)
            if blank_canvas:
                canvas = np.full((size[1], size[0], 3), 255, np.uint8)
            else:
                canvas = np.ascontiguousarray(
                    slide.read_region((x_start, y_start), vis_level, size)
                )
            img[y_img:y_end, x_img:x_end] = add_weighted_u8(block, alpha, canvas, 1 - alpha, 0)
    return img


def vis_heatmap(
    slide: SlideReader,
    scores: np.ndarray,
    coords: np.ndarray,
    seg: Optional[TissueSegmentation] = None,
    vis_level: int = -1,
    top_left=None,
    bot_right=None,
    patch_size: Tuple[int, int] = (256, 256),
    blank_canvas: bool = False,
    alpha: float = 0.4,
    blur: bool = False,
    overlap: float = 0.0,
    segment: bool = True,
    use_holes: bool = True,
    convert_to_percentiles: bool = False,
    binarize: bool = False,
    thresh: float = 0.5,
    max_size: Optional[int] = None,
    custom_downsample: int = 1,
    cmap: str = "coolwarm",
) -> np.ndarray:
    """Render per-patch attention/probability scores as a slide heatmap:

    1. accumulate scores over overlapping patch footprints (mean per pixel),
    2. optional percentile normalization / binarization / gaussian blur,
    3. colormap the accumulated map, paint it over the slide (clipped to the
       tissue mask when ``segment``), and
    4. alpha-blend with the underlying slide blockwise.

    ``scores`` are raw in [0, 1] (or any range with
    convert_to_percentiles=True); ``coords`` are level-0 (x, y). Returns an
    RGB uint8 array at ``vis_level`` (optionally downscaled), equal to the
    JAX package's (the blur is ``ops.imgproc.gaussian_blur``, OpenCV's
    bit-exact uint8 Gaussian at every kernel size; tests/test_torch_heatmap.py).
    """
    scores = np.asarray(scores, np.float64).reshape(-1).copy()
    coords = np.asarray(coords, np.int64).reshape(-1, 2)
    if vis_level < 0:
        vis_level = slide.get_best_level_for_downsample(32)
    scale = 1.0 / slide.level_downsamples[vis_level]

    threshold = (1.0 / len(scores) if thresh < 0 else thresh) if binarize else 0.0

    if top_left is not None and bot_right is not None:
        scores, coords = screen_coords(scores, coords, top_left, bot_right)
        coords = coords - np.asarray(top_left)
        top_left = tuple(top_left)
        bot_right = tuple(bot_right)
        w, h = tuple(
            (np.array(bot_right) * scale).astype(int)
            - (np.array(top_left) * scale).astype(int)
        )
        region_size = (w, h)
    else:
        region_size = slide.level_dimensions[vis_level]
        top_left = (0, 0)
        bot_right = slide.dimensions
        w, h = region_size

    ps = np.ceil(np.array(patch_size) * scale).astype(int)
    coords = np.ceil(coords * scale).astype(int)

    if convert_to_percentiles:
        scores = to_percentiles(scores)
    # unconditional /100 after the optional percentile pass: raw scores
    # are expected in [0, 100];
    # probability-style [0, 1] callers pass scores*100
    scores = scores / 100

    overlay = np.zeros((h, w), np.float64)
    counter = np.zeros((h, w), np.uint16)
    for idx in range(len(coords)):
        score = scores[idx]
        x, y = coords[idx]
        if score >= threshold:
            if binarize:
                score = 1.0
        else:
            score = 0.0
        overlay[y : y + ps[1], x : x + ps[0]] += score
        counter[y : y + ps[1], x : x + ps[0]] += 1

    nz = counter > 0
    overlay[nz] = overlay[nz] / counter[nz]
    if binarize:
        overlay[nz] = np.around(overlay[nz])
    del counter

    if blur:
        k = tuple((ps * (1 - overlap)).astype(int) * 2 + 1)
        overlay = gaussian_blur(overlay, k)

    tissue_mask = None
    if segment and seg is not None:
        tissue_mask = get_seg_mask(
            seg, region_size, scale, use_holes=use_holes, offset=tuple(top_left)
        )

    if blank_canvas:
        img = np.full((h, w, 3), 255, np.uint8)
    else:
        img = np.ascontiguousarray(slide.read_region(top_left, vis_level, region_size))

    colormap = _cmap(cmap)
    for idx in range(len(coords)):
        if scores[idx] < threshold:
            continue
        x, y = coords[idx]
        raw_block = overlay[y : y + ps[1], x : x + ps[0]]
        color_block = colormap(raw_block)
        if tissue_mask is not None:
            img_block = img[y : y + ps[1], x : x + ps[0]].copy()
            mask_block = tissue_mask[y : y + ps[1], x : x + ps[0]]
            img_block[mask_block] = color_block[mask_block]
        else:
            img_block = color_block
        img[y : y + ps[1], x : x + ps[0]] = img_block

    del overlay
    if blur:
        k = tuple((ps * (1 - overlap)).astype(int) * 2 + 1)
        img = gaussian_blur(img, k)

    if alpha < 1.0:
        img = block_blend(
            slide, img, vis_level, top_left, bot_right,
            alpha=alpha, blank_canvas=blank_canvas,
        )

    if custom_downsample > 1:
        img = resize_u8(img, (int(h / custom_downsample), int(w / custom_downsample)))
    hh, ww = img.shape[:2]
    if max_size is not None and (ww > max_size or hh > max_size):
        f = max_size / ww if ww > hh else max_size / hh
        img = resize_u8(img, (int(hh * f), int(ww * f)))
    return img


def iter_patches(
    slide: SlideReader,
    seg: TissueSegmentation,
    patch_level: int = 0,
    patch_size: int = 256,
    step_size: int = 256,
    custom_downsample: int = 1,
    white_black: bool = True,
    white_thresh: int = 15,
    black_thresh: int = 50,
    use_padding: bool = True,
) -> Iterator[dict]:
    """Legacy contour-bounded patch generator: stride-grid each
    tissue contour's bounding rect, keep four-pt in-contour / out-of-hole
    positions, read the patch, drop white/black patches, and yield
    ``{'x', 'y', 'cont_idx', 'patch_level', 'patch', 'downsample'}`` with
    x/y in patch-level (downsampled) coordinates."""
    if custom_downsample > 1:
        if custom_downsample != 2:
            raise ValueError(f"iter_patches: custom_downsample is 1 or 2, got {custom_downsample}")
        target = patch_size
        patch_size, step_size = patch_size * 2, step_size * 2
    downsample = int(slide.level_downsamples[patch_level])
    ref_ps = patch_size * downsample
    step = step_size * downsample
    img_w, img_h = slide.dimensions
    for cont_idx, (cont, holes) in enumerate(zip(seg.contours, seg.holes)):
        x0, y0, cw, ch = cnt.bounding_rect(cont)
        stop_y = y0 + ch if use_padding else min(y0 + ch, img_h - ref_ps)
        stop_x = x0 + cw if use_padding else min(x0 + cw, img_w - ref_ps)
        for y in range(y0, stop_y, step):
            for x in range(x0, stop_x, step):
                if not _four_pt_check(cont, (x, y), ref_ps) or _in_holes(
                    holes, (x, y), ref_ps
                ):
                    continue
                patch = slide.read_region((x, y), patch_level, (patch_size, patch_size))
                if custom_downsample > 1:
                    patch = resize_u8(patch, (target, target))
                if white_black and (
                    is_black_patch(patch, rgb_thresh=black_thresh)
                    or is_white_patch(patch, sat_thresh=white_thresh)
                ):
                    continue
                yield dict(
                    x=x // (downsample * custom_downsample),
                    y=y // (downsample * custom_downsample),
                    cont_idx=cont_idx,
                    patch_level=patch_level,
                    downsample=slide.level_downsamples[patch_level],
                    patch=patch,
                )
