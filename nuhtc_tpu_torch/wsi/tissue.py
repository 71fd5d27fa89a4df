"""Tissue segmentation + patch-grid extraction on the host (port of
nuhtc_tpu/wsi/tissue.py; OpenCV's operations come from ``ops.imgproc`` and
``ops.contours``, which reproduce them exactly).

Behavioral re-implementation of the reference's CLAM-derived WSI stage A
(tools/wsi_core/WholeSlideImage.py:105-199 segmentTissue, :411-495
process_contours; tools/wsi_core/util_classes.py:53-92 contour checks):
HSV median-blur → Otsu/fixed threshold → morphological close → contour
filtering by area with holes → stride grid of patch coords filtered by the
four-point contour-membership check.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from nuhtc_tpu_torch.ops import contours as cnt
from nuhtc_tpu_torch.ops import imgproc
from nuhtc_tpu_torch.wsi.slide import SlideReader


@dataclass
class TissueSegmentation:
    contours: List[np.ndarray]  # tissue contours at level-0 coords
    holes: List[List[np.ndarray]]  # holes per contour, level-0 coords
    seg_level: int
    downsample: float


def segment_tissue(
    slide: SlideReader,
    seg_level: int = -1,
    sthresh: int = 8,
    mthresh: int = 7,
    close: int = 4,
    use_otsu: bool = False,
    a_t: float = 100,
    a_h: float = 16,
    max_n_holes: int = 8,
    ref_patch_size: int = 512,
) -> TissueSegmentation:
    """Reference segmentTissue: thresholds the HSV saturation channel."""
    if seg_level < 0:
        seg_level = slide.get_best_level_for_downsample(64)
    ds = slide.level_downsamples[seg_level]
    w, h = slide.level_dimensions[seg_level]
    img = slide.read_region((0, 0), seg_level, (w, h))

    med = imgproc.median_blur_u8(imgproc.rgb_to_saturation_u8(img), int(mthresh))
    if use_otsu:
        binarized = imgproc.threshold_otsu(med)
    else:
        binarized = imgproc.threshold_binary(med, sthresh)
    if close > 0:
        binarized = imgproc.morph_close(binarized, int(close))

    scale = ds
    # reference WholeSlideImage.py:178-181: thresholds scale by
    # round(ref_patch_size / downsample), NOT by the area ratio
    scaled_ref_area = round(ref_patch_size / scale)
    a_t = a_t * scaled_ref_area
    a_h = a_h * scaled_ref_area

    contours, hierarchy = cnt.find_contours(binarized, cnt.RETR_CCOMP, cnt.CHAIN_APPROX_NONE)
    if hierarchy is None:
        return TissueSegmentation([], [], seg_level, ds)
    hierarchy = hierarchy[0]

    fg_idx = [i for i in range(len(contours)) if hierarchy[i][3] == -1]
    keep_contours, keep_holes = [], []
    for i in fg_idx:
        cont = contours[i]
        hole_idx = [j for j in range(len(contours)) if hierarchy[j][3] == i]
        area = cnt.contour_area(cont) - sum(cnt.contour_area(contours[j]) for j in hole_idx)
        if area <= 0 or area <= a_t:
            continue
        holes = sorted((contours[j] for j in hole_idx), key=cnt.contour_area, reverse=True)
        holes = [hh for hh in holes[:max_n_holes] if cnt.contour_area(hh) > a_h]
        keep_contours.append((cont * scale).astype(np.int32))
        keep_holes.append([(hh * scale).astype(np.int32) for hh in holes])
    return TissueSegmentation(keep_contours, keep_holes, seg_level, ds)


def _four_pt_check(cont: np.ndarray, pt: Tuple[int, int], patch_size: int,
                   center_shift: float = 0.5) -> bool:
    """Reference isInContourV3_Easy (tools/wsi_core/util_classes.py:71-89):
    4 corner points at shift = patch_size//2 * center_shift from the patch
    center; any inside passes. shift == 0 degenerates to the center point."""
    cx = pt[0] + patch_size // 2
    cy = pt[1] + patch_size // 2
    shift = int(patch_size // 2 * center_shift)
    if shift > 0:
        points = [
            (cx - shift, cy - shift),
            (cx + shift, cy + shift),
            (cx + shift, cy - shift),
            (cx - shift, cy + shift),
        ]
    else:
        points = [(cx, cy)]
    for p in points:
        if cnt.point_polygon_test(cont, p) >= 0:
            return True
    return False


def _in_holes(holes: List[np.ndarray], pt, patch_size) -> bool:
    cx = pt[0] + patch_size // 2
    cy = pt[1] + patch_size // 2
    for hole in holes:
        if cnt.point_polygon_test(hole, (cx, cy)) > 0:
            return True
    return False


def grid_coords(
    slide: SlideReader,
    seg: TissueSegmentation,
    patch_size: int = 256,
    step_size: int = 192,
    patch_level: int = 0,
    use_padding: bool = True,
) -> np.ndarray:
    """Stride grid of tissue patch coordinates (level-0 (x, y)); reference
    process_contour."""
    w0, h0 = slide.dimensions
    ps = int(patch_size * slide.level_downsamples[patch_level])
    step = int(step_size * slide.level_downsamples[patch_level])
    coords = []
    for cont, holes in zip(seg.contours, seg.holes):
        x, y, cw, ch = cnt.bounding_rect(cont)
        stop_x = x + cw if use_padding else min(x + cw, w0 - ps + 1)
        stop_y = y + ch if use_padding else min(y + ch, h0 - ps + 1)
        if use_padding:
            stop_x = min(stop_x, w0 - 1)
            stop_y = min(stop_y, h0 - 1)
        for yy in range(y, stop_y, step):
            for xx in range(x, stop_x, step):
                if _four_pt_check(cont, (xx, yy), ps) and not _in_holes(holes, (xx, yy), ps):
                    coords.append((xx, yy))
    if not coords:
        return np.zeros((0, 2), np.int64)
    return np.unique(np.asarray(coords, np.int64), axis=0)


def require_h5py():
    """h5py, imported here; ImportError by name where it is missing."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is needed to read or write .h5 files (patch coordinates, "
                          "features)") from e
    return h5py


def save_coords_h5(path: str, coords: np.ndarray, attrs: dict | None = None):
    h5py = require_h5py()

    with h5py.File(path, "w") as f:
        d = f.create_dataset("coords", data=coords)
        for k, v in (attrs or {}).items():
            d.attrs[k] = v


def load_coords_h5(path: str) -> Tuple[np.ndarray, dict]:
    h5py = require_h5py()

    with h5py.File(path, "r") as f:
        coords = f["coords"][:]
        attrs = dict(f["coords"].attrs)
    return coords, attrs
