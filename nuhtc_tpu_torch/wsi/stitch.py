"""Port of nuhtc_tpu/wsi/stitch.py: downscaled patch mosaic preview (reference tools/wsi_core/wsi_utils.py:259
StitchCoords) + tissue-mask visualization (visWSI)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nuhtc_tpu_torch.ops.contours import draw_contours
from nuhtc_tpu_torch.ops.imgproc import resize_u8
from nuhtc_tpu_torch.wsi.slide import SlideReader


def stitch_coords(
    slide: SlideReader,
    coords: np.ndarray,
    patch_size: int = 256,
    downscale: int = 64,
    bg_color: Tuple[int, int, int] = (0, 0, 0),
) -> np.ndarray:
    """Render all patches into one downscaled mosaic (RGB uint8)."""
    w0, h0 = slide.dimensions
    w, h = max(w0 // downscale, 1), max(h0 // downscale, 1)
    canvas = np.full((h, w, 3), bg_color, np.uint8)
    level = slide.get_best_level_for_downsample(downscale)
    lds = slide.level_downsamples[level]
    tile = max(int(patch_size / lds), 1)
    out_tile = max(int(patch_size / downscale), 1)
    for x, y in coords:
        patch = slide.read_region((int(x), int(y)), level, (tile, tile))
        patch = resize_u8(patch, (out_tile, out_tile))
        cx, cy = int(x // downscale), int(y // downscale)
        ph = min(out_tile, h - cy)
        pw = min(out_tile, w - cx)
        if ph > 0 and pw > 0:
            canvas[cy : cy + ph, cx : cx + pw] = patch[:ph, :pw]
    return canvas


def vis_tissue_mask(slide: SlideReader, seg, vis_level: int = -1, line_thickness: int = 32) -> np.ndarray:
    """Slide preview with tissue contours drawn (reference visWSI). Lines of
    thickness 1 are OpenCV's pixel for pixel; thicker ones are close to them
    and not held bit for bit (see ``ops.contours.draw_contours``)."""
    if vis_level < 0:
        vis_level = slide.get_best_level_for_downsample(64)
    ds = slide.level_downsamples[vis_level]
    w, h = slide.level_dimensions[vis_level]
    img = slide.read_region((0, 0), vis_level, (w, h)).copy()
    scale = 1.0 / ds
    cont = [np.round(c * scale).astype(np.int32) for c in seg.contours]
    draw_contours(img, cont, (0, 255, 0), max(int(line_thickness * scale), 1))
    for holes in seg.holes:
        hh = [np.round(c * scale).astype(np.int32) for c in holes]
        draw_contours(img, hh, (0, 0, 255), max(int(line_thickness * scale), 1))
    return img
