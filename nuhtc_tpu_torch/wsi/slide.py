"""Slide reading abstraction (port of nuhtc_tpu/wsi/slide.py).

A small reader interface with three backends: ``OpenSlideReader`` when the
library is importable, ``ImageReader`` for plain raster images as one-level
slides, and ``ArraySlide`` for an RGB array in memory with optional averaged
lower levels (what the tests and the smoke run read).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import openslide  # type: ignore

    HAS_OPENSLIDE = True
except ImportError:
    openslide = None
    HAS_OPENSLIDE = False


class SlideReader:
    """Interface: level_dimensions, level_downsamples, read_region, properties."""

    path: str
    level_dimensions: List[Tuple[int, int]]  # (w, h) per level
    level_downsamples: List[float]
    properties: dict

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    def read_region(self, location: Tuple[int, int], level: int, size: Tuple[int, int]) -> np.ndarray:
        """(x, y) level-0 coords → RGB uint8 (size[1], size[0], 3)."""
        raise NotImplementedError

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 0.01:
                best = i
        return best

    @property
    def magnification(self) -> Optional[float]:
        for key in ("openslide.objective-power", "aperio.AppMag"):
            if key in self.properties:
                try:
                    return float(self.properties[key])
                except ValueError:
                    pass
        return None


class OpenSlideReader(SlideReader):
    def __init__(self, path: str):
        self.path = path
        self._osr = openslide.open_slide(path)
        self.level_dimensions = list(self._osr.level_dimensions)
        self.level_downsamples = list(self._osr.level_downsamples)
        self.properties = dict(self._osr.properties)

    def read_region(self, location, level, size):
        img = self._osr.read_region(location, level, size).convert("RGB")
        return np.asarray(img)


def _crop_zero_padded(img: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    """img[y:y+h, x:x+w] with zeros where the window leaves the image."""
    out = np.zeros((h, w, 3), np.uint8)
    ih, iw = img.shape[:2]
    x2, y2 = min(x + w, iw), min(y + h, ih)
    x1, y1 = max(x, 0), max(y, 0)
    if x2 > x1 and y2 > y1:
        out[y1 - y: y2 - y, x1 - x: x2 - x] = img[y1:y2, x1:x2]
    return out


class ArraySlide(SlideReader):
    """An RGB uint8 (H, W, 3) array as a slide. ``level_downsamples`` are
    powers of two starting at 1; each lower level is the rounded mean of
    2 × 2 blocks of the one above (odd edges cropped)."""

    def __init__(self, array: np.ndarray, level_downsamples: Sequence[float] = (1,),
                 path: str = "", properties: Optional[dict] = None):
        if array.dtype != np.uint8 or array.ndim != 3 or array.shape[2] != 3:
            raise ValueError(f"ArraySlide takes a uint8 (H, W, 3) array, got "
                             f"{array.dtype} {array.shape}")
        if level_downsamples[0] != 1:
            raise ValueError(f"ArraySlide levels double from 1, got {level_downsamples}")
        self.path = path
        self.properties = dict(properties or {})
        self._levels = [array]
        self.level_downsamples = [1.0]
        for ds in level_downsamples[1:]:
            if ds != 2 * self.level_downsamples[-1]:
                raise ValueError(f"ArraySlide levels double from 1, got {level_downsamples}")
            a = self._levels[-1]
            a = a[: a.shape[0] // 2 * 2, : a.shape[1] // 2 * 2].astype(np.uint16)
            self._levels.append(((a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
                                  + 2) >> 2).astype(np.uint8))
            self.level_downsamples.append(float(ds))
        self.level_dimensions = [(a.shape[1], a.shape[0]) for a in self._levels]

    def read_region(self, location, level, size):
        ds = int(self.level_downsamples[level])
        return _crop_zero_padded(self._levels[level], int(location[0]) // ds,
                                 int(location[1]) // ds, size[0], size[1])


class ImageReader(ArraySlide):
    """Plain image file as a one-level slide (dev/test backend)."""

    def __init__(self, path: str):
        from nuhtc_tpu_torch.utils.imageio import read_image

        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        super().__init__(read_image(path), path=path)


def open_slide(path: str) -> SlideReader:
    ext = os.path.splitext(path)[1].lower()
    if HAS_OPENSLIDE and ext in (".svs", ".ndpi", ".mrxs", ".scn", ".svslide", ".tiff", ".tif", ".bif", ".vms", ".vmu"):
        return OpenSlideReader(path)
    if HAS_OPENSLIDE:
        try:
            return OpenSlideReader(path)
        except Exception:
            pass
    return ImageReader(path)
