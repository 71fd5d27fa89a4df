"""Sliding-window patch extraction for CoNIC preprocessing (port of
tools/analysis_tools/conic/misc/patch_extractor.py).

Two modes on an HWC array: ``valid`` — windows at strides over the
unpadded image, the remainders covered by one more row and column of
windows flush with the bottom and right edges (and the corner window);
images smaller than the window are reflect-padded up to it first;
``mirror`` — reflect-pads by (win − step) / 2 on each side so the centres
tile the image, then extracts as ``valid``. Patches come in the reference's
order (the grid row-major, then the bottom row, the right column, the
corner).
"""

from __future__ import annotations


import math

import numpy as np


def cropping_center(x: np.ndarray, crop_shape, batch: bool = False) -> np.ndarray:
    """Center-crop the leading spatial dims (ref conic/misc/utils.py)."""
    h, w = (x.shape[0], x.shape[1]) if not batch else (x.shape[1], x.shape[2])
    ch, cw = crop_shape
    t, l = (h - ch) // 2, (w - cw) // 2
    if batch:
        return x[:, t:t + ch, l:l + cw]
    return x[t:t + ch, l:l + cw]


class PatchExtractor:
    """Extract win_size patches at step_size strides (ref PatchExtractor)."""

    def __init__(self, win_size: int, step_size: int, debug: bool = False):
        assert isinstance(win_size, int) and isinstance(step_size, int)
        self.win_size = (win_size, win_size)
        self.step_size = (step_size, step_size)
        self.debug = debug

    def _window(self, x: np.ndarray, top: int, left: int) -> np.ndarray:
        wh, ww = self.win_size
        win = x[top:top + wh, left:left + ww]
        assert win.shape[:2] == (wh, ww), f"bad patch {win.shape}"
        return win

    def _extract_valid(self, x: np.ndarray):
        im_h, im_w = x.shape[:2]
        wh, ww = self.win_size
        sh, sw = self.step_size

        def last(length, win, step):
            flag = (length - win) % step != 0
            return flag, (math.floor((length - win) / step) + 1) * step

        h_flag, h_last = last(im_h, wh, sh)
        w_flag, w_last = last(im_w, ww, sw)

        patches = [
            self._window(x, r, c)
            for r in range(0, h_last, sh)
            for c in range(0, w_last, sw)
        ]
        if h_flag:
            patches += [self._window(x, im_h - wh, c) for c in range(0, w_last, sw)]
        if w_flag:
            patches += [self._window(x, r, im_w - ww) for r in range(0, h_last, sh)]
        if h_flag and w_flag:
            patches.append(self._window(x, im_h - wh, im_w - ww))
        return patches

    def _extract_mirror(self, x: np.ndarray):
        dh = self.win_size[0] - self.step_size[0]
        dw = self.win_size[1] - self.step_size[1]
        pads = ((dh // 2, dh - dh // 2), (dw // 2, dw - dw // 2)) + ((0, 0),) * (x.ndim - 2)
        return self._extract_valid(np.pad(x, pads, mode="reflect"))

    def extract(self, x: np.ndarray, patch_type: str):
        patch_type = patch_type.lower()
        if patch_type == "valid":
            h, w = x.shape[:2]
            # undersized inputs reflect-pad up to one window (ref :150-159)
            if w < self.win_size[1]:
                p = int(math.ceil((self.win_size[1] - w) / 2))
                x = np.pad(x, ((0, 0), (p, p)) + ((0, 0),) * (x.ndim - 2), mode="reflect")
            if h < self.win_size[0]:
                p = int(math.ceil((self.win_size[0] - h) / 2))
                x = np.pad(x, ((p, p), (0, 0)) + ((0, 0),) * (x.ndim - 2), mode="reflect")
            return self._extract_valid(x)
        if patch_type == "mirror":
            return self._extract_mirror(x)
        raise ValueError(f"Unknown patch type [{patch_type}]")
