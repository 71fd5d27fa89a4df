"""Reinhard stain normalization for H&E tiles (port of nuhtc_tpu/wsi/stain.py).

Each tile's LAB statistics are mapped onto a fixed H&E target (Reinhard et
al. 2001). Host code on ``ops.imgproc``'s LAB conversions: the RGB → LAB
half equals OpenCV's, the LAB → RGB half is within a few levels of it (see
``lab_to_rgb_u8``).
"""

from __future__ import annotations

import numpy as np

from nuhtc_tpu_torch.ops.imgproc import lab_to_rgb_u8, rgb_to_lab_u8

# LAB (OpenCV 8-bit scaling) mean/std of a canonical well-stained H&E tile.
TARGET_MEANS = np.array([148.60, 169.30, 105.97], np.float32)
TARGET_STDS = np.array([41.56, 9.01, 6.67], np.float32)


def reinhard_normalize(rgb: np.ndarray,
                       target_means: np.ndarray = TARGET_MEANS,
                       target_stds: np.ndarray = TARGET_STDS) -> np.ndarray:
    """Normalize an (H, W, 3) uint8 RGB tile's LAB statistics to the target.
    Against the JAX package's (OpenCV's LAB), within 3 levels per channel on
    the tests' tiles (tests/test_torch_features.py): the LAB statistics are
    equal, and the way back differs as ``lab_to_rgb_u8`` says."""
    lab = rgb_to_lab_u8(rgb).astype(np.float32)
    mean = lab.reshape(-1, 3).mean(0)
    std = lab.reshape(-1, 3).std(0)
    std = np.where(std < 1e-6, 1.0, std)
    lab = (lab - mean) / std * target_stds + target_means
    lab = np.clip(lab, 0, 255).astype(np.uint8)
    return lab_to_rgb_u8(lab)
