"""Detection overlays without OpenCV (port of nuhtc_tpu/utils/visualize.py,
the reference's save_result / imshow_det_bboxes equivalents).

Each mask's borders (``ops.contours.find_contours``, ``RETR_TREE`` and
``CHAIN_APPROX_SIMPLE``, as ``cv2.findContours`` gives them) are drawn in
its class's colour by ``draw_contours``; boxes by ``rectangle``. At
thickness 1 the overlay is OpenCV's pixel for pixel; at the default
thickness 2 ``draw_contours`` covers OpenCV's pixels with an IoU ≥ 0.97
(its docstring). ``apply_viridis`` is ``cv2.applyColorMap(…,
COLORMAP_VIRIDIS)`` with RGB out, from OpenCV's table carried here."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.data.classes import DEFAULT_PALETTE
from nuhtc_tpu_torch.ops.contours import draw_contours, find_contours, rectangle

# OpenCV 5.0.0's COLORMAP_VIRIDIS: applyColorMap of 0..255, as RGB rows
VIRIDIS_U8 = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725"
), np.uint8).reshape(256, 3)


def draw_detections(
    img: np.ndarray,  # RGB uint8
    masks: Sequence[np.ndarray],  # per-instance bool/uint8 (H, W)
    labels: Sequence[int],
    scores: Optional[Sequence[float]] = None,
    boxes: Optional[np.ndarray] = None,
    palette: Optional[List] = None,
    thickness: int = 2,
    draw_boxes: bool = False,
) -> np.ndarray:
    out = img.copy()
    palette = palette or DEFAULT_PALETTE
    for i, m in enumerate(masks):
        color = tuple(int(c) for c in palette[int(labels[i]) % len(palette)])
        contours, _ = find_contours(m)
        if contours:
            draw_contours(out, contours, color, thickness)
        if draw_boxes and boxes is not None:
            x1, y1, x2, y2 = boxes[i].astype(int)
            rectangle(out, (x1, y1), (x2, y2), color, 1)
    return out


def apply_viridis(gray: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → uint8 (H, W, 3) RGB: ``cv2.applyColorMap(gray,
    cv2.COLORMAP_VIRIDIS)`` with its BGR channels reversed."""
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"apply_viridis takes a uint8 (H, W) image, got {gray.dtype} {gray.shape}")
    return VIRIDIS_U8[gray]
