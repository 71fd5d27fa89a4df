"""Milliseconds a tile of the port's ``wsi.mask_nms`` span: the mask NMS
(greedy RLE IoU) and the gathers of what it keeps in ``postprocess_tile``;
its host time over the traced slide's tiles (``harness/spans.py``)."""

from portbench.harness.spans import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, "wsi.mask_nms")
