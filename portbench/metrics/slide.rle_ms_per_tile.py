"""Milliseconds a tile of the port's ``wsi.rle`` span: the RLE encoding of each
kept detection's mask in ``postprocess_tile``; its host time over the traced
slide's tiles (``harness/spans.py``)."""

from portbench.harness.spans import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, "wsi.rle")
