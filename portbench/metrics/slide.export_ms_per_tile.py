"""Milliseconds a tile of the port's ``wsi.export`` span: the exporter's
``add_tile`` and ``close``; its host time over the traced slide's tiles
(``harness/spans.py``)."""

from portbench.harness.spans import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, "wsi.export")
