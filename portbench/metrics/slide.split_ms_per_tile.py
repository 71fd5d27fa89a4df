"""Milliseconds a tile of the port's ``engine.split`` span: the engine's
per-image split of a batch's results (``InferenceEngine._split_results``: with
compact masks, one dense mask a detection from the label map); its host time
over the traced slide's tiles (``harness/spans.py``)."""

from portbench.harness.spans import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, "engine.split")
