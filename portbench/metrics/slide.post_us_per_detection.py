"""Microseconds of the port's ``wsi.post`` span a detection entering
``postprocess_tile`` (counter ``wsi.detections``), over the traced slide:
post's cost at a given amount of work (``harness/spans.py``)."""

from portbench.harness.spans import totals


def read(ctx):
    got = totals()
    if got is None or not got[1].get("wsi.detections"):
        return None
    seconds, counters = got
    return 1e6 * seconds.get("wsi.post", 0.0) / counters["wsi.detections"]
