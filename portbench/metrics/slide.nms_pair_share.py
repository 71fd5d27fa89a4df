"""Share of the pairs of a tile's filtered detections whose pixel boxes
meet, so whose shared pixels the port's mask NMS counted (counter
``wsi.nms_pairs``), over all pairs (``wsi.nms_pairs_all``, n(n - 1)/2 a
tile), in %, over the traced slide (``harness/spans.py``). Every other pair
has an IoU of 0 and no pixel of it is read. None from a program without the
counters, or where no tile had two detections."""

from portbench.harness.spans import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    met = got[1].get("wsi.nms_pairs")
    pairs = got[1].get("wsi.nms_pairs_all", 0)
    if met is None or pairs == 0:
        return None
    return 100.0 * met / pairs
