"""Rounds of the port's host-synchronised fixpoints a batch: counters
``nms.rounds`` (each round of ``ops/nms.py nms_keep_sorted``, the RPN's and
the class NMS) and ``components.rounds`` (``ops/components.py
label_components_raw``) over the traced batches; each round ends on one
``torch.equal`` (``harness/spans.py``)."""

from portbench.harness.spans import totals


def read(ctx):
    got = totals()
    tr = ctx["trace"]
    if got is None or not tr or not tr.get("batches") or "nms.rounds" not in got[1]:
        return None
    counters = got[1]
    return (counters["nms.rounds"] + counters.get("components.rounds", 0)) / tr["batches"]
