"""K4's share of its roofline: the least time of one forward's RoIAlign
launches by their bytes (``work/roofline.py k4_bound_s``: maps, boxes and
bias read once, the output written once, at the configuration's padded
RoI counts) over the trace's ``roi_align_sum_kernel`` time a forward."""

from portbench.harness.trace import kernel_seconds
from portbench.work.roofline import k4_bound_s


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    t = kernel_seconds(tr, ("roi_align_sum_kernel",))
    if t <= 0:
        return None
    return 100.0 * k4_bound_s(ctx["cfg"], ctx["traffic"]["batch"]) * tr["batches"] / t
