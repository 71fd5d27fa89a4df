"""K1's share of its roofline: the least time of one forward's Swin blocks
on the card's peaks (``work/roofline.py k1_bound_s``: every block's FLOP and
bytes at the configuration's padded stage shapes) over the trace's
``window_attn_kernel`` + ``block_mlp_kernel`` time a forward."""

from portbench.harness.trace import kernel_seconds
from portbench.work.roofline import k1_bound_s


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    t = kernel_seconds(tr, ("window_attn_kernel", "block_mlp_kernel"))
    if t <= 0:
        return None
    return 100.0 * k1_bound_s(ctx["cfg"], ctx["traffic"]["batch"]) * tr["batches"] / t
