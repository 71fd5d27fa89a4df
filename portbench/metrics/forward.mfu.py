"""The whole model step's share of the card's bf16 peak: the frozen FLOP
count of one image (``work/<config>.json``) times the traced segment's
images a second, over 989 TFLOP/s."""

from portbench.work.roofline import PEAK_BF16


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("window_s"):
        return None
    img_per_s = tr["batches"] * ctx["traffic"]["batch"] / tr["window_s"]
    return 100.0 * ctx["work"]["flops_per_image"] * img_per_s / PEAK_BF16
