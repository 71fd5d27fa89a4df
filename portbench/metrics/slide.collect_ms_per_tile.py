"""Milliseconds a tile of infer_slide's collect_s: the device wait, the download and _split_results, over the traced run's slides (the
program's own timer)."""


def read(ctx):
    win = ctx["window"]
    if not win.get("tiles"):
        return None
    return 1e3 * win["collect_s"] / win["tiles"]
