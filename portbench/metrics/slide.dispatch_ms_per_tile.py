"""Milliseconds a tile of infer_slide's dispatch_s: upload, device preprocess and the forward up to its host-synchronised proposal stages, over the traced run's slides (the
program's own timer)."""


def read(ctx):
    win = ctx["window"]
    if not win.get("tiles"):
        return None
    return 1e3 * win["dispatch_s"] / win["tiles"]
