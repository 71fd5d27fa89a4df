"""Milliseconds a tile of infer_slide's post_s: postprocess_tile (RLE encode, mask NMS, contours) and the export, over the traced run's slides (the
program's own timer)."""


def read(ctx):
    win = ctx["window"]
    if not win.get("tiles"):
        return None
    return 1e3 * win["post_s"] / win["tiles"]
