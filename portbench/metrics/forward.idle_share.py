"""Share of the traced window in which no kernel, copy or set ran on the
device (100 · (1 − busy / window), from the profiler's trace)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
