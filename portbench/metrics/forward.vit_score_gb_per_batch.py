"""GB of attention scores the ViT backbone writes a batch: counters
``vit.global_score_bytes`` and ``vit.window_score_bytes`` (every
(b, heads, n, n) tensor of ``models/backbones.py ViTAttention``, at the
dtype it is written in) over the traced batches (``harness/spans.py``).
None where the program counts neither (no ViT, or a program without the
counters)."""

from portbench.harness.spans import totals

COUNTERS = ("vit.global_score_bytes", "vit.window_score_bytes")


def read(ctx):
    got = totals()
    tr = ctx["trace"]
    if got is None or not tr or not tr.get("batches"):
        return None
    counters = got[1]
    if not any(name in counters for name in COUNTERS):
        return None
    return sum(counters.get(name, 0) for name in COUNTERS) / 1e9 / tr["batches"]
