"""GB the deformable attention's sampling core writes a batch: counter
``deform.sample_bytes`` (every tensor ``ops/ms_deform_attn.py`` writes
between the value map and its output: the level value copies and grids,
the samples, their stack, the weights' copy, the weighted product and its
sum, at their dtype) over the traced batches (``harness/spans.py``). None
where the program does not count it (no ViT-Adapter, or a program without
the counter)."""

from portbench.harness.spans import totals

COUNTER = "deform.sample_bytes"


def read(ctx):
    got = totals()
    tr = ctx["trace"]
    if got is None or not tr or not tr.get("batches") or COUNTER not in got[1]:
        return None
    return got[1][COUNTER] / 1e9 / tr["batches"]
