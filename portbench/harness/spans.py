"""The port's own spans and counters in a traced run
(``nuhtc_tpu_torch.utils.profiling``): the program's spans are on while the
profiler records, so after a run that profiles one segment its ``SECONDS``
hold that segment's host seconds by span name and its ``COUNTERS`` the
counts. A program without them, or one whose spans recorded nothing (no
``engine.dispatch``, which every cell runs), gives None."""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def totals() -> Optional[Tuple[Dict[str, float], Dict[str, int]]]:
    """(seconds by span, counts by counter) of the traced segment, or None."""
    try:
        from nuhtc_tpu_torch.utils import profiling
    except ImportError:
        return None
    seconds = getattr(profiling, "SECONDS", None)
    counters = getattr(profiling, "COUNTERS", None)
    if seconds is None or counters is None or "engine.dispatch" not in seconds:
        return None
    return seconds, counters


def ms_per_tile(ctx, name: str) -> Optional[float]:
    """Milliseconds a tile of span ``name`` over the traced slide's tiles."""
    got = totals()
    tr = ctx["trace"]
    if got is None or not tr or not tr.get("tiles"):
        return None
    return 1e3 * got[0].get(name, 0.0) / tr["tiles"]
