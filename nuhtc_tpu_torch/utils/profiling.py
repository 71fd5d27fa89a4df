"""Spans and counters at the port's layer boundaries, and Chrome traces of
them (port of nuhtc_tpu/utils/profiling.py's ``trace``).

Spans are on inside ``spans()`` and ``trace()``, and while a
``torch.profiler`` profile records. A span then enters
``torch.profiler.record_function``: a profiler's trace holds it as a
``user_annotation`` event on the clock of the CUDA kernel and copy records,
so ``span_table`` can put each device idle gap down to the stage the host
was in. While spans are on, ``SECONDS`` sums each span's host time by name
and ``COUNTERS`` the counts of ``count``. Off, a span without ``into`` costs
a flag check and returns one shared no-op context, and ``count`` does
nothing.

    with trace("slide", log_dir="traces"):   # Chrome trace (chrome://tracing, Perfetto)
        infer_slide(...)
    with open("traces/slide.pt.trace.json") as f:
        table = span_table(json.load(f)["traceEvents"], "slide")
"""

from __future__ import annotations

import bisect
import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

# counter name → count, and span name → host seconds, while spans are on;
# entering ``spans()`` from off starts both afresh
COUNTERS: Dict[str, int] = {}
SECONDS: Dict[str, float] = {}
_on = False
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans are on: inside ``spans()``, or while a profiler records."""
    return _on or getattr(_torch_profiler, "_is_profiler_enabled", False)


class _Span:
    __slots__ = ("name", "into", "key", "rf", "t0")

    def __init__(self, name: Optional[str], into: Optional[dict], key):
        self.name, self.into, self.key = name, into, key
        self.rf = torch.profiler.record_function(name) if name else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.into is not None:
            self.into[self.key] += dt
        if self.rf is not None:
            SECONDS[self.name] = SECONDS.get(self.name, 0.0) + dt
            self.rf.__exit__(*exc)
        return False


def span(name: Optional[str] = None, into: Optional[dict] = None, key=None):
    """A context manager over one stage. With spans on, a
    ``record_function(name)`` span (none when ``name`` is None) whose host
    time adds to ``SECONDS[name]``. With ``into``, on or off, the body's
    ``time.perf_counter`` duration adds to ``into[key]``."""
    on = enabled()
    if into is None and not on:
        return _OFF
    return _Span(name if on else None, into, key)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to ``COUNTERS[name]`` while spans are on."""
    if enabled():
        COUNTERS[name] = COUNTERS.get(name, 0) + n


@contextlib.contextmanager
def spans():
    """Spans on for the body (``COUNTERS`` and ``SECONDS`` emptied first
    when they were off); the previous state after it."""
    global _on
    was = _on
    if not was:
        COUNTERS.clear()
        SECONDS.clear()
    _on = True
    try:
        yield
    finally:
        _on = was


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None):
    """Profiles the body under ``torch.profiler`` inside a
    ``record_function(name)`` span, with spans on: the CPU activity, and the
    CUDA activity when a CUDA device is available (the body's work is
    synchronised before the profiler stops). Yields the profiler
    (``key_averages()`` once the body is done). With ``log_dir`` the trace
    is written there as ``<name>.pt.trace.json``."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with spans(), torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield prof
        if cuda:
            torch.cuda.synchronize()
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))


# --------------------------------------------------------------------------- #
# reading a Chrome trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _segments(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, int]]:
    """The nested ``spans`` (sorted by start, then longest first) as
    ascending, disjoint (start, end, index) pieces of time, each piece's
    index that of the innermost span then open; time in no span is left
    out."""
    segs: List[Tuple[float, float, int]] = []
    stack: List[int] = []
    t = float("-inf")

    def close(until: float) -> None:
        nonlocal t
        while stack and spans[stack[-1]][1] <= until:
            i = stack.pop()
            if spans[i][1] > t:
                segs.append((t, spans[i][1], i))
                t = spans[i][1]

    for i, (a, b, _) in enumerate(spans):
        close(a)
        if stack and a > t:
            segs.append((t, a, stack[-1]))
        t = max(t, a)
        stack.append(i)
    close(float("inf"))
    return segs


def span_table(events: Sequence[dict], window: str) -> Dict[str, object]:
    """The spans of a Chrome trace's ``traceEvents`` inside the first
    ``user_annotation`` named ``window``, on its thread (times in seconds):

    - ``spans``: name → ``count``, ``host_s`` (summed durations), ``self_s``
      (durations less the part their child spans cover), ``device_s``
      (kernels, copies and sets whose launch, found by ``correlation``, lies
      in the span, given to the innermost such span, however late they ran)
      and ``idle_s`` (device idle, in gaps of any size, while the span was
      the innermost one open);
    - ``window_s``, ``idle_s``, and ``uncovered_idle_s``: idle while no span
      was open;
    - ``device_s`` and ``unspanned_device_s``: device work, and the part
      launched in no span (or whose launch the trace lacks);
    - ``early_starts``: device records that start before the launch that
      queued them (0 when the host's and the device's clocks agree)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    wins = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == window]
    if not wins:
        raise ValueError(f"span_table: no span {window!r} in the trace")
    win = wins[0]
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                    if e.get("cat") == "user_annotation" and e is not win
                    and e.get("tid") == win.get("tid") and w0 <= float(e["ts"]) <= w1),
                   key=lambda s: (s[0], -s[1]))
    rows: Dict[str, Dict[str, float]] = {}
    for _, _, name in spans:
        rows.setdefault(name, dict(count=0, host_s=0.0, self_s=0.0, device_s=0.0, idle_s=0.0))
    for a, b, name in spans:
        rows[name]["count"] += 1
        rows[name]["host_s"] += (b - a) * 1e-6
    segs = _segments(spans)
    for a, b, i in segs:
        rows[spans[i][2]]["self_s"] += (b - a) * 1e-6

    # device work by the span its launch lies in
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = []
    early = 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is not None and float(e["ts"]) < t:
            early += 1
        dev.append((t, a, b))
    starts = [a for a, _, _ in segs]
    unspanned = 0.0
    for t, a, b in dev:
        k = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= segs[k][1]:
            rows[spans[segs[k][2]][2]]["device_s"] += (b - a) * 1e-6
        else:
            unspanned += b - a

    # idle time by the innermost span open then
    busy = _merge([(a, b) for _, a, b in dev])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = sum(b - a for a, b in gaps)
    covered, j = 0.0, 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            d = min(b, segs[k][1]) - max(a, segs[k][0])
            rows[spans[segs[k][2]][2]]["idle_s"] += d * 1e-6
            covered += d
            k += 1
    return {"window_s": (w1 - w0) * 1e-6, "idle_s": idle * 1e-6,
            "uncovered_idle_s": (idle - covered) * 1e-6,
            "device_s": sum(b - a for _, a, b in dev) * 1e-6,
            "unspanned_device_s": unspanned * 1e-6, "early_starts": early, "spans": rows}
