"""Profiling and timing helpers (port of nuhtc_tpu/utils/profiling.py):
``torch.profiler`` in place of ``jax.profiler``, and simple wall timers.

Usage:
    with trace("mask_stage", log_dir="traces"):   # Chrome trace (chrome://tracing, Perfetto)
        out = engine.run_batch(tiles)

    t = Timer(); ...; t.lap("rpn")  — cumulative laps; t.report() sums them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None):
    """Profiles the body under ``torch.profiler`` inside a
    ``record_function(name)`` span: the CPU activity, and the CUDA activity
    when a CUDA device is available (the body's work is synchronised before
    the profiler stops). Yields the profiler (``key_averages()`` once the
    body is done). With ``log_dir`` the trace is written there as
    ``<name>.pt.trace.json``."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield prof
        if cuda:
            torch.cuda.synchronize()
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.laps = {}

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self.last = now
        return dt

    def report(self) -> str:
        total = time.perf_counter() - self.t0
        lines = [f"{k}: {v:.3f}s ({100 * v / total:.0f}%)" for k, v in self.laps.items()]
        return f"total {total:.3f}s | " + " | ".join(lines)


class ThroughputMeter:
    """Tiles/sec counter for streaming loops (WSI stage B)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self.counts = []

    def update(self, n: int):
        self.times.append(time.perf_counter())
        self.counts.append(n)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.counts.pop(0)

    @property
    def rate(self) -> float:
        if len(self.times) < 2:
            return 0.0
        return sum(self.counts[1:]) / max(self.times[-1] - self.times[0], 1e-9)
