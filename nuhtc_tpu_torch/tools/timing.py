"""Timers for one call on the card, used by the smoke run and the kernel
bench: CUDA events around queued calls, and a CUDA graph's replay."""

from __future__ import annotations

import numpy as np
import torch


def cuda_ms(fn, rounds: int = 5, inner: int = 4) -> float:
    """Time of one ``fn`` on the card: CUDA events around a run of ``inner``
    calls, the median over ``rounds`` such runs, after one warm-up call. With
    several calls queued the wrapper's host work hides behind the card's, as
    it does in a forward."""
    fn()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def graph_ms(fn, calls: int = 20) -> float:
    """Time of one ``fn`` on the card alone: ``calls`` calls captured into one
    CUDA graph, replayed 5 times, the median. No host work of the wrapper is
    in it, which ``cuda_ms`` cannot keep out of a call of a few microseconds."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()  # a warm-up call off the default stream, as capture asks
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))
