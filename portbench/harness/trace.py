"""The device trace of a traced run: ``torch.profiler`` with the CPU and
CUDA activities over a span of the window, written as a Chrome trace to a
temporary file, read back into the numbers the per-layer metrics take.

Inside the span ``SPAN``: the union of the device's activity (kernels,
copies, sets), each kernel's time by name, the CUDA runtime's
synchronisations inside the benchmark's ``portbench.dispatch`` spans, the
idle gaps by the innermost host event running at their middle, and the share
of kernel launches whose kernel record the trace lacks (the profiler loses
about 1 % of them late in a long process)."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

SPAN = "portbench.traced"
DISPATCH = "portbench.dispatch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


@contextlib.contextmanager
def traced(torch, device):
    """Profiles the body inside the ``SPAN`` span, the device synchronised
    at both ends; yields a dict that holds the trace's summary afterwards."""
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    out: Dict[str, object] = {}
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            yield out
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.update(summarize(events))


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[dict]) -> Dict[str, object]:
    """The numbers of one trace (times in seconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    spans = [e for e in xs if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("trace: the traced span is missing")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1), e)
           for e in xs if e.get("cat") in DEVICE_CATS]
    dev = [(a, b, e) for a, b, e in dev if b > a]
    busy = _merge([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    by_kernel: Dict[str, float] = defaultdict(float)
    for a, b, e in dev:
        if e.get("cat") == "kernel":
            by_kernel[e["name"]] += (b - a) * 1e-6
    # launches whose kernel record is missing
    kern_corr = {e.get("args", {}).get("correlation") for e in xs if e.get("cat") == "kernel"}
    launches = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "") and w0 <= float(e["ts"]) <= w1]
    lost = sum(1 for e in launches if e.get("args", {}).get("correlation") not in kern_corr)
    # synchronisations inside the dispatch spans
    disp = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
            if e.get("name") == DISPATCH and e.get("cat") == "user_annotation"]
    syncs = 0
    for e in xs:
        if e.get("cat") == "cuda_runtime" and e.get("name") in SYNCS:
            t = float(e["ts"])
            if any(a <= t <= b for a, b in disp):
                syncs += 1
    # idle gaps by the innermost host event at their middle
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                   if e.get("cat") in HOST_CATS and e.get("name") != SPAN),
                  key=lambda t: t[0])
    starts = [s for s, _, _ in host]
    long_ones = [h for h in host if h[1] - h[0] > 1e3]  # over 1 ms
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < 100.0:  # launch-to-launch gaps: not worth a search each
            gaps["gaps under 0.1 ms"] += (b - a) * 1e-6
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        inner = None
        for s, t, name in host[max(0, i - 500):i] + long_ones:
            if s <= mid <= t and (inner is None or t - s < inner[1] - inner[0]):
                inner = (s, t, name)
        gaps[inner[2] if inner else "host (no traced event)"] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernel_s": dict(by_kernel), "launches": len(launches), "lost_launches": lost,
            "dispatch_spans": len(disp), "dispatch_syncs": syncs,
            "breakdown": {"device_ops": top(by_kernel), "idle_gaps": top(gaps)}}


def kernel_seconds(summary: dict, names) -> float:
    """Seconds of the kernels whose name contains any of ``names``."""
    return sum(v for k, v in summary["kernel_s"].items() if any(n in k for n in names))
