"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, the seeds, the window's arithmetic, the host facts and
the result line.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the traffic file's ``kind`` picks the driver
(``harness/<kind>.py``); each per-layer metric is ``metrics/<name>.py``;
the limits of a cell's comparison are ``limits/<workload>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded where the result is printed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "nuhtc_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no BENCHMARK.json beside the benchmark")
    return load_json(path)


def workload(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(workload_name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "limits", f"{workload_name}.json"))


def metrics_of(bench: dict, wl_name: str, section: str) -> List[dict]:
    """The ``section`` ("end_to_end" or "per_layer") metrics this cell
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[section] if wl_name in m.get("workloads", [wl_name])]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from ``--seed`` (any whole number
    from 0 on): 0 the traffic, 1 the sample the check reads."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile over every value (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(work: float, seconds: float) -> float:
    """All the work over all the time."""
    return work / seconds


def spread_summary(values: Sequence[float]) -> Dict[str, float]:
    """Median, 95th percentile, largest, and how many exceed twice the
    median: whether a window's spread is uniform or a few stalls."""
    v = np.asarray(values, np.float64)
    med = float(np.median(v))
    return {"n": int(v.size), "p50": med, "p95": float(np.percentile(v, 95)),
            "max": float(v.max()), "over_2x_p50": int((v > 2 * med).sum()),
            "sum_over_2x_p50": float(v[v > 2 * med].sum())}


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one that may not be loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def host_facts(torch) -> Dict[str, object]:
    facts = {"cpu_count": os.cpu_count(), "python": sys.version.split()[0],
             "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        facts["nvidia_smi"] = out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        facts["nvidia_smi"] = f"unavailable: {exc}"
    return facts


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
                device: dict, check: List[dict], breakdown: Optional[dict] = None) -> str:
    """The contract's last line: ``metrics`` name → (value, unit); the
    numbers the check compared, each with its limit, come last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    return json.dumps(out)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
