"""Runs one benchmark cell once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration file and a traffic mix; the traffic's ``kind`` picks the
driver (``harness/slide.py``, ``harness/forward.py``). Set-up makes the
inputs and the weights from ``--seed``, builds the port's engine and warms
up every shape the traffic uses; the window then runs for ``--seconds``;
after it the program's outputs are compared with the frozen reference
(``limits/<cell>.json``). With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window (``harness/trace.py``) and the
program's own timers. Earlier lines (standard error) give the host's facts,
the card's clocks after the window, a batch's latency and host time (median,
95th percentile, largest, how many exceed twice the median), the counts
behind the check and the trace's lost records; the numbers compared, each
beside its limit, end standard error and the result line.

Exits 2 without the CUDA devices the cell asks for, and 3 when a module of
JAX or of the JAX package is loaded once the window has closed; neither
prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# caches of what the program builds stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device, torch, t_start: float, cell_kw: dict | None = None,
             cfg_kw: dict | None = None) -> dict:
    """Set-up, window, check and metrics of one run on ``device``; → the
    result's parts. ``cell_kw`` and ``cfg_kw`` override traffic and
    configuration entries (the CPU tests' small sizes)."""
    from portbench.harness import check, common
    from portbench.harness import forward, slide
    from portbench.harness import program

    bench = common.benchmark()
    wl = common.workload(bench, args.workload)
    cfg = dict(common.config(bench, wl["config"]), **(cfg_kw or {}))
    tr = dict(common.traffic(wl["traffic"]), **(cell_kw or {}))
    lim = common.limits(args.workload)
    driver = {"slide": slide, "forward": forward}[tr["kind"]]
    cell_cls = {"slide": slide.SlideCell, "forward": forward.ForwardCell}[tr["kind"]]
    cuda = device.type == "cuda"

    cell = cell_cls(cfg, tr, args.seed, device, torch)
    try:
        cell.warm_up()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        summary = {} if args.trace else None
        win = cell.window(args.seconds, traced=summary)
        if cuda:
            torch.cuda.synchronize(device)
            common.log("card after the window:", common.host_facts(torch)["nvidia_smi"])
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        t_check = time.perf_counter()
        # the program's outputs, then its state freed, then the reference
        if tr["kind"] == "forward":
            got, tiles = cell.program_results()
        cell.release()
        ref = program.reference(cfg, cell.state, device)
        if tr["kind"] == "forward":
            numbers = forward.compare(got, tiles, ref, cfg, tr, device)
        else:
            numbers = cell.numbers(ref)
            tiles = cell.check_idx
        check_s = time.perf_counter() - t_check
    finally:
        cell.cleanup()
    correct, rows = check.verdict(numbers, lim["limits"])
    counts = {k: v for k, v in numbers.items() if k.endswith("_counts")}
    e2e = driver.e2e(win)
    e2e["setup_s"] = setup_s
    return dict(bench=bench, wl=wl, cfg=cfg, tr=tr, win=win, summary=summary, peak=peak,
                numbers=numbers, counts=counts, correct=correct, rows=rows, e2e=e2e,
                sample=tiles, check_s=check_s)


def metric_values(res: dict, trace: bool) -> dict:
    """name → (value, unit) of the cell's metrics of this kind of run."""
    from portbench.harness import common

    bench, name = res["bench"], res["wl"]["name"]
    out = {}
    if not trace:
        for m in common.metrics_of(bench, name, "end_to_end"):
            out[m["name"]] = (res["e2e"][m["name"]], m["unit"])
        return out
    work_path = os.path.join(common.BENCH_DIR, "work", f"{res['wl']['config']}.json")
    ctx = dict(cfg=res["cfg"], traffic=res["tr"], window=res["win"], trace=res["summary"],
               work=common.load_json(work_path))
    for m in common.metrics_of(bench, name, "per_layer"):
        value = common.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = (value, m["unit"])
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.harness import common

    bench = common.benchmark()
    chips = common.workload(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"portbench: the cell asks for {chips} CUDA device(s); "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    device = torch.device("cuda:0")
    common.log("host:", common.host_facts(torch))
    res = run_cell(args, device, torch, T_START)
    bad = common.forbidden_loaded()
    if bad:
        common.log(f"portbench: modules of JAX or the JAX package are loaded: {bad}")
        return 3
    report(res, bool(args.trace), torch.cuda.get_device_name(device))
    return 0


def report(res: dict, trace: bool, kind: str) -> None:
    """The earlier lines on standard error, then the result line."""
    from portbench.harness import common

    win, summary = res["win"], res["summary"]
    common.log("window:", {k: v for k, v in win.items() if not k.endswith("_ms")})
    for key in ("latency_ms", "host_ms"):
        if win.get(key):
            common.log(f"window {key} a batch:", common.spread_summary(win[key]))
    common.log(f"check: {res['check_s']:.2f} s after the window (collect, the reference, "
               f"the comparison)", res["counts"])
    got = res["counts"]["det_counts"]["got"]
    checked = len(res["sample"])
    if "nuclei" in win:
        common.log(f"slide: {got / checked:.2f} detections a tile before post (the {checked} "
                   f"checked tiles), {win['nuclei'] / win['tiles']:.2f} nuclei a tile after")
    else:
        common.log(f"forward: {got / checked:.2f} detections a tile (the {checked} checked tiles)")
    device_info = {"platform": "gpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(res["peak"])}
    breakdown = None
    if trace:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]
        common.log(f"trace: {summary['launches']} kernel launches, {summary['lost_launches']} "
                   f"without their kernel record "
                   f"({100.0 * summary['lost_launches'] / max(summary['launches'], 1):.3f} %)")
    metrics = metric_values(res, trace)
    for r in res["rows"]:
        common.log(f"check {r['name']}: {r['value']!r} (limit {r['limit']!r})")
    attempted = win.get("tiles", win.get("batches"))
    print(common.result_line(res["correct"], attempted, 0, metrics, device_info, res["rows"],
                             breakdown), flush=True)


if __name__ == "__main__":
    sys.exit(main())
