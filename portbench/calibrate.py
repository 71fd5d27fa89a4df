"""The readings that a cell's limits are set from, in one process on the
card: for each seed the program's compared numbers after a short window at
the cell's own load (the lower reading is their largest), and for the
control seeds the fp8 reference's numbers in the program's place on the
same tiles and weights (the upper reading is their smallest).

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--out <file.jsonl>]

One JSON line a reading on standard output (and in ``--out``)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seed: int, seconds: float, control: bool, device, torch,
             cell_kw=None, cfg_kw=None):
    """→ (program's numbers, control's numbers or None)."""
    from portbench.harness import common, forward, program, slide

    bench = common.benchmark()
    wl = common.workload(bench, workload)
    cfg = dict(common.config(bench, wl["config"]), **(cfg_kw or {}))
    tr = dict(common.traffic(wl["traffic"]), **(cell_kw or {}))
    cls = {"slide": slide.SlideCell, "forward": forward.ForwardCell}[tr["kind"]]
    cell = cls(cfg, tr, seed, device, torch)
    try:
        cell.warm_up()
        cell.window(seconds)
        if tr["kind"] == "forward":
            got, tiles = cell.program_results()
        cell.release()
        ref = program.reference(cfg, cell.state, device)
        if tr["kind"] == "forward":
            prog = forward.compare(got, tiles, ref, cfg, tr, device)
        else:
            prog = cell.numbers(ref)
            tiles = cell.check_tiles()
        ctrl = None
        if control:
            fp8 = program.reference(cfg, cell.state, device, fp8=True)
            low = program.reference_detect(fp8, tiles, cfg, tr["batch"], device)
            if tr["kind"] == "forward":
                ctrl = forward.compare(low, tiles, ref, cfg, tr, device)
            else:
                coords = cell.coords[cell.check_idx]
                ctrl = slide.compare(low, program.reference_nuclei(low, coords, tr["tile"], tr),
                                     ref, tiles, coords, cfg, tr, device)
            del fp8
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return prog, ctrl
    finally:
        cell.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, ctrl = readings(args.workload, seed, args.seconds, seed in args.control_seeds,
                              device, torch)
        for kind, numbers in (("program", prog), ("control", ctrl)):
            if numbers is None:
                continue
            line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                               "numbers": numbers, "s": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
