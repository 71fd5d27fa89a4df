"""Summarise or plot the training json logs of the port's trainer (port of
tools/analysis_tools/analyze_logs.py; reference analyze_logs.py).

    python -m nuhtc_tpu_torch.tools.analysis_tools.analyze_logs plot_curve \\
        work/log.json --keys total s2.loss_mask --out curves.png
    python -m nuhtc_tpu_torch.tools.analysis_tools.analyze_logs plot_curve \\
        a/log.json b/log.json --keys bPQ --mode val --out val.png
    python -m nuhtc_tpu_torch.tools.analysis_tools.analyze_logs cal_train_time work/log.json

``log.json`` holds one json row a line (``tools.train``: ``mode`` "train"
rows every ``log_interval`` steps, "val" rows after each evaluation).
``cal_train_time`` prints each log's mean iteration time where its rows have
a ``time``, else its row count and epoch range. ``plot_curve`` plots each
key of the rows of ``--mode`` (one point per row; per epoch for val rows)
with ``{log dir}_{key}`` legends; it says which keys a log lacks before it
draws. matplotlib is imported only to draw, after those lines are printed,
and a missing matplotlib raises ImportError by name.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.tools.analysis_tools import pyplot


def load_log(path: str) -> list:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.analysis_tools.analyze_logs")
    ap.add_argument("task", choices=["plot_curve", "cal_train_time"])
    ap.add_argument("json_logs", nargs="+")
    ap.add_argument("--keys", nargs="+", default=["total"])
    ap.add_argument("--mode", choices=["train", "val"], default="train",
                    help="val: per-epoch metric curves from mode=val rows")
    ap.add_argument("--legend", nargs="+", default=None)
    ap.add_argument("--title", default=None)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def cal_train_time(logs: dict) -> None:
    for path, rows in logs.items():
        if rows and "time" in rows[0]:
            ts = [r["time"] for r in rows]
            print(f"{path}: mean iter time {np.mean(ts):.4f}s, std {np.std(ts):.4f}")
        else:
            eps = [r.get("epoch") for r in rows if "epoch" in r]
            print(f"{path}: {len(rows)} log entries, epochs "
                  f"{min(eps) if eps else '?'}..{max(eps) if eps else '?'}")


def plot_curve(logs: dict, args) -> str:
    """Draws the curves into ``args.out`` (default curves.png) → its path."""
    legends = args.legend or [f"{os.path.basename(os.path.dirname(p) or p)}_{k}"
                              for p in args.json_logs for k in args.keys]
    curves = []  # (xs, ys, legend)
    li = 0
    for path, rows in logs.items():
        sel = [r for r in rows if r.get("mode", "train") == args.mode]
        for k in args.keys:
            pts = [(r.get("epoch", i), r[k]) for i, r in enumerate(sel) if k in r]
            if not pts:
                print(f"{path}: no '{k}' in mode={args.mode} rows")
            else:
                curves.append((*zip(*pts), legends[li % len(legends)]))
            li += 1
    plt = pyplot("analyze_logs plot_curve")
    for xs, ys, label in curves:
        if args.mode == "val":
            plt.plot(xs, ys, marker="o", label=label)
            plt.xlabel("epoch")
        else:
            plt.plot(range(len(ys)), ys, linewidth=0.8, label=label)
            plt.xlabel("log step")
    plt.legend()
    if args.title:
        plt.title(args.title)
    out = args.out or "curves.png"
    plt.savefig(out, dpi=120)
    print(f"saved {out}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    logs = {p: load_log(p) for p in args.json_logs}
    if all(not rows for rows in logs.values()):
        print("empty log(s)")
        return 0
    if args.task == "cal_train_time":
        cal_train_time(logs)
    else:
        plot_curve(logs, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
