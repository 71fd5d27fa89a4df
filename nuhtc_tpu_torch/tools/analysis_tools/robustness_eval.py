"""Corruption-benchmark results as P / mPC / rPC (the command line of
tools/analysis_tools/robustness_eval.py, as a module), over the PQ / AJI /
Dice metric suite:

  python -m nuhtc_tpu_torch.tools.analysis_tools.robustness_eval results.json \\
      [--metrics pq aji] [--prints P mPC rPC]

The input is the json that ``test_robustness --out`` writes,
{distortion: {severity: {metric: value}}} with severity 0 the clean run:
P is the clean performance, mPC the mean over distortions and severities
≥ 1, rPC = mPC / P.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def robustness_summary(results: dict, metrics=None):
    distortions = sorted(results)
    sevs = sorted({int(s) for d in distortions for s in results[d] if int(s) > 0})
    if metrics is None:
        metrics = sorted(results[distortions[0]]["0" if "0" in results[distortions[0]] else 0])
    get = lambda d, s: results[d].get(s, results[d].get(str(s), {}))  # noqa: E731
    p = np.array([get(distortions[0], 0).get(m, np.nan) for m in metrics])
    corr = np.array(
        [[[get(d, s).get(m, np.nan) for m in metrics] for s in sevs] for d in distortions]
    )
    mpc = np.nanmean(corr, axis=(0, 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        rpc = np.where(p != 0, mpc / p, np.nan)
    return metrics, p, mpc, rpc


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("filename", help="json from test_robustness.py --out")
    ap.add_argument("--metrics", nargs="+", default=None,
                    help="subset of metrics (default: all in the file)")
    ap.add_argument("--prints", nargs="+", default=["P", "mPC", "rPC"],
                    choices=["P", "mPC", "rPC"])
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    with open(args.filename) as f:
        results = json.load(f)
    metrics, p, mpc, rpc = robustness_summary(results, args.metrics)

    print(f"model: {args.filename}")
    rows = {"P": p, "mPC": mpc, "rPC": rpc}
    titles = {
        "P": "Performance on Clean Data [P]",
        "mPC": "Mean Performance under Corruption [mPC]",
        "rPC": "Relative Performance under Corruption [rPC]",
    }
    for which in args.prints:
        print(titles[which])
        for m, v in zip(metrics, rows[which]):
            if which == "rPC":
                print(f"  {m:10} => {v * 100:0.1f} %")
            else:
                print(f"  {m:10} =  {v:0.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
