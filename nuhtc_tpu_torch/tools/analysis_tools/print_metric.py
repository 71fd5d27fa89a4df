"""One run's PanNuke metrics (the command line of
tools/analysis_tools/print_metric.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.print_metric --path work_dirs/exp1/ \\
      [--basedir work_dirs [--exp exp]]

Reads ``{path}/tissue_stats.csv`` (rows: the 19 tissues and the aggregate
last, columns ``PQ`` = mPQ and ``PQ bin`` = bPQ), prints the last row's PQ
and mPQ and writes them to ``{path}/format_stats.csv``. With ``--basedir``
it also averages three PanNuke folds ``{exp}1..{exp}3``: mPQ and bPQ per
tissue over the folds with a std row of the folds' aggregates, and the PQ
per class from ``class_stats.csv``. The CSV files are read and written with
the standard library (``utils.tables``), byte for byte what pandas writes,
and the tables print as pandas prints them.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.utils.tables import frame_to_string, read_csv_columns, write_csv_rows


def print_single(eval_path: str) -> dict:
    """The last tissue_stats row → format_stats.csv."""
    table = read_csv_columns(os.path.join(eval_path, "tissue_stats.csv"))
    mpq, pq = table["PQ"][-1], table["PQ bin"][-1]
    write_csv_rows(os.path.join(eval_path, "format_stats.csv"), [{"PQ": pq, "mPQ": mpq}],
                   index=[0])
    print(frame_to_string({"PQ": [pq], "mPQ": [mpq]}, index=False))
    return {"PQ": pq, "mPQ": mpq}


def _fold_table(path: str) -> dict:
    table = read_csv_columns(path)
    return {k: v for k, v in table.items() if not k.startswith("Unnamed")}


def print_folds(basedir: str, exp_name: str) -> None:
    """The mean over folds {exp}1..{exp}3 and a std row."""
    stats = [_fold_table(os.path.join(basedir, f"{exp_name}{fold}", "tissue_stats.csv"))
             for fold in range(1, 4)]
    mpq_li = [s["PQ"][-1] for s in stats]
    bpq_li = [s["PQ bin"][-1] for s in stats]
    mean = {k: (0 + np.asarray(stats[0][k]) + np.asarray(stats[1][k])
                + np.asarray(stats[2][k])) / 3 for k in ("PQ", "PQ bin")}
    total = {"Tissue name": list(stats[0]["Tissue name"]) + ["std"],
             "PQ": list(np.round(np.append(mean["PQ"], np.std(mpq_li)), 4)),
             "PQ bin": list(np.round(np.append(mean["PQ bin"], np.std(bpq_li)), 4))}
    print(frame_to_string(total))

    cls = [_fold_table(os.path.join(basedir, f"{exp_name}{fold}", "class_stats.csv"))
           for fold in range(1, 4)]
    pq = (0 + np.asarray(cls[0]["PQ"]) + np.asarray(cls[1]["PQ"]) + np.asarray(cls[2]["PQ"])) / 3
    print(frame_to_string({"Class Name": cls[0]["Class Name"], "PQ": list(np.round(pq, 3))}))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--path", required=True, help="eval dir with tissue_stats.csv")
    ap.add_argument("--basedir", default=None,
                    help="work_dirs root for 3-fold aggregation (ref :65)")
    ap.add_argument("--exp", default=None, help="experiment name prefix")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    print_single(args.path)
    if args.basedir:
        exp = args.exp or os.path.basename(os.path.normpath(args.path))[:-1]
        print_folds(args.basedir, exp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
