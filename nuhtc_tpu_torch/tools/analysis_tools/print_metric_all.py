"""The per-suite stat CSVs of an eval directory as one summary row (the
command line of tools/analysis_tools/print_metric_all.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.print_metric_all --path <eval_dir>

Reads ``conic_stats.csv`` (its first row's aji and dice) and
``tissue_stats.csv`` (its last row's ``PQ bin`` and ``PQ``), writes
``format_stats.csv`` with aji, dice, PQ and mPQ and prints it, as pandas
would (``utils.tables``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from nuhtc_tpu_torch.utils.tables import frame_to_string, read_csv_columns, write_csv_rows


def metric_log(eval_path: str) -> str:
    conic = read_csv_columns(os.path.join(eval_path, "conic_stats.csv"))
    pannuke = read_csv_columns(os.path.join(eval_path, "tissue_stats.csv"))
    row = {"aji": conic["aji"][0], "dice": conic["dice"][0],
           "PQ": pannuke["PQ bin"][-1], "mPQ": pannuke["PQ"][-1]}
    write_csv_rows(os.path.join(eval_path, "format_stats.csv"), [row], index=[0])
    out = frame_to_string({k: [v] for k, v in row.items()}, index=False)
    print(out)
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--path", required=True, help="eval directory with the stat CSVs")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    metric_log(parse_args(argv).path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
