"""Whole-slide throughput summary of an ``infer_wsi`` save directory (port
of tools/misc/wsi_throughput_summary.py), with the standard library's
``csv`` in place of pandas.

    python -m nuhtc_tpu_torch.tools.misc.wsi_throughput_summary SAVE_DIR

Prints ``process_list_autogen.csv`` as pandas prints the frame
(``utils.tables.frame_to_string``), the ``mean <col>: x.xx`` lines of
``seg_time``, ``patch_time`` and ``n_patches`` (missing cells skipped, as
pandas' ``mean``), then one ``<file> <n> nuclei`` line per GeoJSON under
``nuclei/<slide>/``, leaving out the ``_point`` and ``_merged`` files.
Host only.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.utils.tables import frame_to_string, read_csv_columns


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.misc.wsi_throughput_summary")
    ap.add_argument("save_dir")
    args = ap.parse_args(argv)

    csv = os.path.join(args.save_dir, "process_list_autogen.csv")
    if os.path.exists(csv):
        table = read_csv_columns(csv)
        print(frame_to_string(table, index=False))
        for col in ("seg_time", "patch_time", "n_patches"):
            if col in table:
                # pandas' mean: a float64 sum of the cells that are not NaN, over their count
                vals = np.asarray(table[col], np.float64)
                vals = vals[~np.isnan(vals)]
                mean = vals.sum() / len(vals) if len(vals) else math.nan
                print(f"mean {col}: {mean:.2f}")
    for gj in sorted(glob.glob(os.path.join(args.save_dir, "nuclei", "*", "*.geojson"))):
        if "_point" in gj or "_merged" in gj:
            continue
        with open(gj) as f:
            feats = json.load(f)
        n = len(feats["features"] if isinstance(feats, dict) else feats)
        print(f"{os.path.basename(gj):<40s} {n:>8d} nuclei")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
