"""Cross-tile nucleus merge on a GeoJSON (the command line of
tools/nuclei_merge.py, as a module).

Usage:
  python -m nuhtc_tpu_torch.tools.nuclei_merge --geojson results/nuclei/S/S.geojson \\
      --overlap_threshold 0.05 --merge_strategy probability
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from nuhtc_tpu_torch.wsi.merge import merge_geojson_file


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.nuclei_merge")
    ap.add_argument("--geojson", required=True)
    ap.add_argument("--overlap_threshold", type=float, default=0.05)
    ap.add_argument("--merge_strategy", default="probability", choices=["probability", "area"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--output_name", default=None,
                    help="output file name (written next to the input as <name>.geojson)")
    ap.add_argument("--uniform_classification", action="store_true",
                    help="relabel every merged cell as one 'uniform' class, yellow")
    args = ap.parse_args(argv)

    out_path = args.out
    if args.output_name and not out_path:
        out_path = os.path.join(os.path.dirname(args.geojson), args.output_name + ".geojson")
    t0 = time.time()
    out = merge_geojson_file(args.geojson, args.overlap_threshold, args.merge_strategy,
                             out_path, uniform_classification=args.uniform_classification)
    print(f"merged → {out} ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
