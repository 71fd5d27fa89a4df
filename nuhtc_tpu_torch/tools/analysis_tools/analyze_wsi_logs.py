"""Per-epoch validation-metric curves from training json logs (port of
tools/analysis_tools/analyze_wsi_logs.py; reference analyze_wsi_logs.py):
``plot_val_curve`` is ``analyze_logs plot_curve --mode val``, and
``cal_train_time`` passes through.

    python -m nuhtc_tpu_torch.tools.analysis_tools.analyze_wsi_logs plot_val_curve \\
        work/log.json --keys bPQ mPQ --out val.png
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from nuhtc_tpu_torch.tools.analysis_tools import analyze_logs

USAGE = ("usage: analyze_wsi_logs.py {plot_val_curve,cal_train_time} "
         "<json_logs...> [--keys ...] [--legend ...] [--title T] [--out F]")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("plot_val_curve", "cal_train_time"):
        sys.exit(USAGE)
    task = "plot_curve" if argv[0] == "plot_val_curve" else argv[0]
    extra = ["--mode", "val"] if argv[0] == "plot_val_curve" else []
    return analyze_logs.main([task, *argv[1:], *extra])


if __name__ == "__main__":
    raise SystemExit(main())
