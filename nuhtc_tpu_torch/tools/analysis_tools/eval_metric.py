"""Metrics from pickled raw results without running inference again (the
command line of tools/analysis_tools/eval_metric.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.eval_metric <config> results.pkl --eval segm
  python -m nuhtc_tpu_torch.tools.analysis_tools.eval_metric <config> results.pkl \\
      --format-only --eval-options save_path=infer format=conic

The pickle is the per-image ``(bboxes_per_class, segms_per_class)`` list that
``tools.test --out`` writes; ``evaluate_dataset`` scores it on the config's
test split, so one inference pass can be scored under other options.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Evaluate metric of results saved in pkl format")
    ap.add_argument("config")
    ap.add_argument("pkl_results")
    ap.add_argument("--eval", nargs="+", default=None,
                    help="evaluation metrics, e.g. segm (reference --eval)")
    ap.add_argument("--format-only", action="store_true",
                    help="format/convert predictions without evaluating")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="config overrides, key=value with dotted keys")
    ap.add_argument("--eval-options", nargs="+", default=None,
                    help="kwargs for evaluation, key=value "
                    "(save=1 format=conic save_path=infer overlay=1)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if not (args.eval or args.format_only):
        sys.exit("Please specify at least one of --eval / --format-only")
    if args.eval and args.format_only:
        sys.exit("--eval and --format-only cannot be both specified")

    from nuhtc_tpu_torch.eval.evaluate import evaluate_dataset
    from nuhtc_tpu_torch.tools.analysis_tools import load_test_dataset

    _, dataset = load_test_dataset(args.config, args.cfg_options)
    with open(args.pkl_results, "rb") as f:
        results = pickle.load(f)
    if len(results) != len(dataset):
        print(f"warning: {len(results)} results vs {len(dataset)} images — "
              "evaluating the overlapping prefix")
        results = results[: len(dataset)]

    eval_opts = dict(kv.split("=", 1) for kv in args.eval_options or [])
    metrics = evaluate_dataset(
        dataset,
        results,
        save=bool(eval_opts.get("save", False)) or args.format_only,
        save_path=eval_opts.get("save_path", "infer"),
        data_format=eval_opts.get("format", "conic"),
        overlay=bool(eval_opts.get("overlay", False)),
        format_only=args.format_only,
    )
    for k, v in metrics.items():
        if k != "confusion_matrix":
            print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
