"""Interrater agreement over a multi-rater label CSV (the command line of
tools/analysis_tools/interrater_analysis.py, as a module): Dawid-Skene EM
truth inference and Krippendorff's alpha over the rater × unit matrix
(``eval.interrater``).

  python -m nuhtc_tpu_torch.tools.analysis_tools.interrater_analysis labels.csv \\
      --level nominal --em-iters 20 --out truth.csv

The CSV's columns are example,worker,label (the header is optional).
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from collections import defaultdict
from typing import Optional, Sequence


def load_responses(path: str):
    responses = defaultdict(dict)
    with open(path) as f:
        rows = list(csv.reader(f))
    if rows and rows[0][:2] == ["example", "worker"]:
        rows = rows[1:]
    for r in rows:
        if len(r) < 3:
            continue
        responses[r[0]][r[1]] = r[2]
    return dict(responses)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv", help="example,worker,label CSV")
    ap.add_argument("--level", default="nominal",
                    choices=["nominal", "ordinal", "interval", "ratio"])
    ap.add_argument("--em-iters", type=int, default=20)
    ap.add_argument("--initquality", type=float, default=0.7)
    ap.add_argument("--out", default=None, help="write inferred truth CSV here")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.eval.interrater import (
        DawidSkeneEM, krippendorff_alpha, truth_from_posteriors,
    )

    responses = load_responses(args.csv)
    workers = sorted({w for ws in responses.values() for w in ws})
    examples = sorted(responses)

    # the rater × unit reliability matrix for alpha
    rows = [[responses[e].get(w) for e in examples] for w in workers]
    values = sorted({label for ws in responses.values() for label in ws.values()})
    numeric = all(_is_float(v) for v in values)
    if numeric and args.level in ("interval", "ratio", "ordinal"):
        rows = [[float(v) if v is not None else None for v in r] for r in rows]
    alpha = krippendorff_alpha(rows, args.level)

    em = DawidSkeneEM(responses, initquality=args.initquality)
    e2lpd, cm, priors = em.run(n_iter=args.em_iters)
    truth = truth_from_posteriors(e2lpd)

    worker_acc = {w: float(cm[em.widx[w]].diagonal().mean()) for w in workers}
    print(json.dumps({
        "n_examples": len(examples),
        "n_workers": len(workers),
        "krippendorff_alpha": alpha,
        "level": args.level,
        "label_priors": {str(label): float(p) for label, p in zip(em.labels, priors)},
        "worker_mean_diag": worker_acc,
    }, indent=2))

    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["example", "label", "posterior"])
            for e in examples:
                w.writerow([e, truth[e], f"{e2lpd[e][truth[e]]:.4f}"])
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _is_float(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


if __name__ == "__main__":
    raise SystemExit(main())
