"""Corruption robustness: the metric suite of the detector on corrupted
inputs at rising severity (the command line of
tools/analysis_tools/test_robustness.py, as a module):

  python -m nuhtc_tpu_torch.tools.analysis_tools.test_robustness <config> [checkpoint] \\
      --corruptions gaussian_noise gaussian_blur jpeg pixelate --limit 64 [--out r.json] \\
      [--device cpu]

The corruptions are ``data.pipelines.CORRUPTIONS`` (numpy host code, the
JAX package's draws), ``--corruptions`` takes names or the groups of
``CORRUPTION_GROUPS`` (benchmark, all, noise, blur, weather, digital,
holdout, None). Severity 0 is the clean run, done once and reused for every
corruption. Each run corrupts the first ``--limit`` images of the config's
test split, runs the engine's strict path (``init_detector``,
``InferenceEngine.run_batch``: one full-frame mask a detection, RLE through
``ops.rle``) and scores them with ``evaluate_dataset``. ``--out`` writes
{distortion: {severity: metrics}}, the input of ``robustness_eval``.

The model runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU. ``main`` also takes, from Python, the engine's
``batch_size`` (8, as the JAX tool's ``init_detector`` gives it) and a
``timing`` list that gets one record a run: images, seconds, and the
seconds of read, corrupt, run_batch, encode and evaluate.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from nuhtc_tpu_torch.data.pipelines import CORRUPTION_GROUPS, CORRUPTIONS


def corrupt(img: np.ndarray, kind: str, severity: int, seed: int | None = None) -> np.ndarray:
    """One corruption of a uint8 RGB image. Every call draws from a fresh
    ``RandomState(0 if seed is None else seed)``, so every image gets the
    same draws; the result is clipped and truncated to uint8."""
    if kind == "jpeg":  # the legacy alias
        kind = "jpeg_compression"
    if kind not in CORRUPTIONS:
        raise ValueError(f"{kind}; available: {sorted(CORRUPTIONS)}")
    out = CORRUPTIONS[kind](img.astype(np.uint8), severity,
                            np.random.RandomState(0 if seed is None else seed))
    return np.clip(out, 0, 255).astype(np.uint8)


def _expand_corruptions(names):
    """The group aliases of the reference ('benchmark' by default, 'all',
    'noise', 'blur', 'weather', 'digital', 'holdout', 'None') or corruption
    names, in order, each once."""
    out = []
    for n in names:
        if n == "None":
            continue
        elif n in CORRUPTION_GROUPS:
            out.extend(CORRUPTION_GROUPS[n])
        elif n in CORRUPTIONS or n == "jpeg":
            out.append(n)
        else:
            raise ValueError(f"unknown corruption/group: {n}")
    return list(dict.fromkeys(out))


def run_eval(engine, dataset, n: int, transform, timing: Optional[Dict[str, float]] = None):
    """The first n images through ``transform`` and the engine, scored by
    ``evaluate_dataset``; ``timing`` gathers the seconds of each part."""
    from nuhtc_tpu_torch.eval.evaluate import evaluate_dataset
    from nuhtc_tpu_torch.tools.test import _SlicedDataset, result_tuple

    parts = dict.fromkeys(("read_s", "corrupt_s", "run_batch_s", "encode_s", "evaluate_s"), 0.0)
    results = []
    for s in range(0, n, engine.batch_size):
        t0 = time.perf_counter()
        imgs = [dataset.load_image(i) for i in range(s, min(s + engine.batch_size, n))]
        t1 = time.perf_counter()
        imgs = [transform(x) for x in imgs]
        t2 = time.perf_counter()
        out = engine.run_batch(imgs)
        t3 = time.perf_counter()
        results.extend(result_tuple(res, engine.num_classes) for res in out)
        t4 = time.perf_counter()
        for key, dt in zip(("read_s", "corrupt_s", "run_batch_s", "encode_s"),
                           (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key] += dt
    t5 = time.perf_counter()
    metrics = evaluate_dataset(_SlicedDataset(dataset, n), results)
    parts["evaluate_s"] = time.perf_counter() - t5
    if timing is not None:
        timing.update(parts)
    return metrics


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--corruptions", nargs="+", default=["benchmark"],
                    help="corruption names or groups: all/benchmark/noise/"
                    "blur/weather/digital/holdout/None (reference)")
    ap.add_argument("--severities", nargs="+", type=int, default=[0, 1, 2, 3, 4, 5],
                    help="0 = clean (reference default 0-5)")
    ap.add_argument("--limit", type=int, default=64)
    ap.add_argument("--summaries", action="store_true",
                    help="print every metric per corruption/severity (reference)")
    ap.add_argument("--show-dir", default=None,
                    help="save corrupted-input overlays here (reference)")
    ap.add_argument("--show-score-thr", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=None,
                    help="seed for the corruption noise draws")
    ap.add_argument("--cfg-options", nargs="+", default=None)
    ap.add_argument("--out", default=None, help="save {distortion: {severity: metrics}} json")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    args.corruptions = _expand_corruptions(args.corruptions)
    return args


def main(argv: Optional[Sequence[str]] = None, *, batch_size: int = 8,
         timing: Optional[List[dict]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import init_detector, resolve_device
    from nuhtc_tpu_torch.tools.analysis_tools import load_test_dataset
    from nuhtc_tpu_torch.utils.imageio import write_image

    device = resolve_device(args.device, "test_robustness")
    cfg, dataset = load_test_dataset(args.config, args.cfg_options)
    engine = init_detector(cfg, args.checkpoint, batch_size=batch_size, device=device)
    n = min(args.limit, len(dataset))
    if args.show_dir:
        os.makedirs(args.show_dir, exist_ok=True)

    def timed_eval(kind, sev, transform):
        parts = {}
        t0 = time.perf_counter()
        metrics = run_eval(engine, dataset, n, transform, parts)
        if timing is not None:
            timing.append(dict(corruption=kind, severity=sev, images=n,
                               seconds=time.perf_counter() - t0, **parts))
        return metrics

    base = timed_eval("clean", 0, lambda x: x)
    print(f"clean: pq={base['pq']:.4f}")
    # {distortion: {severity: metrics}}, severity 0 the clean run (the
    # aggregation input of mmdet's test_robustness)
    all_results = {}
    sevs = [s for s in args.severities if s != 0]
    for kind in args.corruptions:
        all_results[kind] = {0: {k: float(v) for k, v in base.items() if isinstance(v, float)}}
        for sev in sevs:
            if args.show_dir:
                write_image(os.path.join(args.show_dir, f"{kind}_s{sev}.png"),
                            corrupt(dataset.load_image(0), kind, sev, args.seed))
            m = timed_eval(kind, sev, lambda x, k=kind, s=sev: corrupt(x, k, s, args.seed))
            if args.summaries:
                for mk, mv in m.items():
                    if isinstance(mv, float):
                        print(f"  {kind} s{sev} {mk}: {mv:.4f}")
            else:
                print(f"{kind} s{sev}: pq={m['pq']:.4f}")
            all_results[kind][int(sev)] = {
                k: float(v) for k, v in m.items() if isinstance(v, float)
            }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(all_results, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
