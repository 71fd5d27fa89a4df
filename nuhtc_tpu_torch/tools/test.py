"""Dataset evaluation (the command line of tools/test.py, as a module):
batched patch inference over a COCO test split, then the AJI / AJI+ / DQ /
SQ / PQ / Dice / mPQ / mPQ+ suite and a confusion matrix
(``eval.evaluate.evaluate_dataset``).

  python -m nuhtc_tpu_torch.tools.test <config> [checkpoint] --eval segm \\
      --eval-options save=True format=pannuke save_path=infer overlay=True \\
      [--cfg-options data.test.ann_file=... data.test.img_prefix=...] \\
      [--work-dir DIR] [--show-dir DIR] [--format-only] [--batch-size 16] \\
      [--limit N] [--out-json F] [--out F.pkl] [--device cpu]
  torchrun --standalone --nproc_per_node=N -m nuhtc_tpu_torch.tools.test <config> \\
      [checkpoint] --launcher pytorch [...]

The model runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU. ``run_dataset`` is the inference loop (read, the
engine's strict-path ``run_batch``, RLE encoding into the reference result
tuple); the tool prints images/s with the seconds of read, run_batch, encode
and evaluate, and one line ``test: {json}`` with those figures.

``--launcher pytorch`` evaluates over the processes torchrun starts (the JAX
script's ``jax``; reference ``multi_gpu_test``): rank r runs images r, r + W,
r + 2W, ... on ``cuda:LOCAL_RANK`` (or ``--device``), the results are
gathered (``parallel.mesh.gather_objects``) and put back in dataset order
(``merge_strided_results``) on rank 0, which alone evaluates, prints and
writes; the other ranks return after the gather.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from nuhtc_tpu_torch.ops import rle as rle_ops

TIMING_KEYS = ("read_s", "run_batch_s", "encode_s")


def parse_eval_options(opts) -> Dict[str, object]:
    """``key=value`` strings → dict: True/False, numbers, else the text."""
    out = {}
    for kv in opts or []:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = float(v) if "." in v else int(v)
            except ValueError:
                pass
        out[k] = v
    return out


def result_tuple(res: Dict[str, np.ndarray], num_classes: int) -> Tuple[List, List]:
    """One image's detections → (bbox_results [C × (n, 5) float32 with the
    score last], segm_results [C × [RLE, ...]]), the reference's contract."""
    bboxes, segms = [], []
    for c in range(num_classes):
        sel = res["labels"] == c
        bboxes.append(np.concatenate([res["boxes"][sel], res["scores"][sel][:, None]], 1
                                     ).astype(np.float32))
        segms.append([rle_ops.encode(m) for m in res["masks"][sel]])
    return bboxes, segms


def run_dataset(engine, dataset, batch_size: int, limit: int = 0,
                timing: Optional[Dict[str, float]] = None, progress: bool = False,
                indices: Optional[Sequence[int]] = None) -> List:
    """Runs the engine over the first ``limit`` images of ``dataset`` (all
    when 0), or over ``indices`` when given, ``batch_size`` at a time;
    returns one ``result_tuple`` per image. ``timing``, when given, gathers
    seconds under ``TIMING_KEYS``."""
    if indices is None:
        indices = range(len(dataset) if not limit else min(limit, len(dataset)))
    indices = list(indices)
    n = len(indices)
    results = []
    t_start = time.perf_counter()
    for start in range(0, n, batch_size):
        t0 = time.perf_counter()
        imgs = [dataset.load_image(i) for i in indices[start:start + batch_size]]
        t1 = time.perf_counter()
        out = engine.run_batch(imgs)
        t2 = time.perf_counter()
        results.extend(result_tuple(res, engine.num_classes) for res in out)
        t3 = time.perf_counter()
        if timing is not None:
            for key, dt in zip(TIMING_KEYS, (t1 - t0, t2 - t1, t3 - t2)):
                timing[key] = timing.get(key, 0.0) + dt
        if progress:
            rate = len(results) / (time.perf_counter() - t_start)
            print(f"\r{len(results)}/{n} imgs ({rate:.1f} img/s)", end="", flush=True)
    if progress:
        print()
    return results


class _SlicedDataset:
    """The first ``n`` images of a dataset; everything else delegated."""

    def __init__(self, ds, n):
        self._ds = ds
        self._n = n

    def __len__(self):
        return self._n

    def __getattr__(self, k):
        return getattr(self._ds, k)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Evaluate a detector on a COCO patch dataset")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--eval", nargs="+", default=["segm"])
    ap.add_argument("--eval-options", nargs="+", default=None)
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="config overrides, key=value with dotted keys "
                    "(reference --cfg-options)")
    ap.add_argument("--work-dir", default=None,
                    help="directory for the metrics json/log (reference --work-dir)")
    ap.add_argument("--format-only", action="store_true",
                    help="write converted predictions without evaluating "
                    "(reference --format-only)")
    ap.add_argument("--show-dir", default=None,
                    help="save prediction overlays here (reference --show-dir)")
    ap.add_argument("--show-score-thr", type=float, default=0.3,
                    help="score threshold for drawn instances (reference)")
    ap.add_argument("--batch-size", "--samples_per_gpu", type=int, default=16,
                    dest="batch_size")
    ap.add_argument("--limit", type=int, default=0, help="evaluate only the first N images")
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--out", default=None, help="pickle the raw per-image results")
    ap.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                    help="'pytorch' = the processes torchrun starts: images strided "
                    "across them, results gathered, rank 0 evaluates (reference "
                    "multi_gpu_test + init_dist, tools/test.py:239)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import resolve_device
    from nuhtc_tpu_torch.parallel import mesh as P

    device = resolve_device(args.device, "test")
    with P.launched(args.launcher, device, args.device is not None) as (device, pid, nproc):
        return _evaluate(args, device, nproc, pid)


def _evaluate(args, device, nproc: int, pid: int) -> int:
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.eval.evaluate import evaluate_dataset
    from nuhtc_tpu_torch.parallel import mesh as P

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    dataset = build_dataset({**cfg.data.test, "test_mode": True})
    engine = init_detector(cfg, args.checkpoint, batch_size=args.batch_size, device=device)

    n = len(dataset) if not args.limit else min(args.limit, len(dataset))
    timing = dict.fromkeys(TIMING_KEYS, 0.0)
    t0 = time.perf_counter()
    # interleaved, like mmdet's DistributedSampler: process p → p, p + P, ...
    my_idxs = list(range(pid, n, nproc))
    results = run_dataset(engine, dataset, args.batch_size, timing=timing,
                          progress=pid == 0, indices=my_idxs)
    if nproc > 1:
        parts = P.gather_objects(list(zip(my_idxs, results)))
        if pid != 0:
            return 0  # rank 0 evaluates (reference collect_results → rank 0)
        results = P.merge_strided_results(parts)

    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
        print(f"raw results → {args.out}")

    eval_opts = parse_eval_options(args.eval_options)
    t1 = time.perf_counter()
    metrics = evaluate_dataset(
        dataset if not args.limit else _SlicedDataset(dataset, n),
        results,
        save=eval_opts.get("save", False) or args.format_only,
        save_path=args.show_dir or eval_opts.get("save_path", "infer"),
        data_format=eval_opts.get("format", "conic"),
        overlay=eval_opts.get("overlay", False) or bool(args.show_dir),
        overlay_score_thr=args.show_score_thr if args.show_dir else 0.0,
        format_only=args.format_only,
    )
    t2 = time.perf_counter()
    for k, v in metrics.items():
        if k != "confusion_matrix":
            print(f"{k}: {v:.4f}")
    out_json = args.out_json
    if args.work_dir and not out_json:
        os.makedirs(args.work_dir, exist_ok=True)
        out_json = os.path.join(args.work_dir, "eval_metrics.json")
    if out_json and metrics:
        with open(out_json, "w") as f:
            json.dump({k: v for k, v in metrics.items()}, f, indent=2)
        print(f"metrics → {out_json}")
    detections = sum(len(b) for bboxes, _ in results for b in bboxes)
    summary = dict(images=n, detections=detections, seconds=t2 - t0,
                   img_per_s=n / (t2 - t0), **timing, evaluate_s=t2 - t1)
    print(f"{n} images, {detections / max(n, 1):.1f} detections a tile: {n / (t2 - t0):.2f} "
          f"img/s; read {timing['read_s']:.3f} s, run_batch {timing['run_batch_s']:.3f} s, "
          f"encode {timing['encode_s']:.3f} s, evaluate {t2 - t1:.3f} s")
    print("test: " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
