"""Inference throughput benchmark (port of tools/analysis_tools/benchmark.py;
reference tools/analysis_tools/benchmark.py:59-132 of mmdet,
``measure_inference_speed``): img/s over a long loop after a warm-up, with
periodic fps prints and the average over repeats.

    python -m nuhtc_tpu_torch.tools.analysis_tools.benchmark CONFIG [CHECKPOINT] \\
        [--batch-size 16] [--max-iter 100] [--repeat-num 1] [--log-interval 50] \\
        [--warmup 5] [--tile 256] [--dataset] [--cfg-options k=v ...] [--device cpu]

Each iteration is ``InferenceEngine.forward`` (the model and the mask paste)
on a batch already on the device, normalized and padded, in the engine's
dtype: four batches of ``RandomState(0).randn`` draws, or with ``--dataset``
the config's test images through ``engine.preprocess``, uploaded once. The
engine is ``init_detector``'s default contract (host preprocess, one
full-frame mask per detection, Swin tier "block"). Forwards are queued
without a sync inside a step; ``torch.cuda.synchronize`` at each log
interval and at the end bounds the timed span (the reference's discipline).
The proposal stages sync with the host inside a forward (NMS and component
fixpoints), so the queue is only partly pipelined.

The model runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from nuhtc_tpu_torch.tools.timing import synced_clock


def measure_inference_speed(engine, imgs, max_iter, log_interval, warmup=5):
    """One measurement pass → img/s (reference :100-131). ``imgs``: device
    batches in the engine's input layout and dtype."""
    batch = imgs[0].shape[0]
    dev = engine.device
    for i in range(warmup):
        engine.forward(imgs[i % len(imgs)])
        synced_clock(dev)

    fps = 0.0
    t0 = synced_clock(dev)
    for i in range(max_iter):
        engine.forward(imgs[i % len(imgs)])
        if (i + 1) % log_interval == 0 or (i + 1) == max_iter:
            pure_inf = synced_clock(dev) - t0
            fps = (i + 1) * batch / pure_inf
            print(f"Done image [{(i + 1) * batch:<3}/ {max_iter * batch}], "
                  f"fps: {fps:.1f} img / s, "
                  f"times per image: {1000 / fps:.1f} ms / img", flush=True)
    print(f"Overall fps: {fps:.1f} img / s, "
          f"times per image: {1000 / fps:.1f} ms / img", flush=True)
    return fps


def random_inputs(batch_size: int, size: int, count: int = 4) -> List[np.ndarray]:
    """The JAX tool's draws: ``count`` batches of RandomState(0).randn
    (batch_size, size, size, 3) as f32."""
    rng = np.random.RandomState(0)
    return [rng.randn(batch_size, size, size, 3).astype(np.float32) for _ in range(count)]


def dataset_inputs(engine, cfg, batch_size: int) -> List[np.ndarray]:
    """Up to 4 full batches of the config's test images through
    ``engine.preprocess`` (one short batch when fewer images than a batch)."""
    from nuhtc_tpu_torch.data.coco import build_dataset

    ds = build_dataset({**cfg.data.test, "test_mode": True})
    n = min(len(ds), 4 * batch_size)
    tiles = [ds.load_image(i) for i in range(n)]
    return [
        engine.preprocess(tiles[s : s + batch_size])
        for s in range(0, n, batch_size)
        if len(tiles[s : s + batch_size]) == batch_size
    ] or [engine.preprocess(tiles[:batch_size])]


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """→ img/s of each repeat."""
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.analysis_tools.benchmark",
                                 description="benchmark a model")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--max-iter", "--iters", type=int, default=100, dest="max_iter")
    ap.add_argument("--repeat-num", type=int, default=1,
                    help="repeat the measurement and average (reference)")
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--tile", type=int, default=256, help="tile side the engine takes")
    ap.add_argument("--dataset", action="store_true",
                    help="feed real images from the config's test dataset "
                    "instead of random tensors (reference data_loader)")
    ap.add_argument("--cfg-options", nargs="+", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' for the CPU")
    args = ap.parse_args(argv)

    from nuhtc_tpu_torch.apis.inference import init_detector, resolve_device
    from nuhtc_tpu_torch.config import Config

    device = resolve_device(args.device, "benchmark")
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    engine = init_detector(cfg, args.checkpoint, batch_size=args.batch_size, device=device,
                           tile_size=args.tile)

    if args.dataset:
        host = dataset_inputs(engine, cfg, args.batch_size)
    else:
        host = random_inputs(args.batch_size, engine.input_size)
    imgs = [torch.from_numpy(x).to(device=engine.device, dtype=engine.dtype) for x in host]

    fps_list = [
        measure_inference_speed(engine, imgs, args.max_iter, args.log_interval, args.warmup)
        for _ in range(args.repeat_num)
    ]
    if args.repeat_num > 1:
        mean = float(np.mean(fps_list))
        print(f"Average fps of {args.repeat_num} evaluations: {mean:.1f} img / s, "
              f"times per image: {1000 / mean:.1f} ms / img")
    return fps_list


if __name__ == "__main__":
    main()
