"""Train-step throughput (port of tools/analysis_tools/benchmark_train.py):
the full NuHTC train step (RPN + 3 cascade stages + mask + semantic losses,
AdamW + EMA) on a synthetic batch of 256² tiles; ms/step, steps/s and
tiles/s.

    B=8 python -m nuhtc_tpu_torch.tools.analysis_tools.benchmark_train [--device cpu]

The batch size comes from the environment variable ``B`` (default 8), as in
the JAX tool. The model is the JAX tool's: ``NuHTC`` with 5 classes and
``scale_factor=1.0`` at Swin-T's widths, random weights from seed 0; the
batch the JAX tool's numpy draws (``synthetic_train_batch``); the step
``make_train_step`` under bf16 autocast on a CUDA device (f32 on the CPU),
its samplers and stochastic depth drawn from one ``torch.Generator`` seeded
1 in place of the JAX tool's ``fold_in`` keys. One warm step, then 10 steps
timed by ``tools.timing.synced_clock``. Training takes the plain Swin blocks,
so a step launches K4 4 times, K4's backward 4 times, K3 at least once and
no Swin kernel.

The step runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nuhtc_tpu_torch.tools.timing import synced_clock

SIZE = 256  # train tiles are 256² (no test-time ×2 rescale)


def synthetic_train_batch(rng: np.random.RandomState, batch: int, size: int = SIZE,
                          g: int = 64) -> Dict[str, np.ndarray]:
    """The JAX tool's draws, in its order: normalized-looking images
    (batch, size, size, 3) f32 and ``g`` ground-truth nuclei a tile (boxes
    around uniform centres, half-sides 4 to 12; labels of 5 classes; 28²
    mask patches; a semantic map at 1/4 scale), under the names
    ``compute_losses`` reads."""
    img = rng.randn(batch, size, size, 3).astype(np.float32)
    cx = rng.uniform(8, size - 8, (batch, g))
    cy = rng.uniform(8, size - 8, (batch, g))
    half = rng.uniform(4, 12, (batch, g))
    return dict(
        img=img,
        gt_boxes=np.stack([cx - half, cy - half, cx + half, cy + half], -1).astype(np.float32),
        gt_labels=rng.randint(0, 5, (batch, g)).astype(np.int32),
        gt_valid=np.ones((batch, g), bool),
        gt_patches=(rng.rand(batch, g, 28, 28).astype(np.float32) > 0.4).astype(np.float32),
        gt_semantic=rng.randint(0, 2, (batch, size // 4, size // 4)).astype(np.int32),
    )


def build_model(device: torch.device, **kwargs) -> torch.nn.Module:
    """The JAX tool's ``NuHTC(num_classes=5, scale_factor=1.0)`` (``kwargs``
    override constructor arguments), random weights from seed 0, f32 on
    ``device``."""
    from nuhtc_tpu_torch.models.build import init_random_weights
    from nuhtc_tpu_torch.models.detector import NuHTC

    model = NuHTC(**{"num_classes": 5, "scale_factor": 1.0, **kwargs})
    init_random_weights(model, torch.Generator().manual_seed(0))
    return model.to(device)


def make_step(model: torch.nn.Module):
    """→ ``run(batch) -> metrics``: one train step of ``model`` on a batch of
    device tensors, the train state and the generator (seeded 1) kept from
    call to call; bf16 autocast on a CUDA device, f32 on the CPU."""
    from nuhtc_tpu_torch.train.train_state import create_train_state, make_train_step

    device = next(model.parameters()).device
    dtype = torch.bfloat16 if device.type == "cuda" else None
    state, tx = create_train_state(model)
    step = make_train_step(model, tx, compute_dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(1)

    def run(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        nonlocal state
        state, metrics = step(state, batch, gen)
        return metrics

    return run


def time_train_steps(model: torch.nn.Module, batch: Dict[str, np.ndarray],
                     steps: int = 10) -> Tuple[float, Dict[str, float]]:
    """One warm step, then ``steps`` steps timed on the host clock after the
    device caught up → (seconds a step, the last step's metrics)."""
    device = next(model.parameters()).device
    run = make_step(model)
    dev_batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    float(run(dev_batch)["total"])  # warm: kernel builds, cuDNN plans, allocator
    t0 = synced_clock(device)
    for _ in range(steps):
        metrics = run(dev_batch)
    dt = (synced_clock(device) - t0) / steps
    return dt, {k: float(v) for k, v in metrics.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """→ dict(ms_per_step, steps_per_s, tiles_per_s) and the last step's
    metrics (the losses, "total", "grad_norm")."""
    ap = argparse.ArgumentParser(
        prog="python -m nuhtc_tpu_torch.tools.analysis_tools.benchmark_train")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' for the CPU")
    args = ap.parse_args(argv)

    from nuhtc_tpu_torch.apis.inference import resolve_device

    device = resolve_device(args.device, "benchmark_train")
    B = int(os.environ.get("B", 8))
    batch = synthetic_train_batch(np.random.RandomState(0), B)
    dt, metrics = time_train_steps(build_model(device), batch)
    print(
        f"train step B={B}: {dt * 1000:.0f} ms/step → {1 / dt:.2f} steps/s, "
        f"{B / dt:.1f} tiles/s  (total loss {metrics['total']:.3f})"
    )
    return dict(ms_per_step=dt * 1000, steps_per_s=1 / dt, tiles_per_s=B / dt, **metrics)


if __name__ == "__main__":
    main()
