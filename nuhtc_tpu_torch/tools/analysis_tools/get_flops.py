"""Parameter count and FLOPs of a model (port of
tools/analysis_tools/get_flops.py; reference tools/analysis_tools/get_flops.py
of mmdet with ``forward_dummy``).

    python -m nuhtc_tpu_torch.tools.analysis_tools.get_flops CONFIG [--shape 512 [W]] \\
        [--batch 1] [--size-divisor 32] [--cfg-options k=v ...] [--device cpu]

The input is zeros of (batch, H, W, 3), H and W padded up to a multiple of
``--size-divisor``. The model is built from the config with random weights
from seed 0 and runs in f32 on the plain path (Swin tier "none",
``roi_align_plain`` / ``roi_align_sum_plain``, ``component_stats_plain``):
a hand kernel called through ctypes is invisible to the counter, so on the
kernel path every Swin block and every RoIAlign would count 0.

What is counted: ``torch.utils.flop_counter.FlopCounterMode`` counts the
products, 2·M·N·K for every matrix product and 2 · output elements ·
input channels · kernel area / groups for every convolution, around
``extract_feats`` (backbone + FPN) and around the whole forward. Norms,
softmax, activations, adds and gathers count 0. The JAX tool's XLA cost
analysis counts elementwise work too, so the two numbers differ by design.
Inside the forward, the plain RoIAlign is a separable dense product (each
RoI's interpolation matrices times the whole map: 2·R·out·H·W·C a map and
stage, as the JAX package's XLA RoIAlign), far more than the gathers of
K4, and the NMS fixpoints' suppression products count once per round they
take, so the full count follows the proposals of this input. The full
count is thus the plain path's work, not the card's: a share of the card's
peak is read from the backbone + FPN count plus an analytic count of the
heads on the kernel path, not from the full count.

The model runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU. The count does not depend on the device.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Dict, Optional, Sequence

import torch


@contextlib.contextmanager
def plain_path():
    """The names through which a detector's forward reaches K3 and K4 bound
    to their plain versions for the body (the Swin tier is the model's own:
    build it with "none")."""
    from nuhtc_tpu_torch.models import roi_extractor
    from nuhtc_tpu_torch.ops import components
    from nuhtc_tpu_torch.ops import roi_align as ra

    swaps = [(roi_extractor, "roi_align", ra.roi_align_plain),
             (roi_extractor, "roi_align_sum", ra.roi_align_sum_plain),
             (components, "component_stats", components.component_stats_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def count_flops(model: torch.nn.Module, img: torch.Tensor) -> Dict[str, int]:
    """→ dict(params, feats_flops, full_flops) of ``model`` (on the plain
    path) on ``img`` (B, H, W, 3)."""
    from torch.utils.flop_counter import FlopCounterMode

    out = {"params": sum(p.numel() for p in model.parameters())}
    with torch.no_grad(), plain_path():
        for key, fn in (("feats_flops", model.extract_feats), ("full_flops", model)):
            counter = FlopCounterMode(display=False)
            with counter:
                fn(img)
            out[key] = int(counter.get_total_flops())
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """→ dict(params, feats_flops, full_flops)."""
    ap = argparse.ArgumentParser(
        prog="python -m nuhtc_tpu_torch.tools.analysis_tools.get_flops")
    ap.add_argument("config")
    ap.add_argument("--shape", type=int, nargs="+", default=[512],
                    help="input H [W] (reference --shape nargs)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--size-divisor", type=int, default=32,
                    help="pad input dims up to a multiple (reference)")
    ap.add_argument("--cfg-options", nargs="+", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' for the CPU")
    args = ap.parse_args(argv)

    from nuhtc_tpu_torch.apis.inference import no_tf32, resolve_device
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.models.build import build_detector, init_random_weights

    device = resolve_device(args.device, "get_flops")
    if len(args.shape) == 1:
        h = w = args.shape[0]
    else:
        h, w = args.shape[:2]
    if args.size_divisor > 0:
        d = args.size_divisor
        h, w = (h + d - 1) // d * d, (w + d - 1) // d * d

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    no_tf32()
    model = build_detector(cfg.model, cfg.model.get("test_cfg"), swin_kernel="none")
    init_random_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device=device, dtype=torch.float32).eval()
    img = torch.zeros((args.batch, h, w, 3), dtype=torch.float32, device=device)

    out = count_flops(model, img)
    print(f"params: {out['params'] / 1e6:.2f} M")
    print(f"backbone+fpn flops: {out['feats_flops'] / 1e9:.2f} GFLOPs (batch {args.batch})")
    print(f"full pipeline flops: {out['full_flops'] / 1e9:.2f} GFLOPs (batch {args.batch})")
    return out


if __name__ == "__main__":
    main()
