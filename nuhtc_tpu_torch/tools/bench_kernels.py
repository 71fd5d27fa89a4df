"""K4 and K3 on the card at the main path's shapes: what fusing a stage and
the order and size of the boxes are worth.

    python -m nuhtc_tpu_torch.tools.bench_kernels        (from the repo's root)

Runs on the first CUDA device (it fails without one) and prints the card's
name and power limit first. The inputs are those of ``chip_smoke.py``
(``tools/synthetic.py``: B16, C64 bf16 maps of 128², 64² and 128², R1512 at
out 7 and R500 at out 14, boxes from a seed with one sixteenth large ones;
512² labels, K512). Every time is taken twice: by CUDA events around runs of
4 calls (``timing.cuda_ms``, the wrapper's host work included where it does
not hide) and as the device's time alone, from 20 calls replayed as one CUDA
graph (``timing.graph_ms``).

K4, per stage call and per forward (3 bbox-stage calls + 1 mask-stage call):
- ``fused``: one ``roi_align_sum`` launch (what the detector runs);
- ``unfused``: the same kernel in its one-map mode three times, the bias
  broadcast and the three adds in PyTorch (what fusing the stage buys);
- ``large last``: the fused call with each image's boxes sorted by area, the
  large ones at the end of the image and of the grid (what the order of the
  blocks costs), and ``large first``, the reverse; ``no large boxes``: the
  large sixteenth replaced by nucleus-sized boxes (what the large ones cost).
K3: one ``component_stats`` call.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from nuhtc_tpu_torch.ops import components as comp
from nuhtc_tpu_torch.ops.roi_align import roi_align, roi_align_sum
from nuhtc_tpu_torch.tools.synthetic import blob_mask, roi_stage_inputs
from nuhtc_tpu_torch.tools.timing import cuda_ms, graph_ms

BATCH = 16


def by_area(rois: torch.Tensor, descending: bool) -> torch.Tensor:
    area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    idx = area.argsort(dim=1, descending=descending)
    return rois.gather(1, idx[..., None].expand(-1, -1, 4)).contiguous()


def without_large(rois: torch.Tensor) -> torch.Tensor:
    """The boxes with the large sixteenth replaced by copies of nucleus-sized ones."""
    n = rois.shape[1] // 16
    out = rois.clone()
    out[:, n:2 * n] = rois[:, 6 * n:7 * n]
    return out


def bench_k4(device):
    maps, _, _, stages = roi_stage_inputs(device, BATCH)
    bmaps = [maps[k].bfloat16() for k in ("p2", "p3", "semantic")]
    totals = {}
    for name, rois, bias, per_forward, args in stages:
        scales, out, ratios, pools = args

        def unfused(rois=rois, bias=bias):
            acc = None
            for m, sc, sr, pf in zip(bmaps, scales, ratios, pools):
                t = roi_align(m, rois, sc, out, sampling_ratio=sr, pool_from=pf)
                acc = t if acc is None else acc + t
            return acc + bias.to(acc.dtype)[:, :, None, None, :]

        def fused(r, bias=bias):
            return lambda: roi_align_sum(bmaps, r, *args, bias=bias)

        variants = {
            "fused": fused(rois),
            "unfused": unfused,
            "large last": fused(by_area(rois, False)),
            "large first": fused(by_area(rois, True)),
            "no large boxes": fused(without_large(rois)),
        }
        for vname, fn in variants.items():
            ev, dev = cuda_ms(fn), graph_ms(fn)
            print(f"K4 {name} R{rois.shape[1]} out {out} {vname}: events {ev:.4f} ms, "
                  f"device (graph) {dev:.4f} ms", flush=True)
            t = totals.setdefault(vname, [0.0, 0.0])
            t[0] += ev * per_forward
            t[1] += dev * per_forward
    for vname, (ev, dev) in totals.items():
        print(f"K4 per forward {vname}: events {ev:.4f} ms, device (graph) {dev:.4f} ms",
              flush=True)


def bench_k3(device):
    mask = torch.from_numpy(blob_mask(np.random.RandomState(0), BATCH, 512, 400)).to(device)
    lab = comp.label_components_raw(mask)
    roots, _ = comp.first_roots(lab, mask, 512)
    fn = lambda: comp.component_stats(lab, roots)  # noqa: E731
    print(f"K3 B{BATCH} 512x512 K512: events {cuda_ms(fn):.4f} ms, "
          f"device (graph) {graph_ms(fn):.4f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    bench_k3(device)
    bench_k4(device)


if __name__ == "__main__":
    main()
