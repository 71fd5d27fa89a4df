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

K4's backward at a train step's four calls (B8, C64 bf16 maps of 128², 64²
and 128²; three bbox-stage calls at R1024 out 7, one mask call at R256 out
14), on boxes clustered as a train step samples them
(``synthetic.clustered_roi_boxes``) and on the uniform boxes of the forward
(``synthetic.roi_boxes``): per call events and graph times, the largest
error against the plain version on f32 copies (of the gradient's scale),
whether a second call gives the same bits; per step the two launches' device
times from torch.profiler.
"""

from __future__ import annotations

import re
import subprocess

import numpy as np
import torch

from nuhtc_tpu_torch.ops import components as comp
from nuhtc_tpu_torch.ops.roi_align import (roi_align, roi_align_sum, roi_align_sum_backward,
                                           roi_align_sum_backward_plain)
from nuhtc_tpu_torch.tools.synthetic import (blob_mask, clustered_roi_boxes, roi_boxes,
                                             roi_stage_inputs)
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


TRAIN_BATCH = 8
KERNEL_NAME = re.compile(r"\w+_kernel")  # the kernel's name in a profiler key


def bench_k4_backward(device):
    from torch.profiler import ProfilerActivity, profile

    shapes = [(TRAIN_BATCH, 128, 128, 64), (TRAIN_BATCH, 64, 64, 64), (TRAIN_BATCH, 128, 128, 64)]
    scales = [0.25, 0.125, 0.25]
    stage = [(1024, (scales, 7, [2, 2, 0], [None, None, 14]))] * 3
    stage.append((256, (scales, 14, [0, 0, 0], [None, None, None])))
    for boxes, make in (("clustered", clustered_roi_boxes), ("uniform", roi_boxes)):
        rng = np.random.RandomState(0)
        calls = []
        for r, args in stage:
            rois = torch.from_numpy(make(rng, TRAIN_BATCH, r)).to(device)
            g = torch.from_numpy(rng.randn(TRAIN_BATCH, r, args[1], args[1], 64)
                                 .astype(np.float32)).to(device).bfloat16()
            calls.append((g, rois, args))
        ev_total = dev_total = 0.0
        for g, rois, args in calls:
            got, got_b = roi_align_sum_backward(g, shapes, rois, *args, True)
            again, again_b = roi_align_sum_backward(g, shapes, rois, *args, True)
            same = all(torch.equal(x, y) for x, y in zip(got + [got_b], again + [again_b]))
            want, _ = roi_align_sum_backward_plain(g.float(), shapes, rois, *args, True)
            err = max(((x.float() - w).abs().max() / w.abs().max()).item()
                      for x, w in zip(got, want))
            fn = lambda g=g, rois=rois, args=args: roi_align_sum_backward(  # noqa: E731
                g, shapes, rois, *args, True)
            ev, dev = cuda_ms(fn), graph_ms(fn)
            ev_total, dev_total = ev_total + ev, dev_total + dev
            print(f"K4 backward {boxes} R{rois.shape[1]} out {args[1]}: events {ev:.4f} ms, "
                  f"device (graph) {dev:.4f} ms, bf16 err {err:.5f} of the gradient scale, "
                  f"bit-equal twice {same}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for g, rois, args in calls:
                roi_align_sum_backward(g, shapes, rois, *args, True)
            torch.cuda.synchronize()
        split = ", ".join(f"{KERNEL_NAME.search(e.key).group()} {e.count}× "
                          f"{e.self_device_time_total / 1e3:.4f} ms" for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA and "roi" in e.key)
        print(f"K4 backward per train step, {boxes} boxes: events {ev_total:.4f} ms, device "
              f"(graph) {dev_total:.4f} ms; profiler: {split}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda", 0)
    bench_k3(device)
    bench_k4(device)
    bench_k4_backward(device)


if __name__ == "__main__":
    main()
