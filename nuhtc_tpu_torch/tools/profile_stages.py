"""Where a serve step's time goes, per stage, for both engine contracts.

    python -m nuhtc_tpu_torch.tools.profile_stages

Runs on the first CUDA device (it fails without one). For WSI mode (device
preprocess, compact label maps, Swin tier "block") and for the strict patch
path (host preprocess, one full-frame mask per detection, Swin tier "attn"),
on the PanNuke config with random weights from a seed and the
positive-objectness logit raised so detections exist, it prints:

- ``run_batch`` as it is, host clock, mean over the batches (tiles/s);
- the same batches with every stage wrapped in ``torch.cuda.synchronize()``:
  host preprocess, upload and device preprocess, backbone, FPN, RPN head,
  RPN proposals, semantic head, component proposals, the cascade's bbox
  stages, multiclass NMS, the mask branch, the paste, and ``collect``'s
  device wait, download and per-image split;
- one batch under ``torch.profiler``: the device's summed kernel and copy
  time, the idle share that leaves of an untraced batch, the kernels with
  the most device time, and every kernel of ``csrc/`` with its time per
  launch (the Swin kernels' template arguments name the width; K4 is
  ``roi_align_sum_kernel``, 4 launches a forward, K3 ``strip_stats_kernel``
  and ``reduce_strips_kernel``).
The card's name and power limit are printed first, then one JSON line per
contract.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from nuhtc_tpu_torch import kernels
from nuhtc_tpu_torch.apis import inference
from nuhtc_tpu_torch.models import detector as detector_mod
from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_tiles

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_swin_fpn_pannuke.py")
BATCH, TIMED_BATCHES = 16, 3  # one warm-up batch comes first


class StageTimer:
    """Sums synchronized wall time per stage name."""

    def __init__(self):
        self.seconds = collections.OrderedDict()

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out

        return timed


@contextlib.contextmanager
def instrumented(engine, timer: StageTimer):
    """Wraps the stages of ``engine`` and its detector; restores them after."""
    model = engine.model
    saved = []

    def patch(obj, attr, name):
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn, attr in vars(obj)))
        setattr(obj, attr, timer.wrap(name, fn))

    patch(engine, "preprocess", "host preprocess (resize, normalize, pad)")
    patch(engine, "preprocess_u8", "host uint8 batch")
    patch(engine, "_prep", "device preprocess")
    patch(model.backbone, "forward", "Swin backbone")
    patch(model.neck, "forward", "FPN")
    patch(model.rpn_head, "forward", "RPN head")
    patch(detector_mod, "rpn_proposals", "RPN proposals (top-k, NMS)")
    patch(model.roi_head.semantic_head, "forward", "semantic head")
    patch(detector_mod, "component_proposals_batched", "component proposals (CCL, K3)")
    patch(model, "_bbox_stage", "3 cascade bbox stages (RoI features + heads)")
    patch(model, "_multiclass_nms", "multiclass NMS")
    patch(model, "_mask_forward", "mask branch (RoI features + mask head)")
    patch(inference, "paste_label_map", "label-map paste")
    patch(inference, "paste_fn", "full-mask paste")
    patch(engine, "_split_results", "collect: per-image split on the host")
    patch(engine, "dispatch", "dispatch total")
    patch(engine, "collect", "collect total")
    try:
        yield
    finally:
        for obj, attr, fn, own in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)


def profile_contract(name: str, batches, batch_size: int, **engine_kw):
    engine = inference.init_detector(CONFIG, None, batch_size=batch_size, **engine_kw)
    lift_objectness(engine.model)
    engine.run_batch(batches[0])  # warm-up
    torch.cuda.synchronize()

    engine.collect_timing.update(device_s=0.0, download_s=0.0)
    t0 = time.perf_counter()
    n_det = 0
    for tiles in batches[1:]:
        n_det += sum(len(r["scores"]) for r in engine.run_batch(tiles))
    torch.cuda.synchronize()
    steps = len(batches) - 1
    wall = (time.perf_counter() - t0) / steps
    split = {k: v / steps for k, v in engine.collect_timing.items()}

    timer = StageTimer()
    with instrumented(engine, timer):
        for tiles in batches[1:]:
            engine.run_batch(tiles)
    stages = {k: 1e3 * v / steps for k, v in timer.seconds.items()}

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.run_batch(batches[1])
        torch.cuda.synchronize()
    # device-side events only: an aten op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)

    print(f"== {name}: run_batch {1e3 * wall:.1f} ms per batch of {batch_size} = "
          f"{batch_size / wall:.2f} tiles/s; {n_det / (steps * batch_size):.2f} detections/tile; "
          f"collect: device wait {1e3 * split['device_s']:.1f} ms, download "
          f"{1e3 * split['download_s']:.1f} ms", flush=True)
    for k, v in stages.items():
        print(f"   {v:9.2f} ms  {k}")
    # the traced batch's own wall holds the profiler's start-up: the idle
    # share is taken against the untraced batches' mean
    print(f"   traced batch: device time (kernels and copies) {device_ms:.2f} ms, "
          f"idle share of a {1e3 * wall:.1f} ms batch {1 - device_ms / (1e3 * wall):.3f}")
    for key, ms, count in rows[:14]:
        print(f"   {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    # the port's own kernels (the __global__ functions of csrc/*.cu), whatever their rank
    names = set()
    for src in kernels.SOURCES:
        with open(os.path.join(kernels.CSRC, src)) as f:
            names.update(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(",
                                    f.read()))
    own = [r for r in rows if "(anonymous namespace)::" in r[0]
           and r[0].split("(anonymous namespace)::")[1].split("<")[0].split("(")[0] in names]
    print(f"   the port's kernels in that batch: {sum(r[1] for r in own):.3f} ms")
    for key, ms, count in own:
        short = key.split("(anonymous namespace)::")[1].split("(")[0]
        print(f"   {ms:9.3f} ms  x{count:<5d} {1e3 * ms / count:9.1f} us each  {short}")
    print(json.dumps({"contract": name, "batch_ms": 1e3 * wall, "tiles_per_s": batch_size / wall,
                      "detections_per_tile": n_det / (steps * batch_size),
                      "collect_ms": {k: 1e3 * v for k, v in split.items()}, "stages_ms": stages,
                      "device_ms": device_ms, "idle_share": 1 - device_ms / (1e3 * wall),
                      "top_kernels": [[k[:80], ms, c] for k, ms, c in rows[:8]]}), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rng = np.random.RandomState(0)
    batches = [synthetic_tiles(rng, BATCH) for _ in range(TIMED_BATCHES + 1)]
    profile_contract("WSI mode (device preprocess, label maps, tier block)", batches, BATCH,
                     device_preprocess=True, compact_masks=True, swin_kernel="block")
    profile_contract("strict path (host preprocess, full masks, tier attn)", batches, BATCH,
                     swin_kernel="attn")


if __name__ == "__main__":
    main()
