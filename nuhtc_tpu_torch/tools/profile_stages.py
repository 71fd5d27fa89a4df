"""Where a serve step's time goes, per stage, for both engine contracts.

    python -m nuhtc_tpu_torch.tools.profile_stages

Runs on the first CUDA device (it fails without one). For WSI mode (device
preprocess, compact label maps, Swin tier "block") and for the strict patch
path (host preprocess, one full-frame mask per detection, Swin tier "attn"),
on the PanNuke config with random weights from a seed and the
positive-objectness logit raised so detections exist, it prints:

- ``run_batch`` as it is, host clock, mean over the batches (tiles/s);
- the same batches under ``utils.profiling.trace``, with no added
  synchronisation: each span of the engine and the model (``engine.upload``,
  ``engine.prep``, ``model.backbone``, ``model.neck``, ``model.rpn_head``,
  ``model.rpn_proposals``, ``model.semantic``, ``model.components``, the
  cascade's ``model.bbox_stage``, ``model.multiclass_nms``,
  ``model.mask_head``, ``engine.paste``, and ``collect``'s ``engine.wait``,
  ``engine.download`` and ``engine.split``) a batch: its host time, its self
  time, the device time of the work it launched and the device idle while
  the host was in it (``profiling.span_table``); the fixpoints' rounds a
  batch; the device idle in no span, and the device records that start
  before their launch (0 when the clocks agree);
- over those batches: the device's summed kernel and copy time, the idle
  share that leaves of an untraced batch, the kernels with the most device
  time, and every kernel of ``csrc/`` with its time per launch (the Swin
  kernels' template arguments name the width; K4 is
  ``roi_align_sum_kernel``, 4 launches a forward, K3 ``strip_stats_kernel``
  and ``reduce_strips_kernel``).
The card's name and power limit are printed first, then one JSON line per
contract.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

from nuhtc_tpu_torch import kernels
from nuhtc_tpu_torch.apis import inference
from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_tiles
from nuhtc_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_swin_fpn_pannuke.py")
BATCH, TIMED_BATCHES = 16, 3  # one warm-up batch comes first


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

    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace("stages", log_dir=log_dir) as prof:
            for tiles in batches[1:]:
                engine.run_batch(tiles)
        with open(os.path.join(log_dir, "stages.pt.trace.json")) as f:
            table = profiling.span_table(json.load(f)["traceEvents"], "stages")
    stages = {k: {m: (v / steps if m == "count" else 1e3 * v / steps) for m, v in row.items()}
              for k, row in table["spans"].items()}
    rounds = {k: v / steps for k, v in profiling.COUNTERS.items()}
    # device-side events only: an aten op's row repeats its kernels' time,
    # and a span's device row the kernels it encloses
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in table["spans"] and e.key != "stages"]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)

    print(f"== {name}: run_batch {1e3 * wall:.1f} ms per batch of {batch_size} = "
          f"{batch_size / wall:.2f} tiles/s; {n_det / (steps * batch_size):.2f} detections/tile; "
          f"collect: device wait {1e3 * split['device_s']:.1f} ms, download "
          f"{1e3 * split['download_s']:.1f} ms", flush=True)
    print("   a batch, ms: host, self, device launched, device idle; span (count)")
    for k, v in stages.items():
        print(f"   {v['host_s']:8.2f} {v['self_s']:8.2f} {v['device_s']:8.2f} {v['idle_s']:8.2f}"
              f"  {k} ({v['count']:g})")
    print(f"   counters a batch: {rounds}")
    idle, dev = max(table["idle_s"], 1e-12), max(table["device_s"], 1e-12)
    print(f"   device idle in no span {table['uncovered_idle_s'] / idle:.4f} of the idle; device "
          f"work launched in no span {table['unspanned_device_s'] / dev:.4f} of the work; "
          f"records before their launch {table['early_starts']}")
    # the traced batches' wall holds the profiler's cost: the idle share is
    # taken against the untraced batches' mean
    print(f"   traced batches: device time (kernels and copies) {device_ms:.2f} ms a batch, "
          f"idle share of a {1e3 * wall:.1f} ms batch {1 - device_ms / (1e3 * wall):.3f}")
    for key, ms, count in rows[:14]:
        print(f"   {ms:9.3f} ms  x{count:<7g} {key[:100]}")
    # the port's own kernels (the __global__ functions of csrc/*.cu), whatever their rank
    names = set()
    for src in kernels.SOURCES:
        with open(os.path.join(kernels.CSRC, src)) as f:
            names.update(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(",
                                    f.read()))
    own = [r for r in rows if "(anonymous namespace)::" in r[0]
           and r[0].split("(anonymous namespace)::")[1].split("<")[0].split("(")[0] in names]
    print(f"   the port's kernels a batch: {sum(r[1] for r in own):.3f} ms")
    for key, ms, count in own:
        short = key.split("(anonymous namespace)::")[1].split("(")[0]
        print(f"   {ms:9.3f} ms  x{count:<7g} {1e3 * ms / count:9.1f} us each  {short}")
    print(json.dumps({"contract": name, "batch_ms": 1e3 * wall, "tiles_per_s": batch_size / wall,
                      "detections_per_tile": n_det / (steps * batch_size),
                      "collect_ms": {k: 1e3 * v for k, v in split.items()}, "stages": stages,
                      "counters": rounds, "uncovered_idle_s": table["uncovered_idle_s"],
                      "early_starts": table["early_starts"],
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
