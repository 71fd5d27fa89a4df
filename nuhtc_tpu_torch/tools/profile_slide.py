"""Where a whole-slide run spends its time, on the GPU.

    python -m nuhtc_tpu_torch.tools.profile_slide [--side 2304] [--repeats 2]

Drives ``wsi.infer.infer_slide`` (WSI mode, PanNuke config, B16, bf16, random
weights from a seed, ``mode="all"``) over the synthetic slide of
``tools/synthetic.py``, once with the numpy RLE code and once with the C
library (``ops.rle.NATIVE``), ``--repeats`` times each in turn, and prints
for every run the wall time, tiles/s, ``infer_slide``'s own attribution
(read_wait / dispatch / collect with its device wait and download / post)
and, from a ``utils.profiling.trace`` of the run, each span's host time,
self time and device idle (``profiling.span_table``): ``wsi.read_wait``, the
engine's ``engine.dispatch`` and ``engine.collect`` with their children,
``wsi.post`` with ``wsi.filter``, ``wsi.rle``, ``wsi.mask_nms``,
``wsi.contours`` and ``wsi.export`` (``exporter.close`` too), ``wsi.slide``'s
self time; the detections entering post and the nuclei leaving it; the
device idle in no span, and the device records that start before their
launch (0 when the clocks agree). All runs are traced. The card's name and
power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.profile_slide")
    ap.add_argument("--side", type=int, default=2304)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.data.classes import dataset_classes
    from nuhtc_tpu_torch.ops import rle
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, slide_and_grid
    from nuhtc_tpu_torch.utils import profiling
    from nuhtc_tpu_torch.wsi import infer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    config = os.path.join(repo, "configs", "nuhtc", "htc_lite_swin_fpn_pannuke.py")
    slide, seg, coords, stage_a = slide_and_grid(args.side)
    print(f"stage A: {len(coords)} tiles, {len(seg.contours)} regions in {stage_a:.3f} s", flush=True)
    engine = init_detector(config, None, batch_size=args.batch_size, device_preprocess=True,
                           compact_masks=True)
    lift_objectness(engine.model)
    engine.run_batch([slide.read_region((int(x), int(y)), 0, (256, 256))
                      for x, y in coords[:args.batch_size]])  # warm-up
    torch.cuda.synchronize()

    try:
        for rep in range(args.repeats):
            for native in (False, True):
                rle.NATIVE = native
                with tempfile.TemporaryDirectory() as out_dir:
                    with profiling.trace("slide", log_dir=out_dir):
                        stats = infer.infer_slide(engine, slide, coords, out_dir, "slide",
                                                  dataset_classes("PanNukeCocoDataset"),
                                                  mode="all", progress=False)
                    with open(os.path.join(out_dir, "slide.pt.trace.json")) as f:
                        table = profiling.span_table(json.load(f)["traceEvents"], "slide")
                spans = {k: {m: round(float(v), 4) for m, v in row.items()}
                         for k, row in table["spans"].items()}
                print(json.dumps(dict(run=rep, rle="C library" if native else "numpy",
                                      **{k: round(float(v), 4) for k, v in stats.items()},
                                      counters=dict(profiling.COUNTERS), spans=spans,
                                      idle_s=round(table["idle_s"], 4),
                                      uncovered_idle_s=round(table["uncovered_idle_s"], 4),
                                      early_starts=table["early_starts"])), flush=True)
    finally:
        rle.NATIVE = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
