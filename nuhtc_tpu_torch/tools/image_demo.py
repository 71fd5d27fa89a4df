"""Single-image demo (the command line of tools/image_demo.py, as a module;
reference demo/image_demo.py): runs the detector on one image (or every file
of a glob) and saves ``<name>_demo.png``, the overlay of the detections at or
above ``--score-thr``, and ``<name>.json`` with their boxes, scores and labels.

  python -m nuhtc_tpu_torch.tools.image_demo demo/imgs/242.png <config> [ckpt] \\
      --output out/ [--score-thr 0.3] [--device cpu]

The model runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

from nuhtc_tpu_torch.utils.imageio import read_image, write_png
from nuhtc_tpu_torch.utils.visualize import draw_detections


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run the detector on one image or a glob")
    ap.add_argument("img", help="image file or glob")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--output", default="demo_out")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import init_detector

    engine = init_detector(args.config, args.checkpoint, batch_size=1, device=args.device)
    os.makedirs(args.output, exist_ok=True)
    for p in sorted(glob.glob(args.img)) or [args.img]:
        img = read_image(p)
        res = engine.run_batch([img])[0]
        keep = res["scores"] >= args.score_thr
        overlay = draw_detections(
            img, [m for m, k in zip(res["masks"], keep) if k],
            list(res["labels"][keep]), scores=list(res["scores"][keep]))
        name = os.path.splitext(os.path.basename(p))[0]
        write_png(os.path.join(args.output, f"{name}_demo.png"), overlay)
        with open(os.path.join(args.output, f"{name}.json"), "w") as f:
            json.dump({"boxes": res["boxes"][keep].tolist(),
                       "scores": res["scores"][keep].tolist(),
                       "labels": res["labels"][keep].tolist()}, f)
        print(f"{name}: {int(keep.sum())} nuclei ≥ {args.score_thr}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
