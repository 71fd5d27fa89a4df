"""The train pipeline's output drawn for inspection (port of
tools/misc/browse_dataset.py; reference tools/misc/browse_dataset.py).

    python -m nuhtc_tpu_torch.tools.misc.browse_dataset CONFIG --out vis/ --num 8 [--no-aug]

Draws ``--num`` samples of the config's train set (class-aware sampling
where the set is a ``CASDataset``) through its ``train_pipeline`` (none with
``--no-aug``) with the draws of ``np.random.RandomState(--seed)``, as the
JAX tool draws them; a normalised image is taken back to pixels. Each
instance's outline and box are drawn in its class colour
(``utils.visualize.draw_detections``) and the image written as
``{out}/sample_{k}_{index}.png`` (``utils.imageio.write_png``). Host only.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def render_samples(config: str, num: int, no_aug: bool = False, seed: int = 0):
    """Yields (name, RGB uint8 drawing) for each sample."""
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.data.loader import CASDataset, prepare_train_sample
    from nuhtc_tpu_torch.data.pipelines import IMG_NORM, build_train_pipeline
    from nuhtc_tpu_torch.utils.visualize import draw_detections

    cfg = Config.fromfile(config)
    ds = build_dataset(cfg.to_dict()["data"]["train"])
    inner = ds.dataset if isinstance(ds, CASDataset) else ds
    pipeline = [] if no_aug else build_train_pipeline(cfg.to_dict().get("train_pipeline", []))
    rng = np.random.RandomState(seed)
    for k in range(num):
        idx = ds.sample_index(rng) if isinstance(ds, CASDataset) else rng.randint(len(inner))
        r = prepare_train_sample(inner, idx, pipeline, rng)
        img = r["img"]
        if img.max() <= 20:  # normalised: back to pixels for display
            img = img * np.asarray(IMG_NORM["std"]) + np.asarray(IMG_NORM["mean"])
        img = np.clip(img, 0, 255).astype(np.uint8)
        vis = draw_detections(img, list(r.get("gt_masks", [])), r.get("gt_labels", []),
                              boxes=r.get("gt_bboxes"), palette=getattr(inner, "PALETTE", None),
                              draw_boxes=True)
        yield f"sample_{k}_{idx}.png", vis


def main(argv: Optional[Sequence[str]] = None) -> int:
    from nuhtc_tpu_torch.utils.imageio import write_png

    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.misc.browse_dataset")
    ap.add_argument("config")
    ap.add_argument("--out", default="vis")
    ap.add_argument("--num", type=int, default=8)
    ap.add_argument("--no-aug", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name, vis in render_samples(args.config, args.num, args.no_aug, args.seed):
        write_png(os.path.join(args.out, name), vis)
    print(f"wrote {args.num} samples to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
