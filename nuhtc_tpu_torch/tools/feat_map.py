"""FPN feature maps / pooled feature vectors per image (the command line of
tools/feat_map.py, as a module; reference tools/feat_map.py:23-47
single_gpu_feat).

Two input modes:
- an explicit path (a file, or a directory of PNGs) → every FPN level's map
  of the image as ``<out>/<name>_fpn.npz`` (``level<i>``: (H, W, C) float32,
  the layout the JAX tool saves); ``--vis`` adds ``<name>_level<i>.png``, the
  channel mean scaled to 0..255 through OpenCV's viridis map
  (``utils.visualize.apply_viridis``); ``--pooled`` saves instead the
  reference's vector, every level's spatial mean concatenated, as
  ``<name>.npy``;
- no path → the config's test dataset, one pooled ``<out>/<img_name>.npy``
  per image (the reference's behaviour), ``--batch-size`` images a forward.

  python -m nuhtc_tpu_torch.tools.feat_map <img_or_dir> <config> [ckpt] --out featmaps/
  python -m nuhtc_tpu_torch.tools.feat_map --config CFG --checkpoint CKPT --out featmaps/ \\
      [--cfg-options data.test.ann_file=...] [--device cpu]

The backbone and FPN (``NuHTC.extract_feats``; the Swin blocks through K1 on
the card) run on the first CUDA device and raise without one; ``--device
cpu`` asks for the CPU. The port's maps are channels-last (B, H, W, C), as
the JAX package's are: a level is pooled over axes 1 and 2.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from nuhtc_tpu_torch.tools.extract_features_nuhtc import embed_batch
from nuhtc_tpu_torch.utils.imageio import read_image, write_png
from nuhtc_tpu_torch.utils.visualize import apply_viridis


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Dump FPN feature maps or pooled vectors")
    ap.add_argument("path", nargs="?", default=None,
                    help="image file or dir; omit to walk the config's test dataset")
    ap.add_argument("config_pos", nargs="?", default=None)
    ap.add_argument("checkpoint_pos", nargs="?", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="featmaps")
    ap.add_argument("--name", default=None,
                    help="subdirectory name under --out (reference --name)")
    ap.add_argument("--pooled", action="store_true",
                    help="save the reference's pooled all-level vector instead "
                    "of full maps")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="config overrides, key=value with dotted keys")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--vis", action="store_true", help="also save mean-activation PNGs")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def level_maps(engine, img: np.ndarray) -> list:
    """One RGB uint8 image → each FPN level's map, (H, W, C) float32."""
    batch = engine.preprocess([img])[:1]
    x = torch.from_numpy(batch).to(engine.device).to(engine.dtype)
    with torch.no_grad():
        return [f[0].float().cpu().numpy() for f in engine.model.extract_feats(x)]


def mean_activation_u8(fmap: np.ndarray) -> np.ndarray:
    """(H, W, C) map → its channel mean scaled to 0..255 and truncated to uint8."""
    m = fmap.mean(-1)
    return (255 * (m - m.min()) / max(m.max() - m.min(), 1e-9)).astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import init_detector, resolve_device
    from nuhtc_tpu_torch.config import Config

    # positional (path cfg [ckpt]) or flag (--config/--checkpoint) invocation
    config = args.config or args.config_pos
    checkpoint = args.checkpoint or args.checkpoint_pos
    if config is None and args.path and args.config_pos is None:
        # flag-style: the single positional is actually the config
        config, args.path = args.path, None
    if config is None:
        sys.exit("need a config (positional or --config)")

    device = resolve_device(args.device, "feat_map")
    cfg = Config.fromfile(config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    engine = init_detector(cfg, checkpoint, batch_size=args.batch_size, device=device)

    out_dir = os.path.join(args.out, args.name) if args.name else args.out
    os.makedirs(out_dir, exist_ok=True)

    if args.path is None:
        # dataset mode (reference single_gpu_feat): pooled vector per image
        from nuhtc_tpu_torch.data.coco import build_dataset

        dataset = build_dataset({**cfg.data.test, "test_mode": True})
        for start in range(0, len(dataset), args.batch_size):
            idxs = range(start, min(start + args.batch_size, len(dataset)))
            vecs = embed_batch(engine, [dataset.load_image(i) for i in idxs])
            for i, vec in zip(idxs, vecs):
                name = os.path.splitext(os.path.basename(dataset.img_info(i)["file_name"]))[0]
                np.save(os.path.join(out_dir, f"{name}.npy"), vec)
            print(f"\r{min(start + args.batch_size, len(dataset))}/{len(dataset)}",
                  end="", flush=True)
        print(f"\npooled features → {out_dir}")
        return 0

    paths = (sorted(glob.glob(os.path.join(args.path, "*.png")))
             if os.path.isdir(args.path) else [args.path])
    for p in paths:
        img = read_image(p)
        name = os.path.splitext(os.path.basename(p))[0]
        if args.pooled:
            np.save(os.path.join(out_dir, f"{name}.npy"), embed_batch(engine, [img])[0])
        else:
            maps = level_maps(engine, img)
            np.savez(os.path.join(out_dir, f"{name}_fpn.npz"),
                     **{f"level{i}": m for i, m in enumerate(maps)})
            if args.vis:
                for i, m in enumerate(maps):
                    write_png(os.path.join(out_dir, f"{name}_level{i}.png"),
                              apply_viridis(mean_activation_u8(m)))
        print(f"{name}: saved")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
