"""Deep features per whole-slide patch → HDF5 + .npy bags (the command line
of tools/extract_features_nuhtc.py, as a module): the backbone and FPN run on
each tissue tile, and each coordinate gets one vector, the concatenation of
every FPN level's spatial mean (4 × 64 = 256 values at the PanNuke config).

Tiles go ``tile_stream`` → stain normalization / resize on the host →
``engine.preprocess`` (the host preprocess of the strict path) →
``model.extract_feats`` on the card (the Swin blocks through K1) → mean over
H, W per level → concatenation. ``embed_batch`` is that per-batch work;
``iter_slide_features`` streams it over a slide; ``write_slide_features``
appends each batch to an .h5 file, which needs h5py.

Reference mode:
  python -m nuhtc_tpu_torch.tools.extract_features_nuhtc --config CFG [--checkpoint CKPT] \\
      --data_h5_dir DIR --data_slide_dir DIR --csv_path list.csv --feat_dir OUT \\
      [--slide_ext .svs] [--batch_size 16] [--no_auto_skip] [--stain_norm] \\
      [--custom_downsample 2] [--target_patch_size 256] [--device cpu]
  walks the CSV's ``slide_id`` rows, reads coords from DIR/patches/<slide>.h5
  (with patch_level/patch_size attrs), writes OUT/h5_files/<slide>.h5
  (features + coords) and OUT/pt_files/<slide>.npy, skipping slides whose
  .npy exists unless --no_auto_skip.
Legacy positional mode:
  python -m nuhtc_tpu_torch.tools.extract_features_nuhtc <wsi_dir> <config> [ckpt] --save_dir D

The model runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from nuhtc_tpu_torch.ops.imgproc import resize_u8
from nuhtc_tpu_torch.wsi.infer import tile_stream
from nuhtc_tpu_torch.wsi.stain import reinhard_normalize
from nuhtc_tpu_torch.wsi.tissue import require_h5py

TIMING_KEYS = ("read_s", "stain_resize_s", "preprocess_s", "forward_s", "pool_s")


def embed_batch(engine, tiles: Sequence[np.ndarray], level: Optional[int] = None,
                stain_norm: bool = False, resize_to: Optional[int] = None,
                timing: Optional[Dict[str, float]] = None) -> np.ndarray:
    """RGB uint8 tiles (at most the engine's batch) → (n, D) float32: each
    FPN level's mean over H and W, concatenated (or the one ``level``).
    ``timing``, when given, gathers seconds under ``TIMING_KEYS`` (with a
    device synchronization between the parts)."""
    t0 = time.perf_counter()
    proc = []
    for t in tiles:
        if stain_norm:
            t = reinhard_normalize(t)
        if resize_to is not None:
            t = resize_u8(t, (resize_to, resize_to))
        proc.append(t)
    t1 = time.perf_counter()
    batch = engine.preprocess(proc)
    t2 = time.perf_counter()
    x = torch.from_numpy(batch).to(engine.device).to(engine.dtype)
    feats = engine.model.extract_feats(x)
    if timing is not None and engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t3 = time.perf_counter()
    with torch.no_grad():
        levels = feats if level is None else (feats[level],)
        pooled = torch.cat([f.float().mean(dim=(1, 2)) for f in levels], dim=1)
        out = pooled[:len(tiles)].cpu().numpy()
    t4 = time.perf_counter()
    if timing is not None:
        for key, dt in zip(TIMING_KEYS[1:], (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            timing[key] = timing.get(key, 0.0) + dt
    return out


def iter_slide_features(engine, slide, coords: np.ndarray, patch_size: int,
                        patch_level: int = 0, level: Optional[int] = None,
                        target_patch_size: int = -1, custom_downsample: int = 1,
                        stain_norm: bool = False, timing: Optional[Dict[str, float]] = None,
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (features (n, D), coords (n, 2)) per batch of tiles over the
    slide, in coordinate order. A tile is resized to ``target_patch_size``
    when that is positive, else to patch_size / ``custom_downsample`` when
    that is above 1."""
    if target_patch_size > 0:
        resize_to = int(target_patch_size)
    elif custom_downsample > 1:
        resize_to = int(patch_size) // int(custom_downsample)
    else:
        resize_to = None
    t = time.perf_counter()
    for tiles, bc in tile_stream(slide, coords, int(patch_size), patch_level=int(patch_level),
                                 batch_size=engine.batch_size):
        if timing is not None:
            timing["read_s"] = timing.get("read_s", 0.0) + time.perf_counter() - t
        yield embed_batch(engine, tiles, level, stain_norm, resize_to, timing), np.asarray(bc)
        t = time.perf_counter()


def write_slide_features(out_h5: str, batches) -> int:
    """Appends each (features, coords) batch to ``out_h5`` (created anew,
    datasets "features" and "coords" growable along axis 0); returns the
    count of rows."""
    h5py = require_h5py()
    mode, n = "w", 0
    for f, bc in batches:
        with h5py.File(out_h5, mode) as hf:
            if mode == "w":
                hf.create_dataset("features", data=f, maxshape=(None, f.shape[1]))
                hf.create_dataset("coords", data=bc, maxshape=(None, 2))
            else:
                for k, v in (("features", f), ("coords", bc)):
                    d = hf[k]
                    d.resize(d.shape[0] + len(v), axis=0)
                    d[-len(v):] = v
        mode = "a"
        n += len(f)
    return n


def _engine(args):
    from nuhtc_tpu_torch.apis.inference import init_detector

    return init_detector(args.config, args.checkpoint, batch_size=args.batch_size,
                         device=args.device)


def _run_reference_mode(args):
    from nuhtc_tpu_torch.utils.tables import read_csv_rows
    from nuhtc_tpu_torch.wsi.slide import open_slide
    from nuhtc_tpu_torch.wsi.tissue import load_coords_h5

    rows = read_csv_rows(args.csv_path)
    os.makedirs(os.path.join(args.feat_dir, "pt_files"), exist_ok=True)
    os.makedirs(os.path.join(args.feat_dir, "h5_files"), exist_ok=True)
    dest = set(os.listdir(os.path.join(args.feat_dir, "pt_files")))
    engine = _engine(args)

    total = len(rows)
    for i, row in enumerate(rows):
        slide_id = str(row["slide_id"]).split(args.slide_ext)[0]
        print(f"\nprogress: {i}/{total}\n{slide_id}")
        if not args.no_auto_skip and slide_id + ".npy" in dest:
            print(f"skipped {slide_id}")
            continue
        h5_path = os.path.join(args.data_h5_dir, "patches", slide_id + ".h5")
        slide_path = os.path.join(args.data_slide_dir, slide_id + args.slide_ext)
        out_h5 = os.path.join(args.feat_dir, "h5_files", slide_id + ".h5")
        try:
            coords, attrs = load_coords_h5(h5_path)
            slide = open_slide(slide_path)
            t0 = time.time()
            write_slide_features(out_h5, iter_slide_features(
                engine, slide, coords, patch_size=attrs.get("patch_size", args.patch_size),
                patch_level=attrs.get("patch_level", 0), level=args.level,
                target_patch_size=args.target_patch_size,
                custom_downsample=args.custom_downsample, stain_norm=args.stain_norm))
            with require_h5py().File(out_h5, "r") as hf:
                feats = hf["features"][:]
            print(f"computing features for {out_h5} took {time.time() - t0:.1f} s")
            print("features size: ", feats.shape)
            np.save(os.path.join(args.feat_dir, "pt_files", slide_id + ".npy"), feats)
        except Exception as e:  # one bad slide is logged and the list goes on
            print("ERROR:", slide_id)
            print(f"Exception: {e}")


def _run_legacy_mode(args):
    from nuhtc_tpu_torch.wsi.slide import open_slide
    from nuhtc_tpu_torch.wsi.tissue import load_coords_h5

    engine = _engine(args)
    os.makedirs(os.path.join(args.save_dir, "features"), exist_ok=True)
    slides = sorted(
        f for f in os.listdir(args.source) if os.path.isfile(os.path.join(args.source, f))
    )
    for slide_name in slides:
        slide_id = os.path.splitext(slide_name)[0]
        h5_path = os.path.join(args.save_dir, "patches", slide_id + ".h5")
        if not os.path.exists(h5_path):
            print(f"skip {slide_id}: no coords")
            continue
        coords, attrs = load_coords_h5(h5_path)
        slide = open_slide(os.path.join(args.source, slide_name))
        out = os.path.join(args.save_dir, "features", slide_id + ".h5")
        n = write_slide_features(out, iter_slide_features(
            engine, slide, coords, patch_size=attrs.get("patch_size", args.patch_size),
            patch_level=attrs.get("patch_level", 0), level=args.level,
            stain_norm=args.stain_norm))
        print(f"{slide_id}: {n} patches → {out}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.extract_features_nuhtc",
                                 description="Feature Extraction")
    ap.add_argument("source", nargs="?", default=None, help="(legacy mode) directory of slides")
    ap.add_argument("config_pos", nargs="?", default=None, help="(legacy mode) config path")
    ap.add_argument("checkpoint_pos", nargs="?", default=None)
    ap.add_argument("--config", default=None, help="config file (reference mode)")
    ap.add_argument("--checkpoint", default=None, help="checkpoint file (reference mode)")
    ap.add_argument("--data_h5_dir", default=None, help="dir with patches/<slide>.h5 coords")
    ap.add_argument("--data_slide_dir", default=None)
    ap.add_argument("--slide_ext", default=".svs")
    ap.add_argument("--csv_path", default=None, help="process list with slide_id column")
    ap.add_argument("--feat_dir", default=None, help="output root: h5_files/ + pt_files/")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--no_auto_skip", action="store_true")
    ap.add_argument("--stain_norm", action="store_true",
                    help="Reinhard-normalize tiles before embedding")
    ap.add_argument("--custom_downsample", type=int, default=1)
    ap.add_argument("--target_patch_size", type=int, default=-1)
    ap.add_argument("--save_dir", default="results", help="(legacy mode)")
    ap.add_argument("--patch_size", type=int, default=256,
                    help="fallback when the coords h5 lacks the attr")
    ap.add_argument("--level", type=int, default=None,
                    help="pool a single FPN level instead of the all-level concat")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device; 'cpu' to run there)")
    args = ap.parse_args(argv)

    if args.csv_path is not None:
        if not (args.config and args.data_h5_dir and args.data_slide_dir and args.feat_dir):
            sys.exit("reference mode needs --config --data_h5_dir --data_slide_dir --feat_dir")
        _run_reference_mode(args)
    else:
        if not (args.source and args.config_pos):
            sys.exit("usage: extract_features_nuhtc <wsi_dir> <config> [ckpt] --save_dir D "
                     "(or the reference --csv_path mode)")
        args.config = args.config_pos
        args.checkpoint = args.checkpoint_pos
        _run_legacy_mode(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
