"""Whole-slide inference with the PyTorch port (the command line of
tools/infer_wsi.py, as a module).

Stage A: tissue segmentation + patch grid (+ optional mask/stitch previews);
Stage B: streamed tile inference on the GPU → per-nucleus
GeoJSON/DSA/COCO/SQLite.

Usage:
  python -m nuhtc_tpu_torch.tools.infer_wsi <wsi_dir> <config> [checkpoint] \\
      --patch --seg --stitch --save_dir results --mode qupath

Stage B runs on the first CUDA device and raises without one; ``--device cpu``
asks for the CPU. On a GPU the engine runs in WSI mode (tiles preprocessed on
the device, one compact label map per tile), on the CPU in the strict
contract (host preprocess, one full-frame mask per detection).

Stage A hands the patch grid to stage B through ``patches/<slide>.h5``
(h5py). From Python, ``main(argv, coords={})`` keeps it in that dict by
slide instead and writes no .h5: for a host without h5py.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from nuhtc_tpu_torch.utils.tables import read_csv_rows, write_csv_rows


def main(argv: Optional[Sequence[str]] = None, coords: Optional[dict] = None) -> int:
    """``coords`` (from Python only): a dict that holds stage A's patch grid
    by slide in place of the .h5 files."""
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.infer_wsi")
    ap.add_argument("source")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--step_size", type=int, default=192)
    ap.add_argument("--patch_size", type=int, default=256)
    ap.add_argument("--patch", action="store_true")
    ap.add_argument("--seg", action="store_true")
    ap.add_argument("--stitch", action="store_true")
    ap.add_argument("--no_auto_skip", action="store_true")
    ap.add_argument("--save_dir", default="results")
    ap.add_argument("--mag", type=int, default=40)
    ap.add_argument("--patch_level", type=int, default=0,
                    help="pyramid level to read tiles at (reference --patch_level)")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_workers", type=int, default=2)
    ap.add_argument("--margin", type=int, default=0)
    ap.add_argument("--min_area", type=int, default=10)
    ap.add_argument("--score-thr", type=float, default=0.0, dest="score_thr",
                    help="drop detections below this score before export "
                    "(reference --score-thr; its 0.35 applies to --det overlays "
                    "only — export there is unthresholded, so default 0)")
    ap.add_argument("--slide_ext", default=".svs")
    ap.add_argument("--mode", default="qupath", choices=["qupath", "dsa", "coco", "sql", "all"])
    ap.add_argument("--use_otsu", action="store_true")
    ap.add_argument("--det", action="store_true",
                    help="save per-tile detection-overlay jpgs under "
                    "nuclei/<slide>/infer/ (reference --det)")
    ap.add_argument("--preset", default=None,
                    help="CSV of seg/filter/patch parameter overrides "
                    "(reference --preset: columns sthresh/mthresh/close/use_otsu/"
                    "a_t/a_h/max_n_holes/use_padding; first row applies)")
    ap.add_argument("--process_list", default=None,
                    help="CSV with a slide_id column (+ optional process flag and "
                    "per-slide seg params) restricting/refining the run "
                    "(reference --process_list)")
    ap.add_argument("--shard", default=None, metavar="I/N",
                    help="process slide subset i of n (multi-host scale-out: "
                    "slides are embarrassingly parallel — launch one process "
                    "per host/GPU with --shard 0/4 … 3/4; the reference's "
                    "DDP analog for WSI inference)")
    ap.add_argument("--device", default=None,
                    help="device of stage B: default the first CUDA device (an error "
                    "without one); 'cpu' for the CPU")
    args = ap.parse_args(argv)

    from nuhtc_tpu_torch.apis.inference import init_detector, resolve_device
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.classes import dataset_classes
    from nuhtc_tpu_torch.utils.imageio import write_jpg, write_png
    from nuhtc_tpu_torch.wsi.infer import infer_slide
    from nuhtc_tpu_torch.wsi.slide import open_slide
    from nuhtc_tpu_torch.wsi.stitch import stitch_coords, vis_tissue_mask
    from nuhtc_tpu_torch.wsi.tissue import (
        grid_coords, load_coords_h5, save_coords_h5, segment_tissue)

    device = resolve_device(args.device, "infer_wsi")

    for sub in ("patches", "masks", "stitches", "nuclei"):
        os.makedirs(os.path.join(args.save_dir, sub), exist_ok=True)

    cfg = Config.fromfile(args.config)
    # test-time rescale follows magnification: scale_factor = 80 / mag
    scale_factor = 80.0 / args.mag
    classes = dataset_classes(cfg.get("dataset", "PanNukeCocoDataset"))

    # seg/filter/patch params: built-in defaults ← --preset CSV ← per-slide
    # process_list columns (reference precedence, tools/infer_wsi.py:133-159,392-404)
    seg_keys = ("sthresh", "mthresh", "close", "use_otsu", "a_t", "a_h", "max_n_holes")
    base_seg = dict(use_otsu=args.use_otsu)
    base_patch = {}
    if args.preset:
        row = read_csv_rows(args.preset)[0]
        base_seg.update({k: row[k] for k in seg_keys if k in row})
        if "use_padding" in row:
            base_patch["use_padding"] = bool(row["use_padding"])

    slides = sorted(
        f for f in os.listdir(args.source) if os.path.isfile(os.path.join(args.source, f))
    )
    per_slide: dict = {}
    if args.process_list:
        listed = []
        for r in read_csv_rows(args.process_list):
            if "process" in r and r["process"] != 1:
                continue
            sid = str(r["slide_id"])
            matches = [s for s in slides if s == sid or os.path.splitext(s)[0] == sid]
            for s in matches:
                listed.append(s)
                per_slide[s] = {k: r[k] for k in seg_keys if r.get(k) is not None}
        slides = listed
    if args.shard:
        i, n = (int(x) for x in args.shard.split("/"))
        if not 0 <= i < n:
            raise ValueError(f"--shard {args.shard}: the index must lie in [0, {n})")
        slides = slides[i::n]
        print(f"shard {i}/{n}: {len(slides)} slides")
    status_rows = []

    # ---------------- Stage A: seg + patch + stitch ----------------------
    for slide_name in slides:
        slide_id = os.path.splitext(slide_name)[0]
        h5_path = os.path.join(args.save_dir, "patches", slide_id + ".h5")
        row = dict(slide_id=slide_name, status="processed")
        done = slide_id in coords if coords is not None else os.path.exists(h5_path)
        if not args.no_auto_skip and done:
            row["status"] = "already_exist"
            status_rows.append(row)
            continue
        slide = open_slide(os.path.join(args.source, slide_name))
        t0 = time.time()
        seg_kw = {**base_seg, **per_slide.get(slide_name, {})}
        seg_kw["use_otsu"] = bool(seg_kw.get("use_otsu", False))
        seg = segment_tissue(slide, **seg_kw)
        seg_t = time.time() - t0
        if args.seg:
            vis = vis_tissue_mask(slide, seg)
            write_png(os.path.join(args.save_dir, "masks", slide_id + ".png"), vis)
        t0 = time.time()
        grid = grid_coords(slide, seg, args.patch_size, args.step_size,
                           patch_level=args.patch_level, **base_patch)
        patch_t = time.time() - t0
        if args.patch and coords is not None:
            coords[slide_id] = grid
        elif args.patch:
            save_coords_h5(
                h5_path, grid,
                attrs=dict(patch_size=args.patch_size, step_size=args.step_size,
                           patch_level=args.patch_level, name=slide_id),
            )
        stitch_t = 0.0
        if args.stitch and len(grid):
            t0 = time.time()
            mosaic = stitch_coords(slide, grid, args.patch_size)
            write_jpg(os.path.join(args.save_dir, "stitches", slide_id + ".jpg"), mosaic)
            stitch_t = time.time() - t0
        print(
            f"{slide_id}: {len(grid)} patches "
            f"(seg {seg_t:.1f}s, patch {patch_t:.1f}s, stitch {stitch_t:.1f}s)"
        )
        row.update(n_patches=len(grid), seg_time=seg_t, patch_time=patch_t)
        status_rows.append(row)
    status_csv = "process_list_autogen.csv" if not args.shard else (
        f"process_list_autogen_shard{args.shard.replace('/', '_')}.csv"
    )
    write_csv_rows(os.path.join(args.save_dir, status_csv), status_rows)

    # ---------------- Stage B: tile inference ---------------------------
    # device-side preprocess + compact label-map transfer: the WSI throughput
    # path (uint8 tiles up, one int32 label map per tile down)
    on_device = device.type != "cpu"
    engine = init_detector(
        cfg, args.checkpoint, batch_size=args.batch_size, scale_factor=scale_factor,
        device=device, device_preprocess=on_device, compact_masks=on_device,
        tile_size=args.patch_size,
    )

    for slide_name in slides:
        slide_id = os.path.splitext(slide_name)[0]
        h5_path = os.path.join(args.save_dir, "patches", slide_id + ".h5")
        if not (slide_id in coords if coords is not None else os.path.exists(h5_path)):
            print(f"skip {slide_id}: no coord file")
            continue
        nuclei_dir = os.path.join(args.save_dir, "nuclei", slide_id)
        if os.path.exists(os.path.join(nuclei_dir, f"{slide_id}_merged.geojson")):
            print(f"skip {slide_id}: existing results")
            continue
        grid = coords[slide_id] if coords is not None else load_coords_h5(h5_path)[0]
        slide = open_slide(os.path.join(args.source, slide_name))
        stats = infer_slide(
            engine, slide, grid, nuclei_dir, slide_id, classes,
            patch_size=args.patch_size, patch_level=args.patch_level,
            mode=args.mode, margin=args.margin, min_area=args.min_area,
            score_thr=args.score_thr,
            det_dir=os.path.join(nuclei_dir, "infer") if args.det else None,
            num_read_threads=args.num_workers,
        )
        print(f"{slide_id}: {stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
