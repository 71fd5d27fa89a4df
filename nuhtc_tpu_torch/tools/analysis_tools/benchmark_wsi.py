"""Whole-slide stage-B throughput benchmark (port of
tools/analysis_tools/benchmark_wsi.py): a synthetic slide, the full tile
loop of ``wsi.infer.infer_slide`` (threaded reads → device forward + compact
label maps → host contours → GeoJSON export), tiles/s and where the wall
time went.

    python -m nuhtc_tpu_torch.tools.analysis_tools.benchmark_wsi [--tiles 64] \\
        [--batch-size 16] [--host-path] [--device cpu]

The slide is the JAX tool's: ``tiles / 8`` rows of 8 tiles of 256², pale
tissue with dark round blobs, from RandomState(0) (``synthetic_benchmark_slide``),
written as a PNG by ``utils.imageio.write_png`` and read back by
``wsi.slide.ImageReader``, outside the timed pass. The model is the PanNuke
config's with random weights from seed 0. On a CUDA device the engine runs in
WSI mode (device preprocess, compact label maps) unless ``--host-path``; on
the CPU in the strict contract. The first pass builds the kernels and warms
cuDNN; the second is timed and printed.

The model runs on the first CUDA device and raises without one; ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
CONFIG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_swin_fpn_pannuke.py")
COLS = 8  # tiles a row of the synthetic slide
PARTS = ("read_wait_s", "dispatch_s", "collect_s", "post_s")


def synthetic_benchmark_slide(tiles: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """→ (RGB uint8 slide of ceil(tiles / 8) × 8 tiles of 256², the first
    ``tiles`` tile origins (x, y) in raster order, int64 (tiles, 2))."""
    rows = (tiles + COLS - 1) // COLS
    hw = (rows * 256, COLS * 256)
    rng = np.random.RandomState(seed)
    img = rng.randint(160, 230, (hw[0], hw[1], 3), np.uint8)  # pale tissue
    yy, xx = np.mgrid[:64, :64]
    blob = ((yy - 32) ** 2 + (xx - 32) ** 2 <= 150).astype(np.uint8)
    for _ in range(tiles * 20):
        y, x = rng.randint(0, hw[0] - 64), rng.randint(0, hw[1] - 64)
        reg = img[y : y + 64, x : x + 64].astype(np.int16)
        reg[..., 0] -= 60 * blob
        reg[..., 2] -= 30 * blob
        img[y : y + 64, x : x + 64] = np.clip(reg, 0, 255).astype(np.uint8)
    coords = np.stack(
        [
            np.tile(np.arange(COLS) * 256, rows)[:tiles],
            np.repeat(np.arange(rows) * 256, COLS)[:tiles],
        ],
        axis=1,
    )
    return img, coords


def benchmark_slide(engine, slide, coords: np.ndarray, out_dir: str,
                    dev: bool) -> Tuple[Dict[str, float], float]:
    """Two passes of ``infer_slide`` over ``coords`` into ``out_dir``: the
    first untimed (kernel builds, cuDNN plans), the second timed. Prints the
    JAX tool's two lines; → (the timed pass's stats, the first pass's s)."""
    from nuhtc_tpu_torch.wsi.infer import infer_slide

    classes = [f"c{i}" for i in range(engine.num_classes)]
    t0 = time.perf_counter()
    infer_slide(engine, slide, coords, out_dir, "synth", classes=classes, progress=False)
    warm = time.perf_counter() - t0
    stats = infer_slide(engine, slide, coords, out_dir, "synth", classes=classes,
                        progress=False)
    print(
        f"wsi stage-B: {stats['tiles']} tiles in {stats['seconds']:.2f}s "
        f"→ {stats['tiles_per_sec']:.1f} tiles/s "
        f"({stats['nuclei']} nuclei; first pass incl. compile {warm:.1f}s; "
        f"device_path={dev})"
    )
    acct = sum(stats[k] for k in PARTS)
    print(
        "attribution: "
        f"read_wait {stats['read_wait_s']:.2f}s · "
        f"dispatch(upload) {stats['dispatch_s']:.2f}s · "
        f"collect(device+download) {stats['collect_s']:.2f}s · "
        f"host post(contours/export) {stats['post_s']:.2f}s · "
        f"other {stats['seconds'] - acct:.2f}s"
    )
    return stats, warm


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """→ the timed pass's ``infer_slide`` stats."""
    ap = argparse.ArgumentParser(
        prog="python -m nuhtc_tpu_torch.tools.analysis_tools.benchmark_wsi")
    ap.add_argument("--tiles", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--host-path", action="store_true",
                    help="disable device preprocess + compact masks")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA device (raises without "
                    "one); 'cpu' for the CPU")
    args = ap.parse_args(argv)

    from nuhtc_tpu_torch.apis.inference import init_detector, resolve_device
    from nuhtc_tpu_torch.utils.imageio import write_png
    from nuhtc_tpu_torch.wsi.slide import ImageReader

    device = resolve_device(args.device, "benchmark_wsi")
    img, coords = synthetic_benchmark_slide(args.tiles)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "synth.png")
        write_png(path, img)
        slide = ImageReader(path)
        dev = device.type == "cuda" and not args.host_path
        engine = init_detector(CONFIG, None, batch_size=args.batch_size, device=device,
                               device_preprocess=dev, compact_masks=dev)
        stats, _ = benchmark_slide(engine, slide, coords, td, dev)
    return stats


if __name__ == "__main__":
    main()
