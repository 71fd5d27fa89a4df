"""The end-to-end chain on the synthetic PanNuke release, through the port's
command lines (port of tools/misc/run_e2e_golden.py), and its golden summary.

    python -m nuhtc_tpu_torch.tools.misc.run_e2e_golden --device cpu \\
        --out tests/goldens/e2e_synthetic_torch.json      # write the golden
    python -m nuhtc_tpu_torch.tools.misc.run_e2e_golden --device cpu --check
    python -m nuhtc_tpu_torch.tools.misc.run_e2e_golden --device cuda --check

The eight stages of the JAX chain, each the ``main(argv)`` of a port tool:

  1. ``misc.make_synthetic_pannuke``: fold 1 (8 tiles, seed 0), fold 3 (4, seed 3);
  2. ``preprocess_pannuke``: COCO jsons and PNG tiles;
  3. ``train``: 2 steps → a checkpoint;
  4. ``test``: ``--eval segm``, the metrics json and preds_pannuke.npy;
  5. ``analysis_tools.pannuke.compute_stats``: bPQ/mPQ of those predictions;
  6. ``infer_wsi``: a 512² slide (the fold-3 tiles 2 × 2), overlapping tiles,
     every export mode;
  7. ``nuclei_merge``: the merged GeoJSON;
  8. ``wsi_feat_extract``: the per-nucleus feature CSV.

The model is the tiny config (``configs/nuhtc/htc_lite_tiny_synthetic.py``,
depths 1-1-1-1) at the widths the Swin kernel takes (embed 96, heads
3-6-12-24; the kernel needs a head dim of 32 and C of 96 to 768), written
as a config of its own into the work directory, so that the same chain runs
on the CPU and on the card. ``--device`` reaches train, test and infer_wsi
(the first CUDA device by default; it raises without one). On a host
without h5py, infer_wsi keeps its patch grid in memory (``main(argv,
coords={})``) instead of writing ``patches/slide0.h5``, which no summary
entry reads.

The summary holds, besides the JAX chain's distillation of every stage, the
sha1 of stages 1 and 2, which depend on no device: the three .npy files of
each fold, and the COCO jsons, types files and the decoded pixels of the
PNG tiles; the JAX chain writes the same. The golden
(tests/goldens/e2e_synthetic_torch.json) is written on the CPU, in f32,
through the kernels' plain versions (the JAX golden rests on JAX's sampling
draws and cannot serve). ``--check`` compares the whole summary on the CPU
(floats within rtol 2e-3, as the JAX chain's), and on a CUDA device only
the device-free hashes: the card computes in bf16 and its summary is
printed beside the golden's.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import glob
import hashlib
import io
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
CONFIG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_tiny_synthetic.py")
GOLDEN = os.path.join(REPO, "tests", "goldens", "e2e_synthetic_torch.json")
# the tiny config at the Swin kernel's widths
KERNEL_WIDTHS = dict(backbone=dict(embed_dims=96, num_heads=[3, 6, 12, 24]),
                     neck=dict(in_channels=[96, 192, 384, 768]))
FOLDS = (("1", "raw_f1", 8, 0), ("3", "raw_f3", 4, 3))  # fold, dir, tiles, seed


def _round(obj, nd=4):
    if isinstance(obj, dict):
        return {k: _round(v, nd) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_round(v, nd) for v in obj]
    if isinstance(obj, float):
        if np.isnan(obj):
            return "nan"
        return round(obj, nd)
    return obj


def _sha1(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()


def device_free_hashes(work: str) -> dict:
    """sha1 of stage 1's .npy files and stage 2's jsons, types files and PNG
    pixels (decoded: the encoders' bytes differ), by path under ``work``."""
    from nuhtc_tpu_torch.utils.imageio import read_png

    out = {}
    for _, raw, _, _ in FOLDS:
        for name in ("images.npy", "masks.npy", "types.npy"):
            with open(os.path.join(work, raw, name), "rb") as f:
                out[f"{raw}/{name}"] = _sha1(f.read())
    for path in sorted(glob.glob(os.path.join(work, "coco", "PanNuke", "*"))):
        with open(path, "rb") as f:
            out[os.path.relpath(path, work)] = _sha1(f.read())
    for path in sorted(glob.glob(os.path.join(work, "datasets", "PanNuke", "*", "*.png"))):
        px = read_png(path)
        out[os.path.relpath(path, work)] = _sha1(str(px.shape).encode() + px.tobytes())
    return out


def make_data(work: str) -> None:
    """Stages 1 and 2."""
    from nuhtc_tpu_torch.tools import preprocess_pannuke
    from nuhtc_tpu_torch.tools.misc import make_synthetic_pannuke

    t = lambda *p: os.path.join(work, *p)  # noqa: E731
    for fold, raw, n, seed in FOLDS:
        make_synthetic_pannuke.main(["--out", t(raw), "--n-tiles", str(n), "--seed", str(seed)])
    for fold, raw, _, _ in FOLDS:
        preprocess_pannuke.main(["--images", t(raw, "images.npy"), "--masks", t(raw, "masks.npy"),
                                 "--types", t(raw, "types.npy"), "--fold", fold,
                                 "--out-dir", t("datasets", "PanNuke"),
                                 "--coco-dir", t("coco", "PanNuke")])


def _numeric_columns(rows: list) -> dict:
    """The CSV's columns whose every value is a number → their values."""
    cols = {}
    for c in rows[0] if rows else []:
        try:
            cols[c] = [float(r[c]) for r in rows]
        except ValueError:
            continue
    return cols


@contextlib.contextmanager
def _data_root(work: str):
    """The tiny config reads its data root from NUHTC_SYN_ROOT."""
    old = os.environ.get("NUHTC_SYN_ROOT")
    os.environ["NUHTC_SYN_ROOT"] = work
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("NUHTC_SYN_ROOT")
        else:
            os.environ["NUHTC_SYN_ROOT"] = old


def build_chain(work: str, device: Optional[str] = None, log=print) -> dict:
    """Runs the eight stages in ``work`` on ``device`` → the summary."""
    import importlib.util

    from nuhtc_tpu_torch.tools import infer_wsi, nuclei_merge, test, train, wsi_feat_extract
    from nuhtc_tpu_torch.tools.analysis_tools.pannuke import compute_stats
    from nuhtc_tpu_torch.utils.imageio import write_png

    os.makedirs(work, exist_ok=True)
    t = lambda *p: os.path.join(work, *p)  # noqa: E731
    dev = ["--device", device] if device else []
    config = t("tiny_kernel_widths.py")
    with open(config, "w") as f:
        f.write(f"_base_ = {CONFIG!r}\nmodel = {KERNEL_WIDTHS!r}\n")

    def stage(name, fn, argv, **kw):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            fn(argv, **kw)
        log(f"e2e {name}: done")
        return out.getvalue()

    h5 = importlib.util.find_spec("h5py") is not None

    with _data_root(work):
        make_data(work)
        log("e2e stages 1-2 (synthetic release, preprocess_pannuke): done")
        stage("3 train", train.main, [config, "--work-dir", t("train"), "--max-epochs", "1",
                                      "--iters-per-epoch", "2", "--seed", "0", *dev])
        ckpt = t("train", "checkpoints")
        if not glob.glob(os.path.join(ckpt, "*")):
            raise RuntimeError("e2e: train wrote no checkpoint")
        stage("4 test", test.main, [config, ckpt, "--eval", "segm", "--batch-size", "2",
                                    "--eval-options", "save=True", "format=pannuke",
                                    f"save_path={t('infer')}", "--out-json", t("metrics.json"),
                                    *dev])
    with open(t("metrics.json")) as f:
        metrics = json.load(f)
    preds_path = glob.glob(t("infer", "*", "preds_pannuke.npy"))
    if not preds_path:
        raise RuntimeError("e2e: test did not save preds_pannuke.npy")
    preds = np.load(preds_path[0])
    stage("5 compute_stats", compute_stats.main,
          ["--true", t("raw_f3", "masks.npy"), "--pred", preds_path[0],
           "--types", t("raw_f3", "types.npy"), "--out", t("pq.json")])
    with open(t("pq.json")) as f:
        pq = json.load(f)

    imgs = np.load(t("raw_f3", "images.npy"))
    mosaic = np.zeros((512, 512, 3), np.uint8)
    for i in range(4):
        y, x = (i // 2) * 256, (i % 2) * 256
        mosaic[y:y + 256, x:x + 256] = np.clip(imgs[i], 0, 255).astype(np.uint8)
    os.makedirs(t("wsi"), exist_ok=True)
    write_png(t("wsi", "slide0.png"), mosaic)
    # mag 80: scale factor 80 / mag = 1.0, as the tiny config; step 192 < 256
    # overlaps the tiles, so that the merge has work to do
    stage("6 infer_wsi" + ("" if h5 else " (no h5py: the patch grid kept in memory)"),
          infer_wsi.main,
          [t("wsi"), config, ckpt, "--patch", "--seg", "--patch_size", "256", "--step_size",
           "192", "--batch_size", "2", "--num_workers", "1", "--mag", "80", "--margin", "8",
           "--min_area", "4", "--slide_ext", ".png", "--mode", "all", "--save_dir",
           t("wsi_out"), *dev], **({} if h5 else dict(coords={})))
    gj_path = t("wsi_out", "nuclei", "slide0", "slide0.geojson")
    with open(gj_path) as f:
        feats = json.load(f)
    merged_path = t("wsi_out", "nuclei", "slide0", "slide0_merged.geojson")
    stage("7 nuclei_merge", nuclei_merge.main, ["--geojson", gj_path, "--out", merged_path])
    with open(merged_path) as f:
        merged = json.load(f)
    stage("8 wsi_feat_extract", wsi_feat_extract.main,
          [t("wsi"), "--segdir", t("wsi_out"), "--mag", "80", "--slide_ext", ".png"])
    csvs = glob.glob(t("wsi_out", "nuclei", "slide0", "*_features.csv"))
    if not csvs:
        raise RuntimeError("e2e: wsi_feat_extract wrote no CSV")
    with open(csvs[0], newline="") as f:
        reader = csv.DictReader(f)
        columns, rows = reader.fieldnames or [], list(reader)
    numeric = _numeric_columns(rows)
    num_cols = sorted(numeric)
    return {
        "device_free": device_free_hashes(work),
        "test_metrics": _round(metrics),
        "pannuke_pq": _round(pq),
        "preds": {
            "shape": list(preds.shape),
            "instances_per_class": [
                int(sum(len(np.unique(preds[i, :, :, c])) - 1 for i in range(len(preds))))
                for c in range(5)],
        },
        "wsi": {
            "geojson_features": len(feats),
            "merged_features": len(merged),
            "class_names": sorted({ft["properties"]["classification"]["name"] for ft in feats}),
            "feature_rows": len(rows),
            "feature_columns_sha1": _sha1(",".join(sorted(columns)).encode()),
            "feature_means": _round({c: float(np.mean(numeric[c])) for c in num_cols[:12]}, 2),
        },
    }


def compare(got, want, path="", rtol=2e-3, atol=1e-4) -> list:
    """Structural equality with a float tolerance → the mismatches."""
    errs = []
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            errs.append(f"{path}: keys {sorted(got) if isinstance(got, dict) else got} "
                        f"!= {sorted(want)}")
            return errs
        for k in want:
            errs += compare(got[k], want[k], f"{path}.{k}", rtol, atol)
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            errs.append(f"{path}: {got} != {want}")
            return errs
        for i, (g, w) in enumerate(zip(got, want)):
            errs += compare(g, w, f"{path}[{i}]", rtol, atol)
    elif isinstance(want, float) or isinstance(got, float):
        if want == "nan" or got == "nan":
            if got != want:
                errs.append(f"{path}: {got} != {want}")
        elif not np.isclose(float(got), float(want), rtol=rtol, atol=atol):
            errs.append(f"{path}: {got} != {want}")
    elif got != want:
        errs.append(f"{path}: {got!r} != {want!r}")
    return errs


def check(summary: dict, device: Optional[str], golden: str = GOLDEN) -> list:
    """The mismatches against the golden: all of it on the CPU, the
    device-free hashes elsewhere."""
    with open(golden) as f:
        want = json.load(f)
    if device == "cpu":
        return compare(summary, want)
    return compare(summary["device_free"], want["device_free"], ".device_free")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.misc.run_e2e_golden")
    ap.add_argument("--out", default=None, help="write the summary json here (a golden)")
    ap.add_argument("--check", action="store_true", help="compare against the committed golden")
    ap.add_argument("--work", default=None, help="work dir (default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the first one by default)")
    args = ap.parse_args(argv)
    from nuhtc_tpu_torch.apis.inference import resolve_device

    device = str(resolve_device(args.device, "run_e2e_golden"))
    work = args.work or tempfile.mkdtemp(prefix="nuhtc_e2e_torch_")
    print(f"work dir: {work}")
    summary = build_chain(work, device)
    print(json.dumps(summary, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"golden -> {args.out}")
    if args.check:
        errs = check(summary, device)
        if errs:
            print("\n".join(["GOLDEN MISMATCH:"] + errs))
            return 1
        print("golden check OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
