"""Where a dataset evaluation spends its time, on the GPU.

    python -m nuhtc_tpu_torch.tools.profile_eval [--tiles 64] [--repeats 2]

Makes the synthetic PanNuke release of ``chip_smoke.py``'s phase 10
(``tools/synthetic.py synthetic_pannuke``, seed 0) and converts it with
``tools.preprocess_pannuke``, builds the PanNuke config's engine (strict
path, tier block, B16, bf16, random weights of seed 0, objectness lifted),
then ``--repeats`` times: ``tools.test.run_dataset`` (read / run_batch /
encode) and ``eval.evaluate.evaluate_dataset`` as ``tools.test`` calls it
(``save=True format=pannuke``, overlays at score ≥ 0.3), with the seconds
and calls of its parts taken by wrapping them: the annotations' reading,
mask NMS, the RLE IoU tables, the per-image statistics, the confusion
matrix, the pannuke conversion, the overlays (and inside them contour
tracing and drawing), PNG writing and ``np.save``. Last, the overlays of
``tools.infer`` over 8 tiles (every detection drawn). Every time is the
host's clock; the card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time


def _timed(bucket: dict, key: str, fn):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            s, n = bucket.get(key, (0.0, 0))
            bucket[key] = (s + time.perf_counter() - t0, n + 1)
    return wrapper


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nuhtc_tpu_torch.tools.profile_eval")
    ap.add_argument("--tiles", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=16)
    args = ap.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    config = os.path.join(repo, "configs", "nuhtc", "htc_lite_swin_fpn_pannuke.py")
    with tempfile.TemporaryDirectory() as tmp:
        return _profile(args, config, tmp)


def _profile(args, config: str, tmp: str) -> int:
    import numpy as np
    import torch

    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.data.coco import WSICocoDataset, build_dataset
    from nuhtc_tpu_torch.eval import evaluate, stats
    from nuhtc_tpu_torch.tools import preprocess_pannuke
    from nuhtc_tpu_torch.tools import test as test_tool
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_pannuke
    from nuhtc_tpu_torch.utils import visualize
    from nuhtc_tpu_torch.utils.visualize import draw_detections

    images, masks, types = synthetic_pannuke(np.random.RandomState(0), args.tiles)
    paths = []
    for name, arr in (("images", images), ("masks", masks), ("types", types)):
        paths += [f"--{name}", os.path.join(tmp, f"{name}.npy")]
        np.save(paths[-1], arr)
    preprocess_pannuke.main(paths + ["--fold", "3", "--out-dir", os.path.join(tmp, "datasets"),
                                     "--coco-dir", os.path.join(tmp, "coco")])
    dataset = build_dataset(dict(
        type="PanNukeCocoDataset", ann_file=os.path.join(tmp, "coco", "PanNuke_annt_RLE_fold3.json"),
        img_prefix=os.path.join(tmp, "datasets", "rgb"), test_mode=True))
    engine = init_detector(config, None, batch_size=args.batch_size)
    lift_objectness(engine.model)
    test_tool.run_dataset(engine, dataset, args.batch_size, limit=args.batch_size)  # warm-up
    torch.cuda.synchronize()

    parts: dict = {}
    wrapped = [
        (WSICocoDataset, "get_ann_info", "get_ann_info"),
        (WSICocoDataset, "load_image", "load_image (run_dataset's and the overlays')"),
        (evaluate, "mask_nms", "mask_nms"),
        (stats, "tables_from_rles", "tables_from_rles (RLE IoU)"),
        (stats, "stat_calc_tables", "stat_calc_tables"),
        (evaluate, "update_confusion_matrix", "update_confusion_matrix"),
        (evaluate, "convert_format", "convert_format"),
        (evaluate, "draw_detections", "draw_detections"),
        (visualize, "find_contours", "in draw_detections: find_contours"),
        (visualize, "draw_contours", "in draw_detections: draw_contours"),
        (evaluate, "write_png", "write_png"),
        (np, "save", "np.save"),
    ]
    plain = [getattr(owner, name) for owner, name, _ in wrapped]
    for (owner, name, key), fn in zip(wrapped, plain):
        setattr(owner, name, _timed(parts, key, fn))
    try:
        for rep in range(args.repeats):
            parts.clear()
            timing: dict = {}
            t0 = time.perf_counter()
            results = test_tool.run_dataset(engine, dataset, args.batch_size, timing=timing)
            t1 = time.perf_counter()
            with tempfile.TemporaryDirectory() as out:
                metrics = evaluate.evaluate_dataset(dataset, results, save=True, save_path=out,
                                                    data_format="pannuke", overlay=True,
                                                    overlay_score_thr=0.3)
            t2 = time.perf_counter()
            dets = sum(len(b) for bboxes, _ in results for b in bboxes)
            print(json.dumps(dict(
                run=rep, tiles=len(results), detections_a_tile=dets / len(results),
                loop_s=t1 - t0, **timing, evaluate_s=t2 - t1,
                img_per_s=len(results) / (t2 - t0), pq=metrics["pq"],
                parts={k: [s, n] for k, (s, n) in parts.items()})), flush=True)
    finally:
        for (owner, name, _), fn in zip(wrapped, plain):
            setattr(owner, name, fn)

    # tools.infer's overlays: every detection of a tile drawn
    imgs = [dataset.load_image(i) for i in range(min(8, len(dataset), args.batch_size))]
    res = engine.run_batch(imgs)
    t0 = time.perf_counter()
    for img, r in zip(imgs, res):
        draw_detections(img, r["masks"], r["labels"])
    drawn = sum(len(r["scores"]) for r in res)
    print(json.dumps(dict(infer_overlays_tiles=len(imgs), masks_drawn=drawn,
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
