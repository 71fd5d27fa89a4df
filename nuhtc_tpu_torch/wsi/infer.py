"""WSI inference pipeline (port of nuhtc_tpu/wsi/infer.py): tissue seg → tile
grid → streamed device batches → per-tile postprocessing → export.

Re-designs the reference Stage B loop (tools/infer_wsi.py:440-692): tile
reads run in host prefetch threads (double-buffered against device compute —
the reference serializes read → forward → CPU post per batch, SURVEY.md
§3.3); the detector + mask pasting run on the device; margin filtering,
min-area, mask-NMS (greedy RLE IoU > 0.05) and contour extraction run on
host per tile.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from nuhtc_tpu_torch.data.classes import DEFAULT_PALETTE
from nuhtc_tpu_torch.eval.evaluate import mask_nms
from nuhtc_tpu_torch.ops import rle as rle_ops
from nuhtc_tpu_torch.ops.contours import draw_contours, find_contours
from nuhtc_tpu_torch.utils.imageio import write_jpg
from nuhtc_tpu_torch.utils.profiling import count, span
from nuhtc_tpu_torch.wsi.export import NucleiExporter
from nuhtc_tpu_torch.wsi.slide import SlideReader


def tile_stream(
    slide: SlideReader,
    coords: np.ndarray,
    patch_size: int,
    patch_level: int = 0,
    num_threads: int = 2,
    prefetch: int = 8,
    batch_size: int = 16,
) -> Iterator[Tuple[List[np.ndarray], np.ndarray]]:
    """Yields (list of RGB tiles, their coords) in batches, read-ahead."""
    n = len(coords)
    idx_q: "queue.Queue[int]" = queue.Queue()
    for i in range(0, n, batch_size):
        idx_q.put(i)
    out_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    n_batches = (n + batch_size - 1) // batch_size
    done = threading.Event()

    def worker():
        while not done.is_set():
            try:
                start = idx_q.get_nowait()
            except queue.Empty:
                return
            batch_coords = coords[start : start + batch_size]
            tiles = [
                slide.read_region((int(x), int(y)), patch_level, (patch_size, patch_size))
                for x, y in batch_coords
            ]
            # bounded put that re-checks the shutdown flag: a consumer that
            # abandons the generator mid-slide (exception in postprocess,
            # early break) must not leave workers blocked forever on a full
            # queue holding the slide reader + buffered tiles
            while not done.is_set():
                try:
                    out_q.put((start, tiles, batch_coords), timeout=0.25)
                    break
                except queue.Full:
                    continue

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(num_threads)]
    for t in threads:
        t.start()

    try:
        # re-order by start index for deterministic output
        pending: Dict[int, tuple] = {}
        expected = 0
        received = 0
        while received < n_batches:
            start, tiles, bc = out_q.get()
            pending[start] = (tiles, bc)
            received += 1
            while expected in pending:
                tiles, bc = pending.pop(expected)
                yield tiles, bc
                expected += batch_size
    finally:
        # runs on normal exhaustion AND on generator close/abandonment
        done.set()


@dataclass
class TilePostprocessConfig:
    margin: int = 0
    min_area: int = 10
    nms_thr: float = 0.05
    score_thr: float = 0.0


def postprocess_tile(
    result: Dict[str, np.ndarray],  # engine.run_batch per-image dict
    coord: Tuple[int, int],
    tile_size: int,
    cfg: TilePostprocessConfig,
):
    """Margin/area filter + mask NMS + contours, mapped to slide frame.

    Returns (contours [K×(1,P,2)], labels, scores, boxes_slide, rles_tile)."""
    boxes = result["boxes"]
    masks = result["masks"]
    labels = result["labels"]
    scores = result["scores"]
    m = cfg.margin
    count("wsi.detections", len(boxes))
    if len(boxes) == 0:
        return [], labels, scores, boxes, []
    with span("wsi.filter"):
        areas = masks.reshape(len(masks), -1).sum(axis=1)
        sel = (
            (boxes[:, 0] >= m)
            & (boxes[:, 1] >= m)
            & (boxes[:, 2] <= tile_size - m)
            & (boxes[:, 3] <= tile_size - m)
            & (areas >= cfg.min_area)
            & (scores >= cfg.score_thr)
        )
        boxes, masks, labels, scores = boxes[sel], masks[sel], labels[sel], scores[sel]
    if len(boxes) == 0:
        return [], labels, scores, boxes, []

    with span("wsi.rle"):
        rles = [rle_ops.encode(mm) for mm in masks]
    with span("wsi.mask_nms"):
        kept_rles, keep_idx = mask_nms(rles, scores, thr=cfg.nms_thr)
        boxes, masks = boxes[keep_idx], masks[keep_idx]
        labels, scores = labels[keep_idx], scores[keep_idx]

    contours, final = [], []
    with span("wsi.contours"):
        for i, mm in enumerate(masks):
            found, _ = find_contours(mm)  # RETR_TREE, CHAIN_APPROX_SIMPLE
            if not found:
                continue
            cont = found[0].reshape(-1, 2)
            if len(cont) < 3:
                continue
            contours.append(cont + np.asarray(coord))
            final.append(i)
    count("wsi.nuclei", len(contours))
    final = np.asarray(final, np.int64)
    boxes_slide = boxes[final] + np.tile(np.asarray(coord, np.float32), 2)
    return (
        contours,
        labels[final],
        scores[final],
        boxes_slide,
        [kept_rles[i] for i in final],
    )


def infer_slide(
    engine,  # nuhtc_tpu_torch.apis.inference.InferenceEngine
    slide: SlideReader,
    coords: np.ndarray,
    out_dir: str,
    slide_id: str,
    classes: Sequence[str],
    patch_size: int = 256,
    patch_level: int = 0,
    mode: str = "qupath",
    margin: int = 0,
    min_area: int = 10,
    score_thr: float = 0.0,
    det_dir: Optional[str] = None,  # save per-tile overlays (reference --det)
    num_read_threads: int = 2,
    progress: bool = True,
) -> Dict[str, float]:
    """Run the full per-slide loop; returns timing/throughput stats."""
    with span("wsi.slide"):
        cfg = TilePostprocessConfig(margin=margin, min_area=min_area, score_thr=score_thr)
        if det_dir:
            os.makedirs(det_dir, exist_ok=True)
        exporter = NucleiExporter(slide_id, out_dir, classes, mode=mode)
        t0 = time.perf_counter()
        n_tiles = len(coords)
        n_nuclei = 0
        annidx = 0
        coco_mode = mode in ("coco", "all")
        # wall-time attribution, to tell a device stall from the host's contour
        # and export cost: read_wait = blocked on the threaded tile reader;
        # dispatch = upload + enqueue (with the host syncs of the proposal
        # stages); collect = device wait + download + the split into per-image
        # results (the engine times the first two by the event it recorded at
        # dispatch: collect_device_s, collect_download_s); post = host contours
        # and export after collect
        tm = {"read_wait_s": 0.0, "dispatch_s": 0.0, "collect_s": 0.0, "post_s": 0.0}
        eng_tm = getattr(engine, "collect_timing", None)
        if eng_tm is not None:
            eng_tm["device_s"] = eng_tm["download_s"] = 0.0

        def process(handle, batch_coords, tiles):
            nonlocal n_nuclei, annidx
            with span(None, tm, "collect_s"):
                results = engine.collect(handle)
            with span("wsi.post", tm, "post_s"):
                for res, coord, tile in zip(results, batch_coords, tiles):
                    conts, labels, scores, boxes, rles = postprocess_tile(
                        res, tuple(coord), patch_size, cfg
                    )
                    # coco mode registers EVERY tile (empty ones included —
                    # negatives must appear in 'images') and saves the patch png
                    # its file_name points at; other modes skip empty tiles
                    if conts or coco_mode:
                        with span("wsi.export"):
                            exporter.add_tile(
                                annidx, conts, labels, scores, boxes, rles,
                                (patch_size, patch_size),
                                tile=tile if coco_mode else None,
                            )
                        n_nuclei += len(conts)
                    if det_dir and conts:
                        # reference --det: per-tile detection overlay jpg named by
                        # the tile's level-0 coord (tools/infer_wsi.py:500-510)
                        ov = np.ascontiguousarray(tile)
                        for cont, lab in zip(conts, labels):
                            color = DEFAULT_PALETTE[int(lab) % len(DEFAULT_PALETTE)]
                            draw_contours(ov, [np.asarray(cont - np.asarray(coord), np.int32)],
                                          color, 1)
                        name = f"img_{int(coord[0])}_{int(coord[1])}.jpg"
                        write_jpg(os.path.join(det_dir, name), ov)
                    annidx += 1
            if progress:
                dt = time.perf_counter() - t0
                print(
                    f"\r{slide_id}: {annidx}/{n_tiles} tiles "
                    f"({annidx / max(dt, 1e-9):.1f} tiles/s, {n_nuclei} nuclei)",
                    end="", flush=True,
                )

        # software pipelining: dispatch batch N+1 before collecting batch N so
        # host post-processing (contours, export IO) overlaps device compute
        # (reference stage B serializes these per batch — SURVEY.md §3.3)
        pending = None
        stream = iter(
            tile_stream(
                slide, coords, patch_size, patch_level=patch_level,
                batch_size=engine.batch_size, num_threads=num_read_threads,
            )
        )
        while True:
            with span("wsi.read_wait", tm, "read_wait_s"):
                item = next(stream, None)
            if item is None:
                break
            tiles, batch_coords = item
            with span(None, tm, "dispatch_s"):
                handle = engine.dispatch(tiles)
            if pending is not None:
                process(*pending)
            pending = (handle, batch_coords, tiles)
        if pending is not None:
            process(*pending)
        with span("wsi.export"):
            exporter.close()
        dt = time.perf_counter() - t0
        if progress:
            print()
        if eng_tm is not None:
            tm["collect_device_s"] = eng_tm["device_s"]
            tm["collect_download_s"] = eng_tm["download_s"]
        return dict(
            tiles=n_tiles, nuclei=n_nuclei, seconds=dt,
            tiles_per_sec=n_tiles / max(dt, 1e-9), **tm,
        )
