"""Traffic kind ``slide``: whole slides through the port's stage B,
``wsi.infer.infer_slide``, back to back.

Set-up makes the slide from the seed (an ``ArraySlide`` in memory), the
weights and the engine, and warms up on the slide's first tiles. The window
starts a new slide while its elapsed time is under ``--seconds`` and ends
with the last slide; the rate is all its tiles over all its time. Each
slide exports to a directory under ``TMPDIR`` that goes after the slide.

A traced run profiles one slide of the window, ``trace_slide``.

The check: on the window's first slide, ``check_tiles`` tiles drawn from
the seed; the engine's results for them (``collect`` is wrapped for that
slide only, and keeps references) and their exported nuclei (the slide's
GeoJSON, kept aside) against the reference's detections and nuclei."""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from portbench.harness import check, common, program
from portbench.harness import trace as T
from portbench.harness import traffic as gen
from portbench.harness import weights as W

PARTS = ("read_wait_s", "dispatch_s", "collect_s", "post_s")


class SlideCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, torch):
        self.cfg, self.tr, self.device, self.torch = cfg, traffic, device, torch
        s_traffic, s_sample = common.seeds(seed, 2)
        self.img, self.coords = gen.slide(np.random.RandomState(s_traffic), traffic["tiles"],
                                          traffic["cols"], traffic["tile"],
                                          traffic["blobs_per_tile"], traffic["blob_radius2"])
        from nuhtc_tpu_torch.wsi.slide import ArraySlide

        self.slide = ArraySlide(self.img)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        self.state = W.make(cfg, cfg["weights_seed"], device, dtype)
        self.engine = program.engine(cfg, self.state, traffic["batch"], device)
        rng = np.random.RandomState(s_sample)
        self.check_idx = np.sort(rng.choice(len(self.coords), traffic["check_tiles"],
                                            replace=False))
        self.tmp = tempfile.mkdtemp(prefix="portbench_slide_")
        self.captured: Dict[int, dict] = {}
        self.exported = None

    def _infer(self, coords, tag: str) -> dict:
        from nuhtc_tpu_torch.wsi.infer import infer_slide

        out_dir = os.path.join(self.tmp, tag)
        stats = infer_slide(self.engine, self.slide, coords, out_dir, "slide",
                            classes=self.cfg["classes"], patch_size=self.tr["tile"],
                            mode=self.tr["mode"], margin=self.tr["margin"],
                            min_area=self.tr["min_area"], score_thr=self.tr["score_thr"],
                            num_read_threads=self.tr["read_threads"], progress=False)
        stats["out_dir"] = out_dir
        return stats

    def warm_up(self) -> None:
        stats = self._infer(self.coords[: self.tr["warmup_tiles"]], "warm")
        shutil.rmtree(stats["out_dir"], ignore_errors=True)

    def _capture(self):
        """Wraps ``engine.collect`` to keep the check tiles' results."""
        orig, calls, b = self.engine.collect, [0], self.tr["batch"]
        wanted = set(int(i) for i in self.check_idx)

        def collect(handle):
            res = orig(handle)
            for j, r in enumerate(res):
                if calls[0] * b + j in wanted:
                    self.captured[calls[0] * b + j] = r
            calls[0] += 1
            return res

        self.engine.collect = collect

    def window(self, seconds: float, traced: dict | None = None) -> dict:
        """Slides back to back; → tiles, seconds, slides, the summed split.
        With ``traced`` (a dict) the slide ``trace_slide`` runs under the
        profiler and ``traced`` receives the trace's summary."""
        tiles, slides = 0, 0
        split = dict.fromkeys(PARTS, 0.0)
        nuclei = 0
        t0 = time.perf_counter()
        while True:
            if slides == 0:
                self._capture()
            if traced is not None and slides == self.tr["trace_slide"]:
                with T.traced(self.torch, self.device) as summary:
                    stats = self._infer(self.coords, f"s{slides}")
                traced.update(summary, tiles=stats["tiles"])
            else:
                stats = self._infer(self.coords, f"s{slides}")
            if slides == 0:
                del self.engine.collect  # the bound method again
                kept = os.path.join(self.tmp, "checked.geojson")
                os.replace(os.path.join(stats["out_dir"], "slide.geojson"), kept)
                self.exported = kept
            shutil.rmtree(stats["out_dir"], ignore_errors=True)
            tiles += stats["tiles"]
            nuclei += stats["nuclei"]
            for k in PARTS:
                split[k] += stats[k]
            slides += 1
            if time.perf_counter() - t0 >= seconds and (
                    traced is None or slides > self.tr["trace_slide"]):
                break
        t1 = time.perf_counter()
        return dict(tiles=tiles, slides=slides, seconds=t1 - t0, nuclei=nuclei, **split)

    def exported_nuclei(self) -> List[dict]:
        """The check tiles' nuclei from the kept GeoJSON."""
        with open(self.exported) as f:
            feats = json.load(f)
        t = self.tr["tile"]
        by_tile: Dict[tuple, dict] = {}
        for c in self.coords[self.check_idx]:
            by_tile[(int(c[0]), int(c[1]))] = dict(contours=[], labels=[], scores=[])
        for feat in feats:
            ring = np.asarray(feat["geometry"]["coordinates"][0], np.int64)[:-1]
            key = (int(ring[:, 0].min()) // t * t, int(ring[:, 1].min()) // t * t)
            if key in by_tile:
                by_tile[key]["contours"].append(ring)
                by_tile[key]["labels"].append(feat["properties"]["label"])
                by_tile[key]["scores"].append(feat["properties"]["score"])
        return [by_tile[(int(c[0]), int(c[1]))] for c in self.coords[self.check_idx]]

    def check_tiles(self) -> List[np.ndarray]:
        t = self.tr["tile"]
        return [self.slide.read_region((int(x), int(y)), 0, (t, t))
                for x, y in self.coords[self.check_idx]]

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        self.engine = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def numbers(self, ref_model) -> Dict[str, float]:
        """The compared numbers of the program's outputs against ``ref_model``'s."""
        got = [self.captured[int(i)] for i in self.check_idx]
        return compare(got, self.exported_nuclei(), ref_model, self.check_tiles(),
                       self.coords[self.check_idx], self.cfg, self.tr, self.device)

    def cleanup(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def compare(got, got_nuclei, ref_model, tiles, coords, cfg, tr, device) -> Dict[str, float]:
    """The compared numbers of a program's (or the control's) detections
    ``got`` of ``tiles`` against the reference's, and of its exported nuclei
    ``got_nuclei`` against the reference's post-processing of ``got``."""
    want = program.reference_detect(ref_model, tiles, cfg, tr["batch"], device)
    numbers = program.detection_numbers(got, want, ref_model, tiles, cfg, tr, device)
    # the post-processing followed from the program's own detections
    forced = program.reference_nuclei(got, coords, tr["tile"], tr)
    numbers["nuclei_off"], numbers["nuclei_off_counts"] = check.nuclei_exact(got_nuclei, forced)
    return numbers


def e2e(win: dict) -> Dict[str, float]:
    return {"slide_tiles_per_s": common.rate(win["tiles"], win["seconds"])}
