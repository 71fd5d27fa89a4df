"""Traffic kind ``forward``: a closed loop with one batch in flight, as
``tools.test`` and ``infer_patch`` run: ``InferenceEngine.dispatch`` on a
batch of uint8 tiles (upload, device preprocess, the model, the label-map
paste), then the ``done`` event it returns is waited for.

Set-up makes ``distinct_batches`` batches from the seed, cycled through the
window, the weights and the engine, and runs ``warmup_batches``. A batch's
latency is read by CUDA events recorded before its dispatch and after it:
on the idle stream of a closed loop the first is stamped at once, the second
when the batch's last kernel ends. The rate is all the window's images over
all its time by the host's clock.

The check: ``check_batches`` batches among the window's first
``check_from_first``, drawn from the seed; their handles are kept and
collected (``InferenceEngine.collect``: download and split) after the
window, against the reference on the same tiles."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from portbench.harness import common, program
from portbench.harness import traffic as gen
from portbench.harness import trace as T
from portbench.harness import weights as W


class ForwardCell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, torch):
        self.cfg, self.tr, self.device, self.torch = cfg, traffic, device, torch
        s_traffic, s_sample = common.seeds(seed, 2)
        rng = np.random.RandomState(s_traffic)
        self.batches = [gen.tiles(rng, traffic["batch"], traffic["tile"],
                                  traffic["blobs_per_tile"], traffic["blob_radius2"])
                        for _ in range(traffic["distinct_batches"])]
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        self.state = W.make(cfg, cfg["weights_seed"], device, dtype)
        self.engine = program.engine(cfg, self.state, traffic["batch"], device)
        rng = np.random.RandomState(s_sample)
        self.check_idx = sorted(int(i) for i in rng.choice(
            traffic["check_from_first"], traffic["check_batches"], replace=False))
        self.kept: Dict[int, tuple] = {}
        self.last = None

    def _step(self, i: int, lat: List[tuple]) -> None:
        torch = self.torch
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
        else:
            a = time.perf_counter()
        with torch.profiler.record_function(T.DISPATCH):
            handle = self.engine.dispatch(self.batches[i % len(self.batches)])
        if cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            handle[3].synchronize()
        else:
            b = time.perf_counter()
        lat.append((a, b, time.perf_counter() - t0))
        if i in self.check_idx:
            self.kept[i] = handle
        self.last = (i, handle)

    def warm_up(self) -> None:
        lat: List[tuple] = []
        for i in range(self.tr["warmup_batches"]):
            self._step(i, lat)
        self.kept.clear()

    def window(self, seconds: float, traced: dict | None = None) -> dict:
        """The loop for ``seconds``; with ``traced`` (a dict) the batches
        from ``trace_from`` on, ``trace_batches`` of them, run under the
        profiler and ``traced`` receives the trace's summary."""
        lat: List[tuple] = []
        i = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or (
                traced is not None and i < self.tr["trace_from"] + self.tr["trace_batches"]):
            if traced is not None and i == self.tr["trace_from"]:
                t_seg = time.perf_counter()
                with T.traced(self.torch, self.device) as summary:
                    for _ in range(self.tr["trace_batches"]):
                        self._step(i, lat)
                        i += 1
                traced.update(summary, batches=self.tr["trace_batches"],
                              segment_s=time.perf_counter() - t_seg)
                continue
            self._step(i, lat)
            i += 1
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            ms = [a.elapsed_time(b) for a, b, _ in lat]
        else:
            ms = [1e3 * (b - a) for a, b, _ in lat]
        return dict(batches=i, images=i * self.tr["batch"], seconds=t1 - t0, latency_ms=ms,
                    host_ms=[1e3 * h for _, _, h in lat])

    def checked(self) -> List[tuple]:
        """(batch index, its handle) of the check; a batch the window did
        not reach is replaced by its last."""
        out = [(i, self.kept[i]) for i in self.check_idx if i in self.kept]
        missing = len(self.check_idx) - len(out)
        return out + [self.last] * missing

    def release(self) -> None:
        self.engine = None
        self.kept.clear()
        self.last = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def program_results(self) -> tuple:
        """(per-tile results, their tiles) of the checked batches, collected."""
        got, tiles = [], []
        for i, handle in self.checked():
            got += self.engine.collect(handle)
            tiles += self.batches[i % len(self.batches)]
        return got, tiles

    def cleanup(self) -> None:
        pass


def compare(got, tiles, ref_model, cfg, tr, device) -> Dict[str, float]:
    want = program.reference_detect(ref_model, tiles, cfg, tr["batch"], device)
    return program.detection_numbers(got, want, ref_model, tiles, cfg, tr, device)


def e2e(win: dict) -> Dict[str, float]:
    return {"forward_img_per_s": common.rate(win["images"], win["seconds"]),
            "forward_p95_ms": common.percentile(win["latency_ms"], 95)}
