#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nuhtc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand kernels from ``nuhtc_tpu_torch/csrc`` (into
     ``build/nuhtc_tpu_torch/``);
  3. K1 ``window_block`` against its plain twin at the four Swin-T stage
     shapes of the main path (B16, 512² input), shift 0 and 3, bf16;
     max abs error ≤ 0.05; median times from CUDA events;
  4. K3 ``component_stats`` against its plain version at B16, 512², K512 on
     labels from the port's CCL of a blob mask; exactly equal;
  K4. ``roi_align`` against ``roi_align_plain`` at the twelve calls of one
     forward (B16, C64; levels 128² and 64² and the semantic map 128²;
     R1512 at out 7 with sampling ratio 2, the semantic call with
     pool_from 14; R500 at out 14 with the adaptive grid), boxes from a
     seed that include tiny, large, border-crossing and zero-size ones. In
     f32 max abs error ≤ 1e-4; in bf16, against the plain version on the
     f32 copy of the map, ≤ 2⁻⁷ of the map's largest magnitude;
  K2. ``window_attention`` against its plain twin at the four stage shapes,
     shift 0 and 3; max abs error ≤ 0.05;
  5. a small-input reference check: the backbone on the card (through K1,
     then through K2) against the plain CPU path in f32;
  6. the WSI-mode slice: ``init_detector`` on the PanNuke config (Swin-T,
     B16, 256² tiles rescaled to 512², bf16, random weights from a seed,
     the positive-objectness logit raised so detections exist, device
     preprocess and compact label maps), ``run_batch`` on 2 batches of
     synthetic tiles after one warm-up batch; per forward K1 must launch
     12 times, K4 12 times and K3 at least once; outputs finite, label
     maps in [0, 500]; tiles/s;
  7. the strict patch path: the same config with the engine's defaults
     (host preprocess, one full-frame mask per detection) and the Swin
     tier "attn"; per forward K2 12 times, K4 12 times, K3 at least once;
     masks (n, 256, 256) uint8 of 0/1; tiles/s and the collect split. Then
     flip TTA on 4 tiles: no more detections than the three views
     together, kept boxes inside the tile.
Every count is set to 0 just before a path is driven and read just after it.
The line before the last is a JSON object with each kernel's launches, error,
times and bound (the least time the card could take: the larger of the bytes
moved once over 3.35 TB/s and the operations over the peak rate for their
type); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_swin_fpn_pannuke.py")
BATCH = 16
TILE = 256
# (padded map side, C, heads, blocks at this stage) of the main path
STAGES = ((133, 96, 3, 2), (70, 192, 6, 2), (35, 384, 12, 6), (21, 768, 24, 2))
K1_TOL = 0.05
K2_TOL = 0.05
# published peaks of one H100 SXM: dense bf16 tensor cores, f32 outside them, HBM
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
ROI_R, MASK_R, FPN_C = 1512, 500, 64


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median time of ``fn`` on the card, by CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(flops: float, peak: float, nbytes: float):
    """(least time in ms, what bounds it) for this much work on the card."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def block_bound(side, c, mode: str):
    """Work of one Swin block on a (BATCH, side, side, c) map. "block" (K1):
    qkv, proj, fc1, fc2 (24·M·C² FLOP) and attention (4·M·49·C); two maps
    read, one written, weights read once. "attn" (K2): qkv and proj
    (8·M·C²) and attention; one map read, one written."""
    m = BATCH * side * side
    attn = 4.0 * m * 49 * c
    if mode == "block":
        return 24.0 * m * c * c + attn, 3 * m * c * 2 + 12 * c * c * 2
    return 8.0 * m * c * c + attn, 2 * m * c * 2 + 4 * c * c * 2


def k1_inputs(side, c, nh, gen, device):
    import torch

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * std)

    x = rnd(BATCH, side, side, c, std=0.5).bfloat16()
    h1 = torch.nn.functional.layer_norm(x.float(), (c,)).bfloat16()
    hid = 4 * c
    return dict(
        xp=x, h1p=h1, wqkv=rnd(3 * c, c, std=c ** -0.5), bqkv=rnd(3 * c, std=0.02),
        wproj=rnd(c, c, std=c ** -0.5), bproj=rnd(c, std=0.02),
        bias49=rnd(nh, 49, 49, std=0.02), g2=1.0 + rnd(c, std=0.1), b2=rnd(c, std=0.02),
        wfc1=rnd(hid, c, std=c ** -0.5), bfc1=rnd(hid, std=0.02),
        wfc2=rnd(c, hid, std=0.5 * hid ** -0.5), bfc2=rnd(c, std=0.02),
    )


def phase_k1(device):
    import torch
    from nuhtc_tpu_torch.ops.window_block import window_block, window_block_plain

    gen = torch.Generator(device=device).manual_seed(0)
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for side, c, nh, depth in STAGES:
        inp = k1_inputs(side, c, nh, gen, device)
        for shift in (0, 3):
            kw = dict(ws=7, num_heads=nh, shift=shift)
            got = window_block(**inp, **kw)
            want = window_block_plain(**inp, **kw)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            if not np.isfinite(e) or e > K1_TOL:
                raise AssertionError(f"K1 {side}² C{c} shift {shift}: max abs err {e}")
            t_k = cuda_ms(lambda: window_block(**inp, **kw))
            t_p = cuda_ms(lambda: window_block_plain(**inp, **kw))
            log(f"K1 window_block {BATCH}x{side}x{side}x{c} heads {nh} shift {shift}: "
                f"max_abs_err {e:.5f} kernel {t_k:.3f} ms plain {t_p:.3f} ms")
            err = max(err, e)
            ms += t_k * depth / 2  # half the stage's blocks are shifted
            plain_ms += t_p * depth / 2
        del inp
    flops = sum(block_bound(side, c, "block")[0] * d for side, c, _, d in STAGES)
    nbytes = sum(block_bound(side, c, "block")[1] * d for side, c, _, d in STAGES)
    bound, by = bound_ms(flops, PEAK_BF16, nbytes)
    log(f"K1 per forward (12 blocks): kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def phase_k2(device):
    import torch
    from nuhtc_tpu_torch.ops.window_block import window_attention, window_attention_plain

    gen = torch.Generator(device=device).manual_seed(1)
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for side, c, nh, depth in STAGES:
        full = k1_inputs(side, c, nh, gen, device)
        inp = {k: full[k] for k in ("h1p", "wqkv", "bqkv", "wproj", "bproj", "bias49")}
        del full
        for shift in (0, 3):
            kw = dict(ws=7, num_heads=nh, shift=shift)
            got = window_attention(**inp, **kw)
            want = window_attention_plain(**inp, **kw)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            if not np.isfinite(e) or e > K2_TOL or got.shape != want.shape:
                raise AssertionError(f"K2 {side}² C{c} shift {shift}: max abs err {e}")
            t_k = cuda_ms(lambda: window_attention(**inp, **kw))
            t_p = cuda_ms(lambda: window_attention_plain(**inp, **kw))
            b_ms, b_by = bound_ms(block_bound(side, c, "attn")[0], PEAK_BF16,
                                  block_bound(side, c, "attn")[1])
            log(f"K2 window_attention {BATCH}x{side}x{side}x{c} heads {nh} shift {shift}: "
                f"max_abs_err {e:.5f} kernel {t_k:.3f} ms plain {t_p:.3f} ms "
                f"bound {b_ms:.4f} ms ({b_by})")
            err = max(err, e)
            ms += t_k * depth / 2
            plain_ms += t_p * depth / 2
        del inp
    flops = sum(block_bound(side, c, "attn")[0] * d for side, c, _, d in STAGES)
    nbytes = sum(block_bound(side, c, "attn")[1] * d for side, c, _, d in STAGES)
    bound, by = bound_ms(flops, PEAK_BF16, nbytes)
    log(f"K2 per forward (12 blocks): kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def roi_boxes(rng, b, r, extent=512.0):
    """(b, r, 4) boxes in image coordinates: nucleus-sized ones, plus tiny,
    large (> 32 cells at stride 4), border-crossing and zero-size ones."""
    xy = rng.uniform(-8, extent - 8, (b, r, 2))
    wh = rng.uniform(6, 64, (b, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    n = r // 16
    rois[:, :n, 2:] = rois[:, :n, :2] + rng.uniform(0.05, 2.0, (b, n, 2))  # tiny
    big = rng.uniform(-40, 200, (b, n, 2))
    rois[:, n:2 * n] = np.concatenate([big, big + rng.uniform(140, 500, (b, n, 2))], -1)
    rois[:, 2 * n:3 * n, :2] = rng.uniform(-60, -1, (b, n, 2))  # cross the near border
    rois[:, 2 * n:3 * n, 2:] = rng.uniform(4, 60, (b, n, 2))
    far = rng.uniform(extent - 30, extent - 2, (b, n, 2))  # cross the far border
    rois[:, 3 * n:4 * n] = np.concatenate([far, far + rng.uniform(20, 80, (b, n, 2))], -1)
    rois[:, 4 * n:5 * n, 2:] = rois[:, 4 * n:5 * n, :2]  # zero size
    rois[:, 5 * n] = [-200, -200, -150, -150]  # wholly outside
    return rois


def roi_work(feat, rois, scale, out_size, sampling_ratio, pool_from):
    """FLOP and bytes of one RoIAlign call on these boxes: 8 FLOP per channel
    and sample point (four corners, a multiply and an add each) over each
    box's own grid; the map and the boxes read once, the output written once."""
    from nuhtc_tpu_torch.ops.roi_align import _geometry

    _, _, gh, _, _, gw, _ = _geometry(rois, scale, out_size, sampling_ratio, 8, pool_from)
    samples = float((gh.long() * gw.long()).sum()) * out_size * out_size
    c = feat.shape[-1]
    out_elems = rois.shape[0] * rois.shape[1] * out_size * out_size * c
    nbytes = feat.numel() * feat.element_size() + rois.numel() * 4 + out_elems * feat.element_size()
    return 8.0 * samples * c, nbytes


def phase_k4(device):
    import torch
    from nuhtc_tpu_torch.ops.roi_align import roi_align, roi_align_plain

    rng = np.random.RandomState(4)
    maps = {name: torch.from_numpy(rng.randn(BATCH, side, side, FPN_C).astype(np.float32)
                                   ).to(device)
            for name, side in (("p2", 128), ("p3", 64), ("semantic", 128))}
    box_rois = torch.from_numpy(roi_boxes(rng, BATCH, ROI_R)).to(device)
    mask_rois = torch.from_numpy(roi_boxes(rng, BATCH, MASK_R)).to(device)
    # (map, stride, rois, calls per forward, arguments): the 12 calls of a forward
    calls = [
        ("p2", 4, box_rois, 3, dict(output_size=7, sampling_ratio=2)),
        ("p3", 8, box_rois, 3, dict(output_size=7, sampling_ratio=2)),
        ("semantic", 4, box_rois, 3, dict(output_size=7, sampling_ratio=0, pool_from=14)),
        ("p2", 4, mask_rois, 1, dict(output_size=14, sampling_ratio=0)),
        ("p3", 8, mask_rois, 1, dict(output_size=14, sampling_ratio=0)),
        ("semantic", 4, mask_rois, 1, dict(output_size=14, sampling_ratio=0)),
    ]
    err32 = err16 = 0.0
    ms = plain_ms = total_flops = total_bytes = bound_sum = 0.0
    for name, stride, rois, per_forward, kw in calls:
        f32map = maps[name]
        scale = 1.0 / stride
        want = roi_align_plain(f32map, rois, scale, **kw)
        got = roi_align(f32map, rois, scale, **kw)
        torch.cuda.synchronize()
        e32 = (got - want).abs().max().item()
        if got.shape != want.shape or not np.isfinite(e32) or e32 > 1e-4:
            raise AssertionError(f"K4 f32 {name} {kw}: max abs err {e32}")
        del got, want
        bmap = f32map.bfloat16()
        ref = roi_align_plain(bmap.float(), rois, scale, **kw)
        got = roi_align(bmap, rois, scale, **kw)
        plain16 = roi_align_plain(bmap, rois, scale, **kw)
        torch.cuda.synchronize()
        tol = 2.0 ** -7 * bmap.float().abs().max().item()
        e16 = (got.float() - ref).abs().max().item()
        e16_plain = (plain16.float() - ref).abs().max().item()
        if got.dtype != torch.bfloat16 or not np.isfinite(e16) or e16 > tol:
            raise AssertionError(f"K4 bf16 {name} {kw}: max abs err {e16} > {tol}")
        del got, ref, plain16
        t_k = cuda_ms(lambda: roi_align(bmap, rois, scale, **kw))
        t_p = cuda_ms(lambda: roi_align_plain(bmap, rois, scale, **kw))
        flops, nbytes = roi_work(bmap, rois, scale, kw["output_size"], kw["sampling_ratio"],
                                 kw.get("pool_from"))
        b_ms, b_by = bound_ms(flops, PEAK_F32, nbytes)
        log(f"K4 roi_align {name} {tuple(bmap.shape)} R{rois.shape[1]} {kw}: f32 err {e32:.2e}; "
            f"bf16 err {e16:.5f} (plain bf16 {e16_plain:.5f}, allowed {tol:.5f}); "
            f"kernel {t_k:.3f} ms plain {t_p:.3f} ms bound {b_ms:.4f} ms ({b_by})")
        err32, err16 = max(err32, e32), max(err16, e16)
        ms += t_k * per_forward
        plain_ms += t_p * per_forward
        total_flops += flops * per_forward
        total_bytes += nbytes * per_forward
        bound_sum += b_ms * per_forward
    by = bound_ms(total_flops, PEAK_F32, total_bytes)[1]
    log(f"K4 per forward (12 calls): kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"bound {bound_sum:.4f} ms ({by}); max abs err f32 {err32:.2e}, bf16 {err16:.5f}")
    return dict(max_abs_err=err16, max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_sum, bound_by=by)


def blob_mask(rng, b, size, n_blobs):
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((b, size, size), bool)
    for i in range(b):
        for _ in range(n_blobs):
            cy, cx = rng.randint(0, size, 2)
            r = rng.randint(3, 12)
            mask[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return mask


def phase_k3(device):
    import torch
    from nuhtc_tpu_torch.ops.components import (
        component_stats, component_stats_plain, first_roots, label_components_raw)

    mask = torch.from_numpy(blob_mask(np.random.RandomState(0), BATCH, 512, 400)).to(device)
    lab = label_components_raw(mask)
    roots, valid = first_roots(lab, mask, 512)
    boxes, areas = component_stats(lab, roots)
    pb, pa = component_stats_plain(lab, roots)
    torch.cuda.synchronize()
    if not (torch.equal(boxes, pb) and torch.equal(areas, pa)):
        bad = int((boxes != pb).any(-1).sum() + (areas != pa).sum())
        raise AssertionError(f"K3 differs from its plain version in {bad} entries")
    t_k = cuda_ms(lambda: component_stats(lab, roots))
    t_p = cuda_ms(lambda: component_stats_plain(lab, roots))
    # labels and roots read once, boxes and areas written once; int compares only
    nbytes = lab.numel() * 4 + roots.numel() * 4 + boxes.numel() * 4 + areas.numel() * 4
    bound, by = bound_ms(0.0, PEAK_F32, nbytes)
    log(f"K3 component_stats {BATCH}x512x512 K512 ({int(valid.sum())} components): "
        f"exact; kernel {t_k:.3f} ms plain {t_p:.3f} ms bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=bound, bound_by=by)


def phase_reference(device):
    """Backbone of the tiny config: card (K1 or K2, bf16 inside) vs CPU plain f32."""
    import torch
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.models.build import build_detector, init_random_weights

    cfg = Config.fromfile(os.path.join(REPO, "configs", "nuhtc", "htc_lite_tiny_synthetic.py"))
    cfg.model.backbone.update(embed_dims=96, num_heads=[3, 6, 12, 24])
    img = torch.from_numpy(np.random.RandomState(0).randn(2, 128, 128, 3).astype(np.float32))
    for tier in ("block", "attn"):
        model = build_detector(cfg.model, cfg.model.get("test_cfg"), 1.0, swin_kernel=tier)
        init_random_weights(model, torch.Generator().manual_seed(0))
        bb = model.backbone.eval()
        with torch.no_grad():
            want = bb(img)
            got = bb.to(device)(img.to(device))
        errs = [(g.float().cpu() - w).abs().max().item() for g, w in zip(got, want)]
        scale = max(w.abs().max().item() for w in want)
        log(f"reference: backbone (tier {tier}) on {device} vs CPU f32, max abs err per level "
            f"{[round(e, 4) for e in errs]} (outputs up to {scale:.2f})")
        # the kernels compute in bf16 (K1 with tanh gelu); the CPU path in f32, erf gelu
        if not all(np.isfinite(errs)) or max(errs) > 0.05 * max(1.0, scale):
            raise AssertionError(f"backbone ({tier}) disagrees with the CPU reference: {errs}")


def kernel_counters():
    from nuhtc_tpu_torch.ops.components import component_stats
    from nuhtc_tpu_torch.ops.roi_align import roi_align
    from nuhtc_tpu_torch.ops.window_block import window_attention, window_block

    return dict(window_block=window_block, window_attention=window_attention,
                component_stats=component_stats, roi_align=roi_align)


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def check_counts(path, counts, forwards, swin_counter):
    """Per forward: 12 launches of the tier's Swin kernel and none of the
    other's, 12 of roi_align, at least one of component_stats."""
    other = "window_attention" if swin_counter == "window_block" else "window_block"
    ok = (counts[swin_counter] == 12 * forwards and counts[other] == 0
          and counts["roi_align"] == 12 * forwards and counts["component_stats"] >= forwards)
    if not ok:
        raise AssertionError(f"{path}: kernel launches over {forwards} forwards: {counts}")


def check_detections(det_boxes, det_scores):
    if not (np.isfinite(det_boxes).all() and np.isfinite(det_scores).all()):
        raise AssertionError("non-finite boxes or scores")


def phase_slice(device):
    """WSI mode: device preprocess, compact label maps, Swin tier "block"."""
    import torch
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_tiles

    engine = init_detector(CONFIG, None, batch_size=BATCH, device_preprocess=True,
                           compact_masks=True)
    lift_objectness(engine.model)
    rng = np.random.RandomState(0)
    batches = [synthetic_tiles(rng, BATCH, TILE) for _ in range(3)]
    engine.run_batch(batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    reset_counts()
    n_det = 0
    t0 = time.perf_counter()
    for tiles in batches[1:]:
        handle = engine.dispatch(tiles)
        det = handle[0]
        lab = det["label_map"]
        if lab.shape != (BATCH, TILE, TILE) or int(lab.min()) < 0 or int(lab.max()) > 500:
            raise AssertionError(f"label map out of range: {tuple(lab.shape)}")
        for key in ("boxes", "scores", "probs"):
            if not bool(torch.isfinite(det[key]).all()):
                raise AssertionError(f"non-finite {key}")
        results = engine.collect(handle)
        n_det += sum(len(r["scores"]) for r in results)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    forwards = len(batches) - 1
    check_counts("WSI-mode slice", counts, forwards, "window_block")
    tiles = BATCH * forwards
    log(f"slice (WSI mode, tier block): {tiles} tiles in {dt:.3f} s = {tiles / dt:.2f} tiles/s "
        f"(B{BATCH}, 512² input, bf16); {n_det / tiles:.2f} detections/tile; "
        f"launches {counts}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def phase_strict(device):
    """The strict patch path (host preprocess, one full-frame mask per
    detection) on the Swin tier "attn", then flip TTA on top of it."""
    import torch
    from nuhtc_tpu_torch.apis.inference import TTAEngine, init_detector
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_tiles

    engine = init_detector(CONFIG, None, batch_size=BATCH, swin_kernel="attn")
    if engine.device_preprocess or engine.compact_masks or engine.device.type != device.type:
        raise AssertionError("init_detector's defaults are not the strict path on the card")
    lift_objectness(engine.model)
    rng = np.random.RandomState(1)
    batches = [synthetic_tiles(rng, BATCH, TILE) for _ in range(3)]
    engine.run_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.collect_timing.update(device_s=0.0, download_s=0.0)

    reset_counts()
    n_det = 0
    t0 = time.perf_counter()
    for tiles in batches[1:]:
        results = engine.run_batch(tiles)
        if len(results) != BATCH:
            raise AssertionError(f"{len(results)} results for {BATCH} tiles")
        for r in results:
            n = len(r["scores"])
            m = r["masks"]
            if m.shape != (n, TILE, TILE) or m.dtype != np.uint8 or (n and int(m.max()) > 1):
                raise AssertionError(f"masks {m.shape} {m.dtype}")
            if r["boxes"].shape != (n, 4) or r["probs"].shape != (n, 5):
                raise AssertionError(f"boxes {r['boxes'].shape} probs {r['probs'].shape}")
            check_detections(r["boxes"], r["scores"])
            n_det += n
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    forwards = len(batches) - 1
    check_counts("strict path", counts, forwards, "window_attention")
    tiles = BATCH * forwards
    ct = engine.collect_timing
    log(f"strict path (host preprocess, full masks, tier attn): {tiles} tiles in {dt:.3f} s = "
        f"{tiles / dt:.2f} tiles/s; {n_det / tiles:.2f} detections/tile; collect: device wait "
        f"{ct['device_s'] / forwards * 1e3:.1f} ms, download {ct['download_s'] / forwards * 1e3:.1f} "
        f"ms per batch; launches {counts}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # flip TTA on 4 tiles; count each view's detections as the engine returns them
    views = []
    plain_run = engine.run_batch

    def counting_run(imgs):
        res = plain_run(imgs)
        views.append([len(r["scores"]) for r in res])
        return res

    engine.run_batch = counting_run
    tiles = batches[1][:4]
    t0 = time.perf_counter()
    merged = TTAEngine(engine).run_batch(tiles)
    dt = time.perf_counter() - t0
    engine.run_batch = plain_run
    if len(views) != 3 or len(merged) != len(tiles):
        raise AssertionError(f"TTA ran {len(views)} views, returned {len(merged)} results")
    for i, r in enumerate(merged):
        total = sum(v[i] for v in views)
        n = len(r["scores"])
        if n > total or (total and n == 0):
            raise AssertionError(f"TTA tile {i}: kept {n} of {total}")
        check_detections(r["boxes"], r["scores"])
        if n and (r["boxes"].min() < -1e-3 or r["boxes"].max() > TILE + 1e-3):
            raise AssertionError(f"TTA tile {i}: boxes outside the tile")
        if r["masks"].shape != (n, TILE, TILE):
            raise AssertionError(f"TTA tile {i}: masks {r['masks'].shape}")
    kept = sum(len(r["scores"]) for r in merged)
    log(f"TTA (3 views, {len(tiles)} tiles): {dt:.3f} s; kept {kept} of "
        f"{sum(sum(v[:len(tiles)]) for v in views)} detections")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from nuhtc_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    kernels.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {kernels.library_path()}")

    k1 = phase_k1(device)
    k3 = phase_k3(device)
    k4 = phase_k4(device)
    k2 = phase_k2(device)
    phase_reference(device)
    wsi = phase_slice(device)
    strict = phase_strict(device)

    def entry(name, source, replaces, measured):
        # launches: over both driven paths; no single PyTorch call computes K1-K4
        return {"name": name, "route": "cuda", "source": f"nuhtc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": wsi[name] + strict[name],
                "launches_by_path": {"wsi": wsi[name], "strict": strict[name]},
                **measured, "library_ms": None}

    pallas = "nuhtc_tpu/ops/window_attention_pallas.py"
    kernels_line = [
        entry("window_block", "window_block.cu", f"{pallas}:255", k1),
        entry("window_attention", "window_block.cu", f"{pallas}:128", k2),
        entry("component_stats", "component_stats.cu", "nuhtc_tpu/ops/components_pallas.py:98", k3),
        entry("roi_align", "roi_align.cu", "nuhtc_tpu/ops/roi_align_pallas.py:126", k4),
    ]
    if any(k["launches"] < 1 for k in kernels_line):
        raise AssertionError(f"a kernel was never launched on the main paths: {kernels_line}")
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
