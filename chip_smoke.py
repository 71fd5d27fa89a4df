#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nuhtc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand kernels from ``nuhtc_tpu_torch/csrc`` (into
     ``build/nuhtc_tpu_torch/``);
  3. K1 ``window_block`` against its plain twin at the four Swin-T stage
     shapes of the main path (B16, 512² input), shift 0 and 3, bf16, the
     parameters passed as a ``BlockParams`` pack as ``SwinBlock`` passes
     them; max abs error ≤ 0.05; times from CUDA events (``cuda_ms`` of
     ``nuhtc_tpu_torch/tools/timing.py``: runs of 4 calls, the median of 5
     runs), and beside them, as a yardstick only, the time of the same block as an unfused
     sequence of PyTorch's own bf16 calls (``F.linear`` ×4, softmax,
     ``F.layer_norm``, tanh ``F.gelu``), which the port never runs on the
     card with tier "block";
  4. K3 ``component_stats`` against its plain version at B16, 512², K512 on
     labels from the port's CCL of a blob mask; exactly equal;
  K4. ``roi_align`` (the kernel's one-map mode) against ``roi_align_plain``
     at the six (map, boxes, mode) pairs of one forward (B16, C64; levels
     128² and 64² and the semantic map 128²; R1512 at out 7 with sampling
     ratio 2, the semantic map with pool_from 14; R500 at out 14 with the
     adaptive grid), boxes from a seed that include tiny, large,
     border-crossing and zero-size ones; then the two fused stage calls of a
     forward, ``roi_align_sum`` over p2 + p3 + semantic + a per-RoI bias,
     against ``roi_align_sum_plain``. In f32 max abs error ≤ 1e-4; in bf16,
     against the plain version on the f32 copies of the maps, ≤ 2⁻⁷ of the
     (summed) largest magnitudes: the kernel rounds once. K4's time per
     forward is 3 × the bbox-stage call + the mask-stage call;
  K2. ``window_attention`` against its plain twin at the four stage shapes,
     shift 0 and 3; max abs error ≤ 0.05; the unfused bf16 yardstick up to
     proj beside it;
  5. a small-input reference check: the backbone on the card (through K1,
     then through K2) against the plain CPU path in f32;
  6. the WSI-mode slice: ``init_detector`` on the PanNuke config (Swin-T,
     B16, 256² tiles rescaled to 512², bf16, random weights from a seed,
     the positive-objectness logit raised so detections exist, device
     preprocess and compact label maps), ``run_batch`` on 2 batches of
     synthetic tiles after one warm-up batch; per forward K1 must launch
     12 times, K4 4 times and K3 at least once; outputs finite, label
     maps in [0, 500]; tiles/s;
  7. the strict patch path: the same config with the engine's defaults
     (host preprocess, one full-frame mask per detection) and the Swin
     tier "attn"; per forward K2 12 times, K4 4 times, K3 at least once;
     masks (n, 256, 256) uint8 of 0/1; tiles/s and the collect split. Then
     flip TTA on 4 tiles: no more detections than the three views
     together, kept boxes inside the tile.
K3's and K4's times are taken twice: by CUDA events around runs of 4 calls
(``ms``, as for K1 and K2) and as the card's time alone, from 20 calls
replayed as one CUDA graph (``device_ms``), because K3's wrapper spends more
time on the host than its kernels on the card.
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


def unfused_bf16(pack, mask, nh, mlp: bool):
    """The block (or, without ``mlp``, attention and proj) as a sequence of
    PyTorch's own bf16 calls on the card. A yardstick for the kernels' times
    only: it rounds to bf16 after every call and is compared with nothing."""
    import torch
    import torch.nn.functional as F
    from nuhtc_tpu_torch.ops.window_block import window_partition, window_reverse

    bf = torch.bfloat16
    bias = pack.bias49.to(bf)[None]
    if mask is not None:
        bias = (bias + mask[:, None]).to(bf)  # (nW, nh, N, N)
    vec = {k: getattr(pack, k).to(bf) for k in ("bqkv", "bproj", "g2", "b2", "bfc1", "bfc2")
           if hasattr(pack, k)}

    def run(xp, h1p):
        b, hp, wp, c = h1p.shape
        wins = window_partition(h1p, 7)
        bw, n = wins.shape[:2]
        qkv = F.linear(wins, pack.wqkv, vec["bqkv"]).reshape(bw, n, 3, nh, c // nh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * (c // nh) ** -0.5) @ k.transpose(-1, -2)
        attn = (attn.reshape(b, -1, nh, n, n) + bias).reshape(bw, nh, n, n)
        o = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        y = F.linear(window_reverse(o, 7, hp, wp), pack.wproj, vec["bproj"])
        if not mlp:
            return y
        x2 = xp + y
        h2 = F.layer_norm(x2, (c,), vec["g2"], vec["b2"], eps=1e-5)
        u = F.gelu(F.linear(h2, pack.wfc1, vec["bfc1"]), approximate="tanh")
        return x2 + F.linear(u, pack.wfc2, vec["bfc2"])

    return run


def phase_swin_kernel(device, which: str):
    """K1 ("block") or K2 ("attn") at the four stage shapes, both shifts."""
    import torch
    from nuhtc_tpu_torch.ops import window_block as wb
    from nuhtc_tpu_torch.tools.timing import cuda_ms

    block = which == "block"
    name = "K1 window_block" if block else "K2 window_attention"
    kernel, plain = ((wb.window_block, wb.window_block_plain) if block
                     else (wb.window_attention, wb.window_attention_plain))
    tol = K1_TOL if block else K2_TOL
    gen = torch.Generator(device=device).manual_seed(0 if block else 1)
    err, ms, plain_ms, unfused_ms = 0.0, 0.0, 0.0, 0.0
    for side, c, nh, depth in STAGES:
        inp = k1_inputs(side, c, nh, gen, device)
        maps = (inp.pop("xp"), inp.pop("h1p")) if block else (inp.pop("h1p"),)
        if not block:
            inp = {k: inp[k] for k in ("wqkv", "bqkv", "wproj", "bproj", "bias49")}
        pack = wb.BlockParams(**inp)  # made once, as SwinBlock.kernel_params makes it
        params = pack.block() if block else pack.attention()
        for shift in (0, 3):
            kw = dict(ws=7, num_heads=nh, shift=shift)
            got = kernel(*maps, *params, **kw)
            want = plain(*maps, **inp, **kw)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            if not np.isfinite(e) or e > tol or got.shape != want.shape:
                raise AssertionError(f"{name} {side}² C{c} shift {shift}: max abs err {e}")
            del got, want
            mask = None
            if shift:
                mask = torch.from_numpy(wb.shift_attn_mask(side, side, 7, shift)).to(device)
            yard = unfused_bf16(pack, mask, nh, mlp=block)
            xh = maps if block else (None, maps[0])
            t_k = cuda_ms(lambda: kernel(*maps, *params, **kw))
            t_p = cuda_ms(lambda: plain(*maps, **inp, **kw))
            t_u = cuda_ms(lambda: yard(*xh))
            b_ms, b_by = bound_ms(block_bound(side, c, which)[0], PEAK_BF16,
                                  block_bound(side, c, which)[1])
            log(f"{name} {BATCH}x{side}x{side}x{c} heads {nh} shift {shift}: "
                f"max_abs_err {e:.5f} kernel {t_k:.3f} ms plain {t_p:.3f} ms "
                f"unfused bf16 {t_u:.3f} ms bound {b_ms:.4f} ms ({b_by})")
            err = max(err, e)
            ms += t_k * depth / 2  # half the stage's blocks are shifted
            plain_ms += t_p * depth / 2
            unfused_ms += t_u * depth / 2
        del inp, maps, pack, params
    flops = sum(block_bound(side, c, which)[0] * d for side, c, _, d in STAGES)
    nbytes = sum(block_bound(side, c, which)[1] * d for side, c, _, d in STAGES)
    bound, by = bound_ms(flops, PEAK_BF16, nbytes)
    log(f"{name} per forward (12 blocks): kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"unfused bf16 sequence (yardstick) {unfused_ms:.3f} ms bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                unfused_bf16_ms=unfused_ms)


def _cells_per_bin(rois, scale, out_size, sampling_ratio, pool_from, h, w):
    """Per RoI and bin row / bin column, the distinct map cells with a
    non-zero weight: (B, R, out) each, from the plain version's Sy and Sx."""
    from nuhtc_tpu_torch.ops.roi_align import _geometry, _interp_matrix

    sh, bh, gh, sw, bw, gw, mg = _geometry(rois, scale, out_size, sampling_ratio, 8, pool_from)
    ny = (_interp_matrix(sh, bh, gh, out_size, h, mg) != 0).sum(-1)
    nx = (_interp_matrix(sw, bw, gw, out_size, w, mg) != 0).sum(-1)
    return ny, nx, gh, gw


def roi_work(feats, rois, scales, out_size, sampling_ratios, pool_froms, bias=None):
    """FLOP and bytes of one (fused) RoIAlign call on these boxes, in the
    cheapest exact form: per map, one multiply-add per channel and distinct
    cell under each bin, one multiply per such cell for its weight, and 8
    operations per sample point and axis for the weight lists; every map, the
    boxes and the bias read once, the one output written once."""
    c = feats[0].shape[-1]
    flops = 0.0
    for feat, scale, ratio, pool_from in zip(feats, scales, sampling_ratios, pool_froms):
        ny, nx, gh, gw = _cells_per_bin(rois, scale, out_size, ratio, pool_from, *feat.shape[1:3])
        rows, cols = ny.sum(-1).double(), nx.sum(-1).double()
        flops += (2.0 * c + 1.0) * float((rows * cols).sum())
        flops += 8.0 * out_size * float((gh.long() + gw.long()).sum())
    out_elems = rois.shape[0] * rois.shape[1] * out_size * out_size * c
    nbytes = (sum(f.numel() * f.element_size() for f in feats) + rois.numel() * 4
              + (0 if bias is None else bias.numel() * 4) + out_elems * feats[0].element_size())
    return flops, nbytes


def phase_k4(device):
    import torch
    from nuhtc_tpu_torch.ops.roi_align import (
        roi_align, roi_align_plain, roi_align_sum, roi_align_sum_plain)
    from nuhtc_tpu_torch.tools.synthetic import roi_stage_inputs
    from nuhtc_tpu_torch.tools.timing import cuda_ms, graph_ms

    maps, box_rois, mask_rois, stages = roi_stage_inputs(device, BATCH, ROI_R, MASK_R, FPN_C)
    # the kernel's one-map mode at the six (map, boxes, mode) pairs of a forward
    calls = [
        ("p2", 4, box_rois, dict(output_size=7, sampling_ratio=2)),
        ("p3", 8, box_rois, dict(output_size=7, sampling_ratio=2)),
        ("semantic", 4, box_rois, dict(output_size=7, sampling_ratio=0, pool_from=14)),
        ("p2", 4, mask_rois, dict(output_size=14, sampling_ratio=0)),
        ("p3", 8, mask_rois, dict(output_size=14, sampling_ratio=0)),
        ("semantic", 4, mask_rois, dict(output_size=14, sampling_ratio=0)),
    ]
    err32 = err16 = 0.0
    for name, stride, rois, kw in calls:
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
        flops, nbytes = roi_work([bmap], rois, [scale], kw["output_size"],
                                 [kw["sampling_ratio"]], [kw.get("pool_from")])
        b_ms, b_by = bound_ms(flops, PEAK_F32, nbytes)
        log(f"K4 roi_align (one map) {name} {tuple(bmap.shape)} R{rois.shape[1]} {kw}: "
            f"f32 err {e32:.2e}; bf16 err {e16:.5f} (plain bf16 {e16_plain:.5f}, allowed "
            f"{tol:.5f}); kernel {t_k:.3f} ms bound {b_ms:.4f} ms ({b_by})")
        err32, err16 = max(err32, e32), max(err16, e16)

    # the fused stage calls, as NuHTC._roi_features makes them
    ms = device_ms = plain_ms = total_flops = total_bytes = bound_sum = 0.0
    f32maps = [maps["p2"], maps["p3"], maps["semantic"]]
    bmaps = [m.bfloat16() for m in f32maps]
    for name, rois, bias, per_forward, args in stages:
        want = roi_align_sum_plain(f32maps, rois, *args, bias=bias)
        got = roi_align_sum(f32maps, rois, *args, bias=bias)
        torch.cuda.synchronize()
        e32 = (got - want).abs().max().item()
        if got.shape != want.shape or not np.isfinite(e32) or e32 > 1e-4:
            raise AssertionError(f"K4 f32 {name}: max abs err {e32}")
        del got, want
        ref = roi_align_sum_plain([m.float() for m in bmaps], rois, *args, bias=bias)
        got = roi_align_sum(bmaps, rois, *args, bias=bias)
        plain16 = roi_align_sum_plain(bmaps, rois, *args, bias=bias)
        torch.cuda.synchronize()
        # one bf16 rounding of a sum as large as the summed largest magnitudes
        tol = 2.0 ** -7 * (sum(m.float().abs().max().item() for m in bmaps)
                           + bias.abs().max().item())
        e16 = (got.float() - ref).abs().max().item()
        e16_plain = (plain16.float() - ref).abs().max().item()
        if got.dtype != torch.bfloat16 or not np.isfinite(e16) or e16 > tol:
            raise AssertionError(f"K4 bf16 {name}: max abs err {e16} > {tol}")
        del got, ref, plain16
        t_k = cuda_ms(lambda: roi_align_sum(bmaps, rois, *args, bias=bias))
        t_d = graph_ms(lambda: roi_align_sum(bmaps, rois, *args, bias=bias))
        t_p = cuda_ms(lambda: roi_align_sum_plain(bmaps, rois, *args, bias=bias))
        flops, nbytes = roi_work(bmaps, rois, *args, bias=bias)
        b_ms, b_by = bound_ms(flops, PEAK_F32, nbytes)
        log(f"K4 roi_align_sum {name} (p2 + p3 + semantic + bias, R{rois.shape[1]} out {args[1]}"
            f" ratios {args[2]} pool_from {args[3]}): f32 err {e32:.2e}; bf16 err {e16:.5f} "
            f"(plain bf16 composition {e16_plain:.5f}, allowed {tol:.5f}); kernel {t_k:.3f} ms "
            f"(device alone {t_d:.3f} ms) plain {t_p:.3f} ms bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        err32, err16 = max(err32, e32), max(err16, e16)
        ms += t_k * per_forward
        device_ms += t_d * per_forward
        plain_ms += t_p * per_forward
        total_flops += flops * per_forward
        total_bytes += nbytes * per_forward
        bound_sum += b_ms * per_forward
    by = bound_ms(total_flops, PEAK_F32, total_bytes)[1]
    log(f"K4 per forward (3 bbox-stage calls + 1 mask-stage call): kernel {ms:.3f} ms (device "
        f"alone {device_ms:.3f} ms) plain "
        f"{plain_ms:.3f} ms bound {bound_sum:.4f} ms ({by}); max abs err f32 {err32:.2e}, "
        f"bf16 {err16:.5f}")
    return dict(max_abs_err=err16, max_abs_err_f32=err32, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_sum, bound_by=by)


def phase_k3(device):
    import torch
    from nuhtc_tpu_torch.ops.components import (
        component_stats, component_stats_plain, first_roots, label_components_raw)
    from nuhtc_tpu_torch.tools.synthetic import blob_mask
    from nuhtc_tpu_torch.tools.timing import cuda_ms, graph_ms

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
    t_d = graph_ms(lambda: component_stats(lab, roots))
    t_p = cuda_ms(lambda: component_stats_plain(lab, roots))
    # labels and roots read once, boxes and areas written once; int compares only
    nbytes = lab.numel() * 4 + roots.numel() * 4 + boxes.numel() * 4 + areas.numel() * 4
    bound, by = bound_ms(0.0, PEAK_F32, nbytes)
    log(f"K3 component_stats {BATCH}x512x512 K512 ({int(valid.sum())} components): "
        f"exact; kernel {t_k:.4f} ms (device alone "
        f"{t_d:.4f} ms: its two launches without the wrapper's host work) plain {t_p:.3f} ms "
        f"bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=0.0, ms=t_k, device_ms=t_d, plain_ms=t_p, bound_ms=bound,
                bound_by=by)


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
    other's, 4 of roi_align (one per cascade stage), at least one of
    component_stats."""
    other = "window_attention" if swin_counter == "window_block" else "window_block"
    ok = (counts[swin_counter] == 12 * forwards and counts[other] == 0
          and counts["roi_align"] == 4 * forwards and counts["component_stats"] >= forwards)
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

    for row in kernels.resource_usage():
        if row["kernel"].startswith(("window_attn_kernel", "block_mlp_kernel")):
            log(f"ptxas: {row['kernel']}: {row['registers']} registers, "
                f"{row['spill_bytes']} spill bytes, {row['static_smem']} bytes static smem")

    k1 = phase_swin_kernel(device, "block")
    k3 = phase_k3(device)
    k4 = phase_k4(device)
    k2 = phase_swin_kernel(device, "attn")
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
