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
  V. ``vit_attention`` (``phase_vit_attention``, csrc/vit_attention.cu) at
     the shapes of the cell vitdet-b-nucls-forward-b8: 8 × 12 heads × 4,096
     tokens on a 64 × 64 grid and 200 windows × 12 heads × 196 tokens on
     14 × 14, with relative-position tables, against its plain twin in f32
     (max abs error ≤ 2⁻⁸ of the largest |v|, derived beside the phase);
     the kernel's time beside its bound, the plain twin's, and one
     ``scaled_dot_product_attention`` call with the bias as a mask as the
     ``library_ms`` yardstick only; then ViTDet-B at 1024², B8 bf16: one
     launch a block, 4 global and 8 window, none of K1-K4; img/s;
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
     together, kept boxes inside the tile. Then one batch against an f32
     engine on the card through the plain versions (Swin tier "none",
     ``roi_align_sum_plain``, ``component_stats_plain``; no kernel launch)
     on the same bf16-rounded weights: detections matched one to one (same
     label, IoU > 0.5) within the bound NUHTC_MATCH_MIN / NUHTC_SCORE_TOL /
     NUHTC_IOU_MEDIAN, whose derivation stands beside it; the FPN's finest
     level, the semantic logits and the proposal counts of both runs printed;
  8. the whole-slide path: a synthetic H&E-like slide from a seed (2304²,
     levels 1 to 32) through ``segment_tissue`` → ``grid_coords`` (256² tiles
     at step 192) → ``infer_slide(mode="all")`` on the WSI-mode engine
     (tier block) into a temporary directory; every tile processed, nuclei
     found, every export file parses and they agree on the count (GeoJSON
     features = points = DSA elements = SQLite rows = rtree rows = COCO
     annotations, COCO images = tiles), every ring closed with ≥ 4 points
     inside the slide, the kernels' launches per forward as in 6, the four
     timing parts within the wall time; tiles/s, the parts and stage A's
     seconds are printed;
  9. the offline whole-slide tools over step 8's output directory: (a)
     ``merge_geojson_file`` on its GeoJSON (0 < kept ≤ features, every kept
     feature one of the inputs; both counts printed: the 64 px tile overlap
     reports nuclei twice); (b) ``extract_slide_features`` over the slide
     and the merged file (at most ``FEATURE_PREFIX`` nuclei, the cut
     printed): rows ≥ 90 % of the nuclei, the columns the port's feature
     keys plus the context columns, every value finite, nuclei/s; (c)
     ``vis_heatmap`` of per-tile scores (nuclei a tile × 100 / max) with
     blur and the default colour map: an RGB uint8 image of the vis level's
     size, written as a PNG; (d) the deep-feature path of
     ``tools/extract_features_nuhtc`` (``iter_slide_features``, the batch
     function without the .h5 writer, which needs h5py) over the 73 tiles
     at B16 with ``init_detector``'s defaults: features (73, 256), finite,
     12 K1 launches a forward and none of K2-K4, the first two tiles within
     step 5's tolerance of the CPU in f32, tiles/s and its split (read,
     stain/resize, host preprocess, forward, pool); then once more with
     stain normalization, its seconds printed;
 10. dataset evaluation and the patch tools (``phase_eval``) on the same
     config: a synthetic PanNuke release of 64 tiles from seed 0 converted
     by ``tools.preprocess_pannuke`` (annotations = instances of ≥ 2 px, all
     five classes); the random weights of seed 0 with the objectness lifted,
     saved as a reference-named ``.pth`` that every tool below loads;
     ``tools.test.main`` on the card at B16 (strict path, tier block) with
     ``save=True format=pannuke``, ``--show-dir`` and ``--work-dir``: every
     image evaluated, the metrics json with the JAX package's keys (values
     finite, in [0, 1]), a 6 × 6 confusion matrix, preds_pannuke.npy
     (64, 256, 256, 6), one overlay per image, 12 K1, 4 K4 and ≥ 1 K3
     launches a forward; img/s with its split (read, run_batch, encode,
     evaluate), the metrics and the detections a tile printed, then
     ``run_dataset`` once more under the profiler for the card's idle share;
     the ground truth fed back as predictions scores PQ, AJI, Dice and mPQ
     of 1 within 1e-5; ``tools.infer``, ``infer_patch``, ``image_demo`` and
     ``feat_map`` (pooled dataset mode, maps with --vis) over 8 of the PNGs:
     every file there and parsed, infer_patch's annotations = the
     detections its thresholds keep, pooled vectors of 4 × 64 finite values,
     K1's launches = 12 a forward;
 11. the corruption-robustness run and the host-only analysis tools
     (``phase_robustness``) on phase 10's release and checkpoint:
     ``tools.analysis_tools.test_robustness.main`` on the card at B16 over
     16 tiles with gaussian_noise, defocus_blur and elastic_transform at
     severities 0 and 3 (4 forwards): 12 K1, 4 K4 and ≥ 1 K3 launches a
     forward, the ``--out`` json with every (corruption, severity) and finite
     metrics, each run's img/s and its split (read, corrupt, run_batch,
     encode, evaluate), a traced run's idle share; the ground truth of those
     tiles as predictions scores PQ 1; then ``pannuke.compute_stats``,
     ``pannuke.compute_stats_all``, ``print_metric``,
     ``calculate_confusion_matrix`` and ``convert_format`` on phase 10's
     arrays, on a host without cv2, pandas, matplotlib or Pillow;
 12. supervised training (``phase_train``) on phase 10's release:
     ``tools.train.main`` on the PanNuke config at full width (B8, 512²,
     bf16 autocast, f32 AdamW + EMA) through the full train pipeline and
     ``PrefetchLoader``: two epochs of 4 steps with a checkpoint and an
     evaluation of the EMA weights after each, then ``--resume-from`` for a
     third; every loss finite, the frozen stage-0 leaves bit-equal to their
     seed-0 start and the rest moved, the EMA moved, the step count and lr
     following on after the resume, 4 K4 forwards and 4 K4 backwards and
     ≥ 1 K3 a step, the gradient K4's backward hands to p2 non-zero; the EMA
     checkpoint through ``init_detector(use_ema=True)`` and one
     ``run_batch``; s/step, img/s and its split (loader wait, forward,
     backward, optimizer + EMA), the card's idle share over 3 profiled
     steps, the peak memory; K4's backward at the four calls of a step
     against autograd through the plain version (f32 within 1e-4 of each
     map's gradient scale, bf16 within 2⁻⁷ of the f32 plain gradients'
     scale), bit-equal over three calls in each type, and K4's forward and
     backward time a step against the bound and the plain version;
 12a. data parallelism (``phase_parallel``) on phase 10's release:
     (a) ``tools.train --launcher pytorch --deterministic`` as one NCCL
     rank against ``--launcher none``, 2 steps: every weight and EMA tensor
     bit-equal, 4 K4, 4 K4-backward, ≥ 1 K3 and no Swin kernel a step, the
     gradients' all-reduce 4 bytes a parameter a step; (b) ``tools.test
     --launcher pytorch`` as one NCCL rank on 16 tiles: the metrics equal
     to ``--launcher none``'s; (c) two gloo ranks on the card at B4 against
     one process at B8 on the same weights, batch and seed: the losses,
     gradient norm, weights and EMA within the bounds derived beside
     PAR_CONT_RTOL, the ranks bit-equal; (d) ``shard_state`` (FSDP2) on a
     1 × 1 mesh: 2 steps, the first's losses against (a)'s, then every Swin
     block through K1 against the plain tier on the gathered weights and
     its K1 pack equal to them in bf16; s/step of each;
 12b. the configs whose train pipelines crop (``phase_train_configs``):
     ``tools.train.main`` for 2 steps without evaluation on the CoNIC config
     (``RandomCrop``) over phase 10's release and on the NuCLS config
     (``FOVCrop`` + ``CusRandomCrop``, the partial-mask head) over a
     synthetic NuCLS release with a field of view per image: losses finite,
     4 K4 and 4 K4-backward launches a step, s/step; then two
     ``--deterministic`` runs of 2 steps on the PanNuke config, each a
     process of its own: their weights compared bit for bit, and the ops
     torch warned have no deterministic implementation printed.
 12c. the other RoI-head families (``phase_variants``): the PanNuke config
     as it stands with its roi head's type switched in configs written to
     the temporary directory. ``HybridTaskCascadeRoIHead_Cus`` (a mask head
     per stage, chained by info-flow) served in WSI mode at B16 (12 K1, 4
     K4, ≥ 1 K3 a forward; tiles/s beside the lite engine's, timed in turns)
     and held against an f32 engine through the plain versions
     (``_strict_vs_f32`` with CUS_SCORE_TOL), then ``tools.train`` for 2
     steps at B8 (every loss finite, the three ``loss_mask`` among them; 6
     K4 and 6 K4-backward launches a step; the stage-2 mask call's backward
     bit-equal over three calls); ``fuse_test`` of
     ``HybridTaskCascadeRoIHead_Lite_Fuse`` at B16 (12 K1, ≥ 1 K3 a forward;
     K3's boxes and areas of the fused instance maps exactly equal to
     ``component_stats_plain``'s) and 2 train steps of it
     (``loss_binary_seg``, 4 K4 and 4 K4-backward launches a step);
 12d. the alternative backbones and the tools of the log, anchor, browse
     and golden kind (``phase_backbones``): ``ViT`` at ViTDet-B's published
     widths with ``ViT_FPN`` 64, B16 of 512² in bf16 against f32 plain on
     the same bf16-rounded weights (the bound derived beside VITDET_B),
     img/s and peak memory, 12 ``vit_attention`` launches a bf16 forward
     and no other hand kernel; ``SwinUnet`` at its
     defaults, B16 of 512² in bf16: 11 K1 launches a forward, against tier
     "none" within 0.05 of each output's scale, tiles/s; the RoI-extractor
     variants on the ViT_FPN pyramid with 512 clustered RoIs a tile
     (``selected_roi_features`` 2 K4 launches, ``local_global_roi_features``
     1, each within 1e-4 of its plain composition on the card, timed beside
     it and the bound; ``pos_attention_pool`` card vs CPU within 1e-4);
     ``analyze_logs``/``analyze_wsi_logs cal_train_time`` on phase_train's
     log.json, ``optimize_anchors`` (k-means) and ``browse_dataset`` (4
     samples) on phase_eval's release, and the end-to-end golden chain
     (``misc.run_e2e_golden``) on the card: the device-free hashes equal to
     tests/goldens/e2e_synthetic_torch.json, the summary beside it;
 12e. the benchmark tools and ``utils.profiling`` (``phase_benchmark``) on
     the PanNuke config at full width, bf16, on phase 10's checkpoint:
     ``analysis_tools.benchmark`` at B16 (20 iterations, log interval 10, 2
     repeats; img/s; 12 K1, 4 K4, ≥ 1 K3 a forward), ``benchmark_wsi`` over
     its 64-tile synthetic slide (two passes at B16 in WSI mode: every tile,
     nuclei > 0, the parts within the wall; tiles/s), ``profiling.trace``
     around one ``run_batch`` (the span and a kernel event, or a dropped
     record, for each of K1's 12 launches in the Chrome trace),
     ``benchmark_train`` at B8 (finite metrics; 4 K4, 4 K4-backward, ≥ 1 K3
     a step; ms/step; K4 and its backward at the step's four calls against
     the plain versions, as in phase_train), ``get_flops`` at 512² on the card and the CPU
     (equal counts; the parameters the engine's), and
     ``misc.wsi_throughput_summary`` over an ``infer_wsi`` run on 16 of the
     slide's tiles (its lines against the files);
 13. the semi-supervised recipe (``phase_semi``), configs/nuhtc/semi_base.py
     as shipped (Mask R-CNN, Swin-T, FPN 64, 8 classes) on a synthetic NuCLS
     release written by the phase: serving at B16 in WSI mode and on the
     strict path (12 K1 and 8 K4 a forward, no K2 or K3; tiles/s), the
     strict path against f32 plain on the card (matched detections);
     ``tools.train.main`` at B8 (4 labelled + 4 unlabelled, bf16 autocast)
     for two epochs of 3 steps and a resumed third, teacher and student
     evaluated each epoch (12 K1, 24 K4, 12 K4 backward a step asserted;
     the momentum ramp, burn-in, pseudo boxes, the teacher's K1 pack
     rebuilt after every EMA write); teacher and student through
     ``init_detector(use_ema=)``; the trained teacher's blocks through K1
     against the plain tier; K4 at a serving forward's and a train step's
     calls against its plain version (its backward also bit-equal over two
     calls); s/step with its split (loader wait,
     teacher forward, student forward, backward, optimizer + EMA), the idle
     share over 3 profiled steps, the peak memory.
K3's and K4's times are taken twice: by CUDA events around runs of 4 calls
(``ms``, as for K1 and K2) and as the card's time alone, from 20 calls
replayed as one CUDA graph (``device_ms``), because K3's wrapper spends more
time on the host than its kernels on the card.
Every count is set to 0 just before a path is driven and read just after it.
The line before the last is a JSON object with each kernel's launches (also
by path: vit, wsi, strict, slide, embed, eval, patch, robustness, train,
train_configs, parallel_train, parallel_test, parallel_2rank, parallel_2d,
cus_serve, cus_train, fuse_serve, fuse_train, backbones, extractors,
golden, benchmark, benchmark_wsi, benchmark_train, semi_serve, semi_train;
K4's backward and the ViT's attention are entries of their own),
error, times and bound (the least time the card could take: the larger of
the bytes moved once over 3.35 TB/s and the operations over the peak rate
for their type), and ``library_ms`` (null but for the ViT's attention); the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from portbench.work.roofline import PEAK_BF16, PEAK_F32, block_bound, bound_ms

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_swin_fpn_pannuke.py")
BATCH = 16
TILE = 256
# (padded map side, C, heads, blocks at this stage) of the main path
STAGES = ((133, 96, 3, 2), (70, 192, 6, 2), (35, 384, 12, 6), (21, 768, 24, 2))
K1_TOL = 0.05
K2_TOL = 0.05
ROI_R, MASK_R, FPN_C = 1512, 500, 64


def log(*args):
    print(*args, flush=True)


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
            b_ms, b_by = bound_ms(block_bound(BATCH, side, c, which)[0], PEAK_BF16,
                                  block_bound(BATCH, side, c, which)[1])
            log(f"{name} {BATCH}x{side}x{side}x{c} heads {nh} shift {shift}: "
                f"max_abs_err {e:.5f} kernel {t_k:.3f} ms plain {t_p:.3f} ms "
                f"unfused bf16 {t_u:.3f} ms bound {b_ms:.4f} ms ({b_by})")
            err = max(err, e)
            ms += t_k * depth / 2  # half the stage's blocks are shifted
            plain_ms += t_p * depth / 2
            unfused_ms += t_u * depth / 2
        del inp, maps, pack, params
    flops = sum(block_bound(BATCH, side, c, which)[0] * d for side, c, _, d in STAGES)
    nbytes = sum(block_bound(BATCH, side, c, which)[1] * d for side, c, _, d in STAGES)
    bound, by = bound_ms(flops, PEAK_BF16, nbytes)
    log(f"{name} per forward (12 blocks): kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
        f"unfused bf16 sequence (yardstick) {unfused_ms:.3f} ms bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                unfused_bf16_ms=unfused_ms)


# ViTDet-B's attention at the shapes of the cell vitdet-b-nucls-forward-b8
# (B8 of 1024²: 64² tokens): (name, sequences, grid h, grid w, blocks a
# forward); the windows are 25 an image of 14², the 64² map padded to 70²
VIT_ATTN_SHAPES = (("global", 8, 64, 64, 4), ("window", 200, 14, 14, 8))
VIT_ATTN_HEADS = 12
VIT_ATTN_FORWARD = (8, 1024)  # the launch check's forward: batch, input side


def _vit_attn_errors(got, want):
    d = (got.float() - want).abs()
    return d.max().item(), d.mean().item()


def phase_vit_attention(device):
    """``vit_attention`` (``csrc/vit_attention.cu``) at VIT_ATTN_SHAPES, on
    bf16 q, k, v drawn at std 1 and relative-position tables drawn at std
    0.02, against its plain twin in f32 on the same values. The rule (the
    card tests'): the kernel's largest and mean absolute error against the
    f32 twin are no larger than those of the port's bf16 plain path
    (``vit_attention_unfused``) on the same inputs. The rule's own check:
    the kernel fed a zeroed ``rel_w`` has to fail it. The kernel's
    time beside its bound (``bound_ms``), the plain twin's, and, as the
    ``library_ms`` yardstick only, one ``scaled_dot_product_attention`` call
    with the bias as an additive (b, heads, n, n) mask, which the port never
    calls. Then ViTDet-B (VITDET_B at 1024²) in bf16, one forward of B8:
    one launch a block, 4 in the global and 8 in the window blocks; img/s.
    Returns the kernel's figures for one forward (4 global + 8 window calls)
    and that forward's launches."""
    import torch
    import torch.nn.functional as F
    from nuhtc_tpu_torch.models.backbones import ViT
    from nuhtc_tpu_torch.ops.vit_attention import (
        rel_bias, vit_attention, vit_attention_plain, vit_attention_unfused)
    from nuhtc_tpu_torch.tools.timing import cuda_ms

    gen = torch.Generator(device=device).manual_seed(22)
    nh, hd = VIT_ATTN_HEADS, 64
    c = nh * hd
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    err = 0.0
    for name, b, h, w, blocks in VIT_ATTN_SHAPES:
        n = h * w
        qkv = torch.randn(b, n, 3 * c, generator=gen, device=device).bfloat16()
        q, k, v = qkv.view(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        rel_h, rel_w = ((torch.randn(2 * side - 1, hd, generator=gen, device=device) * 0.02)
                        .bfloat16() for side in (h, w))
        want = vit_attention_plain(qkv.float(), b, h, w, nh, rel_h.float(), rel_w.float(),
                                   hd ** -0.5)
        k_err = _vit_attn_errors(vit_attention(qkv, b, h, w, nh, rel_h, rel_w, hd ** -0.5), want)
        p_err = _vit_attn_errors(
            vit_attention_unfused(qkv, b, h, w, nh, rel_h, rel_w, hd ** -0.5), want)
        z_err = _vit_attn_errors(vit_attention(qkv, b, h, w, nh, rel_h, torch.zeros_like(rel_w),
                                               hd ** -0.5), want)
        del want
        if not (np.isfinite(k_err).all() and k_err[0] <= p_err[0] and k_err[1] <= p_err[1]):
            raise AssertionError(f"vit_attention {name}: max, mean abs err {k_err} against the "
                                 f"f32 twin, the bf16 plain path's {p_err}")
        if z_err[0] <= p_err[0] and z_err[1] <= p_err[1]:
            raise AssertionError(f"vit_attention {name}: the kernel without bias_w passes the "
                                 f"rule ({z_err} against the bf16 plain path's {p_err})")
        e = k_err[0]
        t_k = cuda_ms(lambda: vit_attention(qkv, b, h, w, nh, rel_h, rel_w, hd ** -0.5))
        t_p = cuda_ms(lambda: vit_attention_plain(qkv, b, h, w, nh, rel_h, rel_w, hd ** -0.5),
                      rounds=3, inner=1)
        bias_h, bias_w = rel_bias(qkv.view(b, n, 3, nh, hd)[:, :, 0], h, w, rel_h, rel_w)
        mask = (bias_h.view(b, nh, h, w, h)[..., :, None]
                + bias_w.view(b, nh, h, w, w)[..., None, :]).reshape(b, nh, n, n)
        del bias_h, bias_w
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                      rounds=3, inner=2)
        del mask
        flops, nbytes = 4.0 * b * nh * n * n * hd, 4 * b * n * c * 2
        b_ms, b_by = bound_ms(flops, PEAK_BF16, nbytes)
        log(f"vit_attention {name} {b}x{nh} heads x{n} tokens ({h}x{w} grid): max, mean abs "
            f"err {k_err[0]:.5f} {k_err[1]:.6f} (bf16 plain path {p_err[0]:.5f} {p_err[1]:.6f}; "
            f"kernel with rel_w zeroed {z_err[0]:.5f} {z_err[1]:.6f}, fails) kernel {t_k:.4f} "
            f"ms bound {b_ms:.4f} ms ({b_by}, "
            f"{100 * b_ms / t_k:.1f} %) plain twin {t_p:.3f} ms sdpa with the bias as a mask "
            f"(yardstick) {t_l:.3f} ms")
        err = max(err, e)
        for key, value in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                           ("bound_ms", b_ms)):
            total[key] += blocks * value
        del qkv, q, k, v, rel_h, rel_w
        torch.cuda.empty_cache()
    log(f"vit_attention per forward (4 global + 8 window blocks): kernel {total['ms']:.3f} ms "
        f"plain twin {total['plain_ms']:.3f} ms sdpa (yardstick) {total['library_ms']:.3f} ms "
        f"bound {total['bound_ms']:.4f} ms ({100 * total['bound_ms'] / total['ms']:.1f} %)")

    fb, side = VIT_ATTN_FORWARD
    vit = _vit_weights(ViT(**dict(VITDET_B, img_size=side)), 0).eval().to(device, torch.bfloat16)
    x = _normalized_tiles(np.random.RandomState(22), fb, side, device, torch.bfloat16)
    marks = []  # (block kind, launches so far) after each block of the first forward
    hooks = [blk.register_forward_hook(lambda m, args, out: marks.append(
        ("window" if m.window_size else "global", vit_attention.launches)))
        for blk in vit.blocks]
    reset_counts()
    with torch.no_grad():
        vit(x)
        for hook in hooks:
            hook.remove()
        fwd_s, _ = _timed(lambda: vit(x), VIT_RUNS)
    counts = read_counts()
    forwards = VIT_RUNS + 2
    by_kind = {"global": 0, "window": 0}
    for i, (kind, launches) in enumerate(marks):
        by_kind[kind] += launches - (marks[i - 1][1] if i else 0)
    want = dict({k: 0 for k in counts}, vit_attention=VIT_ATTN_LAUNCHES * forwards)
    if counts != want or by_kind != {"global": 4, "window": 8}:
        raise AssertionError(f"vit_attention: launches {counts} over {forwards} ViTDet-B "
                             f"forwards, the first by block kind {by_kind}; want {want}, 4 "
                             f"global and 8 window")
    log(f"vit_attention: ViTDet-B at {side}², B{fb} bf16: {fb / fwd_s:.2f} img/s ({1e3 * fwd_s:.2f} ms "
        f"a forward), launches a forward {by_kind}")
    del vit, x
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, forward_ms=1e3 * fwd_s, **total), counts


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
    cfg.model.neck.update(in_channels=[96, 192, 384, 768])  # the neck takes the stages' widths
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
    from nuhtc_tpu_torch.ops.roi_align import roi_align, roi_align_sum_backward
    from nuhtc_tpu_torch.ops.vit_attention import vit_attention
    from nuhtc_tpu_torch.ops.window_block import window_attention, window_block

    return dict(window_block=window_block, window_attention=window_attention,
                component_stats=component_stats, roi_align=roi_align,
                roi_align_backward=roi_align_sum_backward, vit_attention=vit_attention)


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def check_counts(path, counts, forwards, swin_counter):
    """Per forward: 12 launches of the tier's Swin kernel and none of the
    other's, 4 of roi_align (one per cascade stage), at least one of
    component_stats, none of the ViT's attention."""
    other = "window_attention" if swin_counter == "window_block" else "window_block"
    ok = (counts[swin_counter] == 12 * forwards and counts[other] == 0
          and counts["roi_align"] == 4 * forwards and counts["component_stats"] >= forwards
          and counts["vit_attention"] == 0)
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


# The NuHTC strict path in bf16 (K2, K3, K4) against the same tiles in f32
# on the card through the plain versions, on the same bf16-rounded weights,
# detections matched one to one (same label, IoU > 0.5). Set before the
# first run, from bf16's rounding and what is discrete on this path:
# - scores: bf16 keeps 8 significant bits, so each of the ~40 layers on the
#   way to a score (12 Swin blocks of two sublayers, 3 merges, the FPN, 3
#   cascade stages of 4 linear layers) rounds its output by up to 2^-9 of
#   its scale; as a random walk that is sqrt(40) * 2^-8 = 0.025 of a logit's
#   scale, ~0.05 on logits of |2|, 0.2 at four sigma, and a sigmoid or a
#   softmax moves by at most 1/4 of its logit's change: |Δscore| <= 0.05,
#   as the Mask R-CNN's SEMI_SCORE_TOL;
# - boxes: three stages of deltas, each off by that relative error: the
#   pairs' median IoU >= 0.95;
# - which detections exist: the score threshold and the NMS decide it as in
#   the Mask R-CNN, whose bound leaves 20 % unmatched for them; here the
#   semantic logits are also thresholded at 0 before the component
#   proposals (up to 512 a tile, prepended to the RPN's): a pixel whose
#   logit lies within the bf16 error of 0 flips, and a flip on a one-pixel
#   neck splits or joins a component (the 5×5 opening removes isolated
#   flips). Taking a few per cent of the components changed and the
#   cascade sending most of their detections to the same nucleus anyway,
#   10 % more may go unmatched: >= 70 % of the f32 detections matched.
NUHTC_MATCH_MIN, NUHTC_SCORE_TOL, NUHTC_IOU_MEDIAN = 0.7, 0.05, 0.95


def _strict_vs_f32(engine, tiles, config=CONFIG, label="strict path", score_tol=NUHTC_SCORE_TOL):
    """The path of ``engine`` (``config``; bf16, its Swin tier, K3, K4)
    against an f32 engine of the same contract (preprocess, masks) on the
    card with the Swin tier "none", ``roi_align_sum_plain`` and
    ``component_stats_plain``, on the bf16 engine's weights, over the
    same tiles: no kernel launched in the f32 run; ≥ NUHTC_MATCH_MIN of its
    detections matched one to one (``_match``), |Δscore| ≤ ``score_tol``,
    the pairs' median IoU ≥ NUHTC_IOU_MEDIAN. Printed beside them, for
    finding a stage that diverges: the FPN's finest level, the semantic
    logits (their sign is what the component proposals threshold), and the
    RPN and component proposals a tile, of both runs."""
    import torch
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.models import detector as det_mod
    from nuhtc_tpu_torch.models import roi_extractor
    from nuhtc_tpu_torch.ops import components
    from nuhtc_tpu_torch.ops import roi_align as ra

    def traced_run(eng):
        seen = {}

        def keep(name, value):
            seen.setdefault(name, value)  # a hook that returns None keeps the output

        hooks = [eng.model.neck.register_forward_hook(
                     lambda mod, inp, out: keep("p2", out[0].float())),
                 eng.model.roi_head.semantic_head.register_forward_hook(
                     lambda mod, inp, out: keep("sem", out[0][..., 0].float()))]
        plain_rpn, plain_ws = det_mod.rpn_proposals, det_mod.component_proposals_batched

        def rpn(*a, **kw):
            out = plain_rpn(*a, **kw)
            keep("rpn", out[2].sum(1).float().mean().item())
            return out

        def ws(*a, **kw):
            out = plain_ws(*a, **kw)
            keep("ws", out[1].sum(1).float().mean().item())
            return out

        det_mod.rpn_proposals, det_mod.component_proposals_batched = rpn, ws
        try:
            res = eng.run_batch(tiles)
            torch.cuda.synchronize()
        finally:
            det_mod.rpn_proposals, det_mod.component_proposals_batched = plain_rpn, plain_ws
            for h in hooks:
                h.remove()
        return res, seen

    got, seen16 = traced_run(engine)
    ref = init_detector(config, None, batch_size=BATCH, dtype=torch.float32, swin_kernel="none",
                        device_preprocess=engine.device_preprocess,
                        compact_masks=engine.compact_masks)
    ref.model.load_state_dict({k: v.float() for k, v in engine.model.state_dict().items()})
    reset_counts()  # before the patch: the counters are read off these very names
    plain_sum, plain_stats = roi_extractor.roi_align_sum, components.component_stats
    roi_extractor.roi_align_sum = ra.roi_align_sum_plain
    components.component_stats = components.component_stats_plain
    try:
        want, seen32 = traced_run(ref)
    finally:
        roi_extractor.roi_align_sum, components.component_stats = plain_sum, plain_stats
    if any(read_counts().values()):
        raise AssertionError(f"{label} vs f32: the plain f32 path launched a kernel: "
                             f"{read_counts()}")
    del ref
    total, d_score, ious = 0, [], []
    for g, w in zip(got, want):
        total += len(w["scores"])
        for gi, wi, iou in _match(g, w):
            d_score.append(abs(float(g["scores"][gi]) - float(w["scores"][wi])))
            ious.append(iou)
    rate = len(ious) / max(total, 1)
    d_score, ious = np.asarray(d_score or [np.inf]), np.asarray(ious or [0.0])
    p2_16, p2_32 = seen16["p2"], seen32["p2"]
    s16, s32 = seen16["sem"], seen32["sem"]
    dp2 = (p2_16 - p2_32).abs()
    log(f"{label} bf16 vs f32 plain on the card, the same bf16-rounded weights, "
        f"{len(tiles)} tiles: FPN p2 max |Δ| {dp2.max().item():.4f} of max "
        f"|p2| {p2_32.abs().max().item():.3f} (mean |Δ| {dp2.mean().item():.5f});"
        f" semantic logits max |Δ| {(s16 - s32).abs().max().item():.4f}, sign differs at "
        f"{((s16 > 0) != (s32 > 0)).float().mean().item():.5f} of the cells; proposals a tile "
        f"RPN {seen16['rpn']:.1f} / {seen32['rpn']:.1f}, components {seen16['ws']:.1f} / "
        f"{seen32['ws']:.1f} (bf16 / f32)")
    log(f"{label} bf16 vs f32: {len(ious)} of {total} detections matched ({rate:.3f}); "
        f"|Δscore| median {np.median(d_score):.4f}, max {d_score.max():.4f}; box IoU of the pairs "
        f"median {np.median(ious):.4f}, min {ious.min():.4f} (allowed: ≥ {NUHTC_MATCH_MIN} "
        f"matched, |Δscore| ≤ {score_tol}, median IoU ≥ {NUHTC_IOU_MEDIAN})")
    if rate < NUHTC_MATCH_MIN or d_score.max() > score_tol or \
            np.median(ious) < NUHTC_IOU_MEDIAN:
        raise AssertionError(f"{label}: the bf16 card path disagrees with the f32 plain path")
    return dict(matched=rate, score_max=float(d_score.max()), iou_median=float(np.median(ious)))


def phase_strict(device):
    """The strict patch path (host preprocess, one full-frame mask per
    detection) on the Swin tier "attn", then flip TTA on top of it, then one
    batch against the f32 plain path (``_strict_vs_f32``)."""
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
    _strict_vs_f32(engine, batches[1])
    return counts


def phase_slide(device, out_dir):
    """Stage A and stage B over a synthetic slide, through the entry points
    of the whole-slide path, on the WSI-mode engine (tier "block"), into
    ``out_dir``. Returns the launches, the slide, its segmentation and coords."""
    import sqlite3

    import torch
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.data.classes import dataset_classes
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, slide_and_grid
    from nuhtc_tpu_torch.wsi.infer import infer_slide

    side = 2304
    slide, seg, coords, stage_a = slide_and_grid(side, seed=0, tile=TILE, step=192)
    n_holes = sum(len(h) for h in seg.holes)
    if seg.downsample != 32.0 or len(seg.contours) < 2 or n_holes < 1 or not 48 <= len(coords) <= 128:
        raise AssertionError(f"stage A: level downsample {seg.downsample}, {len(seg.contours)} "
                             f"regions, {n_holes} holes, {len(coords)} tiles")
    log(f"slide stage A: {side}² slide segmented at downsample {seg.downsample:g}: "
        f"{len(seg.contours)} tissue regions, {n_holes} holes, {len(coords)} tiles of {TILE}² at "
        f"step 192 in {stage_a:.3f} s")

    engine = init_detector(CONFIG, None, batch_size=BATCH, device_preprocess=True,
                           compact_masks=True, swin_kernel="block")
    if engine.device.type != device.type:
        raise AssertionError("init_detector did not take the card")
    lift_objectness(engine.model)
    engine.run_batch([slide.read_region((int(x), int(y)), 0, (TILE, TILE))
                      for x, y in coords[:BATCH]])  # warm-up
    torch.cuda.synchronize()
    classes = dataset_classes("PanNukeCocoDataset")

    reset_counts()
    stats = infer_slide(engine, slide, coords, out_dir, "slide", classes, patch_size=TILE,
                        mode="all", progress=False)
    torch.cuda.synchronize()
    counts = read_counts()

    def load(name):
        with open(os.path.join(out_dir, name)) as f:
            return json.load(f)

    feats, points = load("slide.geojson"), load("slide_point.geojson")
    dsa, coco = load("slide_dsa.json"), load("coco_nuclei.json")
    conn = sqlite3.connect(os.path.join(out_dir, "slide_dql.db"))
    n_rows = conn.execute("SELECT COUNT(*) FROM contour").fetchone()[0]
    n_rtree = conn.execute("SELECT COUNT(*) FROM rtree").fetchone()[0]
    conn.close()
    n_png = len(os.listdir(os.path.join(out_dir, "patches")))

    n = stats["nuclei"]
    tally = dict(features=len(feats), points=len(points), dsa=len(dsa["elements"]),
                 coco_annotations=len(coco["annotations"]), sql_rows=n_rows, rtree_rows=n_rtree)
    if stats["tiles"] != len(coords) or n <= 0 or set(tally.values()) != {n}:
        raise AssertionError(f"slide: {stats['tiles']} of {len(coords)} tiles, {n} nuclei, "
                             f"exports {tally}")
    if len(coco["images"]) != len(coords) or n_png != len(coords):
        raise AssertionError(f"slide: COCO lists {len(coco['images'])} images, {n_png} patch "
                             f"PNGs, for {len(coords)} tiles")
    # a tile may hang over the slide's edge by less than a tile
    limit = side + TILE
    for feat, point in zip(feats, points):
        ring = np.asarray(feat["geometry"]["coordinates"][0])
        if (len(ring) < 4 or (ring[0] != ring[-1]).any() or ring.min() < 0 or ring.max() > limit
                or not 0 <= feat["properties"]["label"] < len(classes)
                or not np.isfinite(feat["properties"]["score"])):
            raise AssertionError(f"slide: bad feature {feat}")
        xy = np.asarray(point["geometry"]["coordinates"])
        if not (np.isfinite(xy).all() and xy.min() >= 0 and xy.max() <= limit):
            raise AssertionError(f"slide: bad point {point}")
    forwards = -(-len(coords) // BATCH)
    check_counts("slide path", counts, forwards, "window_block")
    parts = ("read_wait_s", "dispatch_s", "collect_s", "post_s")
    if sum(stats[k] for k in parts) > stats["seconds"]:
        raise AssertionError(f"slide: timing parts exceed the wall time: {stats}")
    if stats["collect_device_s"] + stats["collect_download_s"] > stats["collect_s"]:
        raise AssertionError(f"slide: collect's split exceeds collect: {stats}")
    log(f"slide stage B (WSI mode, tier block, mode all): {stats['tiles']} tiles, {n} nuclei in "
        f"{stats['seconds']:.3f} s = {stats['tiles_per_sec']:.2f} tiles/s over {forwards} forwards; "
        f"read_wait {stats['read_wait_s']:.3f} s, dispatch {stats['dispatch_s']:.3f} s, collect "
        f"{stats['collect_s']:.3f} s (device wait {stats['collect_device_s']:.3f} s, download "
        f"{stats['collect_download_s']:.3f} s), post {stats['post_s']:.3f} s; launches {counts}")
    return counts, slide, seg, coords


FEATURE_PREFIX = 4000  # at most this many merged nuclei go through the feature tool


def phase_tools(device, out_dir, slide, seg, coords):
    """The offline whole-slide tools over phase_slide's output: (a) the
    cross-tile merge of its GeoJSON, (b) per-nucleus features of the merged
    nuclei (a fixed prefix of them) from the slide, (c) a score heatmap, (d)
    deep features of every tile on the card, with K1 in the Swin blocks,
    held against the CPU in f32 on two tiles. Returns the launches of (d)."""
    import csv

    import torch
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.tools.extract_features_nuhtc import (
        TIMING_KEYS, embed_batch, iter_slide_features)
    from nuhtc_tpu_torch.tools.wsi_feat_extract import extract_slide_features
    from nuhtc_tpu_torch.utils.imageio import write_png
    from nuhtc_tpu_torch.wsi.features import nucleus_features
    from nuhtc_tpu_torch.wsi.heatmap import vis_heatmap
    from nuhtc_tpu_torch.wsi.merge import merge_geojson_file, polygon_of_feature

    # (a) merge: the 64 px overlap of the tiles reports many nuclei twice
    src = os.path.join(out_dir, "slide.geojson")
    t0 = time.perf_counter()
    merged_path = merge_geojson_file(src)
    t_merge = time.perf_counter() - t0
    with open(src) as f:
        feats = json.load(f)
    with open(merged_path) as f:
        merged = json.load(f)
    key = lambda feat: json.dumps([feat["geometry"], {k: v for k, v in feat["properties"].items()
                                                      if k != "nuclei_id"}], sort_keys=True)
    inputs = {key(feat) for feat in feats}
    if not 0 < len(merged) <= len(feats) or any(key(feat) not in inputs for feat in merged):
        raise AssertionError(f"merge: kept {len(merged)} of {len(feats)}, or kept a feature "
                             "that is not an input")
    log(f"tools (a) merge: {len(feats)} nuclei → {len(merged)} kept "
        f"({len(feats) - len(merged)} cross-tile duplicates) in {t_merge:.3f} s")

    # (b) per-nucleus features of a fixed prefix of the merged nuclei
    part = merged[:FEATURE_PREFIX]
    part_path = os.path.join(out_dir, "slide_merged_prefix.geojson")
    with open(part_path, "w") as f:
        json.dump(part, f)
    out_csv = os.path.join(out_dir, "slide_features.csv")
    t0 = time.perf_counter()
    n_rows = extract_slide_features(slide, part_path, out_csv)
    t_feat = time.perf_counter() - t0
    with open(out_csv, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    probe = np.zeros((16, 16), np.uint8)
    probe[4:12, 5:11] = 1
    columns = list(nucleus_features(np.full((16, 16, 3), 128, np.uint8), probe)) + [
        "label", "class", "score", "nucleus_id"]
    numeric = [i for i, c in enumerate(header) if c != "class"]
    values = np.asarray([[float(r[i]) for i in numeric] for r in rows])
    if (header != columns or len(rows) != n_rows or n_rows < 0.9 * len(part)
            or not np.isfinite(values).all()):
        raise AssertionError(f"features: {n_rows} rows for {len(part)} nuclei, header "
                             f"{header[:4]}..., finite {np.isfinite(values).all()}")
    log(f"tools (b) per-nucleus features: {n_rows} rows × {len(header)} columns for the first "
        f"{len(part)} of {len(merged)} merged nuclei (cut to {FEATURE_PREFIX}) in {t_feat:.3f} s "
        f"= {n_rows / t_feat:.1f} nuclei/s")

    # (c) heatmap of merged nuclei per tile, the default colour map, blurred
    centres = np.asarray([polygon_of_feature(feat).mean(0) for feat in merged])
    counts = np.asarray([((centres >= xy) & (centres < xy + TILE)).all(1).sum() for xy in coords])
    scores = counts * 100.0 / max(counts.max(), 1)
    t0 = time.perf_counter()
    heat = vis_heatmap(slide, scores, coords, seg, blur=True)
    t_heat = time.perf_counter() - t0
    vis = slide.get_best_level_for_downsample(32)
    w, h = slide.level_dimensions[vis]
    if heat.dtype != np.uint8 or heat.shape != (h, w, 3):
        raise AssertionError(f"heatmap {heat.dtype} {heat.shape}, want ({h}, {w}, 3)")
    write_png(os.path.join(out_dir, "heatmap.png"), heat)
    log(f"tools (c) heatmap: {heat.shape[1]}x{heat.shape[0]} RGB at level {vis} from "
        f"{len(coords)} tile scores (max {counts.max()} nuclei a tile) in {t_heat:.3f} s")

    # (d) deep features on the card: init_detector's defaults (host
    # preprocess, tier block), every tile of the slide at B16
    engine = init_detector(CONFIG, None, batch_size=BATCH)
    if engine.device.type != device.type or engine.device_preprocess:
        raise AssertionError("init_detector's defaults are not the strict path on the card")
    tiles = [slide.read_region((int(x), int(y)), 0, (TILE, TILE)) for x, y in coords[:BATCH]]
    embed_batch(engine, tiles)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    timing = dict.fromkeys(TIMING_KEYS, 0.0)
    reset_counts()
    t0 = time.perf_counter()
    out = [f for f, _ in iter_slide_features(engine, slide, coords, TILE, timing=timing)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts_embed = read_counts()
    feats_gpu = np.concatenate(out)
    forwards = -(-len(coords) // BATCH)
    if feats_gpu.shape != (len(coords), 4 * FPN_C) or not np.isfinite(feats_gpu).all():
        raise AssertionError(f"deep features {feats_gpu.shape}, finite "
                             f"{np.isfinite(feats_gpu).all()}")
    if (counts_embed["window_block"] != 12 * forwards or counts_embed["window_attention"]
            or counts_embed["roi_align"] or counts_embed["component_stats"]):
        raise AssertionError(f"deep features: launches over {forwards} forwards: {counts_embed}")
    # the first two tiles on the CPU in f32, with the same random weights
    cpu = init_detector(CONFIG, None, batch_size=2, device="cpu")
    with torch.no_grad():
        want = embed_batch(cpu, tiles[:2])
    err = float(np.abs(feats_gpu[:2] - want).max())
    scale = float(np.abs(want).max())
    log(f"tools (d) deep features vs CPU f32 on 2 tiles: max abs err {err:.4f} "
        f"(values up to {scale:.2f})")
    if not np.isfinite(err) or err > 0.05 * max(1.0, scale):
        raise AssertionError(f"deep features disagree with the CPU: {err} (scale {scale})")
    split = ", ".join(f"{k[:-2]} {timing[k]:.3f} s" for k in TIMING_KEYS)
    log(f"tools (d) deep features (strict preprocess, tier block): {len(coords)} tiles → "
        f"{feats_gpu.shape} in {dt:.3f} s = {len(coords) / dt:.2f} tiles/s over {forwards} "
        f"forwards; {split}; launches {counts_embed}")
    # the same run once more under the profiler: the card's busy time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in iter_slide_features(engine, slide, coords, TILE):
            pass
        torch.cuda.synchronize()
    device_s = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    log(f"tools (d) traced run: the card's kernels and copies {device_s:.3f} s, idle share of "
        f"the untraced {dt:.3f} s run {1 - device_s / dt:.3f}")
    t0 = time.perf_counter()
    stained = np.concatenate([f for f, _ in iter_slide_features(engine, slide, coords, TILE,
                                                                stain_norm=True)])
    torch.cuda.synchronize()
    if stained.shape != feats_gpu.shape or not np.isfinite(stained).all():
        raise AssertionError(f"stain-normalized deep features {stained.shape}")
    log(f"tools (d) deep features with stain normalization: {len(coords)} tiles in "
        f"{time.perf_counter() - t0:.3f} s")
    return counts_embed


EVAL_TILES = 64  # the synthetic PanNuke release of phase 10
PATCH_TILES = 8  # the PNGs the patch tools run over
FEAT_SIDE = 2 * TILE // 4  # FPN level 0 of the 512² input


def check_patch_counts(counts, det_forwards, feat_forwards):
    """K1 12 times a forward of either kind; K4 4 times and K3 at least once
    a detection forward; no K2."""
    if (counts["window_block"] != 12 * (det_forwards + feat_forwards)
            or counts["window_attention"] or counts["roi_align"] != 4 * det_forwards
            or counts["component_stats"] < det_forwards):
        raise AssertionError(f"patch tools: launches {counts} for {det_forwards} detection "
                             f"and {feat_forwards} backbone forwards")


def _captured(fn, argv):
    """Runs a command line's ``main(argv)``, echoes what it printed, returns
    that text; raises when it returns non-zero."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    text = buf.getvalue()
    for line in text.replace("\r", "\n").splitlines():
        if line.strip():
            log(f"  | {line}")
    if rc != 0:
        raise AssertionError(f"{fn.__module__}.main returned {rc}")
    return text


def phase_eval(device, tmp):
    """Dataset evaluation and the patch tools on the PanNuke config at full
    width: (a) a synthetic PanNuke release of EVAL_TILES tiles converted by
    ``preprocess_pannuke``; (b) the config's random weights (seed 0, the
    objectness lifted) saved as a reference-named ``.pth``, which every tool
    loads; (c) ``tools.test.main`` on the card (B16, tier block, strict path):
    metrics json, confusion matrix, ``preds_pannuke.npy``, one overlay per
    image, launches per forward, img/s and its split, then a traced second
    run of ``run_dataset`` for the card's busy time; (d) the ground truth fed
    back as predictions through ``evaluate_dataset``: PQ, AJI, Dice and mPQ
    equal 1; (e) ``infer``, ``infer_patch``, ``image_demo`` and ``feat_map``
    (pooled dataset mode, maps with --vis) over PATCH_TILES of the PNGs.
    Returns the launches of (c) and of (e), and what phase_robustness reads:
    the checkpoint, the data options, the release and the saved predictions."""
    import torch
    from nuhtc_tpu_torch.apis.inference import InferenceEngine, init_detector
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.eval.evaluate import evaluate_dataset, mask_nms
    from nuhtc_tpu_torch.ops import rle
    from nuhtc_tpu_torch.tools import feat_map, image_demo, infer, infer_patch, preprocess_pannuke
    from nuhtc_tpu_torch.tools import test as test_tool
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_pannuke
    from nuhtc_tpu_torch.utils.imageio import read_image

    # (a) the release and its conversion
    t0 = time.perf_counter()
    images, masks, types = synthetic_pannuke(np.random.RandomState(0), EVAL_TILES, TILE)
    release = {}
    for name, arr in (("images", images), ("masks", masks), ("types", types)):
        release[name] = os.path.join(tmp, f"{name}.npy")
        np.save(release[name], arr)
    _captured(preprocess_pannuke.main, [
        "--images", release["images"], "--masks", release["masks"], "--types", release["types"],
        "--fold", "3", "--out-dir", os.path.join(tmp, "datasets"),
        "--coco-dir", os.path.join(tmp, "coco")])
    ann_file = os.path.join(tmp, "coco", "PanNuke_annt_RLE_fold3.json")
    with open(ann_file) as f:
        doc = json.load(f)
    instances = sum(int((np.bincount(masks[i, :, :, c].astype(np.int64).ravel())[1:] >= 2).sum())
                    for i in range(EVAL_TILES) for c in range(5))
    cats = {a["category_id"] for a in doc["annotations"]}
    if len(doc["images"]) != EVAL_TILES or len(doc["annotations"]) != instances or cats != set(
            range(1, 6)):
        raise AssertionError(f"preprocess_pannuke: {len(doc['images'])} images, "
                             f"{len(doc['annotations'])} annotations for {instances} instances, "
                             f"classes {sorted(cats)}")
    rgb = os.path.join(tmp, "datasets", "rgb")
    data = [f"data.test.ann_file={ann_file}", f"data.test.img_prefix={rgb}",
            f"data.test.seg_prefix={os.path.join(tmp, 'datasets', 'rgb_seg')}"]
    log(f"eval (a) data: {EVAL_TILES} synthetic PanNuke tiles, {instances} nuclei "
        f"({instances / EVAL_TILES:.1f} a tile, 5 classes) converted in "
        f"{time.perf_counter() - t0:.3f} s")

    # (b) random weights from seed 0, as a reference-named checkpoint
    cpu = init_detector(CONFIG, None, batch_size=1, device="cpu")
    lift_objectness(cpu.model)
    ckpt = os.path.join(tmp, "pannuke_random_seed0.pth")
    torch.save({"state_dict": cpu.model.state_dict()}, ckpt)
    del cpu

    # (c) tools.test on the card
    show, work = os.path.join(tmp, "show"), os.path.join(tmp, "work")
    forwards = -(-EVAL_TILES // BATCH)
    reset_counts()
    text = _captured(test_tool.main, [
        CONFIG, ckpt, "--eval", "segm", "--eval-options", "save=True", "format=pannuke",
        "--show-dir", show, "--work-dir", work, "--batch-size", str(BATCH), "--cfg-options", *data])
    torch.cuda.synchronize()
    counts_eval = read_counts()
    check_counts("eval", counts_eval, forwards, "window_block")
    summary = json.loads([ln for ln in text.splitlines() if ln.startswith("test: ")][-1][6:])
    with open(os.path.join(work, "eval_metrics.json")) as f:
        metrics = json.load(f)
    stat_keys = ["aji", "aji_plus", "dq", "sq", "pq", "dice", "precision", "recall"]
    want_keys = (stat_keys + [f"multi_pq+_{c}" for c in range(5)] + ["multi_pq+"]
                 + [f"multi_pq_{c}" for c in range(5)] + ["multi_pq", "confusion_matrix"])
    cm = np.asarray(metrics.get("confusion_matrix"), float)
    scalars = np.asarray([metrics[k] for k in want_keys[:-1] if k in metrics], float)
    if (list(metrics) != want_keys or cm.shape != (6, 6) or not np.isfinite(cm).all()
            or not np.isfinite(scalars).all() or scalars.min() < 0 or scalars.max() > 1):
        raise AssertionError(f"eval: metrics {list(metrics)} {scalars} confusion {cm.shape}")
    out_dir = os.path.join(show, "PanNukeCocoDataset")
    preds = np.load(os.path.join(out_dir, "preds_pannuke.npy"), mmap_mode="r")
    overlays = os.listdir(os.path.join(out_dir, "overlay"))
    if (summary["images"] != EVAL_TILES or preds.shape != (EVAL_TILES, TILE, TILE, 6)
            or len(overlays) != EVAL_TILES):
        raise AssertionError(f"eval: {summary['images']} images evaluated, preds "
                             f"{preds.shape}, {len(overlays)} overlays")
    log(f"eval (c) tools.test on {device} (strict path, tier block, B{BATCH}): "
        f"{EVAL_TILES} tiles, {summary['detections'] / EVAL_TILES:.1f} detections a tile, "
        f"{summary['img_per_s']:.2f} img/s over {summary['seconds']:.3f} s: read "
        f"{summary['read_s']:.3f} s, run_batch {summary['run_batch_s']:.3f} s, encode "
        f"{summary['encode_s']:.3f} s, evaluate {summary['evaluate_s']:.3f} s; "
        f"pq {metrics['pq']:.4f} aji {metrics['aji']:.4f} dice {metrics['dice']:.4f} "
        f"multi_pq {metrics['multi_pq']:.4f} multi_pq+ {metrics['multi_pq+']:.4f}; "
        f"launches {counts_eval}")

    # the inference loop once more under the profiler: the card's busy time
    from torch.profiler import ProfilerActivity, profile

    engine = init_detector(CONFIG, ckpt, batch_size=BATCH)
    dataset = build_dataset(dict(
        type="PanNukeCocoDataset", ann_file=ann_file, img_prefix=rgb, test_mode=True))
    test_tool.run_dataset(engine, dataset, BATCH, limit=BATCH)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        test_tool.run_dataset(engine, dataset, BATCH)
        torch.cuda.synchronize()
    traced = time.perf_counter() - t0
    device_s = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    loop_s = summary["read_s"] + summary["run_batch_s"] + summary["encode_s"]
    log(f"eval (c) traced run_dataset ({traced:.3f} s under the profiler): the card's kernels "
        f"and copies {device_s:.3f} s; idle share of the untraced inference loop "
        f"({loop_s:.3f} s) {1 - device_s / loop_s:.3f}, of the whole evaluation "
        f"({summary['seconds']:.3f} s) {1 - device_s / summary['seconds']:.3f}")
    del engine

    # (d) the ground truth as predictions, score 1: the metrics are 1
    gt_results = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        boxes = np.concatenate([ann["bboxes"], np.ones((len(ann["bboxes"]), 1), np.float32)], 1)
        gt_results.append(([boxes[ann["labels"] == c] for c in range(5)],
                           [[m for m, l in zip(ann["masks"], ann["labels"]) if l == c]
                            for c in range(5)]))
    wired = evaluate_dataset(dataset, gt_results)
    off = {k: abs(wired[k] - 1.0) for k in ("pq", "aji", "dice", "multi_pq")}
    if max(off.values()) > 1e-5:
        raise AssertionError(f"eval (d): ground truth as predictions scores {wired}")
    log(f"eval (d) ground truth as predictions: " + ", ".join(
        f"{k} {wired[k]:.7f}" for k in off))

    # (e) the patch tools over PATCH_TILES of the PNGs, on the same checkpoint
    names = sorted(os.listdir(rgb), key=lambda n: int(n.split("_")[1].split(".")[0]))
    patch_dir = os.path.join(tmp, "patch_imgs")
    os.makedirs(patch_dir)
    for name in names[:PATCH_TILES]:
        os.symlink(os.path.join(rgb, name), os.path.join(patch_dir, name))
    sub = dict(doc, images=doc["images"][:PATCH_TILES], annotations=[
        a for a in doc["annotations"] if a["image_id"] < PATCH_TILES])
    sub_file = os.path.join(tmp, "coco", "subset.json")
    with open(sub_file, "w") as f:
        json.dump(sub, f)
    with open(os.path.join(tmp, "list.csv"), "w") as f:
        f.write("image_path\n" + "".join(f"{n}\n" for n in names[:PATCH_TILES]))
    raw = []
    plain_run = InferenceEngine.run_batch

    def recording_run(self, imgs):
        res = plain_run(self, imgs)
        raw.extend(res)
        return res

    out = {k: os.path.join(tmp, k) for k in ("infer", "demo", "feat_ds", "feat_maps")}
    patch_json = os.path.join(tmp, "infer_patch.json")
    t0 = time.perf_counter()
    reset_counts()
    _captured(infer.main, [patch_dir, CONFIG, ckpt, "--out", out["infer"], "--batch-size",
                           str(PATCH_TILES), "--save-json"])
    InferenceEngine.run_batch = recording_run
    try:
        _captured(infer_patch.main, [os.path.join(tmp, "list.csv"), CONFIG, ckpt, "--img-root",
                                     rgb, "--out", patch_json, "--vis-dir",
                                     os.path.join(tmp, "patch_vis")])
    finally:
        InferenceEngine.run_batch = plain_run
    _captured(image_demo.main, [os.path.join(patch_dir, "*.png"), CONFIG, ckpt,
                                "--output", out["demo"]])
    _captured(feat_map.main, ["--config", CONFIG, "--checkpoint", ckpt, "--out", out["feat_ds"],
                              "--batch-size", str(PATCH_TILES), "--cfg-options",
                              f"data.test.ann_file={sub_file}", f"data.test.img_prefix={rgb}"])
    _captured(feat_map.main, [patch_dir, CONFIG, ckpt, "--out", out["feat_maps"], "--vis"])
    torch.cuda.synchronize()
    counts_patch = read_counts()
    t_patch = time.perf_counter() - t0
    # detection forwards: infer 1, infer_patch 1, image_demo 1 a tile; backbone
    # only: feat_map's dataset mode 1, its maps mode 1 a tile
    det_forwards, feat_forwards = 2 + PATCH_TILES, 1 + PATCH_TILES
    check_patch_counts(counts_patch, det_forwards, feat_forwards)
    stems = [n[:-4] for n in names[:PATCH_TILES]]
    want_files = {
        "infer": {f"{s}{e}" for s in stems for e in ("_overlay.png", ".json")},
        "demo": {f"{s}{e}" for s in stems for e in ("_demo.png", ".json")},
        "feat_ds": {f"{s}.npy" for s in stems},
        "feat_maps": {f"{s}{e}" for s in stems
                      for e in ["_fpn.npz"] + [f"_level{i}.png" for i in range(4)]},
    }
    for key, want in want_files.items():
        if set(os.listdir(out[key])) != want:
            raise AssertionError(f"{key}: files {sorted(os.listdir(out[key]))[:6]}...")
    for s in stems:
        with open(os.path.join(out["infer"], s + ".json")) as f:
            dets = json.load(f)
        with open(os.path.join(out["demo"], s + ".json")) as f:
            demo = json.load(f)
        if any(rle.decode(d["segmentation"]).shape != (TILE, TILE) or len(d["prob"]) != 5
               for d in dets) or len(demo["boxes"]) != len(demo["scores"]):
            raise AssertionError(f"infer/image_demo: bad json for {s}")
        for p in (f"{s}_overlay.png", f"{s}_demo.png"):
            if read_image(os.path.join(out["infer" if "overlay" in p else "demo"], p)).shape != (
                    TILE, TILE, 3):
                raise AssertionError(f"bad overlay {p}")
        vec = np.load(os.path.join(out["feat_ds"], s + ".npy"))
        maps = np.load(os.path.join(out["feat_maps"], s + "_fpn.npz"))
        if vec.shape != (4 * FPN_C,) or not np.isfinite(vec).all() or sorted(maps) != [
                f"level{i}" for i in range(4)] or maps["level0"].shape != (FEAT_SIDE, FEAT_SIDE, FPN_C):
            raise AssertionError(f"feat_map: vector {vec.shape}, maps {sorted(maps)}")
    # infer_patch: the annotations are the detections its thresholds keep
    with open(patch_json) as f:
        coco_out = json.load(f)
    kept = 0
    for res in raw:
        sel = res["scores"] >= 0.35
        rles = [rle.encode(m) for m in res["masks"][sel]]
        kept += len(mask_nms(rles, res["scores"][sel], thr=0.05)[1]) if rles else 0
    if len(raw) != PATCH_TILES or len(coco_out["images"]) != PATCH_TILES or len(
            coco_out["annotations"]) != kept:
        raise AssertionError(f"infer_patch: {len(coco_out['annotations'])} annotations, its "
                             f"thresholds keep {kept} of {len(raw)} images' detections")
    log(f"eval (e) patch tools over {PATCH_TILES} tiles (infer, infer_patch: "
        f"{kept} nuclei kept, image_demo, feat_map dataset + maps --vis) in {t_patch:.3f} s; "
        f"{det_forwards} detection and {feat_forwards} backbone forwards; "
        f"launches {counts_patch}")
    context = dict(ckpt=ckpt, data=data, release=release, ann_file=ann_file, rgb=rgb,
                   preds=os.path.join(out_dir, "preds_pannuke.npy"), gt_results=gt_results,
                   subset=sub_file, names=names)
    return counts_eval, counts_patch, context


ROBUST_TILES = 16  # the tiles of each robustness run: one forward at B16
ROBUST_CORRUPTIONS = ("gaussian_noise", "defocus_blur", "elastic_transform")


def phase_robustness(device, tmp, ctx):
    """The corruption-robustness run and the host-only analysis tools, on
    phase_eval's release and checkpoint: (a) ``test_robustness.main`` on the
    card (PanNuke config, B16, tier block, strict path) over ROBUST_TILES
    tiles with ROBUST_CORRUPTIONS at severities 0 and 3 (one clean run, used
    for all three, and three corrupted: 4 forwards): 12 K1, 4 K4 and ≥ 1 K3
    launches a forward, none of K2, every (corruption, severity) in the
    ``--out`` json with finite metrics, img/s of each run and its split (read,
    corrupt, run_batch, encode, evaluate), then the defocus run once more
    under the profiler for the card's idle share; (b) the ground truth of
    those tiles fed as predictions through the same ``evaluate_dataset``
    scores PQ 1; (c) the host-only tools, which need no cv2, pandas,
    matplotlib or Pillow: ``pannuke.compute_stats`` and
    ``pannuke.compute_stats_all --mode iou`` on the release's masks and
    phase_eval's ``preds_pannuke.npy``, ``print_metric`` on the latter's
    tissue table, ``calculate_confusion_matrix`` of the ground truth as
    predictions, ``convert_format`` pannuke → conic. Returns the launches of
    (a)."""
    import torch
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.eval.evaluate import evaluate_dataset
    from nuhtc_tpu_torch.tools.analysis_tools import print_metric, test_robustness
    from nuhtc_tpu_torch.tools.analysis_tools.confusion_matrix import calculate_confusion_matrix
    from nuhtc_tpu_torch.tools.analysis_tools.pannuke import compute_stats, compute_stats_all
    from nuhtc_tpu_torch.tools.dataset import convert_format
    from nuhtc_tpu_torch.tools.test import _SlicedDataset

    # (a) test_robustness on the card
    out_json = os.path.join(tmp, "robustness.json")
    timing = []
    reset_counts()
    t0 = time.perf_counter()
    _captured(lambda argv: test_robustness.main(argv, batch_size=BATCH, timing=timing), [
        CONFIG, ctx["ckpt"], "--limit", str(ROBUST_TILES), "--corruptions", *ROBUST_CORRUPTIONS,
        "--severities", "0", "3", "--out", out_json, "--cfg-options", *ctx["data"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    forwards = (1 + len(ROBUST_CORRUPTIONS)) * -(-ROBUST_TILES // BATCH)
    check_counts("robustness", counts, forwards, "window_block")
    with open(out_json) as f:
        res = json.load(f)
    values = [v for kind in res.values() for sev in kind.values() for v in sev.values()]
    if (list(res) != list(ROBUST_CORRUPTIONS) or any(list(k) != ["0", "3"] for k in res.values())
            or not values or not np.isfinite(values).all()):
        raise AssertionError(f"robustness: json {res}")
    for run in timing:
        kind = ROBUST_CORRUPTIONS[0] if run["corruption"] == "clean" else run["corruption"]
        log(f"robustness (a) {run['corruption']} s{run['severity']} on {device} (B{BATCH}, "
            f"tier block, strict path): {run['images']} tiles in {run['seconds']:.3f} s = "
            f"{run['images'] / run['seconds']:.2f} img/s; read {run['read_s']:.3f} s, corrupt "
            f"{run['corrupt_s']:.3f} s, run_batch {run['run_batch_s']:.3f} s, encode "
            f"{run['encode_s']:.3f} s, evaluate {run['evaluate_s']:.3f} s; "
            f"pq {res[kind][str(run['severity'])]['pq']:.4f}")
    log(f"robustness (a) {len(timing)} runs in {wall:.3f} s (model build included); "
        f"launches {counts}")

    # the defocus run once more under the profiler: the card's busy time
    from torch.profiler import ProfilerActivity, profile

    from nuhtc_tpu_torch.apis.inference import init_detector

    engine = init_detector(CONFIG, ctx["ckpt"], batch_size=BATCH)
    dataset = build_dataset(dict(type="PanNukeCocoDataset", ann_file=ctx["ann_file"],
                                 img_prefix=ctx["rgb"], test_mode=True))
    defocus = lambda x: test_robustness.corrupt(x, "defocus_blur", 3)  # noqa: E731
    test_robustness.run_eval(engine, dataset, ROBUST_TILES, defocus)  # warm-up
    torch.cuda.synchronize()
    parts = {}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        test_robustness.run_eval(engine, dataset, ROBUST_TILES, defocus, parts)
        torch.cuda.synchronize()
    traced = time.perf_counter() - t0
    device_s = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    run = [r for r in timing if r["corruption"] == "defocus_blur"][0]
    log(f"robustness (a) traced defocus_blur s3 run ({traced:.3f} s under the profiler): the "
        f"card's kernels and copies {device_s:.3f} s; idle share of the untraced run "
        f"({run['seconds']:.3f} s) {1 - device_s / run['seconds']:.3f}, of its inference loop "
        f"({run['seconds'] - run['evaluate_s']:.3f} s) "
        f"{1 - device_s / (run['seconds'] - run['evaluate_s']):.3f}")
    del engine

    # (b) the ground truth of the robustness tiles as predictions
    gt = evaluate_dataset(_SlicedDataset(dataset, ROBUST_TILES), ctx["gt_results"][:ROBUST_TILES])
    if abs(gt["pq"] - 1.0) > 1e-5:
        raise AssertionError(f"robustness (b): ground truth as predictions scores {gt}")
    log(f"robustness (b) ground truth as predictions through the run's evaluate_dataset: "
        f"pq {gt['pq']:.7f}")

    # (c) the host-only tools on phase_eval's arrays
    t0 = time.perf_counter()
    stats_json = os.path.join(tmp, "pannuke_stats.json")
    _captured(compute_stats.main, ["--true", ctx["release"]["masks"], "--pred", ctx["preds"],
                                   "--types", ctx["release"]["types"], "--out", stats_json])
    t1 = time.perf_counter()
    with open(stats_json) as f:
        stats = json.load(f)
    if not {"mPQ", "bPQ", "PQ_class_0"} <= set(stats) or not 0 <= stats["bPQ"] <= 1:
        raise AssertionError(f"pannuke.compute_stats: {stats}")
    fold = os.path.join(tmp, "stats_iou")
    _captured(compute_stats_all.main, [
        "--true_path", ctx["release"]["masks"], "--pred_path", ctx["preds"], "--type_path",
        ctx["release"]["types"], "--save_path", fold, "--mode", "iou"])
    t2 = time.perf_counter()
    os.replace(os.path.join(fold, "tissue_stats_PQ.csv"), os.path.join(fold, "tissue_stats.csv"))
    _captured(print_metric.main, ["--path", fold])
    if not os.path.exists(os.path.join(fold, "format_stats.csv")):
        raise AssertionError("print_metric wrote no format_stats.csv")
    cm = calculate_confusion_matrix(dataset, ctx["gt_results"])
    n_ann = sum(len(dataset.get_ann_info(i)["labels"]) for i in range(len(dataset)))
    if cm.shape != (6, 6) or np.trace(cm[:5, :5]) < n_ann or cm[5].sum() or cm[:, 5].sum():
        raise AssertionError(f"confusion matrix of the ground truth: {cm.tolist()}, "
                             f"{n_ann} annotations")
    _captured(convert_format.main, ["--data_path", ctx["preds"], "--format", "pannuke", "--to",
                                    "conic", "--name", "preds_conic"])
    conic = np.load(os.path.join(os.path.dirname(ctx["preds"]), "preds_conic.npy"),
                    mmap_mode="r")
    if conic.shape != (EVAL_TILES, TILE, TILE, 2):
        raise AssertionError(f"convert_format: {conic.shape}")
    t3 = time.perf_counter()
    log(f"robustness (c) host-only tools over {EVAL_TILES} tiles: pannuke.compute_stats "
        f"{t1 - t0:.3f} s (mPQ {stats['mPQ']:.4f}, bPQ {stats['bPQ']:.4f}), "
        f"compute_stats_all iou {t2 - t1:.3f} s, print_metric + confusion matrix "
        f"({int(np.trace(cm[:5, :5]))} of {n_ann} on the diagonal) + convert_format "
        f"{t3 - t2:.3f} s")
    return counts


TRAIN_ITERS = 4  # steps an epoch of phase_train
TRAIN_BATCH = 8  # samples_per_gpu of the PanNuke config
PROFILED_STEPS = 3


def _release_data(ctx):
    """phase_eval's release as a config's ``data``: training on its 64 tiles,
    evaluation on the 8-tile subset."""
    seg = os.path.join(os.path.dirname(ctx["rgb"]), "rgb_seg")
    return dict(train=dict(dataset=dict(ann_file=ctx["ann_file"], img_prefix=ctx["rgb"],
                                        seg_prefix=seg)),
                test=dict(ann_file=ctx["subset"], img_prefix=ctx["rgb"], seg_prefix=seg))


def _train_config(tmp, base, data, name):
    """The config ``base`` as it stands with ``data`` for its datasets, a log
    line every step, a checkpoint and an evaluation every epoch, written as
    ``name``.py. Without Pillow on this host, ``RandCorrupt`` leaves out
    ``jpeg_compression`` (Pillow's codec), the one corruption of the catalog
    that needs it; the line says so."""
    import importlib.util

    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.pipelines import CORRUPTIONS

    lines = [f"_base_ = {base!r}", "log_interval = 1", "checkpoint_interval = 1",
             "evaluation = dict(interval=1)", "data = " + repr(data)]
    note = "the train pipeline as the config has it"
    if importlib.util.find_spec("PIL") is None:
        pipeline = Config.fromfile(base).to_dict()["train_pipeline"]
        for t in pipeline:
            if t["type"] == "RandCorrupt":
                t["corruption"] = [n for n in CORRUPTIONS if n != "jpeg_compression"]
        lines.append("train_pipeline = " + repr(pipeline))
        note = ("no Pillow on this host: RandCorrupt draws from the other 18 corruptions "
                "(jpeg_compression needs Pillow's codec)")
    path = os.path.join(tmp, f"{name}.py")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, note


def _train_rows(work):
    with open(os.path.join(work, "log.json")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["mode"] == "train"], [r for r in rows if r["mode"] == "val"]


def _k4_backward_work(maps, rois, scales, out_size, ratios, pools, with_bias):
    """FLOP and bytes of K4's backward on these boxes: the forward's
    multiply-adds per channel and distinct cell under a bin (one scatter
    each), grad_out and the boxes read once, each map's gradient and the
    bias gradient written once."""
    flops, _ = roi_work(maps, rois, scales, out_size, ratios, pools)
    b, r = rois.shape[:2]
    c = maps[0].shape[-1]
    el = maps[0].element_size()
    nbytes = (b * r * out_size * out_size * c * el + rois.numel() * 4
              + sum(m.numel() * el for m in maps) + (b * r * c * 4 if with_bias else 0))
    return flops, nbytes


@contextlib.contextmanager
def _capture_k4_calls(captured, on_call=None):
    """Wraps the RoI extractor's ``roi_align_sum`` for the body: the first
    four calls that take part in autograd (a train step's) are copied into
    ``captured`` as (maps, rois, bias, args), and ``on_call(out)`` sees the
    output of every such call. The wrapped call is the wrapper itself, so the
    launch counts are those of the run."""
    from nuhtc_tpu_torch.models import roi_extractor

    plain_sum = roi_extractor.roi_align_sum

    def capturing_sum(maps, rois, *args, **kw):
        out = plain_sum(maps, rois, *args, **kw)
        if out.grad_fn is not None:
            if len(captured) < 4:
                captured.append(([m.detach().clone() for m in maps], rois.detach().clone(),
                                 kw["bias"].detach().clone(), args))
            if on_call is not None:
                on_call(out)
        return out

    roi_extractor.roi_align_sum = capturing_sum
    try:
        yield captured
    finally:
        roi_extractor.roi_align_sum = plain_sum


def _check_k4_train_call(maps16, rois, bias, args, label):
    """K4 and K4's backward at one captured train-step call, on the card,
    against their plain versions on the same inputs. The forward: in f32
    (the maps' f32 copies) against ``roi_align_sum_plain``, 1e-4 of the
    summed largest magnitudes of the maps and the bias; in the maps' own
    type against the plain version on their f32 copies, 2^-7 of that sum
    (one rounding). The backward: in f32 against the plain version's
    gradients (1e-4 of each map's gradient scale, the bias's too); in bf16,
    as the train step runs it, against the plain gradients of the f32
    upcast (2^-7 of their scale); two more calls in each type bit-equal.
    Returns (the bf16 gradient used, dict of the errors)."""
    import torch
    from nuhtc_tpu_torch.ops import roi_align as ra

    out_size = args[1]
    shapes = [tuple(m.shape) for m in maps16]
    where = (f"{label}: K4 at a train-step call (B{rois.shape[0]} R{rois.shape[1]} out "
             f"{out_size}, maps {[s[1:3] for s in shapes]})")
    # forward
    maps32 = [m.to(torch.float32, copy=True) for m in maps16]
    scale_f = sum(m.abs().max().item() for m in maps32) + bias.abs().max().item()
    want = ra.roi_align_sum_plain(maps32, rois, *args, bias=bias.float())
    got32 = ra.roi_align_sum(maps32, rois, *args, bias=bias.float())
    got16 = ra.roi_align_sum(maps16, rois, *args, bias=bias)
    torch.cuda.synchronize()
    ef32 = (got32 - want).abs().max().item() / max(scale_f, 1e-30)
    ef16 = (got16.float() - want).abs().max().item() / max(scale_f, 1e-30)
    if (got16.shape != want.shape or got16.dtype != maps16[0].dtype
            or not np.isfinite(ef32) or not np.isfinite(ef16) or ef32 > 1e-4
            or ef16 > 2.0 ** -7):
        raise AssertionError(f"{where}: forward f32 err {ef32}, {maps16[0].dtype} err {ef16} "
                             f"of the summed magnitudes {scale_f}")
    del want, got32, got16
    gen = torch.Generator(device=rois.device).manual_seed(len(shapes) + out_size)
    g32 = torch.randn((rois.shape[0], rois.shape[1], out_size, out_size, shapes[0][3]),
                      generator=gen, device=rois.device)
    # f32: the kernel's gradients against the plain version's
    maps32 = [m.requires_grad_(True) for m in maps32]
    b32 = bias.clone().requires_grad_(True)
    ra.roi_align_sum(maps32, rois, *args, bias=b32).backward(g32)
    want32, want_b = ra.roi_align_sum_backward_plain(g32, shapes, rois, *args, True)
    torch.cuda.synchronize()
    err32 = 0.0
    for m, w in zip(maps32, want32):
        err32 = max(err32, (m.grad - w).abs().max().item() / max(w.abs().max().item(), 1e-30))
    eb = (b32.grad - want_b).abs().max().item() / want_b.abs().max().item()
    # bf16, as the train step runs it
    g16 = g32.bfloat16()
    maps_b = [m.clone().requires_grad_(True) for m in maps16]
    ra.roi_align_sum(maps_b, rois, *args, bias=bias).backward(g16)
    ref, _ = ra.roi_align_sum_backward_plain(g16.float(), shapes, rois, *args, True)
    # the same bits from every call: twice more in each type
    for grads, g in (([m.grad for m in maps32] + [b32.grad], g32),
                     ([m.grad for m in maps_b], g16)):
        for _ in range(2):
            again, again_b = ra.roi_align_sum_backward(g, shapes, rois, *args, True)
            if not all(torch.equal(a, w) for a, w in zip(again + [again_b], grads)):
                raise AssertionError(f"{where}: backward ({g.dtype}), two calls on the same "
                                     f"inputs differ")
    torch.cuda.synchronize()
    e16 = 0.0
    for m, w in zip(maps_b, ref):
        e16 = max(e16, (m.grad.float() - w).abs().max().item() / w.abs().max().item())
    if err32 > 1e-4 or eb > 1e-4 or e16 > 2.0 ** -7:
        raise AssertionError(f"{where}: backward f32 err {err32} (of each map's scale), bias "
                             f"{eb}, bf16 err {e16}")
    return g16, dict(fwd32=ef32, fwd16=ef16, bwd32=err32, bias=eb, bwd16=e16)


def phase_train(device, tmp, ctx):
    """Supervised training through ``python -m nuhtc_tpu_torch.tools.train``
    (``main(argv)``) at full width: the PanNuke config (Swin-T 96, depths
    2-2-6-2, FPN 64, 5 classes, B8 of 256² tiles rescaled to 512², bf16
    autocast) on phase_eval's release through the full train pipeline and
    ``PrefetchLoader``: (a) two epochs of TRAIN_ITERS steps with a
    checkpoint and an evaluation of the EMA weights after each; every loss
    finite; the parameters moved but the frozen stage-0 leaves, bit-equal
    to their seed-0 start; the EMA moved; launches: 4 K4 forwards, 4 K4
    backwards and ≥ 1 K3 a step, 12 K1, 4 K4 and ≥ 1 K3 an evaluation
    forward, no K2; the gradient that K4's backward hands to p2 non-zero;
    s/step, img/s and the split (loader wait, forward, backward, optimizer +
    EMA); (b) ``--resume-from`` the epoch-2 checkpoint for a third epoch:
    the step count and the lr follow on; (c) ``init_detector(checkpoint,
    use_ema=True)`` and one ``run_batch`` on the card; (d) PROFILED_STEPS
    steps under torch.profiler: the card's idle share over them, and the
    peak memory; (e) K4 forward and backward at the four calls of a train
    step (captured from (a)'s first step) against the plain version
    (``_check_k4_train_call``: the forward within 1e-4 in f32 and 2^-7 in
    bf16 of the summed magnitudes; the backward within 1e-4 of each map's
    gradient scale in f32 and 2^-7 of the f32 plain gradients' scale in
    bf16), and their times per step against the bound and the plain
    autograd version. Returns (launches, K4 backward's figures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.data.loader import PrefetchLoader
    from nuhtc_tpu_torch.data.pipelines import build_train_pipeline
    from nuhtc_tpu_torch.models.build import build_detector, init_random_weights
    from nuhtc_tpu_torch.ops import roi_align as ra
    from nuhtc_tpu_torch.tools import train as train_tool
    from nuhtc_tpu_torch.tools.timing import cuda_ms
    from nuhtc_tpu_torch.train.train_state import (
        create_train_state, frozen_mask, lr_schedule, make_train_step)
    from nuhtc_tpu_torch.utils import checkpoint as ckpt
    from nuhtc_tpu_torch.utils.imageio import read_image

    cfg_path, note = _train_config(tmp, CONFIG, _release_data(ctx), "train_pannuke")
    work = os.path.join(tmp, "train_work")
    ck_dir = os.path.join(work, "checkpoints")
    argv = [cfg_path, "--work-dir", work, "--iters-per-epoch", str(TRAIN_ITERS), "--seed", "0"]

    # (a) two epochs; the first step's K4 inputs, and the gradient K4's
    # backward hands to p2 at every call (a hook on the call's autograd node:
    # its grad_inputs follow the forward's inputs, rois, bias, spec, p2, ...)
    captured, p2_grad = [], []

    def p2_hook(out):
        out.grad_fn.register_hook(
            lambda grad_in, grad_out: p2_grad.append(grad_in[3].float().abs().max()))

    timing = []
    reset_counts()
    t0 = time.perf_counter()
    with _capture_k4_calls(captured, p2_hook):
        state = train_tool.main(argv + ["--max-epochs", "2"],
                                trainer_kw=dict(record_timing=timing))
        torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    counts_a = read_counts()
    steps = 2 * TRAIN_ITERS
    evals = 2 * -(-PATCH_TILES // TRAIN_BATCH)
    ok = (counts_a["roi_align_backward"] == 4 * steps
          and counts_a["roi_align"] == 4 * (steps + evals)
          and counts_a["window_block"] == 12 * evals and counts_a["window_attention"] == 0
          and counts_a["component_stats"] >= steps + evals)
    if not ok or state.step != steps:
        raise AssertionError(f"train (a): {state.step} steps, launches {counts_a} for {steps} "
                             f"steps and {evals} evaluation forwards")
    p2 = torch.stack(p2_grad).cpu().numpy()
    if len(p2) != 4 * steps or not np.isfinite(p2).all() or (p2 <= 0).any():
        raise AssertionError(f"train (a): the gradient K4 hands to p2: {p2}")
    rows, val_rows = _train_rows(work)
    loss_keys = [k for k in rows[0] if k.startswith(("loss", "s0.", "s1.", "s2."))]
    if (len(rows) != steps or len(loss_keys) != 13 or len(val_rows) != 2
            or not all(np.isfinite(r[k]) for r in rows for k in loss_keys + ["total", "grad_norm"])):
        raise AssertionError(f"train (a): {len(rows)} train rows, losses {loss_keys}, "
                             f"{len(val_rows)} val rows")
    cfg = Config.fromfile(cfg_path)
    start = build_detector(cfg.model, cfg.model.get("test_cfg"), float(cfg.scale_factor))
    init_random_weights(start, torch.Generator().manual_seed(0))
    start = start.state_dict()
    blob2 = ckpt.read_checkpoint(ck_dir, 2)
    frozen = frozen_mask(blob2["ema_params"])
    bad = [k for k, f in frozen.items() if torch.equal(blob2["params"][k], start[k]) != f]
    ema_moved = sum(not torch.equal(blob2["ema_params"][k], start[k]) for k in frozen)
    if bad or not ema_moved or sorted(os.listdir(ck_dir)) != ["step_1.pt", "step_2.pt"]:
        raise AssertionError(f"train (a): leaves that moved though frozen or stayed though "
                             f"trained: {bad[:6]}; EMA moved in {ema_moved}; "
                             f"{sorted(os.listdir(ck_dir))}")
    warm = timing[1:]
    split = {k: float(np.mean([t[k] for t in warm]))
             for k in ("loader_wait_s", "forward_s", "backward_s", "optimizer_s")}
    step_s = sum(split.values())
    log(f"train ({note}): config {os.path.basename(CONFIG)} at full width, B{TRAIN_BATCH}, "
        f"512² inputs, bf16 autocast")
    log(f"train (a) tools.train on {device}: {steps} steps + 2 evaluations + 2 checkpoints in "
        f"{wall_a:.3f} s; per step (steps 2-{steps}, synchronized) {step_s:.4f} s = "
        f"{TRAIN_BATCH / step_s:.2f} img/s: loader wait {split['loader_wait_s']:.4f} s, "
        f"forward {split['forward_s']:.4f} s, backward {split['backward_s']:.4f} s, "
        f"optimizer + EMA {split['optimizer_s']:.4f} s; the first step "
        f"{sum(timing[0].values()):.3f} s")
    log(f"train (a) losses of the last step: " + ", ".join(
        f"{k} {rows[-1][k]:.4f}" for k in ["total"] + loss_keys) + f", grad_norm "
        f"{rows[-1]['grad_norm']:.3f}, lr {rows[-1]['lr']:.3e}; eval[ema] pq "
        f"{val_rows[-1].get('pq', float('nan')):.4f}; {sum(frozen.values())} frozen leaves "
        f"bit-equal to their start, the other {len(frozen) - sum(frozen.values())} moved, the "
        f"EMA moved in {ema_moved}; K4's gradient at p2 max |g| {p2.min():.3e}..{p2.max():.3e}; "
        f"launches {counts_a}")

    # (b) resume from the epoch-2 checkpoint for a third epoch
    reset_counts()
    t0 = time.perf_counter()
    state = train_tool.main(argv + ["--max-epochs", "3", "--resume-from",
                                    ckpt.checkpoint_file(ck_dir, 2)])
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    counts_b = read_counts()
    rows_b, _ = _train_rows(work)
    sched = lr_schedule(1e-4, 1000, 1e-3, (30, 160), TRAIN_ITERS)
    if (state.step != blob2["step"] + TRAIN_ITERS or state.opt_state.count != state.step
            or [(r["epoch"], r["iter"]) for r in rows_b[steps:]] != [
                (3, i + 1) for i in range(TRAIN_ITERS)]
            or abs(rows_b[steps]["lr"] - sched(steps)) > 1e-12
            or counts_b["roi_align_backward"] != 4 * TRAIN_ITERS
            or ckpt.latest_step(ck_dir) != 3):
        raise AssertionError(f"train (b): resumed to step {state.step} (count "
                             f"{state.opt_state.count}), rows {len(rows_b)}, launches {counts_b}")
    log(f"train (b) --resume-from step_2.pt: steps {blob2['step']} → {state.step}, lr "
        f"{rows_b[steps]['lr']:.3e} at the first resumed step; {wall_b:.3f} s; launches "
        f"{counts_b}")

    # (c) the EMA checkpoint through init_detector, one batch on the card
    reset_counts()
    engine = init_detector(cfg_path, ck_dir, batch_size=TRAIN_BATCH, use_ema=True)
    ema3 = ckpt.read_checkpoint(ck_dir)["ema_params"]
    own = engine.model.state_dict()
    if any(not torch.equal(own[k].float().cpu(), v.to(own[k].dtype).float()) for k, v in
           ema3.items()):
        raise AssertionError("train (c): init_detector(use_ema=True) holds other weights")
    tiles = [read_image(os.path.join(ctx["rgb"], n)) for n in ctx["names"][:TRAIN_BATCH]]
    res = engine.run_batch(tiles)
    torch.cuda.synchronize()
    counts_c = read_counts()
    check_counts("train (c)", counts_c, 1, "window_block")
    if len(res) != TRAIN_BATCH or not all(np.isfinite(r["scores"]).all() and np.isfinite(
            r["boxes"]).all() for r in res):
        raise AssertionError("train (c): run_batch on the EMA checkpoint")
    log(f"train (c) init_detector(step_3 EMA) + run_batch of {TRAIN_BATCH} tiles: "
        f"{sum(len(r['scores']) for r in res)} detections; launches {counts_c}")
    del engine

    # (d) PROFILED_STEPS steps under the profiler: idle share and peak memory
    model = build_detector(cfg.model, cfg.model.get("test_cfg"), float(cfg.scale_factor))
    model.load_state_dict(ckpt.read_checkpoint(ck_dir)["params"])
    model = model.to(device)
    st, tx = create_train_state(model, schedule=lr_schedule(iters_per_epoch=TRAIN_ITERS))
    step_fn = make_train_step(model, tx, compute_dtype=torch.bfloat16)
    ds = build_dataset(cfg.data.train)
    loader = PrefetchLoader(ds, build_train_pipeline(cfg.train_pipeline),
                            batch_size=TRAIN_BATCH, seed=5)
    gen = torch.Generator(device=device)
    it = iter(loader)

    def one_step():
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        gen.manual_seed(st.step)
        step_fn(st, batch, gen)

    try:
        one_step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                one_step()
            torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    finally:
        loader.close()
    peak = torch.cuda.max_memory_allocated(device)
    device_s = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    log(f"train (d) {PROFILED_STEPS} steps under torch.profiler: {traced:.3f} s, the card's "
        f"kernels and copies {device_s:.3f} s, idle share {1 - device_s / traced:.3f}; "
        f"untraced steps (a) {step_s:.4f} s each, idle share against them "
        f"{1 - device_s / (PROFILED_STEPS * step_s):.3f}; torch.cuda.max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB")
    del model, st, tx, step_fn

    # (e) K4 forward and backward at the train step's four calls
    fwd_ms = bwd_ms = plain_fwd_ms = plain_bwd_ms = bound_f = bound_b = 0.0
    err32 = err16 = 0.0
    tot = dict(ff=0.0, fb=0.0, bf=0.0, bb=0.0)
    for maps16, rois, bias, args in captured:
        shapes = [tuple(m.shape) for m in maps16]
        out_size = args[1]
        g16, errs = _check_k4_train_call(maps16, rois, bias, args, "train (e)")
        err32, eb, e16 = max(err32, errs["bwd32"]), errs["bias"], errs["bwd16"]
        err16 = max(err16, e16)
        t_f = cuda_ms(lambda: ra.roi_align_sum(maps16, rois, *args, bias=bias))
        t_b = cuda_ms(lambda: ra.roi_align_sum_backward(g16, shapes, rois, *args, True))
        t_pf = cuda_ms(lambda: ra.roi_align_sum_plain(maps16, rois, *args, bias=bias),
                       rounds=3, inner=2)
        t_pb = cuda_ms(lambda: ra.roi_align_sum_backward_plain(g16, shapes, rois, *args, True),
                       rounds=3, inner=2)
        ff, fbytes = roi_work(maps16, rois, *args, bias=bias)
        bf, bbytes = _k4_backward_work(maps16, rois, *args, True)
        fwd_ms, bwd_ms = fwd_ms + t_f, bwd_ms + t_b
        plain_fwd_ms, plain_bwd_ms = plain_fwd_ms + t_pf, plain_bwd_ms + t_pb
        bound_f += bound_ms(ff, PEAK_F32, fbytes)[0]
        bound_b += bound_ms(bf, PEAK_F32, bbytes)[0]
        tot["ff"], tot["fb"] = tot["ff"] + ff, tot["fb"] + fbytes
        tot["bf"], tot["bb"] = tot["bf"] + bf, tot["bb"] + bbytes
        log(f"K4 at a train-step call (B{rois.shape[0]} R{rois.shape[1]} out {out_size}, maps "
            f"{[s[1:3] for s in shapes]}): forward f32 err {errs['fwd32']:.2e}, bf16 "
            f"{errs['fwd16']:.5f} of the summed magnitudes; backward f32 err {err32:.2e} of the "
            f"gradient scale "
            f"(bias {eb:.2e}), bf16 {e16:.5f} (allowed {2.0 ** -7:.5f}), bit-equal over 3 calls "
            f"in each type; forward {t_f:.3f} ms "
            f"(plain {t_pf:.3f}), backward {t_b:.3f} ms (plain autograd {t_pb:.3f})")
    by_f = bound_ms(tot["ff"], PEAK_F32, tot["fb"])[1]
    by_b = bound_ms(tot["bf"], PEAK_F32, tot["bb"])[1]
    log(f"K4 per train step ({len(captured)} calls): forward {fwd_ms:.3f} ms, bound "
        f"{bound_f:.4f} ms ({by_f}), plain {plain_fwd_ms:.3f} ms; backward {bwd_ms:.3f} ms, "
        f"bound {bound_b:.4f} ms ({by_b}: {tot['bb'] / 1e6:.1f} MB, {tot['bf'] / 1e9:.2f} "
        f"GFLOP), plain autograd {plain_bwd_ms:.3f} ms. Library call: none (torchvision's "
        f"roi_align takes one map and is not on this host)")
    if len(captured) != 4:
        raise AssertionError(f"train (e): captured {len(captured)} K4 calls of a step")
    counts = {k: counts_a[k] + counts_b[k] for k in counts_a}
    return counts, dict(max_abs_err=err16, max_abs_err_f32=err32, ms=bwd_ms,
                        plain_ms=plain_bwd_ms, bound_ms=bound_b, bound_by=by_b,
                        forward_ms=fwd_ms, forward_bound_ms=bound_f)


CROP_CONFIGS = ("htc_lite_swin_fpn_conic.py", "htc_lite_swin_fpn_nucls.py")
CONFIG_STEPS = 2  # steps of each run of phase_train_configs


def phase_train_configs(device, tmp, ctx):
    """The two configs whose train pipelines crop, through ``python -m
    nuhtc_tpu_torch.tools.train`` (``main(argv)``) for CONFIG_STEPS steps
    without evaluation, at full width (bf16 autocast, each config's batch):
    CoNIC (``RandomCrop`` 128², then the PanNuke chain) on phase_eval's
    release, and NuCLS (``FOVCrop`` + ``CusRandomCrop``, the partial-mask
    head) on a synthetic NuCLS release (``synthetic_nucls(fovloc=True)``:
    16 tiles of 256², a field of view in each image record, every other
    annotation box-only). Every loss finite, 4 K4 forwards and 4 K4
    backwards a step; s/step. Then two ``--deterministic`` runs of
    CONFIG_STEPS steps on the PanNuke config, each a process of its own as a
    user starts it (the two side by side): their weights compared bit for
    bit, and every op that torch warned has no deterministic implementation
    printed. Returns the launches of the first two runs."""
    import re

    import torch
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.tools import train as train_tool
    from nuhtc_tpu_torch.tools.synthetic import synthetic_nucls
    from nuhtc_tpu_torch.utils import checkpoint as ckpt

    opts = synthetic_nucls(os.path.join(tmp, "nucls_release"), splits=(("train", 16),),
                           fovloc=True)
    nucls = dict(ann_file=opts["data.train.sup.ann_file"],
                 img_prefix=opts["data.train.sup.img_prefix"],
                 seg_prefix=opts["data.train.sup.seg_prefix"])
    datas = {CROP_CONFIGS[0]: _release_data(ctx),
             CROP_CONFIGS[1]: dict(train=dict(dataset=nucls), test=nucls)}
    counts = {}
    for name in CROP_CONFIGS:
        base = os.path.join(REPO, "configs", "nuhtc", name)
        cfg_path, note = _train_config(tmp, base, datas[name], "train_" + name[:-3])
        work = os.path.join(tmp, "work_" + name[:-3])
        timing = []
        reset_counts()
        t0 = time.perf_counter()
        state = train_tool.main([cfg_path, "--work-dir", work, "--iters-per-epoch",
                                 str(CONFIG_STEPS), "--max-epochs", "1", "--no-validate",
                                 "--seed", "0"], trainer_kw=dict(record_timing=timing))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        rows, _ = _train_rows(work)
        losses = [k for k in rows[0] if k.startswith(("loss", "s0.", "s1.", "s2."))]
        finite = all(np.isfinite(r[k]) for r in rows for k in losses + ["total", "grad_norm"])
        if (state.step != CONFIG_STEPS or len(rows) != CONFIG_STEPS or not finite
                or got["roi_align_backward"] != 4 * CONFIG_STEPS
                or got["roi_align"] != 4 * CONFIG_STEPS or got["window_attention"]
                or got["window_block"]):
            raise AssertionError(f"train {name}: {state.step} steps, {len(rows)} rows, losses "
                                 f"finite {finite}, launches {got}")
        cfg = Config.fromfile(cfg_path)
        batch = cfg.get("samples_per_gpu", None) or cfg.data.get("samples_per_gpu", 8)
        steps = [sum(t.values()) for t in timing]
        log(f"train {name} ({note}): tools.train {CONFIG_STEPS} steps at B{batch} in "
            f"{wall:.3f} s; s/step {', '.join(f'{x:.3f}' for x in steps)} (the first builds "
            f"the cuDNN plans), {batch / steps[-1]:.2f} img/s at the last; last losses: "
            + ", ".join(f"{k} {rows[-1][k]:.4f}" for k in ["total"] + losses)
            + f"; launches {got}")
        counts = {k: counts.get(k, 0) + v for k, v in got.items()}

    # two --deterministic runs of the PanNuke config, each in a process of its
    # own, side by side on the card
    cfg_path, _ = _train_config(tmp, CONFIG, _release_data(ctx), "det_pannuke")
    params, warned, procs = [], set(), []
    t0 = time.perf_counter()
    try:
        for run in range(2):
            with open(os.path.join(tmp, f"det_{run}.err"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "nuhtc_tpu_torch.tools.train", cfg_path,
                     "--work-dir", os.path.join(tmp, f"det_{run}"), "--iters-per-epoch",
                     str(CONFIG_STEPS), "--max-epochs", "1", "--no-validate", "--deterministic",
                     "--seed", "0"], cwd=REPO, stdout=subprocess.DEVNULL, stderr=err))
        codes = [proc.wait(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for run, code in enumerate(codes):
        with open(os.path.join(tmp, f"det_{run}.err")) as f:
            err = f.read()
        if code != 0:
            raise AssertionError(f"--deterministic run {run}: exit {code}\n{err[-4000:]}")
        warned |= set(re.findall(r"(\S+) does not have a deterministic implementation", err))
        blob = ckpt.read_checkpoint(os.path.join(tmp, f"det_{run}", "checkpoints"))
        params.append({k: v for part in ("params", "ema_params") for k, v in
                       ((f"{part}.{n}", t) for n, t in blob[part].items())})
    log(f"train --deterministic: two runs side by side, each a process of its own, in "
        f"{time.perf_counter() - t0:.1f} s")
    differ = [k for k in params[0] if not torch.equal(params[0][k], params[1][k])]
    log(f"train --deterministic, PanNuke config, {CONFIG_STEPS} steps twice: "
        f"{len(params[0]) - len(differ)} of {len(params[0])} weight and EMA tensors bit-equal"
        + (f"; differ: {differ[:8]}" if differ else "") + "; ops torch warned have no "
        f"deterministic implementation: {sorted(warned) or 'none'}")
    return counts


PAR_STEPS = 2  # steps of each tools.train run of phase_parallel
PAR_TILES = 16  # tiles of each tools.test run of phase_parallel
PAR_LR = 1e-3  # (d)'s constant lr: step 2's weights differ from step 1's in bf16, as K1 reads them
# (c) two ranks at B4 against one process at B8 on the same weights, batch and
# seed, bf16 autocast: bounds derived before the first run (PERF.md §6).
# Every product rounds to bf16 (u = 2^-8) at a different M, so a value moves by
# ~u where the two roundings differ. The RPN losses and the semantic Dice read
# the logits through no discrete step (the RPN's samples come from the anchors,
# the gts and the shared draws): 2.5 u relative. The cascade's proposals pass
# through NMS, top-k and K3's thresholded components, where a flipped tie
# swaps a proposal and so a sample: each swapped sample moves a stage loss by
# (l_i - l_j) / N; ≤ 5 % of ~1,000 positives a stage swapped keeps a loss
# within 0.1 relative, and the gradient norm with it. AdamW's first step moves
# an element by lr·g/(|g| + eps) + lr·wd·p, at most lr (1e-7 at the warm-up's
# first step) in either run: the two runs' weights and EMA differ by at most
# 2 lr plus an f32 rounding of each.
PAR_CONT_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_semantic_seg")
PAR_CONT_RTOL = 2.5 * 2 ** -8
PAR_LOSS_RTOL = 0.1
PAR_PARAM_ATOL = 2 * 1e-7


def _torchrun_env(port: int):
    """torchrun's variables for a group of one on this host, set while the
    returned context lasts."""
    import contextlib

    @contextlib.contextmanager
    def env():
        keys = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port))
        old = {k: os.environ.get(k) for k in keys}
        os.environ.update(keys)
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return env()


def _par_step(device, tx_schedule=None, shard=None):
    """The PanNuke config's detector with tools.train's seed-0 weights on
    ``device`` (``shard``: a mesh for ``shard_state``), its train state and
    ``make_train_step`` under bf16 autocast."""
    import torch

    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.models.build import build_detector, init_random_weights
    from nuhtc_tpu_torch.parallel.shard_rules import shard_state
    from nuhtc_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, cfg.model.get("test_cfg"),
                           float(cfg.get("scale_factor", 2.0)))
    init_random_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    if shard is not None:
        shard_state(model, shard)
    state, tx = create_train_state(model, num_stages=3, num_classes=5, schedule=tx_schedule)
    return model, state, make_train_step(model, tx, compute_dtype=torch.bfloat16)


def _timed_steps(device, model, state, step, batch, record):
    """Step 0 on ``batch`` (recorded: metrics, weights, EMA, on the host),
    then step 1, timed; → (record, seconds of step 1, launches)."""
    import torch

    reset_counts()
    for i in range(2):
        gen = torch.Generator(device=device).manual_seed(1_000_003 + state.step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            record.update(metrics={k: float(v) for k, v in metrics.items()},
                          params={n: p.detach().cpu() for n, p in model.named_parameters()},
                          ema={n: e.cpu() for n, e in state.ema_params.items()})
    return record, dt, read_counts()


def _parallel_rank(rank, world, batch_path, out):
    """A rank of phase_parallel (c): this rank's rows of the B8 batch, one
    recorded step and one timed step."""
    import torch

    device = torch.device("cuda", 0)
    host = np.load(batch_path)
    b = len(host["img"]) // world
    batch = {k: torch.from_numpy(host[k][rank * b:(rank + 1) * b]).to(device) for k in host}
    model, state, step = _par_step(device)
    record, dt, counts = _timed_steps(device, model, state, step, batch, {})
    torch.save(dict(record, seconds=dt, counts=counts), os.path.join(out, f"rank{rank}.pt"))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _check_par_losses(label, got, want):
    """(c)'s bounds on each loss and the gradient norm; returns the largest
    relative difference of each kind."""
    worst = {"continuous": 0.0, "cascade": 0.0, "grad_norm": 0.0}
    for k, w in want.items():
        kind = ("grad_norm" if k == "grad_norm" else
                "continuous" if k in PAR_CONT_KEYS else "cascade")
        tol = PAR_CONT_RTOL if kind == "continuous" else PAR_LOSS_RTOL
        r = _rel(got[k], w)
        if not np.isfinite(got[k]) or r > tol:
            raise AssertionError(f"{label}: {k} {got[k]} against {w} (relative {r:.4g} > {tol})")
        worst[kind] = max(worst[kind], r)
    return worst


def phase_parallel(device, tmp, ctx):
    """Data-parallel training and evaluation (``nuhtc_tpu_torch.parallel``)
    on phase_eval's release at full width (the PanNuke config: Swin-T, FPN
    64, B8 of 512², bf16 autocast). (a) ``tools.train.main(...,
    "--launcher", "pytorch", "--deterministic", "--no-validate")`` in this
    process as one NCCL rank (torchrun's variables set here) for PAR_STEPS
    steps, against the same run with ``--launcher none``: every weight and
    EMA tensor bit-equal; a step launches K4 4, K4's backward 4 and K3 ≥ 1
    times and no Swin kernel (training takes the plain blocks, as the JAX
    step); the gradients' all-reduce moves 4 bytes a parameter a step;
    s/step of both. (b) ``tools.test --launcher pytorch`` as one NCCL rank
    on PAR_TILES tiles against ``--launcher none``: the metrics equal; 12
    K1, 4 K4, ≥ 1 K3 a forward. (c) two ranks on the card, two processes on
    gloo (NCCL takes one rank a card), at B4 each against one process at B8
    on the same weights, batch (the loader's first of (a)) and seed,
    drop-path as shipped: every loss, the gradient norm, the weights and
    the EMA within the bounds derived beside PAR_CONT_RTOL; both ranks'
    weights bit-equal; s/step. (d) ``shard_state`` on a 1 × 1 data × model
    mesh (NCCL, FSDP2): 2 steps at the constant lr PAR_LR, the first's
    losses against (a)'s first within (c)'s bounds; a forward after each
    step, and in the second every Swin block through K1 against the plain
    tier on the gathered weights (K1_TOL) and its K1 pack equal to those
    weights in bf16. Returns the launches of the four paths."""
    import torch
    from torch.distributed.tensor import DTensor

    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.data.loader import PrefetchLoader
    from nuhtc_tpu_torch.data.pipelines import build_train_pipeline
    from nuhtc_tpu_torch.ops.window_block import source_key
    from nuhtc_tpu_torch.parallel import mesh as P
    from nuhtc_tpu_torch.parallel.launch import free_port, run_ranks
    from nuhtc_tpu_torch.parallel.shard_rules import make_mesh_2d
    from nuhtc_tpu_torch.tools import test as test_tool
    from nuhtc_tpu_torch.tools import train as train_tool
    from nuhtc_tpu_torch.train.train_state import lr_schedule

    t_phase = time.perf_counter()
    cfg_path, _ = _train_config(tmp, CONFIG, _release_data(ctx), "parallel_pannuke")
    paths = {}

    # (a) tools.train as one NCCL rank against --launcher none
    runs = {}
    for launcher in ("pytorch", "none"):
        work = os.path.join(tmp, f"parallel_{launcher}")
        timing = []
        reset_counts()
        P.reset_collectives()
        with _torchrun_env(free_port()):
            state = train_tool.main([cfg_path, "--work-dir", work, "--iters-per-epoch",
                                     str(PAR_STEPS), "--max-epochs", "1", "--no-validate",
                                     "--deterministic", "--seed", "0", "--launcher", launcher],
                                    trainer_kw=dict(record_timing=timing))
        torch.cuda.synchronize()
        runs[launcher] = dict(state=state, counts=read_counts(), timing=timing,
                              collectives={k: tuple(v) for k, v in P.COLLECTIVES.items()},
                              rows=_train_rows(work)[0])
    torch.use_deterministic_algorithms(False)
    if P.is_distributed():
        raise AssertionError("parallel (a): tools.train left its process group")
    got, want = runs["pytorch"], runs["none"]
    n_params = sum(p.numel() for p in got["state"].params.values())
    differ = [k for part in ("params", "ema_params")
              for k in getattr(want["state"], part)
              if not torch.equal(getattr(got["state"], part)[k], getattr(want["state"], part)[k])]
    c = got["counts"]
    grads = got["collectives"].get("grads", (0, 0))
    if (differ or got["state"].step != PAR_STEPS or c["window_block"] or c["window_attention"]
            or c["roi_align"] != 4 * PAR_STEPS or c["roi_align_backward"] != 4 * PAR_STEPS
            or c["component_stats"] < PAR_STEPS or grads != (PAR_STEPS, PAR_STEPS * 4 * n_params)
            or want["collectives"]):
        raise AssertionError(f"parallel (a): differ {differ[:8]}, steps {got['state'].step}, "
                             f"launches {c}, collectives {got['collectives']} / "
                             f"{want['collectives']}, {n_params} parameters")
    paths["parallel_train"] = c
    s_step = {k: [sum(t.values()) for t in r["timing"]] for k, r in runs.items()}
    log(f"parallel (a) tools.train --launcher pytorch (one NCCL rank) against --launcher none, "
        f"{PAR_STEPS} steps at B{TRAIN_BATCH}, --deterministic: "
        f"{2 * len(want['state'].params)} weight and EMA tensors bit-equal; s/step "
        + "; ".join(f"{k} " + ", ".join(f"{x:.3f}" for x in v) for k, v in s_step.items())
        + f" (the first builds the cuDNN plans); the step's split (pytorch, last): "
        + ", ".join(f"{k} {v:.3f}" for k, v in runs["pytorch"]["timing"][-1].items())
        + f"; collectives (calls, bytes): {got['collectives']} = {n_params} parameters × 4 "
        f"bytes a step for the gradients; launches {c}")

    # (b) tools.test as one NCCL rank against --launcher none
    metrics, summaries = {}, {}
    for launcher in ("pytorch", "none"):
        work = os.path.join(tmp, f"parallel_test_{launcher}")
        reset_counts()
        with _torchrun_env(free_port()):
            text = _captured(test_tool.main, [
                CONFIG, ctx["ckpt"], "--batch-size", str(BATCH), "--limit", str(PAR_TILES),
                "--work-dir", work, "--launcher", launcher, "--cfg-options", *ctx["data"]])
        torch.cuda.synchronize()
        if launcher == "pytorch":
            paths["parallel_test"] = read_counts()
            check_counts("parallel (b)", paths["parallel_test"], -(-PAR_TILES // BATCH),
                         "window_block")
        summaries[launcher] = json.loads(
            [ln for ln in text.splitlines() if ln.startswith("test: ")][-1][6:])
        with open(os.path.join(work, "eval_metrics.json")) as f:
            metrics[launcher] = json.load(f)
    if metrics["pytorch"] != metrics["none"]:
        raise AssertionError(f"parallel (b): metrics {metrics}")
    log(f"parallel (b) tools.test --launcher pytorch (one NCCL rank) against --launcher none "
        f"on {PAR_TILES} tiles at B{BATCH}: the {len(metrics['none'])} metrics equal (pq "
        f"{metrics['none']['pq']:.4f}, aji {metrics['none']['aji']:.4f}); img/s "
        + ", ".join(f"{k} {v['img_per_s']:.2f}" for k, v in summaries.items())
        + f"; launches {paths['parallel_test']}")

    # (c) two gloo ranks on the card at B4 against one process at B8
    cfg = Config.fromfile(cfg_path)
    loader = PrefetchLoader(build_dataset(cfg.data.train),
                            build_train_pipeline(cfg.get("train_pipeline", [])),
                            batch_size=TRAIN_BATCH, seed=0)
    host = loader.make_batch(0)
    loader.close()
    batch_path = os.path.join(tmp, "parallel_batch.npz")
    np.savez(batch_path, **host)
    out = os.path.join(tmp, "parallel_ranks")
    os.makedirs(out)
    t0 = time.perf_counter()
    run_ranks(_parallel_rank, 2, args=(batch_path, out), backend="gloo", device="cuda:0",
              threads=4, timeout=600)
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    model, state, step = _par_step(device)
    single, dt_single, _ = _timed_steps(device, model, state, step, batch, {})
    del model, state, step
    worst = _check_par_losses("parallel (c)", ranks[0]["metrics"], single["metrics"])
    d_param = 0.0
    for part in ("params", "ema"):
        for k, w in single[part].items():
            g = ranks[0][part][k]
            tol = PAR_PARAM_ATOL + 2 * torch.finfo(torch.float32).eps * w.abs()
            d = (g - w).abs()
            if not bool((d <= tol).all()):
                raise AssertionError(f"parallel (c): {part} {k} differs by {float(d.max())}")
            d_param = max(d_param, float(d.max()))
    same = [k for part in ("params", "ema") for k in single[part]
            if torch.equal(ranks[0][part][k], single[part][k])]
    rank_differ = [k for part in ("params", "ema") for k in ranks[0][part]
                   if not torch.equal(ranks[0][part][k], ranks[1][part][k])]
    if rank_differ or ranks[0]["metrics"] != ranks[1]["metrics"]:
        raise AssertionError(f"parallel (c): the ranks differ: {rank_differ[:8]}")
    paths["parallel_2rank"] = {k: ranks[0]["counts"][k] + ranks[1]["counts"][k]
                               for k in ranks[0]["counts"]}
    n_tensors = 2 * len(single["params"])
    log(f"parallel (c) two gloo ranks on the card at B{TRAIN_BATCH // 2} against one process "
        f"at B{TRAIN_BATCH} (same weights, batch, seed; drop-path as shipped): relative "
        f"difference, largest: RPN and semantic losses {worst['continuous']:.3g} (bound "
        f"{PAR_CONT_RTOL:.3g}), cascade losses {worst['cascade']:.3g}, grad_norm "
        f"{worst['grad_norm']:.3g} (bound {PAR_LOSS_RTOL}); weights and EMA: {len(same)} of "
        f"{n_tensors} tensors bit-equal, largest difference {d_param:.3g} (bound "
        f"{PAR_PARAM_ATOL:.3g} + 2 ulp); the ranks bit-equal; total "
        f"{ranks[0]['metrics']['total']:.6f} against {single['metrics']['total']:.6f}, "
        f"grad_norm {ranks[0]['metrics']['grad_norm']:.6f} against "
        f"{single['metrics']['grad_norm']:.6f}; s/step (the second step) ranks "
        f"{ranks[0]['seconds']:.3f}, {ranks[1]['seconds']:.3f}, one process {dt_single:.3f}; "
        f"the two rank processes {t_ranks:.1f} s start to end; launches "
        f"{paths['parallel_2rank']}")

    # (d) shard_state on a 1 x 1 mesh: 2 steps, K1 on the gathered weights
    errs, stale, keys = [], [], []
    guard = {"busy": False}

    def last_block_key(m, args):
        if not guard["busy"] and not m.training:
            keys.append(source_key([m.attn.w_msa.qkv.weight])[1:])

    def k1_against_plain(m, args, out):
        if guard["busy"]:
            return
        guard["busy"] = True
        try:
            m.kernel = "none"
            want_ = m(args[0])
        finally:
            m.kernel, guard["busy"] = "block", False
        scale = want_.float().abs().max().item()
        errs.append((out.float() - want_.float()).abs().max().item() / max(1.0, scale))
        pack, msa = m._params, m.attn.w_msa
        stale.append(any(not torch.equal(getattr(pack, name), t.detach().to(torch.bfloat16))
                         for name, t in (("wqkv", msa.qkv.weight), ("wproj", msa.proj.weight),
                                         ("wfc1", m.ffn.fc1.weight),
                                         ("wfc2", m.ffn.fc2.weight))))

    with _torchrun_env(free_port()):
        P.init_distributed(device=device)
        try:
            mesh = make_mesh_2d(1, 1)
            schedule = lr_schedule(base_lr=PAR_LR, warmup_iters=1, warmup_ratio=1.0)
            model, state, step = _par_step(device, schedule, shard=mesh)
            blocks = [blk for stage in model.backbone.stages for blk in stage.blocks]
            blocks[-1].register_forward_pre_hook(last_block_key)
            reset_counts()
            firsts, forward_errs = [], []
            for i in range(2):
                gen = torch.Generator(device=device).manual_seed(1_000_003 + state.step)
                state, m_ = step(state, batch, gen)
                firsts.append({k: float(v) for k, v in m_.items()})
                hooks = ([blk.register_forward_hook(k1_against_plain) for blk in blocks]
                         if i == 1 else [])
                with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                    det = model.eval()(batch["img"])
                model.reshard()
                model.train()
                for h in hooks:
                    h.remove()
                check_detections(det["boxes"].float().cpu().numpy(),
                                 det["scores"].float().cpu().numpy())
            torch.cuda.synchronize()
            paths["parallel_2d"] = read_counts()
            sharded = sum(1 for p in model.parameters() if isinstance(p, DTensor))
        finally:
            P.destroy_distributed()
    del model, state, step
    worst_d = _check_par_losses("parallel (d)", firsts[0],
                                {k: v for k, v in want["rows"][0].items()
                                 if k in firsts[0]})
    c = paths["parallel_2d"]
    if (len(errs) != 12 or max(errs) > K1_TOL or any(stale) or len(keys) != 2
            or c["window_block"] != 24
            or c["roi_align"] != 4 * 4 or c["roi_align_backward"] != 4 * 2):
        raise AssertionError(f"parallel (d): K1 errors {errs}, stale packs {stale}, "
                             f"launches {c}")
    log(f"parallel (d) shard_state on a 1x1 data x model mesh (NCCL, FSDP2: {sharded} DTensor "
        f"parameters), 2 steps at lr {PAR_LR}: step 1 against (a)'s first step, largest "
        f"relative difference: RPN and semantic {worst_d['continuous']:.3g}, cascade "
        f"{worst_d['cascade']:.3g}, grad_norm {worst_d['grad_norm']:.3g}; after step 2 the "
        f"12 Swin blocks through K1 against the plain tier on the gathered weights: max err "
        f"{max(errs):.4f} of max(1, scale) (allowed {K1_TOL}), every K1 pack equal to the "
        f"gathered weights in bf16; the last block's qkv weight as gathered for the two "
        f"forwards: address and version counter {'the same' if keys[0] == keys[-1] else 'changed'} "
        f"({keys[0][0][:2]} then {keys[-1][0][:2]}); launches {c}")
    log(f"parallel: the phase took {time.perf_counter() - t_phase:.1f} s")
    return paths


CUS_ROI = "HybridTaskCascadeRoIHead_Cus"
FUSE_ROI = "HybridTaskCascadeRoIHead_Lite_Fuse"
VARIANT_STEPS = 2  # steps of each training run of phase_variants
# The _Cus serve path (WSI mode) in bf16 against f32 plain, set before its
# first run. Its detections come out of the same bbox cascade as the lite
# path's (the per-stage mask heads run after the NMS and move no box or
# score), and its input is the device preprocess's, rounded once to bf16
# (one rounding of 2^-9 beside the ~40 layers', 1 % on the random walk),
# so NUHTC_MATCH_MIN and NUHTC_IOU_MEDIAN hold as derived there. The score
# bound takes the number of pairs into account: NUHTC_SCORE_TOL is four
# sigma of that random walk (sigma = 0.0125 of a score), and the largest of
# n ~ 5,000 matched pairs lies near sqrt(2 ln n) = 4.1 sigma (the strict
# path's max read 0.0483, 97 % of it); five sigma, 0.0625, leaves a
# 1-in-1.7-million tail per pair (both signs), 0.3 % for the batch.
CUS_SCORE_TOL = 0.0625


def _variant_config(tmp, roi_type, name):
    """The PanNuke config with its roi head's type switched, as name.py."""
    path = os.path.join(tmp, f"{name}.py")
    with open(path, "w") as f:
        f.write(f"_base_ = {CONFIG!r}\nmodel = dict(roi_head=dict(type={roi_type!r}))\n")
    return path


def _serve_batches(engine, batches):
    """run_batch over ``batches``, synchronized → (seconds, detections)."""
    import torch

    t0 = time.perf_counter()
    n_det = 0
    for tiles in batches:
        results = engine.run_batch(tiles)
        for r in results:
            check_detections(r["boxes"], r["scores"])
            n_det += len(r["scores"])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, n_det


def _variant_train(tmp, ctx, cfg_path, name, capture=None):
    """``tools.train.main`` for VARIANT_STEPS steps without evaluation on
    phase_eval's release → (state, train rows, per-step timing, launches,
    wall seconds). ``capture``: a list that receives the K4 calls of the
    first step that take a gradient."""
    import torch
    from nuhtc_tpu_torch.models import roi_extractor
    from nuhtc_tpu_torch.tools import train as train_tool

    path, _ = _train_config(tmp, cfg_path, _release_data(ctx), "train_" + name)
    work = os.path.join(tmp, "work_" + name)
    plain_sum = roi_extractor.roi_align_sum

    def capturing_sum(maps, rois, *args, **kw):
        out = plain_sum(maps, rois, *args, **kw)
        if out.grad_fn is not None and capture is not None and len(capture) < 6:
            capture.append(([m.detach().clone() for m in maps], rois.detach().clone(), args))
        return out

    timing = []
    roi_extractor.roi_align_sum = capturing_sum
    reset_counts()
    t0 = time.perf_counter()
    try:
        state = train_tool.main([path, "--work-dir", work, "--iters-per-epoch",
                                 str(VARIANT_STEPS), "--max-epochs", "1", "--no-validate",
                                 "--seed", "0"], trainer_kw=dict(record_timing=timing))
        torch.cuda.synchronize()
    finally:
        roi_extractor.roi_align_sum = plain_sum
    wall = time.perf_counter() - t0
    counts = read_counts()
    rows, _ = _train_rows(work)
    return state, rows, timing, counts, wall


def phase_variants(device, tmp, ctx):
    """The two other RoI-head families of ``build_detector`` at full width:
    the PanNuke config as it stands (Swin-T 96, depths 2-2-6-2, FPN 64, 5
    classes, bf16, random weights from seed 0 with the objectness lifted)
    with its roi head's type switched in a config written here.
    (a) ``HybridTaskCascadeRoIHead_Cus`` (a mask head per stage, chained by
    info-flow, sigmoids averaged) served through ``init_detector`` and
    ``run_batch`` in WSI mode at B16, 256² tiles ×2: 12 K1, 4 K4 and ≥ 1
    K3 a forward; its tiles/s beside the lite engine's over the same tiles,
    timed in turns (lite, _Cus, _Cus, lite); one batch against an f32
    engine through the plain versions on the same bf16-rounded weights
    (``_strict_vs_f32``). (b) ``tools.train`` of the _Cus config for
    VARIANT_STEPS steps at B8 on phase_eval's release: every loss finite,
    ``s0/s1/s2.loss_mask`` among them; K4 and K4's backward 6 times a step;
    the last captured K4 call (stage 2's mask RoIs) through K4's backward
    three times, bit-equal; s/step and its split. (c) ``fuse_test`` of the
    ``_Lite_Fuse`` config at B16 (512² input; the seg logits' bias centred
    on each class's median over the first batch, so that the class maps
    hold instances): 12 K1 and ≥ 1 K3 a forward, no K4; the instances'
    boxes and areas from K3 (``component_stats`` over the B·C instance
    maps) equal to ``component_stats_plain`` on the same maps, exactly, and
    the fused boxes equal to them; tiles/s. (d) ``tools.train`` of the
    _Lite_Fuse config for VARIANT_STEPS steps at B8: every loss finite,
    ``loss_binary_seg`` among them; 4 K4 and 4 K4-backward launches a step.
    Returns the launches of the four paths."""
    import torch
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.ops import roi_align as ra
    from nuhtc_tpu_torch.ops.components import component_stats, component_stats_plain
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_tiles

    t_phase = time.perf_counter()
    cus_cfg = _variant_config(tmp, CUS_ROI, "pannuke_cus")
    fuse_cfg = _variant_config(tmp, FUSE_ROI, "pannuke_fuse")

    # (a) _Cus serving, WSI mode, in turns with the lite engine
    engines = {}
    for name, path in (("lite", CONFIG), ("cus", cus_cfg)):
        engines[name] = init_detector(path, None, batch_size=BATCH, device_preprocess=True,
                                      compact_masks=True)
        lift_objectness(engines[name].model)
    heads = engines["cus"].model.roi_head.mask_head
    if not (isinstance(heads, torch.nn.ModuleList) and len(heads) == 3
            and hasattr(heads[2], "conv_res")):
        raise AssertionError("variants (a): the _Cus config did not build three mask heads")
    rng = np.random.RandomState(7)
    batches = [synthetic_tiles(rng, BATCH, TILE) for _ in range(3)]
    for eng in engines.values():
        eng.run_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    lite_s, _ = _serve_batches(engines["lite"], batches[1:2])
    reset_counts()
    cus_s, cus_det = _serve_batches(engines["cus"], batches[1:])
    cus_serve = read_counts()
    lite_s2, _ = _serve_batches(engines["lite"], batches[2:])
    check_counts("variants (a) _Cus serve", cus_serve, 2, "window_block")
    lite_rate = 2 * BATCH / (lite_s + lite_s2)
    log(f"variants (a) _Cus serve (WSI mode, tier block, B{BATCH}, 512² input, bf16): "
        f"{2 * BATCH / cus_s:.2f} tiles/s against the lite engine's {lite_rate:.2f} over the "
        f"same tiles in turns (lite, _Cus, _Cus, lite); {cus_det / (2 * BATCH):.2f} "
        f"detections/tile; launches {cus_serve}")
    del engines["lite"]
    cus_f32 = _strict_vs_f32(engines.pop("cus"), batches[1], config=cus_cfg,
                             label="_Cus serve (WSI mode)", score_tol=CUS_SCORE_TOL)

    # (b) _Cus training
    captured = []
    state, rows, timing, cus_train, wall = _variant_train(tmp, ctx, cus_cfg, "cus", captured)
    loss_keys = [k for k in rows[0] if k.startswith(("loss", "s0.", "s1.", "s2."))]
    finite = all(np.isfinite(r[k]) for r in rows for k in loss_keys + ["total", "grad_norm"])
    if (state.step != VARIANT_STEPS or not finite
            or any(f"s{i}.loss_mask" not in loss_keys for i in range(3))
            or cus_train["roi_align"] != 6 * VARIANT_STEPS
            or cus_train["roi_align_backward"] != 6 * VARIANT_STEPS
            or cus_train["window_attention"] or cus_train["window_block"]
            or cus_train["component_stats"] < VARIANT_STEPS or len(captured) != 6):
        raise AssertionError(f"variants (b) _Cus train: {state.step} steps, losses {loss_keys} "
                             f"finite {finite}, launches {cus_train}, captured {len(captured)}")
    maps, rois, args = captured[-1]
    shapes = [tuple(m.shape) for m in maps]
    gen = torch.Generator(device=device).manual_seed(12)
    g = torch.randn((rois.shape[0], rois.shape[1], args[1], args[1], shapes[0][3]),
                    generator=gen, device=device).to(maps[0].dtype)
    grads = [ra.roi_align_sum_backward(g, shapes, rois, *args, True) for _ in range(3)]
    same = all(torch.equal(a, b) for other in grads[1:]
               for a, b in zip(grads[0][0] + [grads[0][1]], other[0] + [other[1]]))
    if not same or args[1] != 14:
        raise AssertionError(f"variants (b): K4's backward at stage 2's mask call (out "
                             f"{args[1]}): three calls bit-equal {same}")
    split = {k: timing[-1][k] for k in ("loader_wait_s", "forward_s", "backward_s",
                                        "optimizer_s")}
    log(f"variants (b) _Cus tools.train {VARIANT_STEPS} steps at B{TRAIN_BATCH} in {wall:.3f} s: "
        f"s/step {', '.join(f'{sum(t.values()):.3f}' for t in timing)} (the first builds the "
        f"cuDNN plans); the last step: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + "; last losses: " + ", ".join(f"{k} {rows[-1][k]:.4f}" for k in ["total"] + loss_keys)
        + f"; K4's backward at stage 2's mask call (B{rois.shape[0]} R{rois.shape[1]} out 14) "
        f"bit-equal over 3 calls; launches {cus_train}")

    # (c) fuse_test
    engine = init_detector(fuse_cfg, None, batch_size=BATCH, tile_size=TILE)
    lift_objectness(engine.model)
    model = engine.model
    xs = [torch.from_numpy(engine.preprocess(tiles)).to(device, engine.dtype)
          for tiles in batches]
    with torch.no_grad():
        _, sem = model.roi_head.semantic_head(model.extract_feats(xs[0]))
        seg = model.roi_head.seg_branch(xs[0], sem)[1]
        model.roi_head.seg_branch.conv_seg.bias -= seg.reshape(-1, seg.shape[-1]).median(
            dim=0).values.to(engine.dtype)
    model.fuse_test(xs[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = [model.fuse_test(x) for x in xs[1:]]
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    fuse_serve = read_counts()
    forwards = len(outs)
    if (fuse_serve["window_block"] != 12 * forwards or fuse_serve["window_attention"]
            or fuse_serve["roi_align"] or fuse_serve["component_stats"] < forwards):
        raise AssertionError(f"variants (c) fuse_test: launches {fuse_serve} over {forwards} "
                             f"forwards")
    n_inst = 0
    for out in outs:
        b, c, oh, ow = out["fuse_inst"].shape
        if (b, c, oh, ow) != (BATCH, 5, TILE, TILE) or out["fuse_boxes"].shape[-1] != 5:
            raise AssertionError(f"variants (c): fuse_test shapes {tuple(out['fuse_inst'].shape)}")
        inst = out["fuse_inst"].reshape(b * c, oh, ow)
        roots = out["fuse_roots"].reshape(b * c, -1)
        valid = out["fuse_valid"].reshape(b * c, -1)
        raw = torch.where(inst > 0, inst - 1, oh * ow)
        kb, ka = component_stats(raw, roots)
        pb, pa = component_stats_plain(raw, roots)
        fused = out["fuse_boxes"].reshape(b * c, -1, 5)[..., :4]
        if not (torch.equal(kb, pb) and torch.equal(ka, pa)
                and torch.equal(fused[valid], pb[valid])):
            raise AssertionError("variants (c): K3's boxes and areas of the fused instances "
                                 "differ from component_stats_plain's")
        n_inst += int(valid.sum())
    if n_inst == 0:
        raise AssertionError("variants (c): fuse_test found no instance")
    log(f"variants (c) fuse_test (B{BATCH}, {xs[0].shape[1]}² input, {oh}² original frame, "
        f"{c} classes, bf16): "
        f"{forwards * BATCH / fuse_s:.2f} tiles/s; {n_inst / (forwards * BATCH):.2f} instances/"
        f"tile; K3's boxes and areas over the {BATCH * 5} class maps equal to "
        f"component_stats_plain's, exactly; launches {fuse_serve}")
    del engine, model

    # (d) _Lite_Fuse training
    state, rows, timing, fuse_train, wall = _variant_train(tmp, ctx, fuse_cfg, "fuse")
    loss_keys = [k for k in rows[0] if k.startswith(("loss", "s0.", "s1.", "s2."))]
    finite = all(np.isfinite(r[k]) for r in rows for k in loss_keys + ["total", "grad_norm"])
    if (state.step != VARIANT_STEPS or not finite or "loss_binary_seg" not in loss_keys
            or fuse_train["roi_align"] != 4 * VARIANT_STEPS
            or fuse_train["roi_align_backward"] != 4 * VARIANT_STEPS
            or fuse_train["window_attention"] or fuse_train["window_block"]):
        raise AssertionError(f"variants (d) _Lite_Fuse train: {state.step} steps, losses "
                             f"{loss_keys} finite {finite}, launches {fuse_train}")
    log(f"variants (d) _Lite_Fuse tools.train {VARIANT_STEPS} steps at B{TRAIN_BATCH} in "
        f"{wall:.3f} s: s/step {', '.join(f'{sum(t.values()):.3f}' for t in timing)}; last "
        f"losses: " + ", ".join(f"{k} {rows[-1][k]:.4f}" for k in ["total"] + loss_keys)
        + f"; launches {fuse_train}")
    log(f"variants: the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(cus_serve=cus_serve, cus_train=cus_train, fuse_serve=fuse_serve,
                fuse_train=fuse_train), cus_f32


# ViTDet-B (detectron2 projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py):
# embed 768, depth 12, 12 heads, patch 16, MLP ratio 4, qkv bias, window 14 on
# all blocks but the global 2, 5, 8, 11, decomposed relative position, absolute
# position from the 224 pretrain grid with a cls token; here at a 512² input
VITDET_B = dict(img_size=512, patch_size=16, embed_dims=768, depth=12, num_heads=12,
                mlp_ratio=4.0, qkv_bias=True, use_rel_pos=True, window_size=14,
                window_block_indexes=(0, 1, 3, 4, 6, 7, 9, 10), pretrain_img_size=224,
                pretrain_use_cls_token=True, out_every=3)
VIT_SIDE = 512
VIT_ATTN_LAUNCHES = 12  # ops/vit_attention.py a bf16 ViTDet-B forward: 4 global, 8 window
# The ViT and ViT_FPN in bf16 against f32 plain on the same bf16-rounded
# weights and input, bound derived before the first run (PERF.md §6):
# bf16 keeps 8 bits (u = 2^-8); each product accumulates in f32 and rounds
# once, and the residual stream rounds at each of its 24 adds, so the error
# of a block's output relative to the stream's scale random-walks to about
# sqrt(24 · k) · u / sqrt(3) with k ≈ 3 roundings an add (the input, the
# branch, the sum): ~0.014 rms. The norm of the difference over the norm of
# the f32 output is bounded at 0.03 (about twice that); the largest
# difference, over 12.6 M outputs a map (five sigma of the per-element error
# on the largest elements), at 0.08 of the map's largest magnitude.
VIT_REL_RMS_TOL = 0.03
VIT_MAX_TOL = 0.08
UNET_TOL = 0.05  # phase_swin_kernel's K1 tolerance, of each output's scale
EXTRACT_R = 512  # RoIs a tile for the extractor variants
VIT_RUNS = 3  # timed forwards of each backbone


def _vit_weights(model, seed: int):
    """``init_random_weights`` for the layers, and the absolute and relative
    position tables std 0.02, from ``seed``."""
    import torch
    from nuhtc_tpu_torch.models.backbones import ViTAttention
    from nuhtc_tpu_torch.models.build import init_random_weights

    gen = torch.Generator().manual_seed(seed)
    init_random_weights(model, gen)
    with torch.no_grad():
        tables = [model.pos_embed] if getattr(model, "pos_embed", None) is not None else []
        tables += [p for m in model.modules() if isinstance(m, ViTAttention) and m.use_rel_pos
                   for p in (m.rel_pos_h, m.rel_pos_w)]
        for t in tables:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
    return model


def _timed(fn, runs: int):
    """(seconds a call over ``runs`` synchronized calls after a warm-up, the
    last result)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs, out


def _normalized_tiles(rng, n, side, device, dtype):
    import torch
    from nuhtc_tpu_torch.data.pipelines import IMG_NORM
    from nuhtc_tpu_torch.tools.synthetic import synthetic_tiles

    tiles = np.stack(synthetic_tiles(rng, n, side)).astype(np.float32)
    x = (tiles - np.asarray(IMG_NORM["mean"], np.float32)) / np.asarray(IMG_NORM["std"],
                                                                        np.float32)
    return torch.from_numpy(x).to(device, dtype)


def _backbones_vit(device, rng):
    """phase_backbones (a): ``ViT`` at VITDET_B with ``ViT_FPN`` in bf16 on
    the card against the same bf16-rounded weights and input in f32 on the
    host (the card runs a ViT's attention only through the bf16 kernel).
    Returns the f32 pyramid, on the card."""
    import copy

    import torch
    from nuhtc_tpu_torch.models.backbones import ViT
    from nuhtc_tpu_torch.models.build import init_random_weights
    from nuhtc_tpu_torch.models.extra_heads import ViT_FPN

    reset_counts()
    vit = _vit_weights(ViT(**VITDET_B), 0).eval()
    fpn = ViT_FPN(in_channels=VITDET_B["embed_dims"], out_channels=FPN_C).eval()
    init_random_weights(fpn, torch.Generator().manual_seed(1))
    vit16, fpn16 = vit.to(device, torch.bfloat16), fpn.to(device, torch.bfloat16)
    x16 = _normalized_tiles(rng, BATCH, VIT_SIDE, device, torch.bfloat16)

    def vit_forward(model, neck, x):
        with torch.no_grad():
            feats = model(x)
            return feats, neck(feats)

    torch.cuda.reset_peak_memory_stats(device)
    vit_s, (feats16, pyr16) = _timed(lambda: vit_forward(vit16, fpn16, x16), VIT_RUNS)
    vit_peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    vit32, fpn32 = copy.deepcopy(vit16).float().cpu(), copy.deepcopy(fpn16).float().cpu()
    feats32, pyr32 = vit_forward(vit32, fpn32, x16.float().cpu())
    torch.cuda.synchronize()
    rows = []
    for name, got, want in ([(f"vit.{i}", g, w) for i, (g, w) in enumerate(zip(feats16, feats32))]
                            + [(f"fpn.{i}", g, w) for i, (g, w) in enumerate(zip(pyr16, pyr32))]):
        d = got.float().cpu() - want
        rel_rms = (d.norm() / want.norm()).item()
        rel_max = (d.abs().max() / want.abs().max()).item()
        rows.append((name, tuple(want.shape), rel_rms, rel_max))
        if not (np.isfinite(rel_rms) and rel_rms <= VIT_REL_RMS_TOL and rel_max <= VIT_MAX_TOL):
            raise AssertionError(f"backbones (a) {name}: bf16 vs f32 plain rel rms {rel_rms:.5f}"
                                 f" (≤ {VIT_REL_RMS_TOL}), max {rel_max:.5f} (≤ {VIT_MAX_TOL})")
    if [r[1] for r in rows[-4:]] != [(BATCH, VIT_SIDE // s, VIT_SIDE // s, FPN_C)
                                     for s in (4, 8, 16, 32)]:
        raise AssertionError(f"backbones (a): ViT_FPN shapes {[r[1] for r in rows[-4:]]}")
    vit_counts = read_counts()
    want = dict({k: 0 for k in vit_counts}, vit_attention=VIT_ATTN_LAUNCHES * (VIT_RUNS + 1))
    if vit_counts != want:
        raise AssertionError(f"backbones (a): the ViT's launches {vit_counts}, want {want} "
                             f"({VIT_ATTN_LAUNCHES} a bf16 forward, none in f32)")
    log(f"backbones (a) ViTDet-B (embed 768, depth 12, 12 heads, window 14 + 4 global, rel pos)"
        f" + ViT_FPN 64, B{BATCH} {VIT_SIDE}² bf16: {BATCH / vit_s:.2f} img/s "
        f"({1e3 * vit_s:.2f} ms a forward), peak {vit_peak:.2f} GiB; bf16 vs f32 plain "
        f"(rel rms, max rel to the map's largest; bounds {VIT_REL_RMS_TOL}, {VIT_MAX_TOL}): "
        + ", ".join(f"{n} {s[1]}² {r:.5f} {m:.5f}" for n, s, r, m in rows))
    del vit, vit16, vit32, fpn16, fpn32, feats16, feats32, pyr16, x16
    torch.cuda.empty_cache()
    return [p.to(device) for p in pyr32]


def phase_backbones(device, tmp, ctx):
    """The alternative backbones, ViT_FPN, the RoI-extractor variants and
    the log, anchor, dataset-browse and end-to-end golden tools.
    (a) ``ViT`` at ViTDet-B's published widths (VITDET_B) with ``ViT_FPN``
    at the PanNuke config's 64 channels, random weights from seed 0, B16
    tiles of 512² (32² tokens; windowed blocks padded to 42², 9 windows) in
    bf16 against f32 plain on the host on the same bf16-rounded weights and
    input (VIT_REL_RMS_TOL, VIT_MAX_TOL); img/s, the peak memory. (b) ``SwinUnet``
    at its defaults (embed 96, depths 2-2-2-2, heads 3-6-12-24, window 7),
    B16 of 512² in bf16: 11 K1 launches a forward and no K2, against the
    same weights through tier "none" within UNET_TOL of each output's
    scale; tiles/s. (c) The extractors on (a)'s f32 pyramid (64 channels at
    128², 64², 32², 16²) with EXTRACT_R clustered RoIs a tile:
    ``selected_roi_features`` over the four levels (2 K4 launches),
    ``local_global_roi_features`` from level 2 (1 launch), each within 1e-4
    of the same function through ``roi_align_sum_plain`` on the card, and
    their times beside the plain version's and the bound;
    ``pos_attention_pool`` at level 3 against the same call on the CPU,
    within 1e-4. (d) The host tools: ``analyze_logs`` and
    ``analyze_wsi_logs cal_train_time`` on phase_train's log.json;
    ``optimize_anchors`` (k-means) on phase_eval's release;
    ``browse_dataset`` of 4 samples through the PanNuke train pipeline;
    the golden chain (``misc.run_e2e_golden``) on the card: every stage's
    outputs, the device-free hashes equal to the golden's, the summary
    beside the CPU golden's. Returns the launches of the backbones (b), the
    extractors (c) and the golden chain (d)."""
    import copy
    import io
    from contextlib import redirect_stdout

    import torch
    from nuhtc_tpu_torch.models import roi_extractor_variants as rev
    from nuhtc_tpu_torch.models.backbones import SwinUnet
    from nuhtc_tpu_torch.models.build import init_random_weights
    from nuhtc_tpu_torch.ops import roi_align as ra
    from nuhtc_tpu_torch.tools.analysis_tools import (
        analyze_logs, analyze_wsi_logs, optimize_anchors)
    from nuhtc_tpu_torch.tools.misc import browse_dataset, run_e2e_golden
    from nuhtc_tpu_torch.tools.synthetic import clustered_roi_boxes
    from nuhtc_tpu_torch.tools.timing import cuda_ms
    from nuhtc_tpu_torch.utils.imageio import read_png

    t_phase = time.perf_counter()
    rng = np.random.RandomState(13)

    # (a) ViTDet-B + ViT_FPN, bf16 against f32 plain
    pyr32 = _backbones_vit(device, rng)

    # (b) SwinUnet through K1 against tier "none"
    unet = SwinUnet(kernel="block").eval()
    init_random_weights(unet, torch.Generator().manual_seed(2))
    unet = unet.to(device, torch.bfloat16)
    ref = copy.deepcopy(unet)
    for m in ref.modules():
        if hasattr(m, "kernel"):
            m.kernel = "none"
    xu = _normalized_tiles(rng, BATCH, VIT_SIDE, device, torch.bfloat16)
    with torch.no_grad():
        unet(xu)  # warm-up: the blocks' kernel packs
        torch.cuda.synchronize()
        reset_counts()
        unet_s, got = _timed(lambda: unet(xu), VIT_RUNS)
        unet_counts = read_counts()
        want = ref(xu)
    forwards = VIT_RUNS + 1
    if (unet_counts["window_block"] != 11 * forwards or unet_counts["window_attention"]
            or unet_counts["roi_align"] or unet_counts["component_stats"]):
        raise AssertionError(f"backbones (b) SwinUnet: launches {unet_counts} over {forwards} "
                             f"forwards (11 K1 each)")
    errs = []
    for g, w in zip(got, want):
        e, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        errs.append((tuple(w.shape), e, scale))
        if not np.isfinite(e) or e > UNET_TOL * scale:
            raise AssertionError(f"backbones (b) SwinUnet {tuple(w.shape)}: K1 vs tier none "
                                 f"max abs err {e} > {UNET_TOL} × {scale}")
    log(f"backbones (b) SwinUnet (embed 96, depths 2-2-2-2, window 7), B{BATCH} {VIT_SIDE}² "
        f"bf16, tier block: {BATCH / unet_s:.2f} tiles/s ({1e3 * unet_s:.2f} ms a forward); "
        f"K1 vs tier none max abs err / scale per output "
        + ", ".join(f"{s[1]}²×{s[3]} {e:.4f}/{sc:.2f}" for s, e, sc in errs)
        + f"; launches {unet_counts}")
    del unet, ref, xu, got, want
    torch.cuda.empty_cache()

    # (c) the extractor variants on (a)'s f32 pyramid
    pyr = [p.contiguous() for p in pyr32]
    rois = torch.from_numpy(clustered_roi_boxes(rng, BATCH, EXTRACT_R)).to(device)
    strides = (4, 8, 16, 32)
    calls = dict(selected=lambda: rev.selected_roi_features(pyr, rois, 7, 2),
                 local_global=lambda: rev.local_global_roi_features(pyr, rois, 7, 2,
                                                                    start_level=2))
    reset_counts()
    got = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    extract_counts = read_counts()
    if (extract_counts["roi_align"] != 3 or extract_counts["window_block"]
            or extract_counts["roi_align_backward"]):
        raise AssertionError(f"backbones (c): K4 launches {extract_counts} (2 + 1 expected)")
    real = rev.roi_align_sum
    rev.roi_align_sum = ra.roi_align_sum_plain
    try:
        want = {name: fn() for name, fn in calls.items()}
        plain_ms = {name: cuda_ms(fn) for name, fn in calls.items()}
    finally:
        rev.roi_align_sum = real
    k4_ms = {name: cuda_ms(fn) for name, fn in calls.items()}
    sel_f, sel_b = [sum(x) for x in zip(
        roi_work(pyr[:3], rois, [1 / s for s in strides[:3]], 7, [2] * 3, [None] * 3),
        roi_work(pyr[3:], rois, [1 / strides[3]], 7, [2], [None]))]
    bias = torch.zeros((BATCH, EXTRACT_R, FPN_C), device=device)
    lg_f, lg_b = roi_work(pyr[:2], rois, [1 / s for s in strides[:2]], 7, [2, 2], [None] * 2,
                          bias=bias)
    bounds = {"selected": bound_ms(sel_f, PEAK_F32, sel_b),
              "local_global": bound_ms(lg_f, PEAK_F32, lg_b)}
    for name in calls:
        e = (got[name] - want[name]).abs().max().item()
        if got[name].shape != (BATCH, EXTRACT_R, 7, 7, FPN_C) or not np.isfinite(e) or e > 1e-4:
            raise AssertionError(f"backbones (c) {name}: K4 vs plain max abs err {e}")
    valid = torch.ones((BATCH, EXTRACT_R), dtype=torch.bool, device=device)
    valid[:, -EXTRACT_R // 8:] = False  # padding RoIs
    pooled = rev.pos_attention_pool(pyr[3], rois, 32, valid)
    pooled_cpu = rev.pos_attention_pool(pyr[3].cpu(), rois.cpu(), 32, valid.cpu())
    e_pool = (pooled.cpu() - pooled_cpu).abs().max().item()
    if pooled.shape != (BATCH, EXTRACT_R, FPN_C) or not np.isfinite(e_pool) or e_pool > 1e-4:
        raise AssertionError(f"backbones (c) pos_attention_pool: card vs CPU max abs err {e_pool}")
    launches = dict(selected="2 launches", local_global="1 launch")
    log(f"backbones (c) extractors, B{BATCH} R{EXTRACT_R} clustered, ViT_FPN f32 pyramid "
        f"{[tuple(p.shape[1:3]) for p in pyr]} C{FPN_C}, out 7 ratio 2: "
        + "; ".join(f"{name} K4 {k4_ms[name]:.3f} ms ({launches[name]}) plain "
                    f"{plain_ms[name]:.3f} ms bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) "
                    f"max abs err {(got[name] - want[name]).abs().max().item():.2e}"
                    for name in calls)
        + f"; pos_attention_pool card vs CPU max abs err {e_pool:.2e}; launches {extract_counts}")
    del pyr, pyr32, rois, got, want
    torch.cuda.empty_cache()

    # (d) the host tools and the golden chain
    log_json = os.path.join(tmp, "train_work", "log.json")
    for tool, argv in ((analyze_logs, ["cal_train_time", log_json]),
                       (analyze_wsi_logs, ["cal_train_time", log_json])):
        out = io.StringIO()
        with redirect_stdout(out):
            tool.main(argv)
        if not out.getvalue().startswith(log_json):
            raise AssertionError(f"backbones (d) {tool.__name__}: {out.getvalue()!r}")
        log(f"backbones (d) {tool.__name__.rsplit('.', 1)[-1]} cal_train_time: "
            f"{out.getvalue().strip()}")
    cfg_path, note = _train_config(tmp, CONFIG, _release_data(ctx), "browse_pannuke")
    t0 = time.perf_counter()
    out = io.StringIO()
    with redirect_stdout(out):
        anchors = optimize_anchors.main([cfg_path, "--algorithm", "k-means", "--input-shape",
                                         "512", "512", "--iters", "100", "--output-dir",
                                         os.path.join(tmp, "anchors")])
    with open(os.path.join(tmp, "anchors", "anchor_optimize_result.json")) as f:
        saved = json.load(f)
    if saved != anchors or not anchors or "Collected" not in out.getvalue():
        raise AssertionError(f"backbones (d) optimize_anchors: {out.getvalue()!r}")
    log(f"backbones (d) optimize_anchors k-means on phase_eval's release in "
        f"{time.perf_counter() - t0:.2f} s: " + " ".join(out.getvalue().split("\n")[:3]))
    t0 = time.perf_counter()
    vis = os.path.join(tmp, "browse")
    with redirect_stdout(io.StringIO()):
        browse_dataset.main([cfg_path, "--out", vis, "--num", "4"])
    pngs = sorted(os.listdir(vis))
    shapes = {read_png(os.path.join(vis, p)).shape for p in pngs}
    if len(pngs) != 4 or len(shapes) != 1 or next(iter(shapes))[2] != 3:
        raise AssertionError(f"backbones (d) browse_dataset: {pngs} {shapes}")
    log(f"backbones (d) browse_dataset 4 samples through the PanNuke train pipeline ({note}) "
        f"in {time.perf_counter() - t0:.2f} s: {pngs}, {shapes}")

    t0 = time.perf_counter()
    reset_counts()
    summary = run_e2e_golden.build_chain(os.path.join(tmp, "e2e"), str(device),
                                         log=lambda m: log(f"backbones (d) golden {m}"))
    golden_counts = read_counts()
    errs = run_e2e_golden.check(summary, str(device))
    if errs:
        raise AssertionError("backbones (d) golden: device-free hashes differ: "
                             + "; ".join(errs))
    with open(run_e2e_golden.GOLDEN) as f:
        cpu = json.load(f)
    if (golden_counts["window_block"] < 1 or golden_counts["roi_align"] < 1
            or golden_counts["roi_align_backward"] < 1):
        raise AssertionError(f"backbones (d) golden: launches {golden_counts}")
    log(f"backbones (d) golden chain on {device} in {time.perf_counter() - t0:.1f} s: "
        f"{len(summary['device_free'])} device-free hashes equal to the golden's; launches "
        f"{golden_counts}")
    for key in ("test_metrics", "pannuke_pq", "preds", "wsi"):
        log(f"backbones (d) golden {key}: card {json.dumps(summary[key], sort_keys=True)}")
        log(f"backbones (d) golden {key}: CPU golden {json.dumps(cpu[key], sort_keys=True)}")
    log(f"backbones: the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(backbones=unet_counts, extractors=extract_counts, golden=golden_counts)


BENCH_ARGS = ("--max-iter", "20", "--log-interval", "10", "--repeat-num", "2")
BENCH_FORWARDS = 2 * (5 + 20)  # repeats × (the tool's 5 warm-up forwards + max-iter)
BENCH_WSI_TILES = 64  # the slide of benchmark_wsi; 2 passes of 4 forwards at B16
SUMMARY_TILES = 16  # of that slide, through infer_wsi for wsi_throughput_summary
BENCH_TRAIN_STEPS = 1 + 10  # benchmark_train's warm step and its timed steps


def phase_benchmark(device, tmp, ctx):
    """The benchmark tools and ``utils.profiling`` at full width on the
    PanNuke config, bf16, on phase_eval's seed-0 weights with the objectness
    lifted (``ctx["ckpt"]``). (a) ``analysis_tools.benchmark.main`` at B16,
    BENCH_ARGS, Swin tier "block" (the strict path): img/s finite and > 0, 12
    K1, 4 K4 and ≥ 1 K3 launches a forward. (b) ``benchmark_wsi`` on its
    synthetic slide of BENCH_WSI_TILES tiles, written as a PNG and read by
    ``ImageReader``, the WSI-mode engine at B16, two passes
    (``benchmark_slide``): every tile processed, nuclei > 0, the four parts
    within the wall, the same launches a forward. (f)
    ``profiling.trace("run_batch", log_dir)`` around one ``run_batch`` of
    that engine: the Chrome trace holds the span and, for K1's 12 launches
    (read from the counter), 12 ``window_attn_kernel`` and 12
    ``block_mlp_kernel`` events, or, for each one it lacks, a kernel launch
    record whose kernel record the profiler dropped (late in this script
    the trace lacks ~1 % of its kernel records; run alone, none). (c) ``benchmark_train.main`` at B = 8: every
    metric finite, 4 K4, 4 K4-backward, ≥ 1 K3 and no Swin kernel launch a
    step; ms/step; K4 and K4's backward at the warm step's four calls
    against their plain versions on the same inputs
    (``_check_k4_train_call``, phase_train (e)'s bounds). (d) ``get_flops.main`` at 512², B1, on the card and on
    the CPU: the same three counts on both, the parameters equal to the
    engine model's, both GFLOPs > 0. (e) ``tools.infer_wsi.main`` (stage A
    timed, stage B on SUMMARY_TILES of (b)'s tiles; the patch grid passed
    in memory, no h5py) and ``misc.wsi_throughput_summary.main`` over its
    save directory: each nuclei line the feature count of its GeoJSON, each
    mean line the mean of its CSV column. Returns the launches of (a), (b)
    and (c)."""
    import csv
    import statistics

    import torch
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.tools import infer_wsi
    from nuhtc_tpu_torch.tools.analysis_tools import (
        benchmark, benchmark_train, benchmark_wsi, get_flops)
    from nuhtc_tpu_torch.tools.misc import wsi_throughput_summary
    from nuhtc_tpu_torch.utils import profiling
    from nuhtc_tpu_torch.utils.imageio import write_png
    from nuhtc_tpu_torch.wsi.slide import ImageReader

    t_phase = time.perf_counter()
    reset_counts()
    fps = benchmark.main([CONFIG, ctx["ckpt"], "--batch-size", str(BATCH), *BENCH_ARGS,
                          "--device", str(device)])
    bench_counts = read_counts()
    check_counts("benchmark (a)", bench_counts, BENCH_FORWARDS, "window_block")
    if len(fps) != 2 or not all(np.isfinite(f) and f > 0 for f in fps):
        raise AssertionError(f"benchmark (a): img/s {fps}")
    log(f"benchmark (a) analysis_tools.benchmark B{BATCH} {' '.join(BENCH_ARGS)}: img/s "
        f"{[round(f, 2) for f in fps]}, mean {np.mean(fps):.2f}; launches {bench_counts}")

    src, out = os.path.join(tmp, "bench_slide"), os.path.join(tmp, "bench_out")
    os.makedirs(src)
    os.makedirs(out)
    t0 = time.perf_counter()
    img, coords = benchmark_wsi.synthetic_benchmark_slide(BENCH_WSI_TILES)
    write_png(os.path.join(src, "synth.png"), img)
    slide = ImageReader(os.path.join(src, "synth.png"))
    t_slide = time.perf_counter() - t0
    engine = init_detector(CONFIG, ctx["ckpt"], batch_size=BATCH, device_preprocess=True,
                           compact_masks=True)
    reset_counts()
    stats, warm = benchmark_wsi.benchmark_slide(engine, slide, coords, out, True)
    wsi_counts = read_counts()
    check_counts("benchmark_wsi (b)", wsi_counts, 2 * -(-BENCH_WSI_TILES // BATCH),
                 "window_block")
    parts = [stats[k] for k in benchmark_wsi.PARTS]
    if (stats["tiles"] != BENCH_WSI_TILES or stats["nuclei"] <= 0 or min(parts) < 0
            or sum(parts) > stats["seconds"]):
        raise AssertionError(f"benchmark_wsi (b): {stats}")
    log(f"benchmark_wsi (b) {img.shape[0]}x{img.shape[1]} slide written and read in "
        f"{t_slide:.2f} s; timed pass {stats['tiles']} tiles, {stats['nuclei']} nuclei, "
        f"{stats['seconds']:.3f} s = {stats['tiles_per_sec']:.2f} tiles/s (first pass "
        f"{warm:.3f} s): read_wait {stats['read_wait_s']:.3f}, dispatch {stats['dispatch_s']:.3f},"
        f" collect {stats['collect_s']:.3f} (device wait {stats['collect_device_s']:.3f}, "
        f"download {stats['collect_download_s']:.3f}), post {stats['post_s']:.3f} s; launches "
        f"{wsi_counts}")

    trace_dir = os.path.join(tmp, "bench_trace")
    tiles = [slide.read_region((int(x), int(y)), 0, (TILE, TILE)) for x, y in coords[:BATCH]]
    reset_counts()
    with profiling.trace("run_batch", log_dir=trace_dir):
        engine.run_batch(tiles)
    trace_counts = read_counts()
    with open(os.path.join(trace_dir, "run_batch.pt.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "run_batch"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kern if "block_mlp_kernel" in e.get("name", "")]
    k1_attn = [e for e in kern if "window_attn_kernel" in e.get("name", "")]
    # a launch record without its kernel record is one the profiler
    # dropped; the earliest kernel start less its launch shows whether the
    # device's clock ran ahead of the host's
    launch = {e.get("args", {}).get("correlation"): e for e in events
              if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")}
    ids = {e.get("args", {}).get("correlation") for e in kern}
    lost = [c for c in launch if c not in ids]
    skew = min((e["ts"] - launch[e["args"]["correlation"]]["ts"] for e in kern
                if e.get("args", {}).get("correlation") in launch), default=float("nan"))
    short = 24 - len(k1) - len(k1_attn)
    if (not spans or trace_counts["window_block"] != 12 or len(k1) > 12 or len(k1_attn) > 12
            or short > len(lost)):
        raise AssertionError(
            f"profiling (f): {len(spans)} run_batch spans; {trace_counts['window_block']} K1 "
            f"launches, {len(k1)} block_mlp_kernel and {len(k1_attn)} window_attn_kernel "
            f"events (12 each wanted) of {len(kern)} kernel events; {len(lost)} kernel "
            f"launches without a kernel event")
    log(f"profiling (f) trace('run_batch'): {len(events)} events, {len(kern)} kernel events, "
        f"the span {max(e.get('dur', 0) for e in spans) / 1e3:.3f} ms; K1's 12 launches as "
        f"{len(k1_attn)} window_attn_kernel + {len(k1)} block_mlp_kernel events of "
        f"{np.mean([e['dur'] for e in k1_attn]) / 1e3:.3f} + "
        f"{np.mean([e['dur'] for e in k1]) / 1e3:.3f} ms mean; {len(lost)} kernel launches "
        f"whose kernel record the profiler dropped ({short} of them K1's); the earliest "
        f"kernel start less its launch {skew / 1e3:.3f} ms")
    n_params = sum(p.numel() for p in engine.model.parameters())
    del engine

    os.environ["B"] = str(TRAIN_BATCH)
    captured = []
    try:
        reset_counts()
        with _capture_k4_calls(captured):
            res = benchmark_train.main(["--device", str(device)])
        train_counts = read_counts()
    finally:
        del os.environ["B"]
    steps = BENCH_TRAIN_STEPS
    if (train_counts["roi_align"] != 4 * steps or train_counts["roi_align_backward"] != 4 * steps
            or train_counts["component_stats"] < steps or train_counts["window_block"]
            or train_counts["window_attention"]):
        raise AssertionError(f"benchmark_train (c): launches {train_counts} over {steps} steps")
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"benchmark_train (c): {res}")
    if len(captured) != 4:
        raise AssertionError(f"benchmark_train (c): captured {len(captured)} K4 calls of a step")
    errs = [_check_k4_train_call(*call, "benchmark_train (c)")[1] for call in captured]
    worst = {k: max(e[k] for e in errs) for k in errs[0]}
    log(f"benchmark_train (c) B{TRAIN_BATCH} 256², bf16 autocast: {res['ms_per_step']:.1f} "
        f"ms/step, {res['tiles_per_s']:.2f} tiles/s, total loss {res['total']:.4f}; launches "
        f"{train_counts} over {steps} steps; K4 at the warm step's 4 calls "
        f"({', '.join(f'R{c[1].shape[1]} out {c[3][1]} maps {[tuple(m.shape[1:3]) for m in c[0]]}' for c in captured)}) "
        f"against the plain versions: forward f32 {worst['fwd32']:.2e}, bf16 "
        f"{worst['fwd16']:.5f} of the summed magnitudes; backward f32 {worst['bwd32']:.2e} "
        f"(bias {worst['bias']:.2e}), bf16 {worst['bwd16']:.5f} of the gradient scale, "
        f"bit-equal over 3 calls")

    t0 = time.perf_counter()
    flops = {dev: get_flops.main([CONFIG, "--shape", "512", "--batch", "1", "--device", dev])
             for dev in (str(device), "cpu")}
    card, cpu = flops[str(device)], flops["cpu"]
    if card != cpu or card["params"] != n_params or min(card.values()) <= 0:
        raise AssertionError(f"get_flops (d): card {card}, CPU {cpu}, the engine's "
                             f"parameters {n_params}")
    log(f"get_flops (d) 512² B1 on the card and the CPU in {time.perf_counter() - t0:.1f} s: "
        f"{card['params']} parameters, backbone+FPN {card['feats_flops']} FLOPs, full "
        f"{card['full_flops']} FLOPs (FlopCounterMode: products only), equal on both")

    t0 = time.perf_counter()
    save = os.path.join(tmp, "bench_wsi_save")
    _captured(lambda argv: infer_wsi.main(argv, coords={"synth": coords[:SUMMARY_TILES]}),
              [src, CONFIG, ctx["ckpt"], "--no_auto_skip", "--save_dir", save,
               "--device", str(device)])
    text = _captured(wsi_throughput_summary.main, [save])
    with open(os.path.join(save, "process_list_autogen.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    want = [f"mean {col}: {statistics.mean(float(r[col]) for r in rows if r[col]):.2f}"
            for col in ("seg_time", "patch_time", "n_patches") if col in rows[0]]
    gj_dir = os.path.join(save, "nuclei", "synth")
    names = sorted(n for n in os.listdir(gj_dir) if n.endswith(".geojson")
                   and "_point" not in n and "_merged" not in n)
    for name in names:
        with open(os.path.join(gj_dir, name)) as f:
            doc = json.load(f)
        want.append(f"{name:<40s} {len(doc['features'] if isinstance(doc, dict) else doc):>8d} "
                    f"nuclei")
    lines = text.splitlines()
    if len(want) != 3 + len(names) or not names or lines[-len(want):] != want:
        raise AssertionError(f"wsi_throughput_summary (e): printed {lines[-len(want):]}, "
                             f"expected {want}")
    log(f"wsi_throughput_summary (e) over infer_wsi's save directory ({SUMMARY_TILES} tiles) "
        f"in {time.perf_counter() - t0:.1f} s: the mean and nuclei lines as computed here")
    torch.cuda.synchronize()
    log(f"benchmark: the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(benchmark=bench_counts, benchmark_wsi=wsi_counts, benchmark_train=train_counts)


SEMI_CONFIG = os.path.join(REPO, "configs", "nuhtc", "semi_base.py")
SEMI_SPLITS = (("train", 16), ("unlabeled", 16), ("test", 8))  # tiles of the NuCLS release
SEMI_ITERS = 3  # steps an epoch of phase_semi
SEMI_BATCH = 8  # samples_per_gpu of semi_base.py: 4 labelled + 4 unlabelled
# bf16 against f32 on detections matched one to one (same label, IoU > 0.5):
# a score within 0.05 (bf16 rounds each product to 2^-8 relative, over ~40
# layers) and a median IoU of 0.95; a box's corners are not bounded one by
# one: a class-specific delta's bf16 error grows by exp(dw), and random
# weights give boxes of a few pixels
SEMI_SCORE_TOL, SEMI_IOU_MEDIAN = 0.05, 0.95


def _match(got, want, iou_thr=0.5):
    """Greedy one-to-one matching of two detection sets of a tile (same
    label, box IoU > iou_thr, in want's score order) → (got index, want
    index, IoU) triples."""
    pairs, free = [], np.ones(len(got["scores"]), bool)
    if not len(got["scores"]) or not len(want["scores"]):
        return pairs
    a, b = got["boxes"].astype(np.float64), want["boxes"].astype(np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)  # noqa: E731
    iou = inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-12)
    for wi in np.argsort(-want["scores"], kind="stable"):
        cand = np.where(free & (got["labels"] == want["labels"][wi]) & (iou[:, wi] > iou_thr))[0]
        if len(cand):
            gi = cand[np.argmax(iou[cand, wi])]
            free[gi] = False
            pairs.append((int(gi), int(wi), float(iou[gi, wi])))
    return pairs


def _check_semi_k4(calls, backward: bool):
    """K4 at the calls captured from the semi paths (one map a call, the
    Mask R-CNN's multilevel extractor) against the plain version: the
    forward in the maps' type against ``roi_align_plain`` on their f32
    copies (bf16: 2^-7 of the map's largest magnitude; f32: 1e-4), and
    with ``backward`` the gradient against autograd through the plain
    version (2^-7 of its scale in bf16), and a second backward call bit-equal
    to the first. Returns the largest errors."""
    import torch
    from nuhtc_tpu_torch.ops import roi_align as ra

    err_f = err_b = 0.0
    for feat, rois, scale, out_size, ratio in calls:
        got = ra.roi_align(feat, rois, scale, out_size, sampling_ratio=ratio)
        want = ra.roi_align_plain(feat.float(), rois, scale, out_size, ratio)
        tol = (2.0 ** -7 if feat.dtype == torch.bfloat16 else 1e-4) * max(
            feat.abs().max().item(), 1e-30)
        e = (got.float() - want).abs().max().item()
        if not np.isfinite(e) or e > tol:
            raise AssertionError(f"K4 at a semi call {tuple(feat.shape)} R{rois.shape[1]} out "
                                 f"{out_size}: err {e} > {tol}")
        err_f = max(err_f, e / max(feat.abs().max().item(), 1e-30))
        if backward:
            gen = torch.Generator(device=feat.device).manual_seed(out_size)
            g = torch.randn(got.shape, generator=gen, device=feat.device).to(feat.dtype)
            shapes = [tuple(feat.shape)]
            grads, _ = ra.roi_align_sum_backward(g, shapes, rois, [scale], out_size, [ratio],
                                                 [None], False)
            again, _ = ra.roi_align_sum_backward(g, shapes, rois, [scale], out_size, [ratio],
                                                 [None], False)
            if not torch.equal(grads[0], again[0]):
                raise AssertionError(f"K4 backward at a semi train call {tuple(feat.shape)} "
                                     f"R{rois.shape[1]} out {out_size}: two calls differ")
            ref, _ = ra.roi_align_sum_backward_plain(g.float(), shapes, rois, [scale], out_size,
                                                     [ratio], [None], False)
            s = max(ref[0].abs().max().item(), 1e-30)
            e = (grads[0].float() - ref[0]).abs().max().item() / s
            if not np.isfinite(e) or e > 2.0 ** -7:
                raise AssertionError(f"K4 backward at a semi train call {tuple(feat.shape)} "
                                     f"R{rois.shape[1]} out {out_size}: err {e} of the scale")
            err_b = max(err_b, e)
    return err_f, err_b


def phase_semi(device, tmp):
    """The semi-supervised recipe, configs/nuhtc/semi_base.py as shipped
    (Mask R-CNN, Swin-T 96, depths 2-2-6-2, FPN 64, 8 classes), on a
    synthetic NuCLS release written here (``tools.synthetic.synthetic_nucls``:
    ``synthetic_pannuke`` tiles of 256², their five classes relabelled onto
    the eight, every other annotation box-only, an unlabelled split used as
    such through ``filter_empty=False``). (a) serving: ``init_detector`` at
    B16 on 256² tiles rescaled to 512², bf16, in WSI mode and on the strict
    path, class 0's logit raised by 3 (``lift_objectness``): detections > 0,
    12 K1, 8 K4 and no K2 or K3 launch a forward, tiles/s; the strict path
    against the same weights in f32 on the card with the Swin tier "none"
    and ``roi_align_plain`` in place of K4, on the same bf16-rounded
    weights: ≥ 80 % of the f32 detections matched one to one (same label,
    IoU > 0.5), their scores within SEMI_SCORE_TOL, the pairs' median IoU
    ≥ SEMI_IOU_MEDIAN. (b) training: ``tools.train.main`` on the config at
    its B8 (4 labelled + 4 unlabelled, 256² as the empty train pipeline
    leaves them, bf16 autocast), pseudo labels from every detection the
    teacher keeps (``semi_wrapper.score_thr`` 0.05) and burn-in 1 step, two
    epochs of SEMI_ITERS steps with a checkpoint and an evaluation of the
    teacher and the student each, then ``--resume-from`` a third epoch:
    every loss finite; ``ema_momentum`` 0 at step 0 and > 0 after; the
    unsupervised terms weighted 0 at step 0 and 2 after; pseudo boxes > 0;
    per step 12 K1 (the teacher), 24 K4 forwards and 12 K4 backwards, per
    evaluation forward 12 K1 and 8 K4, no K2 or K3; K1's parameter pack of
    the teacher rebuilt after every EMA write. (c) ``init_detector(ckpt,
    use_ema=True/False)``: the teacher's and the student's weights, one
    ``run_batch`` each. (d) after the EMA writes, every Swin block of the
    teacher through K1 against its plain tier on the block's own input from
    a teacher forward, within phase_swin_kernel's 0.05 (× the output's
    scale where above 1). (e) s/step and its split (loader wait, teacher
    forward, student forward, backward, optimizer + EMA), the idle share
    over 3 profiled steps and the peak memory. K4 at the captured calls of
    a serving forward and of a train step against its plain version
    (forward; backward on the train calls). Returns (launches of the
    serving paths, launches of training)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.data.coco import build_dataset
    from nuhtc_tpu_torch.data.loader import SemiPrefetchLoader
    from nuhtc_tpu_torch.data.pipelines import IMG_NORM, build_train_pipeline
    from nuhtc_tpu_torch.models import roi_extractor, semi
    from nuhtc_tpu_torch.models.build import build_detector
    from nuhtc_tpu_torch.ops import roi_align as ra
    from nuhtc_tpu_torch.tools import train as train_tool
    from nuhtc_tpu_torch.tools.synthetic import lift_objectness, synthetic_nucls, synthetic_tiles
    from nuhtc_tpu_torch.train.train_state import (
        create_semi_train_state, lr_schedule, make_semi_train_step)
    from nuhtc_tpu_torch.utils import checkpoint as ckpt
    from nuhtc_tpu_torch.utils.imageio import read_image

    t0 = time.perf_counter()
    root = os.path.join(tmp, "nucls")
    opts = synthetic_nucls(root, SEMI_SPLITS, size=TILE, seed=0)
    log(f"semi: synthetic NuCLS release {dict(SEMI_SPLITS)} tiles of {TILE}² in "
        f"{time.perf_counter() - t0:.1f} s; config {os.path.basename(SEMI_CONFIG)} as shipped")

    # K4's calls (one map each) of a forward / a train step, for the check against plain
    captured = {"serve": [], "train": []}
    plain_align = roi_extractor.roi_align
    which = ["serve"]

    def capturing_align(feat, rois, scale, out_size, sampling_ratio=0, max_grid=8):
        out = plain_align(feat, rois, scale, out_size, sampling_ratio=sampling_ratio,
                          max_grid=max_grid)
        calls = captured[which[0]]
        if feat.is_cuda and len(calls) < 8 and (which[0] == "serve" or out.grad_fn is not None):
            calls.append((feat.detach().clone(), rois.detach().clone(), scale, out_size,
                          sampling_ratio))
        return out

    # (a) serving, both contracts
    rng = np.random.RandomState(2)
    batches = [synthetic_tiles(rng, BATCH, TILE) for _ in range(3)]
    serve_counts = {}
    for mode, kw in (("WSI mode", dict(device_preprocess=True, compact_masks=True)),
                     ("strict path", {})):
        engine = init_detector(SEMI_CONFIG, None, batch_size=BATCH, **kw)
        lift_objectness(engine.model)
        engine.run_batch(batches[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        roi_extractor.roi_align = capturing_align
        try:
            t0 = time.perf_counter()
            results = [engine.run_batch(b) for b in batches[1:]]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            roi_extractor.roi_align = plain_align
        counts = read_counts()
        forwards = len(batches) - 1
        if (counts["window_block"] != 12 * forwards or counts["roi_align"] != 8 * forwards
                or counts["window_attention"] or counts["component_stats"]
                or counts["roi_align_backward"]):
            raise AssertionError(f"semi (a) {mode}: launches over {forwards} forwards: {counts}")
        n_det = sum(len(r["scores"]) for res in results for r in res)
        for res in results:
            for r in res:
                check_detections(r["boxes"], r["scores"])
                if r["probs"].shape[1:] != (8,) or r["masks"].shape[1:] != (TILE, TILE):
                    raise AssertionError(f"semi (a) {mode}: probs {r['probs'].shape} masks "
                                         f"{r['masks'].shape}")
        if not n_det:
            raise AssertionError(f"semi (a) {mode}: no detection")
        tiles = BATCH * forwards
        log(f"semi (a) {mode} (tier block): {tiles} tiles in {dt:.3f} s = {tiles / dt:.2f} "
            f"tiles/s (B{BATCH}, 512² input, bf16); {n_det / tiles:.2f} detections/tile; "
            f"launches {counts}")
        serve_counts = {k: serve_counts.get(k, 0) + v for k, v in counts.items()}
    bf16_res = results[0]

    # the strict path in f32 on the card, plain Swin tier and plain K4
    ref = init_detector(SEMI_CONFIG, None, batch_size=BATCH, dtype=torch.float32,
                        swin_kernel="none")
    lift_objectness(ref.model)
    with torch.no_grad():  # the card path's weights, rounded to bf16, in f32
        for p in ref.model.parameters():
            p.copy_(p.bfloat16().float())
    roi_extractor.roi_align = (lambda feat, rois, scale, out_size, sampling_ratio=0, max_grid=8:
                               ra.roi_align_plain(feat, rois, scale, out_size, sampling_ratio,
                                                  max_grid))
    reset_counts()
    try:
        f32_res = ref.run_batch(batches[1])
    finally:
        roi_extractor.roi_align = plain_align
    if any(read_counts().values()):
        raise AssertionError(f"semi (a) the plain f32 path launched a kernel: {read_counts()}")
    del ref
    total, d_score, ious = 0, [], []
    for g, w in zip(bf16_res, f32_res):
        total += len(w["scores"])
        for gi, wi, iou in _match(g, w):
            d_score.append(abs(float(g["scores"][gi]) - float(w["scores"][wi])))
            ious.append(iou)
    rate = len(ious) / max(total, 1)
    d_score, ious = np.asarray(d_score or [np.inf]), np.asarray(ious or [0.0])
    log(f"semi (a) strict path bf16 (K1, K4) vs f32 plain on the card, the same bf16-rounded "
        f"weights: {len(ious)} of {total} detections matched ({rate:.3f}); |Δscore| median "
        f"{np.median(d_score):.4f}, max {d_score.max():.4f}; box IoU of the pairs median "
        f"{np.median(ious):.4f}, min {ious.min():.4f} (allowed: ≥ 0.8 matched, |Δscore| ≤ "
        f"{SEMI_SCORE_TOL}, median IoU ≥ {SEMI_IOU_MEDIAN})")
    if rate < 0.8 or d_score.max() > SEMI_SCORE_TOL or np.median(ious) < SEMI_IOU_MEDIAN:
        raise AssertionError("semi (a): the bf16 card path disagrees with the f32 plain path")

    # (b) training through tools.train, then a resumed third epoch
    work = os.path.join(tmp, "semi_work")
    ck_dir = os.path.join(work, "checkpoints")
    options = dict(opts, **{"semi_wrapper.score_thr": 0.05, "semi_wrapper.burn_in": 1,
                            "log_interval": 1, "checkpoint_interval": 1,
                            "evaluation.interval": 1})
    argv = [SEMI_CONFIG, "--work-dir", work, "--iters-per-epoch", str(SEMI_ITERS), "--seed", "0",
            "--cfg-options", *[f"{k}={v}" for k, v in options.items()]]
    pseudo, packs, wrappers = [], [], []
    plain_label = semi.MultiStreamDetector.pseudo_label

    def counting_label(self, img):
        out = plain_label(self, img)
        pseudo.append(int(out["gt_valid"].sum()))
        blk = self.teacher.backbone.stages[2].blocks[0]
        # the teacher's K1 pack: rebuilt for this step's weights, none stale
        packs.append((blk._params.key, blk.kernel_params() is blk._params))
        if not wrappers or wrappers[-1] is not self:
            wrappers.append(self)
        return out

    timing = []
    semi.MultiStreamDetector.pseudo_label = counting_label
    roi_extractor.roi_align = capturing_align
    which[0] = "train"
    reset_counts()
    try:
        t0 = time.perf_counter()
        state = train_tool.main(argv + ["--max-epochs", "2"],
                                trainer_kw=dict(record_timing=timing))
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        roi_extractor.roi_align = plain_align
        counts_b = read_counts()
        reset_counts()
        state = train_tool.main(argv + ["--max-epochs", "3", "--resume-from",
                                        ckpt.checkpoint_file(ck_dir, 2)])
        torch.cuda.synchronize()
        counts_r = read_counts()
    finally:
        semi.MultiStreamDetector.pseudo_label = plain_label
        roi_extractor.roi_align = plain_align
    steps = 2 * SEMI_ITERS
    evals = 2 * 2 * -(-SEMI_SPLITS[2][1] // SEMI_BATCH)  # epochs × (teacher, student) × batches

    def expect(n_steps, n_evals):
        return dict(window_block=12 * (n_steps + n_evals), window_attention=0,
                    component_stats=0, roi_align=24 * n_steps + 8 * n_evals,
                    roi_align_backward=12 * n_steps, vit_attention=0)

    if counts_b != expect(steps, evals) or counts_r != expect(SEMI_ITERS, evals // 2):
        raise AssertionError(f"semi (b) launches: {counts_b} (want {expect(steps, evals)}), "
                             f"resumed {counts_r} (want {expect(SEMI_ITERS, evals // 2)})")
    if state.step != 3 * SEMI_ITERS or state.opt_state.count != state.step:
        raise AssertionError(f"semi (b): resumed to step {state.step}")
    keys = [k for k, _ in packs]
    if (len(packs) != 3 * SEMI_ITERS or not all(fresh for _, fresh in packs)
            or len(set(keys[:steps])) != steps or len(set(keys[steps:])) != SEMI_ITERS):
        raise AssertionError(f"semi (b): the teacher's K1 pack was not rebuilt after each EMA "
                             f"write ({len(set(keys))} distinct of {len(packs)})")
    if sum(pseudo[1:]) <= 0:
        raise AssertionError(f"semi (b): no pseudo box after burn-in: {pseudo}")
    rows, val_rows = _train_rows(work)
    unsup_keys = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
    loss_keys = [k for k in rows[0] if ".loss_" in k]
    bad = [(i, k) for i, r in enumerate(rows) for k in loss_keys + ["total", "grad_norm"]
           if not np.isfinite(r[k])]
    gated = [r["total"] - r["sup.total"] - (0.0 if i == 0 else 2.0) * sum(
        r[f"unsup.{k}"] for k in unsup_keys) for i, r in enumerate(rows[:steps])]
    if (len(rows) != 3 * SEMI_ITERS or len(loss_keys) != 12 or bad
            or rows[0]["ema_momentum"] != 0.0 or min(r["ema_momentum"] for r in rows[1:]) <= 0
            or max(abs(x) for x in gated) > 1e-3 * max(abs(r["total"]) for r in rows)
            or [(r["epoch"], r["tag"]) for r in val_rows] != [
                (e, t) for e in (1, 2, 3) for t in ("teacher", "student")]
            or sorted(os.listdir(ck_dir)) != ["step_1.pt", "step_2.pt", "step_3.pt"]):
        raise AssertionError(f"semi (b): rows {len(rows)}, losses {loss_keys}, non-finite "
                             f"{bad[:4]}, momentum {[r['ema_momentum'] for r in rows]}, gating "
                             f"{gated}, val {[(r['epoch'], r['tag']) for r in val_rows]}, "
                             f"{sorted(os.listdir(ck_dir))}")
    blob = ckpt.read_checkpoint(ck_dir)
    lag = max((v - blob["student_params"][k]).abs().max().item()
              for k, v in blob["teacher_params"].items())
    if not lag > 0:
        raise AssertionError("semi (b): the teacher equals the student after training")
    warm = timing[1:]
    split = {k: float(np.mean([t_[k] for t_ in warm]))
             for k in ("loader_wait_s", "teacher_s", "forward_s", "backward_s", "optimizer_s")}
    step_s = sum(split.values())
    log(f"semi (b) tools.train on {device}: {steps} steps + {evals} evaluation forwards + 2 "
        f"checkpoints in {wall_b:.3f} s; per step (steps 2-{steps}, synchronized) {step_s:.4f} s "
        f"= {SEMI_BATCH / step_s:.2f} img/s: loader wait {split['loader_wait_s']:.4f} s, "
        f"teacher forward {split['teacher_s']:.4f} s, student forward {split['forward_s']:.4f} "
        f"s, backward {split['backward_s']:.4f} s, optimizer + EMA {split['optimizer_s']:.4f} s;"
        f" the first step {sum(timing[0].values()):.3f} s")
    log("semi (b) losses of the last step: " + ", ".join(
        f"{k} {rows[-1][k]:.4f}" for k in ["total"] + loss_keys) + f", grad_norm "
        f"{rows[-1]['grad_norm']:.3f}, ema_momentum {[round(r['ema_momentum'], 4) for r in rows]}; "
        f"pseudo boxes a step {pseudo}; teacher - student max |Δ| {lag:.3e}; eval pq "
        f"{[round(r.get('pq', float('nan')), 4) for r in val_rows]}; launches {counts_b}, "
        f"resumed epoch {counts_r}")

    # (c) the teacher's and the student's weights through init_detector
    cfg = Config.fromfile(SEMI_CONFIG)
    cfg.merge_from_options(options)
    test_ds = build_dataset({**cfg.data.test, "test_mode": True})
    tiles = [read_image(test_ds.img_path(i)) for i in range(len(test_ds))][:SEMI_BATCH]
    counts_c = {}
    for use_ema, key in ((True, "teacher_params"), (False, "student_params")):
        reset_counts()
        engine = init_detector(SEMI_CONFIG, ck_dir, batch_size=SEMI_BATCH, use_ema=use_ema)
        own = engine.model.state_dict()
        if any(not torch.equal(own[k].float().cpu(), v.to(own[k].dtype).float())
               for k, v in blob[key].items()):
            raise AssertionError(f"semi (c): init_detector(use_ema={use_ema}) holds other "
                                 "weights")
        res = engine.run_batch(tiles)
        torch.cuda.synchronize()
        c = read_counts()
        if c["window_block"] != 12 or c["roi_align"] != 8 or len(res) != len(tiles):
            raise AssertionError(f"semi (c) use_ema={use_ema}: launches {c}")
        for r in res:
            check_detections(r["boxes"], r["scores"])
        counts_c = {k: counts_c.get(k, 0) + v for k, v in c.items()}
        log(f"semi (c) init_detector(step_3, use_ema={use_ema}: {key[:-7]}) + run_batch of "
            f"{len(tiles)} tiles: {sum(len(r['scores']) for r in res)} detections; launches {c}")
        del engine
    serve_counts = {k: serve_counts[k] + counts_c[k] for k in serve_counts}

    # (d) the trained teacher's Swin blocks: K1 against the plain tier
    teacher = wrappers[-1].teacher
    x = torch.from_numpy(np.stack([(t_ - np.float32(IMG_NORM["mean"])) / np.float32(
        IMG_NORM["std"]) for t_ in tiles]).astype(np.float32)).to(device)
    inputs = []
    hooks = [blk.register_forward_pre_hook(lambda m, a: inputs.append((m, a[0].detach())))
             for stage in teacher.backbone.stages for blk in stage.blocks]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        teacher.backbone(x)
    for h in hooks:
        h.remove()
    err_d = 0.0
    for blk, inp in inputs:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            got = blk(inp)
            blk.kernel = "none"
            want = blk(inp)
            blk.kernel = "block"
        scale = want.float().abs().max().item()
        e = (got.float() - want.float()).abs().max().item()
        if not np.isfinite(e) or e > K1_TOL * max(1.0, scale):
            raise AssertionError(f"semi (d): teacher block {tuple(inp.shape)} K1 vs plain tier "
                                 f"err {e} (outputs up to {scale:.2f})")
        err_d = max(err_d, e / max(1.0, scale))
    log(f"semi (d) the trained teacher's {len(inputs)} Swin blocks through K1 vs the plain tier "
        f"on their own inputs (bf16 autocast): max err {err_d:.4f} of max(1, scale) "
        f"(allowed {K1_TOL})")

    # K4 at the captured calls of a serving forward and of a train step
    e_serve, _ = _check_semi_k4(captured["serve"], backward=False)
    e_train, e_back = _check_semi_k4(captured["train"], backward=True)
    log(f"semi K4 at {len(captured['serve'])} calls of a serving forward and {len(captured['train'])}"
        f" of a train step vs plain: forward err {max(e_serve, e_train):.5f} of the map scale, "
        f"backward {e_back:.5f} of the gradient scale (allowed 2^-7 = {2.0 ** -7:.5f})")

    # (e) 3 profiled steps: idle share and peak memory
    model = build_detector(cfg.model, cfg.model.get("test_cfg"), float(cfg.get("scale_factor", 2.0)))
    model.load_state_dict(blob["student_params"])
    model = model.to(device)
    wrapper = semi.MultiStreamDetector(model, score_thr=0.05, max_gt=128)
    st, tx = create_semi_train_state(model, wrapper.teacher, num_stages=1, num_classes=8,
                                     schedule=lr_schedule(iters_per_epoch=SEMI_ITERS))
    step_fn = make_semi_train_step(wrapper, tx, unsup_weight=2.0, compute_dtype=torch.bfloat16)
    loader = SemiPrefetchLoader(build_dataset(cfg.data.train), build_train_pipeline([]),
                                strong_pipeline=build_train_pipeline(cfg.unsup_strong_pipeline),
                                batch_size=SEMI_BATCH, sup_ratio=cfg.sup_ratio, seed=5)
    gen = torch.Generator(device=device)
    it = iter(loader)

    def one_step():
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        gen.manual_seed(st.step)
        step_fn(st, batch, gen)

    try:
        one_step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                one_step()
            torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    finally:
        loader.close()
    peak = torch.cuda.max_memory_allocated(device)
    device_s = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    log(f"semi (e) {PROFILED_STEPS} steps under torch.profiler: {traced:.3f} s, the card's "
        f"kernels and copies {device_s:.3f} s, idle share {1 - device_s / traced:.3f}; untraced "
        f"steps (b) {step_s:.4f} s each, idle share against them "
        f"{1 - device_s / (PROFILED_STEPS * step_s):.3f}; torch.cuda.max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB")
    train_counts = {k: counts_b[k] + counts_r[k] for k in counts_b}
    return serve_counts, train_counts


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
        from nuhtc_tpu_torch.apis.inference import no_tf32
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    no_tf32()
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
    vit_attn, vit_counts = phase_vit_attention(device)
    phase_reference(device)
    wsi = phase_slice(device)
    strict = phase_strict(device)
    with tempfile.TemporaryDirectory() as out_dir:
        slide, *slide_parts = phase_slide(device, out_dir)
        embed = phase_tools(device, out_dir, *slide_parts)
    with tempfile.TemporaryDirectory() as tmp:
        evaluation, patch, context = phase_eval(device, tmp)
        robustness = phase_robustness(device, tmp, context)
        train, k4_backward = phase_train(device, tmp, context)
        parallel = phase_parallel(device, tmp, context)
        train_configs = phase_train_configs(device, tmp, context)
        variants, _ = phase_variants(device, tmp, context)
        backbones = phase_backbones(device, tmp, context)
        bench = phase_benchmark(device, tmp, context)
    with tempfile.TemporaryDirectory() as tmp:
        semi_serve, semi_train = phase_semi(device, tmp)
    paths = dict(vit=vit_counts, wsi=wsi, strict=strict, slide=slide, embed=embed, eval=evaluation, patch=patch,
                 robustness=robustness, train=train, train_configs=train_configs,
                 **parallel, **variants, **backbones, **bench, semi_serve=semi_serve,
                 semi_train=semi_train)

    def entry(name, source, replaces, measured):
        # launches: over the driven paths; no single PyTorch call computes K1-K4
        # (the ViT attention's library_ms: sdpa with the bias as a mask, a yardstick)
        by_path = {path: counts[name] for path, counts in paths.items()}
        return {"name": name, "route": "cuda", "source": f"nuhtc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "library_ms": None, **measured}

    pallas = "nuhtc_tpu/ops/window_attention_pallas.py"
    kernels_line = [
        entry("window_block", "window_block.cu", f"{pallas}:255", k1),
        entry("window_attention", "window_block.cu", f"{pallas}:128", k2),
        entry("component_stats", "component_stats.cu", "nuhtc_tpu/ops/components_pallas.py:98", k3),
        entry("roi_align", "roi_align.cu", "nuhtc_tpu/ops/roi_align_pallas.py:126", k4),
        # the JAX package trains through XLA's autodiff of its exact RoIAlign
        entry("roi_align_backward", "roi_align.cu", "nuhtc_tpu/ops/roi_align.py:276",
              k4_backward),
        # the JAX package's ViT attention is plain jnp (nuhtc_tpu/models/backbones.py)
        entry("vit_attention", "vit_attention.cu", "none", vit_attn),
    ]
    if any(k["launches"] < 1 for k in kernels_line):
        raise AssertionError(f"a kernel was never launched on the main paths: {kernels_line}")
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s from the start, the build "
        f"included")
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
