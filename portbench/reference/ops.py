"""Plain operations of the frozen reference: box decoding, anchors, greedy
NMS, RoIAlign, attention pooling, binary morphology, connected components,
the resizes and the label-map paste, in f32 PyTorch.

A frozen copy of the port's plain paths (``nuhtc_tpu_torch/ops``: boxes,
anchors, nms, roi_align's plain versions, morphology, components'
plain versions, mask_paste) as they stood when the benchmark was defined,
with every kernel branch taken out. It imports nothing of the port: a later
change to the port's code cannot move this yardstick.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e10
BIG = 1e9  # extent of an id that owns no pixel
CHUNK_BYTES = 1 << 30  # per-chunk budget of the RoIAlign intermediates


# ---------------------------------------------------------------- boxes
def clip_boxes(boxes: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    h, w = shape[:2]
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
               stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
               max_shape: Tuple[int, int] | None = None,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Decode (..., 4) deltas against (..., 4) rois."""
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    d = deltas * stds + means
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gx = px + pw * d[..., 0]
    gy = py + ph * d[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    return clip_boxes(out, max_shape) if max_shape is not None else out


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """(..., N, 4) × (..., M, 4) → (..., N, M) IoU, the union floored at
    ``eps`` (the assigners take mmdet 2.x ``bbox_overlaps``'s 1e-6)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=eps)


# ---------------------------------------------------------------- anchors
def base_anchors(stride: int, scales: Sequence[float], ratios: Sequence[float]) -> np.ndarray:
    """(num_ratios*num_scales, 4) anchors centred at (0, 0)."""
    out = []
    for r in ratios:
        h_ratio = np.sqrt(r)
        w_ratio = 1.0 / h_ratio
        for s in scales:
            ws = stride * w_ratio * s
            hs = stride * h_ratio * s
            out.append([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(featmap_sizes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 scales: Sequence[float], ratios: Sequence[float]) -> List[np.ndarray]:
    """Per-level anchors, each (H*W*A, 4), row-major over (y, x, anchor)."""
    all_anchors = []
    for (fh, fw), stride in zip(featmap_sizes, strides):
        base = base_anchors(stride, scales, ratios)
        sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * stride,
                             np.arange(fh, dtype=np.float32) * stride)
        shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
        all_anchors.append((shifts[:, None, :] + base[None, :, :]).reshape(-1, 4).astype(np.float32))
    return all_anchors


# ---------------------------------------------------------------- NMS
def sort_desc(x: torch.Tensor):
    """Stable descending sort (ties keep input order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def nms_keep_sorted(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
                    ) -> torch.Tensor:
    """Keep mask (B, N) for boxes (B, N, 4) sorted by descending score: the
    greedy suppression as a fixpoint of 0/1 products, in f32."""
    b, n, _ = boxes.shape
    ov = torch.empty((b, n, n), dtype=torch.float32, device=boxes.device)
    cols = torch.arange(n, device=boxes.device)
    for r0 in range(0, n, 512):
        rows = torch.arange(r0, min(n, r0 + 512), device=boxes.device)
        iou = pairwise_iou(boxes[:, rows], boxes)
        ov[:, rows] = ((iou > iou_threshold) & (rows[:, None] < cols[None, :])).float()
    keep = valid
    for _ in range(n):
        sup = (keep.float()[:, None, :] @ ov)[:, 0] > 0
        new = valid & ~sup
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float, max_out: int):
    """Greedy NMS over (B, N). → (boxes (B, max_out, 4), scores, idx, valid),
    kept boxes in descending score order; padding slots are zero/invalid."""
    scores_m = torch.where(valid, scores, NEG_INF)
    _, order = sort_desc(scores_m)
    sboxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    keep = nms_keep_sorted(sboxes, valid.gather(1, order), iou_threshold)
    kept_scores = torch.where(keep, scores_m.gather(1, order), NEG_INF)
    if max_out > kept_scores.shape[1]:
        pad = max_out - kept_scores.shape[1]
        kept_scores = torch.nn.functional.pad(kept_scores, (0, pad), value=NEG_INF)
        order = torch.nn.functional.pad(order, (0, pad))
    top_scores, top_pos = sort_desc(kept_scores)
    top_scores, top_pos = top_scores[:, :max_out], top_pos[:, :max_out]
    out_idx = order.gather(1, top_pos)
    out_valid = top_scores > NEG_INF / 2
    out_boxes = torch.where(out_valid[..., None],
                            boxes.gather(1, out_idx[..., None].expand(-1, -1, 4)), 0.0)
    out_scores = torch.where(out_valid, scores.gather(1, out_idx), 0.0)
    return out_boxes, out_scores, out_idx, out_valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                valid: torch.Tensor, iou_threshold: float, max_out: int,
                coord_bound=None):
    """NMS where boxes of different ``idxs`` never suppress each other (each
    group is shifted to its own region, mmcv ``batched_nms``). ``coord_bound``:
    a float or a (B,) tensor; default the largest valid coordinate."""
    if coord_bound is None:
        coord_bound = torch.where(valid[..., None], boxes, 0.0).amax(dim=(1, 2))
    if torch.is_tensor(coord_bound):
        coord_bound = coord_bound[:, None]
    shifted = boxes + (idxs.to(boxes.dtype) * (coord_bound + 1.0))[..., None]
    _, out_scores, out_idx, out_valid = nms(shifted, scores, valid, iou_threshold, max_out)
    out_boxes = torch.where(out_valid[..., None],
                            boxes.gather(1, out_idx[..., None].expand(-1, -1, 4)), 0.0)
    return out_boxes, out_scores, out_idx, out_valid


# ---------------------------------------------------------------- RoIAlign
def _interp_matrix(start, bin_size, grid, out_size: int, size: int, max_grid: int):
    """(..., out_size, size) f32 interpolation matrices for one axis.
    start/bin_size (...,) f32, grid (...,) int samples per bin."""
    dev = start.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    s = torch.arange(max_grid, dtype=torch.float32, device=dev)
    gridf = grid.float()[..., None, None]
    y = (start[..., None, None] + i[:, None] * bin_size[..., None, None]
         + (s + 0.5) * bin_size[..., None, None] / gridf)  # (..., out, max_grid)
    sample_w = (s < gridf).float() / gridf
    out_of_range = (y < -1.0) | (y > size)
    yc = y.clamp(0.0, size - 1)
    yc = torch.where(torch.floor(yc) >= size - 1, float(size - 1), yc)
    w = torch.where(out_of_range, 0.0, sample_w)
    h_idx = torch.arange(size, dtype=torch.float32, device=dev)
    hat = (1.0 - (h_idx - yc[..., None]).abs()).clamp(min=0.0)  # (..., out, mg, size)
    return (hat * w[..., None]).sum(dim=-2)


def _geometry(rois, spatial_scale, output_size, sampling_ratio, max_grid, pool_from):
    rois = rois.float()
    start_w = rois[..., 0] * spatial_scale - 0.5
    start_h = rois[..., 1] * spatial_scale - 0.5
    roi_w = rois[..., 2] * spatial_scale - 0.5 - start_w
    roi_h = rois[..., 3] * spatial_scale - 0.5 - start_h
    bin_w = roi_w / output_size
    bin_h = roi_h / output_size
    if pool_from is not None:
        # pooling k×k bins of the pool_from grid = sampling k·ceil(roi/pool_from)
        # points per output bin (the same sample set)
        assert pool_from % output_size == 0 and sampling_ratio == 0
        k = pool_from // output_size
        grid_h = (k * torch.ceil(roi_h / pool_from).clamp(1, max_grid)).int()
        grid_w = (k * torch.ceil(roi_w / pool_from).clamp(1, max_grid)).int()
        mg = k * max_grid
    elif sampling_ratio > 0:
        grid_h = torch.full_like(start_h, sampling_ratio, dtype=torch.int32)
        grid_w = grid_h
        mg = sampling_ratio
    else:
        grid_h = torch.ceil(roi_h / output_size).clamp(1, max_grid).int()
        grid_w = torch.ceil(roi_w / output_size).clamp(1, max_grid).int()
        mg = max_grid
    return start_h, bin_h, grid_h, start_w, bin_w, grid_w, mg


def roi_align_plain(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                    output_size: int, sampling_ratio: int = 0, max_grid: int = 8,
                    pool_from: int | None = None) -> torch.Tensor:
    """RoIAlign on one map. feat (B, H, W, C),
    rois (B, R, 4) [x1, y1, x2, y2] image coords → (B, R, out, out, C) in
    feat.dtype (products in feat.dtype, f32 geometry)."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    out = feat.new_empty((b, r, output_size, output_size, c))
    if r == 0:
        return out
    sh, bh, gh, sw, bw, gw, mg = _geometry(
        rois, spatial_scale, output_size, sampling_ratio, max_grid, pool_from)
    per_roi = b * output_size * max(w * c, mg * max(h, w)) * 4
    chunk = max(1, min(r, CHUNK_BYTES // per_roi))
    f2 = feat.reshape(b, h, w * c)
    for r0 in range(0, r, chunk):
        sl = slice(r0, min(r, r0 + chunk))
        n = sl.stop - sl.start
        sy = _interp_matrix(sh[:, sl], bh[:, sl], gh[:, sl], output_size, h, mg).to(feat.dtype)
        sx = _interp_matrix(sw[:, sl], bw[:, sl], gw[:, sl], output_size, w, mg).to(feat.dtype)
        t1 = (sy.reshape(b, n * output_size, h) @ f2).reshape(b, n, output_size, w, c)
        out[:, sl] = sx[:, :, None] @ t1  # (B, n, out_i, out_j, C)
    return out


def roi_align_sum_plain(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                        spatial_scales: Sequence[float], output_size: int,
                        sampling_ratios: Sequence[int], pool_froms: Sequence[int | None],
                        bias: torch.Tensor | None = None, max_grid: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the fused K4 call: ``roi_align_plain`` per
    map, added up in the maps' type, then ``bias`` (B, R, C) broadcast over
    the bins (every add rounds in that type)."""
    out = None
    for feat, scale, ratio, pool_from in zip(feats, spatial_scales, sampling_ratios, pool_froms):
        t = roi_align_plain(feat, rois, scale, output_size, ratio, max_grid, pool_from)
        out = t if out is None else out + t
    if bias is not None:
        out = out + bias.to(out.dtype)[:, :, None, None, :]
    return out


def attention_pool(feat: torch.Tensor, rois: torch.Tensor, stride: int, thres: float,
                   eps: float = 1e-8, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Cosine-similarity attention pooling of AttentionRoIExtractor's coarse
    levels. feat (B, H, W, C), rois (B, R, 4) → (B, R, C): the mean over the
    level of feat · (relu(cos(centre cell, cell) - thres) + thres), in
    ``out_dtype`` (feat's type when None)."""
    b, h, w, c = feat.shape
    cx = torch.floor((rois[..., 0] + rois[..., 2]) / (2.0 * stride)).clamp(0, w - 1).long()
    cy = torch.floor((rois[..., 1] + rois[..., 3]) / (2.0 * stride)).clamp(0, h - 1).long()
    flat = feat.float().reshape(b, h * w, c)
    center = flat.gather(1, (cy * w + cx)[..., None].expand(-1, -1, c))  # (B, R, C)
    md = feat.dtype
    dots = (flat.to(md) @ center.to(md).transpose(1, 2)).float()  # (B, HW, R)
    denom = (flat.norm(dim=-1)[:, :, None] * center.norm(dim=-1)[:, None, :]).clamp(min=eps)
    sim = torch.relu(dots / denom - thres) + thres
    pooled = (sim.to(md).transpose(1, 2) @ flat.to(md)).float() / (h * w)  # (B, R, C)
    return pooled.to(out_dtype or feat.dtype)



# ---------------------------------------------------------------- morphology
def gaussian_kernel1d(kernel_size: int = 5, sigma: float | None = None) -> np.ndarray:
    """torchvision ``gaussian_blur`` taps: sigma = 0.3*((k-1)/2 - 1) + 0.8."""
    if sigma is None:
        sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    half = (kernel_size - 1) * 0.5
    x = np.linspace(-half, half, kernel_size)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def _conv_ones(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Zero-padded ksize×ksize window sums of (B, H, W) f32 (exact counts)."""
    h, w = x.shape[-2:]
    pad = ksize // 2
    xp = F.pad(x, (pad, pad, pad, pad))
    rows = sum(xp[..., i:i + h, :] for i in range(ksize))
    return sum(rows[..., i:i + w] for i in range(ksize))


def binary_erosion(mask: torch.Tensor, ksize: int = 5, iterations: int = 1) -> torch.Tensor:
    m = mask.float()
    for _ in range(iterations):
        m = torch.clamp(_conv_ones(m, ksize) - ksize * ksize + 1.0, 0.0, 1.0)
    return m


def binary_dilation(mask: torch.Tensor, ksize: int = 5, iterations: int = 1) -> torch.Tensor:
    m = mask.float()
    for _ in range(iterations):
        m = torch.clamp(_conv_ones(m, ksize), 0.0, 1.0)
    return m


def binary_open(mask: torch.Tensor, ksize: int = 5, iterations: int = 1) -> torch.Tensor:
    return binary_dilation(binary_erosion(mask, ksize, iterations), ksize, iterations)


def shift(x: torch.Tensor, k: int, dim: int, rev: bool, fill) -> torch.Tensor:
    """x'[i] = x[i-k] (x[i+k] if ``rev``) along ``dim``, ``fill`` at the edge."""
    n = x.shape[dim]
    edge = torch.full_like(x.narrow(dim, 0, k), fill)
    if rev:
        return torch.cat([x.narrow(dim, k, n - k), edge], dim=dim)
    return torch.cat([edge, x.narrow(dim, 0, n - k)], dim=dim)


def _sweep_or(v: torch.Tensor, allowed: torch.Tensor, dim: int, rev: bool) -> torch.Tensor:
    """Segmented OR scan (doubling): v[i] becomes True if some v[j] is True
    with j..i one contiguous ``allowed`` run in the sweep direction."""
    n = v.shape[dim]
    run = allowed & shift(allowed, 1, dim, rev, False)
    k = 1
    while k < n:
        v = v | (shift(v, k, dim, rev, False) & run)
        run = run & shift(run, k, dim, rev, False)
        k *= 2
    return v


# sweep order of the reference: along W forward/back, then along H
SWEEPS = ((-1, False), (-1, True), (-2, False), (-2, True))


def _flood_scan(seed: torch.Tensor, allowed: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
    """4-connected flood of ``seed`` through ``allowed`` (B, H, W), rounds of
    four directional scans until no image changes (at most ``max_rounds``)."""
    v = seed & allowed
    for _ in range(max_rounds):
        v2 = v
        for dim, rev in SWEEPS:
            v2 = _sweep_or(v2, allowed, dim, rev)
        if torch.equal(v2, v):
            break
        v = v2
    return v


def fill_holes(mask: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
    """scipy ``binary_fill_holes`` (4-connectivity) of (B, H, W) bool masks."""
    mask = mask.bool()
    border = torch.zeros_like(mask)
    border[:, 0, :] = True
    border[:, -1, :] = True
    border[:, :, 0] = True
    border[:, :, -1] = True
    bg = ~mask
    outside = _flood_scan(bg & border, bg, max_rounds=max_rounds)
    return mask | (bg & ~outside)


# ---------------------------------------------------------------- components
def _sweep_min(v: torch.Tensor, allowed: torch.Tensor, dim: int, rev: bool, big: int):
    """Segmented min scan (doubling) along one direction of (B, H, W)."""
    n = v.shape[dim]
    run = allowed & shift(allowed, 1, dim, rev, False)
    k = 1
    while k < n:
        v = torch.minimum(v, torch.where(run, shift(v, k, dim, rev, big), big))
        run = run & shift(run, k, dim, rev, False)
        k *= 2
    return v


def _propagate_min(lab: torch.Tensor, mask: torch.Tensor, big: int, inner: int) -> torch.Tensor:
    """``inner`` steps of 4-neighbour min propagation."""
    for _ in range(inner):
        neigh = torch.minimum(
            torch.minimum(shift(lab, 1, -2, True, big), shift(lab, 1, -2, False, big)),
            torch.minimum(shift(lab, 1, -1, True, big), shift(lab, 1, -1, False, big)),
        )
        lab = torch.where(mask, torch.minimum(lab, neigh), big)
    return lab


def label_components_raw(mask: torch.Tensor, max_iters: int = 24, inner: int = 8,
                         scan_rounds: int = 2) -> torch.Tensor:
    """(B, H, W) bool → int32 labels, the reference's bounded schedule:
    ``scan_rounds`` rounds of four directional min scans, then up to
    ``max_iters`` rounds of ``inner`` propagation steps, stopping once a
    round changes no image (an image at its fixpoint stays there, so the
    per-image stop of the reference gives the same labels)."""
    b, h, w = mask.shape
    mask = mask.bool()
    big = h * w
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(1, h, w)
    lab = torch.where(mask, idx, big)
    for _ in range(scan_rounds):
        for dim, rev in SWEEPS:
            lab = _sweep_min(lab, mask, dim, rev, big)
    for _ in range(max_iters):
        lab2 = _propagate_min(lab, mask, big, inner)
        if torch.equal(lab2, lab):
            break
        lab = lab2
    return lab


def first_roots(lab: torch.Tensor, mask: torch.Tensor, max_components: int):
    """First ``max_components`` component roots in raster order per image.
    → (roots (B, K) int32 ascending, padding = H·W; valid (B, K))."""
    b, h, w = lab.shape
    n = h * w
    idx = torch.arange(n, dtype=torch.int32, device=lab.device).reshape(1, h, w)
    is_root = (lab == idx) & mask.bool()
    scores = torch.where(is_root, idx, n).reshape(b, n)
    roots = torch.topk(scores, max_components, dim=1, largest=False, sorted=True).values
    return roots, roots < n


def component_stats_plain(lab: torch.Tensor, roots: torch.Tensor):
    """Plain version of K3. lab (B, H, W) labels in [0, H·W] (H·W is the
    background), roots (B, K) ids (padding H·W; ids outside [0, H·W] own no
    pixel) → (boxes (B, K, 4) f32 [x1, y1, x2+1, y2+1] of the pixels with
    lab == id, areas (B, K) int32); an id with no pixels gets ±1e9 extents
    and area 0."""
    b, h, w = lab.shape
    hw = h * w
    k = roots.shape[1]
    dev = lab.device
    roots = roots.long()
    in_range = (roots >= 0) & (roots <= hw)
    # slot of each label value; column hw + 1 absorbs out-of-range ids
    slot_of = torch.full((b, hw + 2), -1, dtype=torch.long, device=dev)
    slot_of.scatter_(1, torch.where(in_range, roots, hw + 1),
                     torch.arange(k, device=dev).expand(b, k).contiguous())
    slot_of[:, hw + 1] = -1
    flat = lab.reshape(b, hw).long()
    slot = slot_of.gather(1, torch.where((flat >= 0) & (flat <= hw), flat, hw + 1))
    dest = torch.where(slot >= 0, slot, k)  # column k collects unmatched pixels
    pix = torch.arange(hw, device=dev)

    def reduce(vals, how, init):
        out = torch.full((b, k + 1), init, dtype=torch.long, device=dev)
        out.scatter_reduce_(1, dest, vals.expand(b, hw), reduce=how, include_self=True)
        return out[:, :k]

    big_i = np.iinfo(np.int32).max
    stats = [reduce(pix % w, "amin", big_i), reduce(pix // w, "amin", big_i),
             reduce(pix % w, "amax", -big_i), reduce(pix // w, "amax", -big_i),
             reduce(torch.ones_like(pix), "sum", 0)]
    # duplicate ids all read the slot that holds their table entry
    src = slot_of.gather(1, torch.where(in_range, roots, hw + 1))
    stats = [s.gather(1, src.clamp(min=0)) for s in stats]
    areas = torch.where(src >= 0, stats[4], 0)
    has = areas > 0
    x1 = torch.where(has, stats[0].float(), BIG)
    y1 = torch.where(has, stats[1].float(), BIG)
    x2 = torch.where(has, stats[2].float(), -BIG) + 1.0
    y2 = torch.where(has, stats[3].float(), -BIG) + 1.0
    return torch.stack([x1, y1, x2, y2], dim=-1), areas.to(torch.int32)


def _axis_resize_np(src: int, dst: int) -> np.ndarray:
    if dst == 1:
        return np.ones((1, src))
    coords = np.arange(dst) * (src - 1) / (dst - 1)
    low = np.clip(np.floor(coords), 0, src - 1).astype(int)
    high = np.clip(low + 1, 0, src - 1)
    frac = coords - low
    m = np.zeros((dst, src))
    np.add.at(m, (np.arange(dst), low), 1 - frac)
    np.add.at(m, (np.arange(dst), high), frac)
    return m


def _axis_blur_np(n: int, kernel_size: int = 5, sigma: float | None = None) -> np.ndarray:
    kv = gaussian_kernel1d(kernel_size, sigma).astype(np.float64)
    pad = kernel_size // 2
    g = np.zeros((n, n))
    for t in range(kernel_size):
        for i in range(n):
            j = i - pad + t
            if j < 0:
                j = -j  # reflect padding without edge repeat
            if j >= n:
                j = 2 * (n - 1) - j
            g[i, j] += kv[t]
    return g


@lru_cache(maxsize=16)
def _resize_blur_mats(src_h, src_w, dst_h, dst_w, kernel_size, sigma):
    by = _axis_blur_np(dst_h, kernel_size, sigma) @ _axis_resize_np(src_h, dst_h)
    bx = _axis_blur_np(dst_w, kernel_size, sigma) @ _axis_resize_np(src_w, dst_w)
    return by.astype(np.float32), bx.astype(np.float32)


def resize_blur_align_corners(img: torch.Tensor, size: tuple[int, int],
                              kernel_size: int = 5, sigma: float | None = None) -> torch.Tensor:
    """``gaussian_blur5(resize_align_corners(img, size))`` of (..., H, W) as
    one (dst, src) matrix per axis, in f32."""
    h, w = img.shape[-2:]
    by, bx = _resize_blur_mats(h, w, size[0], size[1], kernel_size, sigma)
    by = torch.from_numpy(by).to(img.device)
    bx = torch.from_numpy(bx).to(img.device)
    return by @ img.float() @ bx.T


@lru_cache(maxsize=16)
def _half_pixel_mats(src_h, src_w, dst_h, dst_w):
    def axis(src, dst):
        coords = (np.arange(dst) + 0.5) * src / dst - 0.5  # half-pixel centres
        low = np.clip(np.floor(coords), 0, src - 1).astype(int)
        high = np.clip(low + 1, 0, src - 1)
        frac = np.clip(coords - np.floor(coords), 0.0, 1.0)
        frac = np.where(coords < 0, 0.0, frac)  # border replicate
        m = np.zeros((dst, src))
        np.add.at(m, (np.arange(dst), low), 1 - frac)
        np.add.at(m, (np.arange(dst), high), frac)
        return m.astype(np.float32)

    return axis(src_h, dst_h), axis(src_w, dst_w)


def resize_half_pixel(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) with half-pixel centres (cv2
    INTER_LINEAR / align_corners=False, border replicate), in f32."""
    h, w = img.shape[-2:]
    if (h, w) == tuple(size):
        return img.float()
    my, mx = _half_pixel_mats(h, w, size[0], size[1])
    my = torch.from_numpy(my).to(img.device)
    mx = torch.from_numpy(mx).to(img.device)
    return my @ img.float() @ mx.T


def resize_align_corners(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) with ``align_corners=True``: source
    coordinate of output i is i·(H-1)/(h2-1). Keeps the input dtype."""
    h, w = img.shape[-2:]
    if (h, w) == tuple(size):
        return img

    def axis(src: int, dst: int) -> torch.Tensor:
        if dst == 1:
            return torch.ones((1, src), device=img.device)
        coords = torch.arange(dst, dtype=torch.float32, device=img.device) * (src - 1) / (dst - 1)
        low = torch.clamp(torch.floor(coords), 0, src - 1).long()
        high = torch.clamp(low + 1, 0, src - 1)
        frac = coords - low
        m = torch.zeros((dst, src), device=img.device)
        rows = torch.arange(dst, device=img.device)
        m.index_put_((rows, low), 1 - frac, accumulate=True)
        m.index_put_((rows, high), frac, accumulate=True)
        return m

    out = axis(h, size[0]) @ img.float() @ axis(w, size[1]).T
    return out.to(img.dtype)


def component_proposals_batched(semantic_logits: torch.Tensor, img_shape: tuple[int, int],
                                max_components: int = 512, min_area: int = 10,
                                thres: float = 0.0):
    """(B, Hs, Ws) semantic logits → (boxes (B, K, 5) [x1, y1, x2, y2, 1],
    valid (B, K)): upsample + blur, threshold, open (5×5, 2), fill holes,
    components, the first K roots' boxes, area filter 10 < area < HW/4."""
    h, w = img_shape
    k = max_components
    mask = resize_blur_align_corners(semantic_logits, (h, w)) > thres
    mask = binary_open(mask, ksize=5, iterations=2) > 0.5
    mask = fill_holes(mask)
    lab = label_components_raw(mask)
    roots, valid = first_roots(lab, mask, k)
    boxes, areas = component_stats_plain(lab, roots)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    areas = torch.where(valid, areas, 0)
    valid = valid & (areas > min_area) & (areas < h * w / 4)
    boxes5 = torch.cat([boxes, torch.ones_like(boxes[..., :1])], dim=-1)
    return torch.where(valid[..., None], boxes5, 0.0), valid


# ---------------------------------------------------------------- paste
def _paste_matrix(b0: torch.Tensor, b1: torch.Tensor, out_size: int, mask_size: int):
    """(...,) box starts/ends → (..., out_size, mask_size) f32 matrices."""
    p = torch.arange(out_size, dtype=torch.float32, device=b0.device) + 0.5
    extent = (b1 - b0).clamp(min=1e-6)
    m = (p - b0[..., None]) / extent[..., None] * mask_size - 0.5  # (..., out)
    k = torch.arange(mask_size, dtype=torch.float32, device=b0.device)
    return (1.0 - (k - m[..., None]).abs()).clamp(min=0.0)



def paste_label_map(masks: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                    out_shape: tuple[int, int], threshold: float = 0.5) -> torch.Tensor:
    """masks (B, N, M, M) probabilities, boxes (B, N, 4) in the output frame,
    valid (B, N) → (B, H, W) int32 label map. Detections go in chunks of 64:
    the (B, 64, H, W) f32 intermediate is 268 MB at B16, 256²."""
    chunk = 64
    b, n, msize, _ = masks.shape
    h, w = out_shape
    big = n + 1
    lab = torch.full((b, h, w), big, dtype=torch.int32, device=masks.device)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        bx = boxes[:, sl].float()
        py = _paste_matrix(bx[..., 1], bx[..., 3], h, msize)  # (B, c, H, M)
        px = _paste_matrix(bx[..., 0], bx[..., 2], w, msize)  # (B, c, W, M)
        full = py @ masks[:, sl].float() @ px.transpose(-1, -2)  # (B, c, H, W)
        on = (full > threshold) & valid[:, sl, None, None]
        ids = torch.arange(sl.start, sl.stop, dtype=torch.int32, device=masks.device)
        cand = torch.where(on, ids[None, :, None, None], big).amin(dim=1)
        lab = torch.minimum(lab, cand)
    return torch.where(lab >= big, 0, lab + 1)
