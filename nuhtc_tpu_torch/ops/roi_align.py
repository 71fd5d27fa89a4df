"""K4: RoIAlign, batched and summed over maps, and attention pooling.

``roi_align`` computes mmcv ``RoIAlign(aligned=True, pool_mode='avg')``, what
the TPU kernel ``roi_align_pallas_batched`` (nuhtc_tpu/ops/roi_align_pallas.py:126)
set out to compute, with the adaptive sampling grid capped at ``max_grid``
and the exact fusion of ``adaptive_avg_pool2d(RoIAlign(pool_from), out)``
through ``pool_from``. ``roi_align_sum`` is what a cascade stage needs of it:
the sum of RoIAlign over up to three maps, each with its own scale, sampling
ratio and ``pool_from``, on one set of boxes, plus a per-RoI bias. On CUDA
tensors both launch the hand kernel (``csrc/roi_align.cu``) once, ``roi_align``
as its one-map mode; on CPU tensors they run the plain versions.

``roi_align_plain`` is the port of the dense ``exact`` semantics of
nuhtc_tpu/ops/roi_align.py: two interpolation products per RoI,
``out = Sy @ F @ Sxᵀ`` (Sy (out, H), Sx (out, W)). RoIs are processed in
chunks so the (R, out, W, C) intermediate stays near 1 GiB.
``roi_align_sum_plain`` composes it with PyTorch adds.
"""

from __future__ import annotations

from typing import Sequence

import torch

CHUNK_BYTES = 1 << 30  # per-chunk budget of the RoIAlign intermediates


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
    """Plain PyTorch version of K4 (the kernel's oracle). feat (B, H, W, C),
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


def roi_align_sum(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                  spatial_scales: Sequence[float], output_size: int,
                  sampling_ratios: Sequence[int], pool_froms: Sequence[int | None],
                  bias: torch.Tensor | None = None, max_grid: int = 8) -> torch.Tensor:
    """K4 wrapper: Σₗ roi_align(featsₗ, rois, …) + bias[:, :, None, None, :].

    feats: 1 to 3 maps (B, Hₗ, Wₗ, C), all bf16 or all f32, each with its
    scale, sampling ratio and ``pool_from`` (None or a multiple of
    ``output_size``, with sampling ratio 0); rois (B, R, 4) image coords;
    bias (B, R, C) or None → (B, R, out, out, C) in the maps' type. The kernel
    sums in f32 and rounds once, at the store.

    CPU tensors take ``roi_align_sum_plain``; CUDA tensors launch the kernel,
    once, or raise."""
    feats = list(feats)
    n = len(feats)
    if not (n == len(spatial_scales) == len(sampling_ratios) == len(pool_froms)):
        raise ValueError("roi_align_sum: one scale, sampling ratio and pool_from per map")
    if not 1 <= n <= 3:
        raise ValueError(f"roi_align_sum: takes 1 to 3 maps, not {n}")
    first = feats[0]
    for f in feats:
        if f.dim() != 4 or f.dtype != first.dtype or f.device != first.device:
            raise ValueError("roi_align_sum: maps must be (B, H, W, C) of one type on one device")
        if f.shape[0] != first.shape[0] or f.shape[3] != first.shape[3]:
            raise ValueError("roi_align_sum: maps differ in batch or channels: "
                             f"{[tuple(f.shape) for f in feats]}")
    b, c = first.shape[0], first.shape[3]
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"roi_align_sum: bad shapes {tuple(first.shape)} {tuple(rois.shape)}")
    r = rois.shape[1]
    if bias is not None and tuple(bias.shape) != (b, r, c):
        raise ValueError(f"roi_align_sum: bias {tuple(bias.shape)} is not {(b, r, c)}")
    if rois.device != first.device or (bias is not None and bias.device != first.device):
        raise ValueError("roi_align_sum: maps, rois and bias must be on one device")
    for ratio, pool_from in zip(sampling_ratios, pool_froms):
        if ratio < 0 or (pool_from is not None and (pool_from <= 0 or pool_from % output_size
                                                   or ratio)):
            raise ValueError("roi_align_sum: pool_from must be a multiple of output_size, "
                             "with sampling_ratio 0")
    if first.device.type == "cpu":
        return roi_align_sum_plain(feats, rois, spatial_scales, output_size, sampling_ratios,
                                   pool_froms, bias, max_grid)
    if first.device.type != "cuda":
        raise ValueError(f"roi_align_sum: unsupported device {first.device}")
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"roi_align_sum: kernel takes bf16 or f32 maps, not {first.dtype}")
    if min(output_size, max_grid) < 1:
        raise ValueError(f"roi_align_sum: out={output_size} max_grid={max_grid}")
    out = first.new_empty((b, r, output_size, output_size, c))
    if out.numel() == 0:
        return out

    import ctypes

    from nuhtc_tpu_torch import kernels

    feats_c = [f.contiguous() for f in feats]
    rois_c = rois.to(torch.float32).contiguous()
    bias_c = None if bias is None else bias.to(torch.float32).contiguous()
    dims = []
    for f, ratio, pool_from in zip(feats_c, sampling_ratios, pool_froms):
        dims += [f.shape[1], f.shape[2], int(ratio), int(pool_from or 0)]
    code = kernels.load().roi_align_sum_launch(
        (ctypes.c_void_p * n)(*[f.data_ptr() for f in feats_c]), (ctypes.c_int * (4 * n))(*dims),
        (ctypes.c_float * n)(*[float(s) for s in spatial_scales]), n, rois_c.data_ptr(),
        None if bias_c is None else bias_c.data_ptr(), out.data_ptr(), b, r, c, output_size,
        max_grid, int(first.dtype == torch.bfloat16),
        torch.cuda.current_stream(first.device).cuda_stream)
    kernels.check(code, "roi_align_sum")
    roi_align.launches += 1
    return out


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float, output_size: int,
              sampling_ratio: int = 0, max_grid: int = 8,
              pool_from: int | None = None) -> torch.Tensor:
    """K4 on one map, without bias. feat (B, H, W, C) bf16 or f32, rois
    (B, R, 4) image coords → (B, R, out, out, C) in feat.dtype, f32 sums.

    CPU tensors take ``roi_align_plain``; CUDA tensors launch the kernel.
    ``roi_align.launches`` counts every launch of the kernel, through this
    wrapper or ``roi_align_sum``."""
    return roi_align_sum([feat], rois, [spatial_scale], output_size, [sampling_ratio],
                         [pool_from], None, max_grid)


roi_align.launches = 0


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

