"""K4: RoIAlign, batched, and attention pooling.

``roi_align`` computes mmcv ``RoIAlign(aligned=True, pool_mode='avg')``, what
the TPU kernel ``roi_align_pallas_batched`` (nuhtc_tpu/ops/roi_align_pallas.py:126)
set out to compute, with the adaptive sampling grid capped at ``max_grid``
and the exact fusion of ``adaptive_avg_pool2d(RoIAlign(pool_from), out)``
through ``pool_from``. On a CUDA tensor it launches the hand gather kernel
(``csrc/roi_align.cu``); on a CPU tensor it runs ``roi_align_plain``.

``roi_align_plain`` is the port of the dense ``exact`` semantics of
nuhtc_tpu/ops/roi_align.py: two interpolation products per RoI,
``out = Sy @ F @ Sxᵀ`` (Sy (out, H), Sx (out, W)). RoIs are processed in
chunks so the (R, out, W, C) intermediate stays near 1 GiB.
"""

from __future__ import annotations

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


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float, output_size: int,
              sampling_ratio: int = 0, max_grid: int = 8,
              pool_from: int | None = None) -> torch.Tensor:
    """K4 wrapper. feat (B, H, W, C) bf16 or f32, rois (B, R, 4) image coords
    → (B, R, out, out, C) in feat.dtype, f32 sums.

    CPU tensors take ``roi_align_plain``; CUDA tensors launch the kernel."""
    if feat.device.type == "cpu":
        return roi_align_plain(feat, rois, spatial_scale, output_size, sampling_ratio,
                               max_grid, pool_from)
    if feat.device.type != "cuda" or rois.device != feat.device:
        raise ValueError(f"roi_align: unsupported devices {feat.device}, {rois.device}")
    if feat.dim() != 4 or rois.dim() != 3 or rois.shape[0] != feat.shape[0] or rois.shape[2] != 4:
        raise ValueError(f"roi_align: bad shapes {tuple(feat.shape)} {tuple(rois.shape)}")
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"roi_align: kernel takes bf16 or f32 maps, not {feat.dtype}")
    if pool_from is not None and (pool_from % output_size or sampling_ratio):
        raise ValueError("roi_align: pool_from must be a multiple of output_size, with "
                         "sampling_ratio 0")
    b, h, w, c = feat.shape
    r = rois.shape[1]
    if b > 65535 or min(output_size, max_grid) < 1 or sampling_ratio < 0:
        raise ValueError(f"roi_align: kernel cannot serve B={b} out={output_size} "
                         f"sampling_ratio={sampling_ratio} max_grid={max_grid}")
    out = feat.new_empty((b, r, output_size, output_size, c))
    if out.numel() == 0:
        return out

    from nuhtc_tpu_torch import kernels

    feat_c = feat.contiguous()
    rois_c = rois.to(torch.float32).contiguous()
    code = kernels.load().roi_align_launch(
        feat_c.data_ptr(), rois_c.data_ptr(), out.data_ptr(), b, h, w, c, r, output_size,
        sampling_ratio, max_grid, pool_from or 0, int(feat.dtype == torch.bfloat16),
        float(spatial_scale), torch.cuda.current_stream(feat.device).cuda_stream)
    kernels.check(code, "roi_align")
    roi_align.launches += 1
    return out


roi_align.launches = 0


def attention_pool(feat: torch.Tensor, rois: torch.Tensor, stride: int, thres: float,
                   eps: float = 1e-8) -> torch.Tensor:
    """Cosine-similarity attention pooling of AttentionRoIExtractor's coarse
    levels. feat (B, H, W, C), rois (B, R, 4) → (B, R, C): the mean over the
    level of feat · (relu(cos(centre cell, cell) - thres) + thres)."""
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
    return pooled.to(feat.dtype)

