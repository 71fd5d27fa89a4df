"""Connected-component ("watershed") proposals, batched over (B, H, W).

Port of nuhtc_tpu/ops/components.py. In the shipped configuration the
reference's watershed proposal branch is connected components of the opened,
hole-filled semantic mask (see that module's docstring). Labels are the
minimum linear pixel index of each 4-connected component (background = H·W).

``component_stats`` (the port of ``boxes_from_roots``) holds K3: on a CUDA
tensor it launches the hand kernel ``csrc/component_stats.cu`` (per-strip
statistics in shared memory, then a reduction over the strips); on a CPU
tensor it runs ``component_stats_plain``, a scatter-reduce with the same
exact result.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nuhtc_tpu_torch.ops import morphology
from nuhtc_tpu_torch.ops.morphology import SWEEPS, shift
from nuhtc_tpu_torch.utils.profiling import count

BIG = 1e9  # extent of an id that owns no pixel


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
        count("components.rounds")
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


MAX_IDS_PER_LAUNCH = 4096  # their hash and statistics fit a block's shared memory (144 KB)


@lru_cache(maxsize=64)
def _strips(b: int, hw: int) -> int:
    """K3's strips per image, as the library computes them."""
    from nuhtc_tpu_torch import kernels

    return kernels.load().component_stats_strips(b, hw)


def _int32_contiguous(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


def component_stats(lab: torch.Tensor, roots: torch.Tensor):
    """Boxes [x1, y1, x2+1, y2+1] (B, K, 4) f32 and int32 areas (B, K) of the
    components with the given ids (``boxes_from_roots`` of the JAX package).
    K3 wrapper: ``component_stats_plain`` on CPU, the kernel on CUDA (ids
    hashed and statistics kept per block in shared memory, two launches,
    nothing initialised). More than ``MAX_IDS_PER_LAUNCH`` ids go to the
    kernel that many at a time; an id listed in two such calls gets the same
    numbers from both, since each counts all of its pixels."""
    if lab.device.type == "cpu":
        return component_stats_plain(lab, roots)
    if lab.device.type != "cuda":
        raise ValueError(f"component_stats: unsupported device {lab.device}")
    if lab.dim() != 3 or roots.dim() != 2 or roots.shape[0] != lab.shape[0]:
        raise ValueError(f"component_stats: bad shapes {tuple(lab.shape)} {tuple(roots.shape)}")
    if roots.device != lab.device:
        raise ValueError("component_stats: lab and roots must be on one device")
    from nuhtc_tpu_torch import kernels

    b, h, w = lab.shape
    k = roots.shape[1]
    dev = lab.device
    if b * k == 0:
        return (torch.empty((b, k, 4), dtype=torch.float32, device=dev),
                torch.empty((b, k), dtype=torch.int32, device=dev))
    if b > 65535 or h * w == 0:
        raise ValueError(f"component_stats: kernel cannot serve {tuple(lab.shape)}")
    lab_c, roots_c = _int32_contiguous(lab), _int32_contiguous(roots)
    lib = kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    strips = _strips(b, h * w)
    parts = []
    chunks = [roots_c] if k <= MAX_IDS_PER_LAUNCH else [
        c.contiguous() for c in roots_c.split(MAX_IDS_PER_LAUNCH, dim=1)]
    for ids in chunks:
        n = ids.shape[1]
        boxes = torch.empty((b, n, 4), dtype=torch.float32, device=dev)
        areas = torch.empty((b, n), dtype=torch.int32, device=dev)
        # per-strip statistics (B, strips, 5, n), then each id's slot (B, n)
        scratch = torch.empty(b * n * (5 * strips + 1), dtype=torch.int32, device=dev)
        code = lib.component_stats_launch(
            lab_c.data_ptr(), ids.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * b * n * 5 * strips, boxes.data_ptr(), areas.data_ptr(),
            b, h, w, n, stream)
        kernels.check(code, "component_stats")
        component_stats.launches += 1
        parts.append((boxes, areas))
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


component_stats.launches = 0


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
    kv = morphology.gaussian_kernel1d(kernel_size, sigma).astype(np.float64)
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
    mask = morphology.binary_open(mask, ksize=5, iterations=2) > 0.5
    mask = morphology.fill_holes(mask)
    lab = label_components_raw(mask)
    roots, valid = first_roots(lab, mask, k)
    boxes, areas = component_stats(lab, roots)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    areas = torch.where(valid, areas, 0)
    valid = valid & (areas > min_area) & (areas < h * w / 4)
    boxes5 = torch.cat([boxes, torch.ones_like(boxes[..., :1])], dim=-1)
    return torch.where(valid[..., None], boxes5, 0.0), valid
