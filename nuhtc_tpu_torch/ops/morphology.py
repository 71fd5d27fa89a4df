"""Binary morphology on (B, H, W) maps, plain PyTorch.

Port of nuhtc_tpu/ops/morphology.py: torchvision's ``gaussian_blur``
(``gaussian_blur5``: 5 taps, reflect padding), the reference's conv-based
erosion and dilation (5×5 ones kernel, zero padding), their opening and
closing, and scipy ``binary_fill_holes`` (border flood of the background,
4-connectivity, to the fixpoint).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(kernel_size: int = 5, sigma: float | None = None) -> np.ndarray:
    """torchvision ``gaussian_blur`` taps: sigma = 0.3*((k-1)/2 - 1) + 0.8."""
    if sigma is None:
        sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    half = (kernel_size - 1) * 0.5
    x = np.linspace(-half, half, kernel_size)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def gaussian_blur5(img: torch.Tensor, kernel_size: int = 5,
                   sigma: float | None = None) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) with reflect padding (no edge
    repeat), in f32: the rows' weighted sum, then the columns', each taken
    tap by tap in order as the JAX package takes it."""
    kv = gaussian_kernel1d(kernel_size, sigma)
    pad = kernel_size // 2
    h, w = img.shape[-2:]
    x = F.pad(img.reshape(-1, h, w).float(), (pad, pad, pad, pad), mode="reflect")
    x = sum(float(kv[i]) * x[:, i:i + h, :] for i in range(kernel_size))
    x = sum(float(kv[i]) * x[:, :, i:i + w] for i in range(kernel_size))
    return x.reshape(img.shape).to(img.dtype)


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


def binary_close(mask: torch.Tensor, ksize: int = 5, iterations: int = 1) -> torch.Tensor:
    return binary_erosion(binary_dilation(mask, ksize, iterations), ksize, iterations)


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
