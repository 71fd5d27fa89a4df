"""ViTDet's attention with the decomposed relative-position bias, in one hand
kernel (``csrc/vit_attention.cu``).

For each image and head of a packed qkv map over an h × w token grid,
``vit_attention`` computes

    out[q] = Σ_k softmax_k(scale · q·k + bias_h[q, k // w] + bias_w[q, k % w]) · v[k]
    bias_h[q, ky] = q · rel_h[y_q − ky + h − 1],  bias_w[q, kx] = q · rel_w[x_q − kx + w − 1]

from the relative-position tables ``rel_h`` (2h − 1, hd) and ``rel_w``
(2w − 1, hd) of ``models/backbones.py ViTAttention``, and writes only the
(b, n, heads · hd) output, the input of ``proj``. Without the tables the
attention has no bias.

The kernel replaces no TPU kernel: the JAX package's ViT attention
(``nuhtc_tpu/models/backbones.py ViTAttention``) is plain jnp that XLA fuses.
It was added because the port's plain path writes the (b, heads, n, n)
scores to device memory at 16 bytes an element (103 GB a batch of eight
1024² images in ViTDet-B's four global blocks), which took most of that
forward's device time. What bounds it is operations: q·kᵀ and p·v are
4·n²·hd FLOP an image and head, 412 GFLOP a global block of 8 images × 12
heads × 4,096 tokens (0.42 ms at 989 TFLOP/s), against 8·n·hd bytes of q,
k, v and the output. Its design (the note in the source): both products on
wgmma with f32 sums, k and v streamed through a shared-memory ring by
cp.async, the bias from q times the tables on wgmma into f32 tables in
shared memory, an online softmax in f32, P in bf16, no score and no bias
tensor in device memory.

On a CUDA tensor ``vit_attention`` launches the kernel (bf16, head dim 64,
with the tables a grid of at most 64 a side, no gradient: the kernel has
no backward) and raises on anything else; on a CPU tensor it runs
``vit_attention_plain``, the same arithmetic in plain PyTorch with the
kernel's roundings: the bias, the scores and the softmax in f32 from the
input's values, P in the input's dtype (bf16 in the kernel), f32 sums, the
output in the input's dtype. ``vit_attention_unfused`` has the roundings of
``ViTAttention``'s plain path instead; the kernel's error against the f32
twin is held to that path's (the tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

HEAD_DIMS = (64,)  # head dims the kernel takes
GRID_MAX = 64  # grid sides the kernel's bias takes (its tables live in shared memory)


def key_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each key's grid row and column, (k // w, k % w), as int64 (h·w,)."""
    k = torch.arange(h * w, device=device)
    return k // w, k % w


def rel_bias(q: torch.Tensor, h: int, w: int, rel_h: torch.Tensor, rel_w: torch.Tensor):
    """q (b, h·w, heads, hd) → bias_h (b, heads, h·w, h) and bias_w
    (b, heads, h·w, w), in the dtype of q and the tables."""
    b, n, nh, hd = q.shape
    rq = q.reshape(b, h, w, nh, hd)
    out = []
    for side, table, eq in ((h, rel_h, "bhwnd,hkd->bnhwk"), (w, rel_w, "bhwnd,wkd->bnhwk")):
        i = torch.arange(side, device=q.device)
        out.append(torch.einsum(eq, rq, table[i[:, None] - i[None, :] + side - 1])
                   .reshape(b, nh, n, side))
    return tuple(out)


def vit_attention_plain(qkv: torch.Tensor, b: int, h: int, w: int, nh: int,
                        rel_h: torch.Tensor | None, rel_w: torch.Tensor | None,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (its oracle). qkv (b, n, 3·C)
    with n = h·w → (b, n, C) in qkv's dtype."""
    n = h * w
    c = qkv.shape[-1] // 3
    hd = c // nh
    q, k, v = qkv.reshape(b, n, 3, nh, hd).float().unbind(2)
    attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    if rel_h is not None:
        bias_h, bias_w = rel_bias(q, h, w, rel_h.float(), rel_w.float())
        ky, kx = key_grid(h, w, qkv.device)
        attn = attn + (bias_h[..., ky] + bias_w[..., kx])
    p = attn.softmax(dim=-1).to(qkv.dtype).float()
    return torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n, c).to(qkv.dtype)


def vit_attention_unfused(qkv: torch.Tensor, b: int, h: int, w: int, nh: int,
                          rel_h: torch.Tensor | None, rel_w: torch.Tensor | None,
                          scale: float) -> torch.Tensor:
    """The roundings of ``models/backbones.py ViTAttention``'s plain path:
    the scores, the bias and the biased scores in qkv's dtype, the softmax in
    f32, P in qkv's dtype. qkv (b, n, 3·C) → (b, n, C)."""
    n, c = h * w, qkv.shape[-1] // 3
    q, k, v = qkv.reshape(b, n, 3, nh, c // nh).unbind(2)
    attn = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    if rel_h is not None:
        bias_h, bias_w = rel_bias(q, h, w, rel_h, rel_w)
        attn = attn.reshape(b, nh, h, w, h, w) + bias_h.reshape(b, nh, h, w, h)[..., :, None]
        attn = (attn + bias_w.reshape(b, nh, h, w, w)[..., None, :]).reshape(b, nh, n, n)
    attn = attn.float().softmax(dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)


def _check(qkv, b, h, w, nh, rel_h, rel_w) -> None:
    """Raises on what the kernel does not take."""
    n = h * w
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention: unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"vit_attention: qkv is {qkv.dtype}, the kernel takes bfloat16")
    if qkv.dim() != 3 or qkv.shape[0] != b or qkv.shape[1] != n or qkv.shape[2] % (3 * nh):
        raise ValueError(f"vit_attention: qkv {tuple(qkv.shape)} is not (b={b}, n={n}, 3·C)")
    hd = qkv.shape[2] // (3 * nh)
    if hd not in HEAD_DIMS:
        raise ValueError(f"vit_attention: head dim {hd}, the kernel takes {HEAD_DIMS}")
    if qkv.stride(2) != 1 or qkv.stride(0) % 8 or qkv.stride(1) % 8 or qkv.data_ptr() % 16:
        raise ValueError(f"vit_attention: qkv strides {qkv.stride()} (the kernel reads each "
                         "token's 3·C values contiguous, rows 16-byte aligned)")
    if (rel_h is None) != (rel_w is None):
        raise ValueError("vit_attention: rel_h and rel_w come together")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (qkv, rel_h, rel_w)):
        raise ValueError("vit_attention: an input needs a gradient and the kernel has no "
                         "backward")
    if rel_h is not None:
        if max(h, w) > GRID_MAX:
            raise ValueError(f"vit_attention: a {h}×{w} grid, the kernel's bias takes at most "
                             f"{GRID_MAX} a side")
        for name, t, side in (("rel_h", rel_h, h), ("rel_w", rel_w, w)):
            if tuple(t.shape) != (2 * side - 1, hd) or t.dtype != torch.bfloat16:
                raise ValueError(f"vit_attention: {name} {tuple(t.shape)} {t.dtype}, the "
                                 f"kernel takes ({2 * side - 1}, {hd}) bfloat16")
            if not t.is_contiguous() or t.data_ptr() % 16 or t.device != qkv.device:
                raise ValueError(f"vit_attention: {name} must be contiguous, 16-byte aligned "
                                 "and on qkv's device")


def vit_attention(qkv: torch.Tensor, b: int, h: int, w: int, nh: int,
                  rel_h: torch.Tensor | None, rel_w: torch.Tensor | None,
                  scale: float) -> torch.Tensor:
    """qkv (b, n, 3·C), the qkv Linear's output over an h × w grid (n = h·w;
    each token's q, k, v, heads of C / nh); rel_h (2h − 1, hd) and rel_w
    (2w − 1, hd), or both None → (b, n, C) in qkv's dtype.

    CPU tensors take ``vit_attention_plain``; CUDA tensors launch the
    kernel, which takes bf16, head dim 64, q, k and v read in place through
    qkv's strides, and contiguous bf16 tables of a grid of at most GRID_MAX
    a side, and no input that autograd would record."""
    if qkv.device.type == "cpu":
        return vit_attention_plain(qkv, b, h, w, nh, rel_h, rel_w, scale)
    _check(qkv, b, h, w, nh, rel_h, rel_w)

    from nuhtc_tpu_torch import kernels

    n = h * w
    c = qkv.shape[2] // 3
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    code = kernels.load().vit_attention_launch(
        qkv.data_ptr(), None if rel_h is None else rel_h.data_ptr(),
        None if rel_w is None else rel_w.data_ptr(), out.data_ptr(), b, n, h, w, nh,
        qkv.stride(0), qkv.stride(1), c, c // nh, float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    kernels.check(code, "vit_attention")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
