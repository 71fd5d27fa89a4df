"""K1 and K2: one Swin block after LN1 on the padded (and rolled) map.

``window_block`` computes what the TPU kernel ``window_block_fused``
(nuhtc_tpu/ops/window_attention_pallas.py:255) computes: windowed attention
on the post-LN1 map ``h1p``, proj, + raw shortcut ``xp``, LN2, an MLP with
tanh-approximate gelu, + residual. On a CUDA tensor it launches the hand
kernel (``csrc/window_block.cu``); on a CPU tensor it runs
``window_block_plain``, the same math in plain PyTorch with the bf16 casts at
the same places. Weights are in PyTorch's (out, in) layout.

``window_attention`` is the attention-only tier, what the TPU kernel
``window_attention_fused`` (nuhtc_tpu/ops/window_attention_pallas.py:128)
computes: windowed attention on ``h1p`` and proj, no residual; LN2 and the
MLP stay with the caller. It is a mode of the same CUDA source; its plain
twin is ``window_attention_plain``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Additive attention mask (nW, ws², ws²) for shifted windows."""
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wss] = cnt
            cnt += 1
    m = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(m[:, :, None] != m[:, None, :], -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B*nH*nW, ws*ws, C). H, W must be multiples of ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    b = wins.shape[0] // (h // ws * (w // ws))
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _bf(t: torch.Tensor) -> torch.Tensor:
    """bf16-rounded values in f32: a bf16 operand of an f32-accumulated product."""
    return t.to(torch.bfloat16).float()


def _attention_f32(h1p, wqkv, bqkv, wproj, bproj, bias49, ws: int, num_heads: int,
                   shift: int, qk_scale: float | None) -> torch.Tensor:
    """proj(attn(h1p)) in f32 with the Pallas bodies' bf16 roundings:
    (B, Hp, Wp, C), before any cast to the output type."""
    b, hp, wp, c = h1p.shape
    nh = num_heads
    hd = c // nh
    n = ws * ws
    scale = qk_scale if qk_scale is not None else hd ** -0.5

    wins = window_partition(_bf(h1p), ws)  # (B*nW, N, C)
    bw = wins.shape[0]
    qkv = wins @ _bf(wqkv).T + bqkv.float()
    q, k, v = qkv.split(c, dim=-1)
    heads = lambda t: t.reshape(bw, n, nh, hd).transpose(1, 2)  # noqa: E731
    q, k, v = _bf(heads(q) * scale), _bf(heads(k)), _bf(heads(v))

    bias = bias49.float()[None]  # (1, nh, N, N)
    if shift:
        mask = torch.from_numpy(shift_attn_mask(hp, wp, ws, shift)).to(h1p.device)
        bias = bias + mask[:, None]  # (nW, nh, N, N)
    attn = (q @ k.transpose(-1, -2)).reshape(b, -1, nh, n, n) + _bf(bias)
    p = _bf(torch.softmax(attn, dim=-1)).reshape(bw, nh, n, n)
    o = (p @ v).transpose(1, 2).reshape(bw, n, c)
    o = window_reverse(o, ws, hp, wp)
    return _bf(o) @ _bf(wproj).T + bproj.float()


def window_attention_plain(h1p, wqkv, bqkv, wproj, bproj, bias49, ws: int, num_heads: int,
                           shift: int, qk_scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2 (the kernel's oracle)."""
    return _attention_f32(h1p, wqkv, bqkv, wproj, bproj, bias49, ws, num_heads, shift,
                          qk_scale).to(h1p.dtype)


def window_block_plain(xp, h1p, wqkv, bqkv, wproj, bproj, bias49, g2, b2,
                       wfc1, bfc1, wfc2, bfc2, ws: int, num_heads: int, shift: int,
                       qk_scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (the kernel's oracle)."""
    c = xp.shape[-1]
    x2 = _bf(xp) + _attention_f32(h1p, wqkv, bqkv, wproj, bproj, bias49, ws, num_heads, shift,
                                  qk_scale)
    h2 = F.layer_norm(x2, (c,), g2.float(), b2.float(), eps=1e-5)
    u = F.gelu(_bf(h2) @ _bf(wfc1).T + bfc1.float(), approximate="tanh")
    y = _bf(u) @ _bf(wfc2).T + bfc2.float()
    return (x2 + y).to(xp.dtype)


def _prep(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 32:
        t = t.clone()
    return t


def _check_attention(name, h1p, tensors, wqkv, wproj, bias49, ws: int, num_heads: int) -> None:
    """Raises on what launch 1 (shared by K1 and K2) does not take."""
    b, hp, wp, c = h1p.shape
    if h1p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h1p.device}")
    if any(t.device != h1p.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if hp % ws or wp % ws:
        raise ValueError(f"{name}: map {tuple(h1p.shape)} is not a multiple of ws={ws}")
    if c != 32 * num_heads or c not in (96, 192, 384, 768) or ws * ws > 64:
        raise ValueError(f"{name}: kernel needs head dim 32, C in 96..768, ws<=8; "
                         f"got C={c} heads={num_heads} ws={ws}")
    want = {"wqkv": (3 * c, c), "wproj": (c, c), "bias49": (num_heads, ws * ws, ws * ws)}
    got = {"wqkv": wqkv, "wproj": wproj, "bias49": bias49}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(got[key].shape)} != {shape}")


def _attn_buf(h1p: torch.Tensor) -> torch.Tensor:
    """bf16 scratch between the launches, rows padded to a multiple of 32."""
    m = h1p.shape[0] * h1p.shape[1] * h1p.shape[2]
    return torch.empty(((m + 31) // 32 * 32, h1p.shape[3]), dtype=torch.bfloat16,
                       device=h1p.device)


def window_attention(h1p, wqkv, bqkv, wproj, bproj, bias49, ws: int, num_heads: int,
                     shift: int, qk_scale: float | None = None) -> torch.Tensor:
    """K2 wrapper. h1p (B, Hp, Wp, C), the post-LN1 padded (and rolled) map;
    returns proj(attn(h1p)) (B, Hp, Wp, C) in h1p.dtype, no residual.

    CPU tensors take ``window_attention_plain``; CUDA tensors launch the
    kernel, which needs head dim 32, ws² ≤ 64 and C in {96, 192, 384, 768}."""
    args = (h1p, wqkv, bqkv, wproj, bproj, bias49)
    if h1p.device.type == "cpu":
        return window_attention_plain(*args, ws=ws, num_heads=num_heads, shift=shift,
                                      qk_scale=qk_scale)
    _check_attention("window_attention", h1p, args, wqkv, wproj, bias49, ws, num_heads)

    from nuhtc_tpu_torch import kernels

    bf, f32 = torch.bfloat16, torch.float32
    b, hp, wp, c = h1p.shape
    h_b = _prep(h1p, bf)
    w_qkv, w_proj = _prep(wqkv, bf), _prep(wproj, bf)
    b_qkv, b_proj, rel = _prep(bqkv, f32), _prep(bproj, f32), _prep(bias49, f32)
    attn_buf = _attn_buf(h1p)
    out_f32 = h1p.dtype == f32
    out = torch.empty(h1p.shape, dtype=f32 if out_f32 else bf, device=h1p.device)
    scale = qk_scale if qk_scale is not None else (c // num_heads) ** -0.5
    code = kernels.load().window_attention_launch(
        h_b.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), rel.data_ptr(), attn_buf.data_ptr(), out.data_ptr(),
        b, hp, wp, c, num_heads, ws, shift, float(scale), int(out_f32),
        torch.cuda.current_stream(h1p.device).cuda_stream,
    )
    kernels.check(code, "window_attention")
    window_attention.launches += 1
    return out if out.dtype == h1p.dtype else out.to(h1p.dtype)


window_attention.launches = 0


def window_block(xp, h1p, wqkv, bqkv, wproj, bproj, bias49, g2, b2,
                 wfc1, bfc1, wfc2, bfc2, ws: int, num_heads: int, shift: int,
                 qk_scale: float | None = None) -> torch.Tensor:
    """K1 wrapper. xp, h1p (B, Hp, Wp, C); returns (B, Hp, Wp, C) in xp.dtype.

    CPU tensors take ``window_block_plain``; CUDA tensors launch the kernel,
    which needs head dim 32, ws² ≤ 64 and C in {96, 192, 384, 768}."""
    args = (xp, h1p, wqkv, bqkv, wproj, bproj, bias49, g2, b2, wfc1, bfc1, wfc2, bfc2)
    if xp.device.type == "cpu":
        return window_block_plain(*args, ws=ws, num_heads=num_heads, shift=shift,
                                  qk_scale=qk_scale)
    b, hp, wp, c = xp.shape
    if h1p.shape != xp.shape or xp.device != h1p.device:
        raise ValueError(f"window_block: bad maps {tuple(xp.shape)} {tuple(h1p.shape)}")
    _check_attention("window_block", h1p, args, wqkv, wproj, bias49, ws, num_heads)
    for key, t, shape in (("wfc1", wfc1, (4 * c, c)), ("wfc2", wfc2, (c, 4 * c))):
        if tuple(t.shape) != shape:
            raise ValueError(f"window_block: {key} {tuple(t.shape)} != {shape} "
                             "(kernel needs mlp_ratio 4)")

    from nuhtc_tpu_torch import kernels

    bf, f32 = torch.bfloat16, torch.float32
    x_b, h_b = _prep(xp, bf), _prep(h1p, bf)
    w = [_prep(t, bf) for t in (wqkv, wproj, wfc1, wfc2)]
    v = [_prep(t, f32) for t in (bqkv, bproj, g2, b2, bfc1, bfc2, bias49)]
    attn_buf = _attn_buf(h1p)
    out_f32 = xp.dtype == f32
    out = torch.empty(xp.shape, dtype=f32 if out_f32 else bf, device=xp.device)
    scale = qk_scale if qk_scale is not None else (c // num_heads) ** -0.5
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    code = kernels.load().window_block_launch(
        x_b.data_ptr(), h_b.data_ptr(), w[0].data_ptr(), v[0].data_ptr(),
        w[1].data_ptr(), v[1].data_ptr(), v[6].data_ptr(), v[2].data_ptr(),
        v[3].data_ptr(), w[2].data_ptr(), v[4].data_ptr(), w[3].data_ptr(),
        v[5].data_ptr(), attn_buf.data_ptr(), out.data_ptr(),
        b, hp, wp, c, num_heads, ws, shift, float(scale), int(out_f32), stream,
    )
    kernels.check(code, "window_block")
    window_block.launches += 1
    return out if out.dtype == xp.dtype else out.to(xp.dtype)


window_block.launches = 0
