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

``BlockParams`` is one block's parameters as the kernels read them (bf16
weights, f32 vectors, the gathered ``bias49``, contiguous and aligned), made
once: the wrappers convert nothing that is already in that form, so a caller
that passes a pack's tensors pays for the launches and nothing else.
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
    """``t`` as the kernels read it; ``t`` itself when it already is so."""
    if (t.dtype is dtype and not t.requires_grad and t.is_contiguous()
            and t.data_ptr() % 32 == 0):
        return t
    t = t.detach().to(dtype).contiguous()
    if t.data_ptr() % 32:
        t = t.clone()
    return t


_WEIGHTS = ("wqkv", "wproj", "wfc1", "wfc2")  # bf16, (out, in)
_VECTORS = ("bqkv", "bproj", "bias49", "g2", "b2", "bfc1", "bfc2")  # f32
_ATTENTION = ("wqkv", "bqkv", "wproj", "bproj", "bias49")
_BLOCK = _ATTENTION + ("g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")


class BlockParams:
    """One Swin block's parameters in the form the kernels read: ``wqkv``
    (3C, C), ``wproj`` (C, C), ``wfc1`` (4C, C), ``wfc2`` (C, 4C) in bf16;
    ``bqkv``, ``bproj``, ``g2``, ``b2``, ``bfc1``, ``bfc2`` and ``bias49``
    (nh, ws², ws²) in f32; all contiguous and 32-byte aligned. The MLP and
    LN2 entries may be left out for the attention-only tier.

    ``attention()`` and ``block()`` give the tensors in the order of
    ``window_attention``'s and ``window_block``'s arguments after the maps.
    ``key`` is what the pack was made from (see ``source_key``): a holder
    rebuilds the pack when its parameters' key differs.
    """

    def __init__(self, key=None, **tensors: torch.Tensor):
        unknown = set(tensors) - set(_BLOCK)
        missing = set(_ATTENTION) - set(tensors)
        if unknown or missing:
            raise ValueError(f"BlockParams: unknown {sorted(unknown)}, missing {sorted(missing)}")
        self.key = key
        for name, t in tensors.items():
            setattr(self, name, _prep(t, torch.bfloat16 if name in _WEIGHTS else torch.float32))
        self.has_mlp = all(hasattr(self, name) for name in _BLOCK)

    def attention(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, name) for name in _ATTENTION)

    def block(self) -> tuple[torch.Tensor, ...]:
        if not self.has_mlp:
            raise ValueError("BlockParams: made without LN2 and the MLP")
        return tuple(getattr(self, name) for name in _BLOCK)


_GATHERS = 0  # weights written without a version bump, counted by weights_gathered()


def weights_gathered() -> None:
    """Marks every parameter as rewritten. FSDP2 all-gathers sharded
    parameters into reused storage under
    ``torch.autograd._unsafe_preserve_version_counter``, so neither the
    address nor the version counter of a gathered weight need change;
    ``parallel.shard_rules.shard_state`` calls this after each gather."""
    global _GATHERS
    _GATHERS += 1


def source_key(tensors) -> tuple:
    """Identity and state of parameter tensors: storage address, in-place
    version counter, dtype and device, and the count of ``weights_gathered``
    calls. It changes when a parameter is written in place
    (``load_state_dict``, an optimizer step, an FSDP gather), replaced, or
    moved, and costs no device work."""
    return (_GATHERS,) + tuple((t.data_ptr(), t._version, t.dtype, t.device) for t in tensors)


def bias_fragments(bias49: torch.Tensor) -> torch.Tensor:
    """The relative-position bias as launch 1 reads it: int32 (nh, 8, 128, 4).

    Entry [h, j, t, 2i + e] belongs to thread ``t`` of a warpgroup (warp
    ``t // 32``, lane ``l``) and to the score at row ``16·(t // 32) + l // 4
    + 8i`` and column ``8j + 2·(l % 4) + e`` of the window's padded 64 × 64
    score tile: the order of the thread's wgmma sum registers, so a thread
    reads its 32 entries as eight 16-byte loads. The low half of an entry is
    bf16(bias), the high half bf16(bias − 100) for a pair the shifted-window
    mask separates (the Pallas bodies round the sum of bias and mask).
    Padded columns hold −3e38 in both halves and padded rows 0.
    """
    nh, n, _ = bias49.shape
    if n > 64:
        raise ValueError(f"bias_fragments: {n} tokens per window, at most 64")
    table = bias49.new_zeros((nh, 64, 64), dtype=torch.float32)
    table[:, :, n:] = -3.0e38
    table[:, :n, :n] = bias49.float()

    def bits(v):
        return v.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF

    masked = table - 100.0
    masked[:, :, n:] = -3.0e38
    packed = bits(table) | (bits(masked) << 16)  # (nh, 64, 64) int32
    t = torch.arange(128, device=bias49.device)
    j = torch.arange(8, device=bias49.device)
    k = torch.arange(4, device=bias49.device)
    row = (16 * (t // 32) + (t % 32) // 4)[None, :, None] + 8 * (k // 2)[None, None, :]
    col = 8 * j[:, None, None] + (2 * (t % 4))[None, :, None] + (k % 2)[None, None, :]
    return packed[:, row.expand(8, 128, 4), col.expand(8, 128, 4)].contiguous()


def _bias_table(rel: torch.Tensor) -> torch.Tensor:
    """``bias_fragments(rel)``, kept on the tensor it was made from (a pack's
    ``bias49`` lives as long as the pack) until that tensor is written to."""
    cached = getattr(rel, "_fragments", None)
    if cached is None or cached[0] != rel._version:
        cached = rel._fragments = (rel._version, bias_fragments(rel))
    return cached[1]


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
    """bf16 scratch for the attention output between the two launches."""
    return torch.empty(h1p.shape, dtype=torch.bfloat16, device=h1p.device)


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
        b_proj.data_ptr(), _bias_table(rel).data_ptr(), attn_buf.data_ptr(), out.data_ptr(),
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
    # at C = 768 x2 waits in an f32 scratch map while fc2's sums fill the registers
    park = torch.empty(xp.shape, dtype=f32, device=xp.device) if c == 768 else None
    out_f32 = xp.dtype == f32
    out = torch.empty(xp.shape, dtype=f32 if out_f32 else bf, device=xp.device)
    scale = qk_scale if qk_scale is not None else (c // num_heads) ** -0.5
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    code = kernels.load().window_block_launch(
        x_b.data_ptr(), h_b.data_ptr(), w[0].data_ptr(), v[0].data_ptr(),
        w[1].data_ptr(), v[1].data_ptr(), _bias_table(v[6]).data_ptr(), v[2].data_ptr(),
        v[3].data_ptr(), w[2].data_ptr(), v[4].data_ptr(), w[3].data_ptr(),
        v[5].data_ptr(), attn_buf.data_ptr(), park.data_ptr() if park is not None else None,
        out.data_ptr(),
        b, hp, wp, c, num_heads, ws, shift, float(scale), int(out_f32), stream,
    )
    kernels.check(code, "window_block")
    window_block.launches += 1
    return out if out.dtype == xp.dtype else out.to(xp.dtype)


window_block.launches = 0
