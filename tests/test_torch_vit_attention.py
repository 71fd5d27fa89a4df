"""ViTDet's attention kernel (``ops/vit_attention.py``, ``csrc/vit_attention.cu``)
against its plain twin and the plain path of ``models/backbones.py ViTAttention``.

On the CPU: the wrapper runs ``vit_attention_plain``; the twin in f32 equals
the module's plain path in f32 (global and window form, an odd 5 × 7 grid,
n not a multiple of 64, one image, the bias on and off); a zeroed ``rel_w``
table or the transposed ``k // w``, ``k % w`` indexing breaks that
agreement; the module counts its calls and score bytes on the plain path.

On a card (``cuda`` marker, ``python -m pytest tests/test_torch_vit_attention.py
-m cuda``): the kernel against the f32 twin on the same bf16 q, k, v and
tables, at the cell's shapes (8 × 12 heads × 4,096 tokens on a 64 × 64 grid;
200 windows × 12 heads × 196 tokens on 14 × 14) with the relative-position
tables drawn at std 0.02 and at 1.0, and at the edge shapes; without the
tables (ViT-Adapter-B's blocks) at the same shapes and on zero-padded
windows of 70² through a qkv projection. The tolerance:
the kernel's largest and mean absolute error against f32 are no larger than
those of the port's bf16 plain path (``vit_attention_unfused``: bf16 bias,
scores, biased scores and P, the softmax in f32; on the CPU it equals the
module's plain path bit for bit) against f32 on the same inputs. Also the
launch count, the raises, ``ViTAttention`` on the card taking the kernel
and raising on what the kernel does not take, and a training forward under
autocast taking the plain path, with gradients. The file imports no JAX.
"""

import pytest
import torch

import nuhtc_tpu_torch.ops.vit_attention as va
from nuhtc_tpu_torch.models.backbones import ViTAttention
from nuhtc_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain
from nuhtc_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

HD = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _module(nh, h, w, rel, table_std=0.02, seed=0):
    torch.manual_seed(seed)
    attn = ViTAttention(nh * HD, nh, use_rel_pos=rel, input_size=(h, w)).eval()
    if rel:
        with torch.no_grad():
            attn.rel_pos_h.normal_(0.0, table_std)
            attn.rel_pos_w.normal_(0.0, table_std)
    return attn


def _twin_through(attn, x, twin=vit_attention_plain, zero_w=False):
    """The module's forward with its attention core replaced by ``twin``."""
    b, h, w, c = x.shape
    tables = (None, None)
    if attn.use_rel_pos:
        rel_w = torch.zeros_like(attn.rel_pos_w) if zero_w else attn.rel_pos_w
        tables = (attn.rel_pos_h, rel_w)
    out = twin(attn.qkv(x.reshape(b, h * w, c)), b, h, w, attn.num_heads, *tables, HD ** -0.5)
    return attn.proj(out).reshape(b, h, w, c)


CPU_CASES = [(2, 2, 8, 8, True), (3, 2, 14, 14, True), (1, 2, 5, 7, True), (2, 1, 9, 9, False)]
CPU_IDS = ["global-8x8", "window-14x14", "odd-5x7-b1", "9x9-no-relpos"]


@pytest.mark.parametrize("b,nh,h,w,rel", CPU_CASES, ids=CPU_IDS)
def test_plain_twin_equals_the_plain_path_in_f32(b, nh, h, w, rel):
    attn = _module(nh, h, w, rel, table_std=1.0)
    x = torch.randn(b, h, w, nh * HD)
    with torch.no_grad():
        want = attn(x)
        got = _twin_through(attn, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert want.abs().max() > 0.1  # not a comparison of zeros


@pytest.mark.parametrize("b,nh,h,w,rel", CPU_CASES[:3], ids=CPU_IDS[:3])
def test_wrapper_takes_the_twin_on_the_cpu(b, nh, h, w, rel):
    attn = _module(nh, h, w, rel)
    x = torch.randn(b, h, w, nh * HD)
    before = vit_attention.launches
    with torch.no_grad():
        got = _twin_through(attn, x, twin=vit_attention)
        want = _twin_through(attn, x)
    assert vit_attention.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("fault", ["bias_w_zero", "index_transposed"])
def test_a_broken_bias_breaks_the_agreement(fault, monkeypatch):
    """Square grid, so the transposed indexing (``k % w`` for the row,
    ``k // w`` for the column) runs; tables at std 0.02, the small values
    the benchmark's weights hold."""
    attn = _module(2, 6, 6, True, table_std=0.02)
    x = torch.randn(2, 6, 6, 2 * HD)
    if fault == "index_transposed":
        grid = va.key_grid
        monkeypatch.setattr(va, "key_grid", lambda h, w, device: grid(h, w, device)[::-1])
    with torch.no_grad():
        want = attn(x)
        got = _twin_through(attn, x, zero_w=fault == "bias_w_zero")
    assert (got - want).abs().max() > 1e-3


@pytest.mark.parametrize("b,nh,h,w,rel", CPU_CASES, ids=CPU_IDS)
def test_unfused_yardstick_is_the_modules_plain_path_in_bf16(b, nh, h, w, rel):
    """``vit_attention_unfused``, what the card tests hold the kernel's error
    to, rounds where the module's plain path does."""
    attn = _module(nh, h, w, rel, table_std=1.0).to(torch.bfloat16)
    x = torch.randn(b, h, w, nh * HD).bfloat16()
    with torch.no_grad():
        want = attn(x)
        got = _twin_through(attn, x, twin=va.vit_attention_unfused)
    assert torch.equal(got, want)


def test_cpu_module_counts_the_plain_path():
    attn = _module(2, 5, 7, True)
    x = torch.randn(1, 5, 7, 2 * HD)
    with profiling.spans(), torch.no_grad():
        attn(x)
        counters = dict(profiling.COUNTERS)
    assert counters["vit.attn_plain"] == 1 and "vit.attn_fused" not in counters
    assert counters["vit.global_score_bytes"] == 4 * 4 * 2 * 35 ** 2  # four f32 (1, 2, 35, 35)


# -- on the card --------------------------------------------------------------

def _inputs(device, b, nh, h, w, rel, table_std, seed=0):
    """bf16 qkv (b, n, 3·C) and relative-position tables (2h − 1, 64) and
    (2w − 1, 64), or None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, h * w, 3 * nh * HD, generator=gen, device=device).bfloat16()
    if not rel:
        return qkv, None, None
    return (qkv, *((torch.randn(2 * s - 1, HD, generator=gen, device=device) * table_std)
                   .bfloat16() for s in (h, w)))


def _errors(got, want):
    d = (got.float() - want).abs()
    return d.max().item(), d.mean().item()


def _held_to_bf16_plain(qkv, b, h, w, nh, rel_h, rel_w):
    scale = HD ** -0.5
    f32 = [None if t is None else t.float() for t in (rel_h, rel_w)]
    want = vit_attention_plain(qkv.float(), b, h, w, nh, *f32, scale)
    got = vit_attention(qkv, b, h, w, nh, rel_h, rel_w, scale)
    plain = va.vit_attention_unfused(qkv, b, h, w, nh, rel_h, rel_w, scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    k_max, k_mean = _errors(got, want)
    p_max, p_mean = _errors(plain, want)
    assert k_max <= p_max and k_mean <= p_mean, (k_max, p_max, k_mean, p_mean)
    assert want.abs().max() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("table_std", [0.02, 1.0])
@pytest.mark.parametrize("b,h,w", [(8, 64, 64), (200, 14, 14)], ids=["global-64x64", "windows-14x14"])
def test_kernel_at_the_cells_shapes(cuda, b, h, w, table_std):
    qkv, rel_h, rel_w = _inputs(cuda, b, 12, h, w, True, table_std)
    _held_to_bf16_plain(qkv, b, h, w, 12, rel_h, rel_w)


def _padded_window_qkv(device):
    """bf16 qkv of ViT-Adapter-B's windows at 1024²: eight 64² maps, 768
    wide, zero-padded to 70² and cut into 200 windows of 14², through a qkv
    projection with a bias (the padded tokens' q, k and v are the bias)."""
    from nuhtc_tpu_torch.models.backbones import vit_window_partition

    attn = _module(12, 14, 14, False, seed=2).to(device)
    with torch.no_grad():
        attn.qkv.bias.normal_(0.0, 0.5)
        gen = torch.Generator(device=device).manual_seed(2)
        x = torch.randn(8, 64, 64, 12 * HD, generator=gen, device=device)
        wins, pad_hw = vit_window_partition(x, 14)
        assert pad_hw == (70, 70) and wins.shape[0] == 200
        return attn.qkv(wins.reshape(200, 196, 12 * HD)).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["global-64x64", "windows-14x14", "padded-windows-70x70"])
def test_kernel_without_tables_at_the_adapter_cells_shapes(cuda, case):
    """ViT-Adapter-B's blocks have no relative-position tables: the kernel's
    path without them, at 8 × 12 heads × 4,096 tokens (global), 200 windows
    × 12 heads × 196 tokens, and on the padded windows the model makes,
    where many keys and values equal the qkv bias: there the bf16 rounding
    of their equal weights adds up, and the kernel divides by the sum of
    the rounded weights so that it cancels."""
    if case == "padded-windows-70x70":
        b, h, w, qkv = 200, 14, 14, _padded_window_qkv(cuda)
    else:
        b, h, w = (8, 64, 64) if case == "global-64x64" else (200, 14, 14)
        qkv = _inputs(cuda, b, 12, h, w, False, 0.0)[0]
    _held_to_bf16_plain(qkv, b, h, w, 12, None, None)


EDGE = [(1, 2, 5, 7, True), (2, 3, 9, 9, True), (1, 2, 3, 64, True), (2, 2, 10, 10, False),
        (1, 1, 1, 1, True), (3, 2, 13, 11, True), (1, 2, 64, 63, True), (1, 2, 64, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("table_std", [0.02, 1.0])
@pytest.mark.parametrize("b,nh,h,w,rel", EDGE,
                         ids=["odd-5x7-b1", "9x9", "3x64-rows", "no-relpos", "one-token", "13x11",
                              "64x63", "64x64-b1"])
def test_kernel_at_edge_shapes(cuda, b, nh, h, w, rel, table_std):
    qkv, rel_h, rel_w = _inputs(cuda, b, nh, h, w, rel, table_std, seed=1)
    _held_to_bf16_plain(qkv, b, h, w, nh, rel_h, rel_w)


@pytest.mark.cuda
def test_launch_count_and_module_dispatch(cuda):
    attn = _module(12, 14, 14, True).to(cuda, torch.bfloat16)
    x = torch.randn(4, 14, 14, 12 * HD, device=cuda).bfloat16()
    before = vit_attention.launches
    with profiling.spans(), torch.no_grad():
        got = attn(x)
        counters = dict(profiling.COUNTERS)
    want = _twin_through(attn.float(), x.float())
    torch.cuda.synchronize()
    assert vit_attention.launches == before + 1
    assert counters == {"vit.attn_fused": 1, "vit.global_score_bytes": 0}
    assert ((got.float() - want).abs().max() / want.abs().max()).item() < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["grid_65", "float32"])
def test_module_on_the_card_raises_on_what_the_kernel_does_not_take(cuda, fault):
    """No plain path on the card for an input the kernel cannot take."""
    side, dtype = (65, torch.bfloat16) if fault == "grid_65" else (8, torch.float32)
    attn = _module(1, side, side, True).to(cuda, dtype)
    x = torch.randn(1, side, side, HD, device=cuda, dtype=dtype)
    before = vit_attention.launches
    with profiling.spans(), torch.no_grad(), pytest.raises(ValueError, match="vit_attention"):
        attn(x)
    assert vit_attention.launches == before


@pytest.mark.cuda
def test_training_forward_on_the_card_has_gradients(cuda):
    """A bf16 training-mode forward under autocast, as ``tools/train.py``
    runs one: the kernel has no backward, so the attention takes the plain
    path, and every parameter gets the gradient the CPU's f32 forward
    gives it (bf16 against f32: within 5 % by norm)."""
    attn = _module(12, 14, 14, True).train()
    x = torch.randn(2, 14, 14, 12 * HD)
    attn(x).square().mean().backward()
    want = {name: p.grad.clone() for name, p in attn.named_parameters()}
    attn.zero_grad()
    attn = attn.to(cuda)
    before = vit_attention.launches
    with profiling.spans(), torch.autocast("cuda", dtype=torch.bfloat16):
        out = attn(x.to(cuda))
        counters = dict(profiling.COUNTERS)
    assert out.dtype == torch.bfloat16
    out.float().square().mean().backward()
    assert vit_attention.launches == before and counters["vit.attn_plain"] == 1
    for name, p in attn.named_parameters():
        g, w = p.grad.float().cpu(), want[name]
        assert w.norm() > 0, name
        assert ((g - w).norm() / w.norm()).item() < 0.05, name


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["float32", "float16", "strides", "head_dim_32", "table_f32",
                                   "grid_65", "requires_grad"])
def test_kernel_raises_on_what_it_does_not_take(cuda, fault):
    b, nh, h, w = 2, 2, 8, 8
    if fault == "grid_65":
        h = w = 65
    qkv, rel_h, rel_w = _inputs(cuda, b, nh, h, w, True, 0.02)
    if fault in ("float32", "float16"):
        qkv = qkv.to(getattr(torch, fault))
    elif fault == "strides":
        qkv = qkv.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "head_dim_32":
        nh = 4
    elif fault == "table_f32":
        rel_h = rel_h.float()
    elif fault == "requires_grad":
        rel_w.requires_grad_(True)
    before = vit_attention.launches
    with pytest.raises(ValueError, match="vit_attention"):
        vit_attention(qkv, b, h, w, nh, rel_h, rel_w, 0.125)
    assert vit_attention.launches == before
