"""Hand kernels of the PyTorch port against their plain PyTorch versions.

These need an NVIDIA GPU (the CUDA kernels have no CPU mode), carry the
``cuda`` marker and skip without one. The file imports no JAX at module
level, so the marked tests also run on a GPU host that has none:
``python -m pytest tests/test_torch_kernels.py -m cuda``.
The CPU wrappers' dispatch to the plain versions is checked here too, and
K2's plain twin ``window_attention_plain`` is held against the Pallas kernel
``window_attention_fused`` in interpret mode (these cases import JAX inside
the test) at the small shapes of test_fused_attention.py, atol 0.06.
K4's backward (``roi_align_sum_backward``, the ``grad_fn`` of
``roi_align_sum`` on CUDA tensors) is held against autograd through the
plain version: f32 within 1e-4 of each map's gradient scale, bf16 within
2^-7 of the f32 plain gradients' scale. The Mask R-CNN's extractor
(``multilevel_roi_features``: one K4 launch per pyramid level, masked by
each RoI's level) is held the same way at out 7 and 14 over four levels,
forward and backward.
"""

import numpy as np
import pytest
import torch

from nuhtc_tpu_torch.models.roi_extractor import multilevel_roi_features, roi_levels
from nuhtc_tpu_torch.ops import components as tc
from nuhtc_tpu_torch.ops.roi_align import (
    roi_align_sum_backward, roi_align_sum_backward_plain,
    roi_align, roi_align_plain, roi_align_sum, roi_align_sum_plain,
)
from nuhtc_tpu_torch.ops.window_block import (
    BlockParams, bias_fragments, window_attention, window_attention_plain, window_block, window_block_plain,
)
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

_NAMES = ("wqkv", "bqkv", "wproj", "bproj", "bias49", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block_args(device, c=96, nh=3, side=21, seed=0, batch=2):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=device) * std

    x = rnd(batch, side, side, c, std=0.5).bfloat16()
    return (x, torch.nn.functional.layer_norm(x.float(), (c,)).bfloat16(),
            rnd(3 * c, c, std=c ** -0.5), rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5),
            rnd(c, std=0.02), rnd(nh, 49, 49, std=0.02), 1.0 + rnd(c, std=0.1),
            rnd(c, std=0.02), rnd(4 * c, c, std=c ** -0.5), rnd(4 * c, std=0.02),
            rnd(c, 4 * c, std=0.5 * (4 * c) ** -0.5), rnd(c, std=0.02))


def _labels(device, b=3, size=96, blobs=30, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((b, size, size), bool)
    for i in range(b):
        for _ in range(blobs):
            cy, cx = rng.randint(0, size, 2)
            mask[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.randint(2, 9) ** 2
    mask = torch.from_numpy(mask).to(device)
    lab = tc.label_components_raw(mask)
    roots, _ = tc.first_roots(lab, mask, 512)
    return lab, roots


def _attn_args(args):
    """K2's arguments out of K1's: h1p, wqkv, bqkv, wproj, bproj, bias49."""
    return args[1:7]


def _roi_case(device, dtype, b=2, h=40, w=32, c=64, r=96, seed=0):
    """A map and boxes in image coordinates (stride 4) that include tiny,
    large, border-crossing, zero-size and far-outside boxes."""
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(device, dtype)
    xy = rng.uniform(-20, 4 * w - 8, (b, r, 2))
    wh = rng.uniform(2, 60, (b, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, 0] = [-30, -30, 4 * w + 30, 4 * h + 30]  # larger than the map
    rois[:, 1] = [10, 12, 10, 12]  # zero size
    rois[:, 2] = [5.2, 7.9, 5.9, 8.3]  # below one cell
    rois[:, 3] = [4 * w - 6, 4 * h - 6, 4 * w + 40, 4 * h + 40]  # crosses the far border
    rois[:, 4] = [-80, -80, -60, -60]  # wholly outside
    rois[:, 5] = [0, 0, 4 * w, 4 * h]  # the whole map
    return feat, torch.from_numpy(rois).to(device)


ROI_MODES = [dict(output_size=7, sampling_ratio=2), dict(output_size=14, sampling_ratio=0),
             dict(output_size=7, sampling_ratio=0, pool_from=14)]


def test_cpu_wrappers_take_the_plain_versions():
    args = _block_args("cpu")
    kw = dict(ws=7, num_heads=3, shift=3)
    before = window_block.launches, window_attention.launches, roi_align.launches
    assert torch.equal(window_block(*args, **kw), window_block_plain(*args, **kw))
    assert torch.equal(window_attention(*_attn_args(args), **kw),
                       window_attention_plain(*_attn_args(args), **kw))
    feat, rois = _roi_case("cpu", torch.float32, c=8, r=12)
    for mode in ROI_MODES:
        assert torch.equal(roi_align(feat, rois, 0.25, **mode),
                           roi_align_plain(feat, rois, 0.25, **mode))
    assert (window_block.launches, window_attention.launches, roi_align.launches) == before
    lab, roots = _labels("cpu")
    boxes, areas = tc.component_stats(lab, roots)
    pb, pa = tc.component_stats_plain(lab, roots)
    assert torch.equal(boxes, pb) and torch.equal(areas, pa)


def test_block_plain_is_attention_plain_plus_mlp():
    """K1's twin is K2's twin plus residual, LN2 and the tanh-gelu MLP."""
    args = [a.float() for a in _block_args("cpu")]
    kw = dict(ws=7, num_heads=3, shift=3)
    xp, g2, b2, wfc1, bfc1, wfc2, bfc2 = args[0], *args[7:]
    bf = lambda v: v.bfloat16().float()  # noqa: E731
    x2 = bf(xp) + window_attention_plain(*_attn_args(args), **kw)
    h2 = torch.nn.functional.layer_norm(x2, (96,), g2, b2, eps=1e-5)
    u = torch.nn.functional.gelu(bf(h2) @ bf(wfc1).T + bfc1, approximate="tanh")
    want = x2 + (bf(u) @ bf(wfc2).T + bfc2)
    got = window_block_plain(*args, **kw)
    assert (got - want).abs().max().item() <= 1e-5


def test_block_params_hold_kernel_ready_tensors_and_give_the_same_result():
    """The pack holds bf16 weights, f32 vectors and bias49 of the right
    shapes, and the wrappers give bit-equal results with it on the CPU."""
    args = _block_args("cpu")
    c, nh = 96, 3
    pack = BlockParams(**dict(zip(_NAMES, args[2:])))
    shapes = dict(wqkv=(3 * c, c), wproj=(c, c), wfc1=(4 * c, c), wfc2=(c, 4 * c), bqkv=(3 * c,),
                  bproj=(c,), bias49=(nh, 49, 49), g2=(c,), b2=(c,), bfc1=(4 * c,), bfc2=(c,))
    for name, shape in shapes.items():
        t = getattr(pack, name)
        want = torch.bfloat16 if name.startswith("w") else torch.float32
        assert t.dtype == want and tuple(t.shape) == shape and t.is_contiguous(), name
        assert t.data_ptr() % 32 == 0 and not t.requires_grad, name
    kw = dict(ws=7, num_heads=nh, shift=3)
    assert torch.equal(window_block(*args[:2], *pack.block(), **kw), window_block(*args, **kw))
    assert torch.equal(window_attention(args[1], *pack.attention(), **kw),
                       window_attention(*_attn_args(args), **kw))
    # a pack's tensors pass through a second pack untouched: nothing is converted twice
    again = BlockParams(**dict(zip(_NAMES, pack.block())))
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(again.block(), pack.block()))


def test_block_params_attention_only_and_bad_names():
    args = _block_args("cpu")
    pack = BlockParams(**dict(zip(_NAMES[:5], args[2:7])))
    assert len(pack.attention()) == 5 and not pack.has_mlp
    with pytest.raises(ValueError):
        pack.block()
    with pytest.raises(ValueError):
        BlockParams(wqkv=args[2])
    with pytest.raises(ValueError):
        BlockParams(**dict(zip(_NAMES[:5], args[2:7])), gamma=args[7])


@pytest.mark.parametrize("nh,ws", [(3, 7), (2, 8), (1, 4)])
def test_bias_fragments_hold_both_roundings_in_register_order(nh, ws):
    """Entry [h, j, t, 2i + e] is the score at row 16(t//32) + (t%32)//4 + 8i,
    column 8j + 2(t%4) + e: low half bf16(bias), high half bf16(bias - 100);
    padded columns -3e38, padded rows 0."""
    n = ws * ws
    bias = torch.from_numpy(np.random.RandomState(nh).randn(nh, n, n).astype(np.float32))
    frag = bias_fragments(bias)
    assert frag.shape == (nh, 8, 128, 4) and frag.dtype == torch.int32 and frag.is_contiguous()

    def f32(half):  # bf16 bits in the low 16 of an int32 -> float
        return (half << 16).view(torch.float32)

    lo, hi = f32(frag & 0xFFFF), f32((frag >> 16) & 0xFFFF)
    rng = np.random.RandomState(0)
    seen_pad = False
    for _ in range(400):
        h, j, t, k = rng.randint(nh), rng.randint(8), rng.randint(128), rng.randint(4)
        row = 16 * (t // 32) + (t % 32) // 4 + 8 * (k // 2)
        col = 8 * j + 2 * (t % 4) + k % 2
        got = lo[h, j, t, k].item(), hi[h, j, t, k].item()
        if col >= n:
            assert got[0] < -2.9e38 and got[1] < -2.9e38
            seen_pad = True
        elif row >= n:
            assert got == (0.0, -100.0)
        else:
            b = bias[h, row, col]
            assert got == (b.bfloat16().float().item(), (b - 100.0).bfloat16().float().item())
    assert seen_pad or n == 64
    with pytest.raises(ValueError):
        bias_fragments(torch.zeros(1, 81, 81))


def _swin_block(dim=96, heads=3, shift=True, seed=0):
    from nuhtc_tpu_torch.models.swin import SwinBlock

    torch.manual_seed(seed)
    blk = SwinBlock(dim, heads, 7, shift=shift).eval()
    with torch.no_grad():
        blk.attn.w_msa.relative_position_bias_table.normal_(std=0.2)
    return blk


def test_swin_block_pack_matches_its_parameters():
    blk = _swin_block()
    msa = blk.attn.w_msa
    pack = blk.kernel_params()
    assert blk.kernel_params() is pack  # made once
    assert torch.equal(pack.wqkv, msa.qkv.weight.detach().bfloat16())
    assert torch.equal(pack.wfc2, blk.ffn.fc2.weight.detach().bfloat16())
    assert torch.equal(pack.bias49, msa.bias49().detach().float())
    assert pack.bias49.shape == (3, 49, 49) and pack.g2.dtype == torch.float32
    # the pack feeds the wrappers what the parameters themselves would
    x = torch.randn(1, 14, 14, 96, generator=torch.Generator().manual_seed(1)).bfloat16()
    h1 = torch.nn.functional.layer_norm(x.float(), (96,)).bfloat16()
    kw = dict(ws=7, num_heads=3, shift=3)
    with torch.no_grad():
        direct = window_block(x, h1, msa.qkv.weight, msa.qkv.bias, msa.proj.weight, msa.proj.bias,
                              msa.bias49(), blk.norm2.weight, blk.norm2.bias, blk.ffn.fc1.weight,
                              blk.ffn.fc1.bias, blk.ffn.fc2.weight, blk.ffn.fc2.bias, **kw)
    assert torch.equal(window_block(x, h1, *pack.block(), **kw), direct)


@pytest.mark.parametrize("how", ["in_place", "bias_table", "load_state_dict", "replaced", "cast"])
def test_swin_block_pack_is_rebuilt_when_a_parameter_changes(how):
    blk = _swin_block()
    msa = blk.attn.w_msa
    old = blk.kernel_params()
    with torch.no_grad():
        if how == "in_place":
            blk.ffn.fc1.weight.mul_(2.0)
        elif how == "bias_table":
            msa.relative_position_bias_table.add_(1.0)
        elif how == "load_state_dict":
            blk.load_state_dict(_swin_block(seed=5).state_dict())
        elif how == "replaced":
            msa.proj.weight = torch.nn.Parameter(msa.proj.weight * 3.0)
        else:
            blk.double()
    new = blk.kernel_params()
    assert new is not old and blk.kernel_params() is new
    assert torch.equal(new.wfc1, blk.ffn.fc1.weight.detach().bfloat16())
    assert torch.equal(new.wproj, msa.proj.weight.detach().bfloat16())
    assert torch.equal(new.bias49, msa.bias49().detach().float())
    changed = dict(in_place="wfc1", bias_table="bias49", load_state_dict="wqkv", replaced="wproj")
    if how in changed:
        assert not torch.equal(getattr(new, changed[how]), getattr(old, changed[how]))


def test_swin_block_without_qkv_bias_packs_zeros():
    from nuhtc_tpu_torch.models.swin import SwinBlock

    blk = SwinBlock(96, 3, 7, shift=False, qkv_bias=False).eval()
    pack = blk.kernel_params()
    assert pack.bqkv.shape == (288,) and not pack.bqkv.any()
    assert blk.kernel_params() is pack


def _pallas_attention_case(ws, c, nh, hw, shift, seed):
    """window_attention_fused (interpret) and the twin on the same inputs."""
    import jax
    import jax.numpy as jnp
    from nuhtc_tpu.models.swin import WindowAttention, _rel_position_index, window_partition
    from nuhtc_tpu.ops.window_attention_pallas import window_attention_fused

    rng = np.random.RandomState(seed)
    x = rng.randn(1, hw[0], hw[1], c).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wa = WindowAttention(dim=c, num_heads=nh, window_size=ws, dtype=jnp.bfloat16)
    prm = wa.init(jax.random.PRNGKey(0), window_partition(xj, ws))["params"]
    # a learned-looking bias table and biases, so that they are exercised
    table = rng.randn(*prm["relative_position_bias_table"].shape).astype(np.float32) * 0.5
    bqkv = rng.randn(3 * c).astype(np.float32) * 0.1
    bproj = rng.randn(c).astype(np.float32) * 0.1
    idx = _rel_position_index(ws)
    bias49 = table[idx.reshape(-1)].reshape(ws * ws, ws * ws, nh).transpose(2, 0, 1)
    wqkv, wproj = np.asarray(prm["qkv"]["kernel"]), np.asarray(prm["proj"]["kernel"])
    want = window_attention_fused(xj, jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wproj),
                                  jnp.asarray(bproj), jnp.asarray(bias49), ws=ws, num_heads=nh,
                                  shift=shift, interpret=True)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = window_attention_plain(tt(x).bfloat16(), tt(wqkv.T), tt(bqkv), tt(wproj.T), tt(bproj),
                                 tt(bias49), ws=ws, num_heads=nh, shift=shift)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("ws,c,nh,hw,shift", [(7, 32, 1, (7, 7), 0), (4, 16, 2, (8, 8), 0),
                                              (4, 16, 2, (8, 8), 2)])
def test_attention_twin_matches_pallas_interpret(ws, c, nh, hw, shift):
    got, want = _pallas_attention_case(ws, c, nh, hw, shift, seed=3)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.06)
    assert np.abs(want).max() > 0.3  # not a comparison of zeros


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("c,nh", [(96, 3), (768, 24)])
def test_window_block_kernel_matches_twin(cuda, shift, c, nh):
    args = _block_args(cuda, c=c, nh=nh)
    kw = dict(ws=7, num_heads=nh, shift=shift)
    before = window_block.launches
    got = window_block(*args, **kw)
    want = window_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert window_block.launches == before + 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 0.05


@pytest.mark.cuda
def test_window_block_kernel_f32_output(cuda):
    args = list(_block_args(cuda))
    args[0] = args[0].float()
    got = window_block(*args, ws=7, num_heads=3, shift=0)
    want = window_block_plain(*args, ws=7, num_heads=3, shift=0)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 0.01


WIDTHS = [(96, 3), (192, 6), (384, 12), (768, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,side", [(1, 7), (3, 21)], ids=["1window", "27windows"])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("c,nh", WIDTHS)
def test_window_kernels_at_tile_edges(cuda, c, nh, shift, batch, side):
    """Token counts that are no multiple of the 64-row tile (49 and 1323) and
    window counts (1 and 27) that are no multiple of the windows per block,
    at every width; K1 and K2, bf16 and f32 output."""
    args = _block_args(cuda, c=c, nh=nh, side=side, batch=batch, seed=c + side)
    kw = dict(ws=7, num_heads=nh, shift=shift)
    got, want = window_block(*args, **kw), window_block_plain(*args, **kw)
    got2 = window_attention(*_attn_args(args), **kw)
    want2 = window_attention_plain(*_attn_args(args), **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 0.05
    assert (got2.float() - want2.float()).abs().max().item() <= 0.05
    assert want2.float().abs().max().item() > 0.1  # not a comparison of zeros
    args32 = (args[0].float(), args[1].float()) + tuple(args[2:])
    got32 = window_block(*args32, **kw)
    assert got32.dtype == torch.float32
    assert (got32 - window_block_plain(*args32, **kw)).abs().max().item() <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("c,nh", [(96, 3), (384, 12)])
def test_window_kernels_take_a_qk_scale_and_a_pack(cuda, c, nh):
    args = _block_args(cuda, c=c, nh=nh, side=14, seed=7)
    kw = dict(ws=7, num_heads=nh, shift=3, qk_scale=0.4)
    want = window_block_plain(*args, **kw)
    default = window_block_plain(*args, ws=7, num_heads=nh, shift=3)
    assert (want.float() - default.float()).abs().max().item() > 0.05  # the scale matters
    pack = BlockParams(**dict(zip(_NAMES, args[2:])))
    for params in (args[2:], pack.block()):
        got = window_block(*args[:2], *params, **kw)
        assert (got.float() - want.float()).abs().max().item() <= 0.05
    got2 = window_attention(args[1], *pack.attention(), **kw)
    want2 = window_attention_plain(*_attn_args(args), **kw)
    assert (got2.float() - want2.float()).abs().max().item() <= 0.05


@pytest.mark.cuda
def test_window_kernels_raise_on_what_they_do_not_take(cuda):
    args = list(_block_args(cuda, side=14))
    kw = dict(ws=7, num_heads=3, shift=0)
    before = window_block.launches, window_attention.launches
    with pytest.raises(ValueError):  # head dim 48, not 32
        window_block(*args, ws=7, num_heads=2, shift=0)
    with pytest.raises(ValueError):
        window_attention(*_attn_args(args), ws=7, num_heads=2, shift=0)
    with pytest.raises(ValueError):  # mlp_ratio 2
        window_block(*args[:9], args[9][:192], args[10][:192], args[11][:, :192], args[12], **kw)
    with pytest.raises(ValueError):  # a map that is no multiple of ws
        window_block(args[0][:, :13], args[1][:, :13], *args[2:], **kw)
    with pytest.raises(ValueError):
        window_attention(args[1][:, :, :13], *args[2:7], **kw)
    with pytest.raises(ValueError):  # tensors on two devices
        window_block(*args[:2], args[2].cpu(), *args[3:], **kw)
    with pytest.raises(ValueError):
        window_attention(args[1], *args[2:6], args[6].cpu(), **kw)
    assert (window_block.launches, window_attention.launches) == before


@pytest.mark.cuda
def test_component_stats_kernel_matches_plain(cuda):
    lab, roots = _labels(cuda)
    roots = roots.clone()
    roots[:, -1] = roots[:, 0]  # a duplicate id
    before = tc.component_stats.launches
    boxes, areas = tc.component_stats(lab, roots)
    pb, pa = tc.component_stats_plain(lab, roots)
    torch.cuda.synchronize()
    assert tc.component_stats.launches == before + 1
    assert torch.equal(boxes, pb) and torch.equal(areas, pa)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("c,nh", [(96, 3), (768, 24)])
def test_window_attention_kernel_matches_twin(cuda, shift, c, nh):
    args = _attn_args(_block_args(cuda, c=c, nh=nh))
    kw = dict(ws=7, num_heads=nh, shift=shift)
    before = window_attention.launches
    got = window_attention(*args, **kw)
    want = window_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 0.05
    # f32 map in, f32 out
    args32 = (args[0].float(),) + tuple(args[1:])
    got32 = window_attention(*args32, **kw)
    assert got32.dtype == torch.float32
    assert (got32 - window_attention_plain(*args32, **kw)).abs().max().item() <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ROI_MODES, ids=["sr2", "adaptive", "pool14"])
@pytest.mark.parametrize("c", [64, 20, 3])
def test_roi_align_kernel_matches_plain(cuda, mode, c):
    """f32: 1e-4 (another order of f32 sums). bf16: against the plain version
    on the f32 copy of the map, one bf16 rounding of the output (2^-7 of the
    map's largest magnitude). c = 20 and 3 take the narrower loads."""
    feat, rois = _roi_case(cuda, torch.float32, c=c)
    before = roi_align.launches
    got = roi_align(feat, rois, 0.25, **mode)
    want = roi_align_plain(feat, rois, 0.25, **mode)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4
    assert want.abs().max().item() > 0.5
    got16 = roi_align(feat.bfloat16(), rois, 0.25, **mode)
    want16 = roi_align_plain(feat.bfloat16().float(), rois, 0.25, **mode)
    assert got16.dtype == torch.bfloat16
    tol = 2.0 ** -7 * feat.abs().max().item()
    assert (got16.float() - want16).abs().max().item() <= tol


@pytest.mark.cuda
def test_roi_align_kernel_raises_on_bad_input(cuda):
    feat, rois = _roi_case(cuda, torch.float32)
    with pytest.raises(ValueError):
        roi_align(feat.half(), rois, 0.25, 7, sampling_ratio=2)
    with pytest.raises(ValueError):
        roi_align(feat, rois.cpu(), 0.25, 7, sampling_ratio=2)
    with pytest.raises(ValueError):
        roi_align(feat, rois, 0.25, 7, pool_from=10)


# the two stage shapes of the detector: (out, sampling ratio of the levels, semantic pool_from)
STAGE_SHAPES = [(7, 2, 14), (14, 0, None)]


def _stage_case(device, dtype, c, seed=0):
    """Two levels (strides 4 and 8) and a semantic map (stride 4) of
    different sides, the boxes of ``_roi_case`` and a per-RoI bias."""
    p2, rois = _roi_case(device, dtype, c=c, seed=seed)
    rng = np.random.RandomState(seed + 100)
    b, r = rois.shape[:2]
    p3 = torch.from_numpy(rng.randn(b, 20, 16, c).astype(np.float32)).to(device, dtype)
    sem = torch.from_numpy(rng.randn(b, 40, 32, c).astype(np.float32)).to(device, dtype)
    bias = torch.from_numpy(rng.randn(b, r, c).astype(np.float32)).to(device)
    return [p2, p3, sem], rois, bias


def _stage_args(out, ratio, pool_from):
    return ([0.25, 0.125, 0.25], out, [ratio, ratio, 0], [None, None, pool_from])


@pytest.mark.cuda
@pytest.mark.parametrize("out,ratio,pool_from", STAGE_SHAPES, ids=["bbox", "mask"])
@pytest.mark.parametrize("c", [64, 20, 3])
def test_roi_align_sum_kernel_matches_plain(cuda, out, ratio, pool_from, c):
    """The fused stage call, one launch. f32: 1e-4 (another order of f32
    sums). bf16: against the plain version on the f32 copies, one bf16
    rounding of the sum (2^-7 of the summed largest magnitudes); the kernel
    rounds once. c = 20 takes one channel per thread in bf16, c = 3 in both."""
    maps, rois, bias = _stage_case(cuda, torch.float32, c)
    scales, out, ratios, pools = _stage_args(out, ratio, pool_from)
    before = roi_align.launches
    got = roi_align_sum(maps, rois, scales, out, ratios, pools, bias=bias)
    want = roi_align_sum_plain(maps, rois, scales, out, ratios, pools, bias=bias)
    torch.cuda.synchronize()
    assert roi_align.launches == before + 1
    assert got.shape == want.shape == (2, 96, out, out, c) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4
    assert want.abs().max().item() > 0.5
    maps16 = [m.bfloat16() for m in maps]
    got16 = roi_align_sum(maps16, rois, scales, out, ratios, pools, bias=bias)
    want16 = roi_align_sum_plain([m.float() for m in maps16], rois, scales, out, ratios, pools,
                                 bias=bias)
    assert got16.dtype == torch.bfloat16
    tol = 2.0 ** -7 * (sum(m.abs().max().item() for m in maps) + bias.abs().max().item())
    assert (got16.float() - want16).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n_maps,with_bias", [(1, True), (2, False), (3, False)])
def test_roi_align_sum_kernel_fewer_maps_and_no_bias(cuda, n_maps, with_bias):
    maps, rois, bias = _stage_case(cuda, torch.float32, 64, seed=3)
    scales, out, ratios, pools = _stage_args(7, 2, 14)
    keep = [2, 0, 1][:n_maps]  # the semantic map (pool_from 14) first
    args = ([maps[i] for i in keep], rois, [scales[i] for i in keep], out,
            [ratios[i] for i in keep], [pools[i] for i in keep])
    b = bias if with_bias else None
    got = roi_align_sum(*args, bias=b)
    want = roi_align_sum_plain(*args, bias=b)
    assert (got - want).abs().max().item() <= 1e-4
    # boxes wholly outside every map keep the bias alone
    outside = got[:, 4]
    expect = bias[:, 4, None, None, :].expand_as(outside) if with_bias else torch.zeros_like(outside)
    assert torch.equal(outside, expect)
    empty = roi_align_sum(args[0], rois[:, :0], *args[2:], bias=None)
    assert tuple(empty.shape) == (2, 0, 7, 7, 64)


@pytest.mark.cuda
def test_roi_align_sum_kernel_large_grids_and_odd_sizes(cuda):
    """max_grid 16 on a pool_from of three times the output (96 samples a bin
    and axis on the largest box), an output size that is no multiple of
    anything, one image."""
    maps, rois, bias = _stage_case(cuda, torch.float32, 8, seed=5)
    maps, rois, bias = [m[:1] for m in maps], rois[:1], bias[:1]
    args = (maps, rois, [0.25, 0.125, 0.25], 5, [3, 0, 0], [None, None, 15])
    got = roi_align_sum(*args, bias=bias, max_grid=16)
    want = roi_align_sum_plain(*args, bias=bias, max_grid=16)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_roi_align_sum_kernel_raises_on_what_it_does_not_take(cuda):
    maps, rois, bias = _stage_case(cuda, torch.float32, 64)
    scales, out, ratios, pools = _stage_args(7, 2, 14)
    before = roi_align.launches
    with pytest.raises(ValueError):  # four maps
        roi_align_sum(maps + maps[:1], rois, scales + [0.25], out, ratios + [0], pools + [None])
    with pytest.raises(ValueError):  # mixed types
        roi_align_sum([maps[0].bfloat16()] + maps[1:], rois, scales, out, ratios, pools)
    with pytest.raises(ValueError):  # mixed devices
        roi_align_sum([maps[0].cpu()] + maps[1:], rois, scales, out, ratios, pools)
    with pytest.raises(ValueError):  # channel counts differ
        roi_align_sum([maps[0][..., :32]] + maps[1:], rois, scales, out, ratios, pools)
    with pytest.raises(ValueError):  # pool_from no multiple of the output
        roi_align_sum(maps, rois, scales, out, ratios, [None, None, 10])
    with pytest.raises(ValueError):  # pool_from with a sampling ratio
        roi_align_sum(maps, rois, scales, out, [2, 2, 2], pools)
    with pytest.raises(ValueError):  # bias of another shape
        roi_align_sum(maps, rois, scales, out, ratios, pools, bias=bias[:, :-1])
    with pytest.raises(ValueError):  # a list too short
        roi_align_sum(maps, rois, scales[:2], out, ratios, pools)
    with pytest.raises(ValueError):  # f16 maps
        roi_align_sum([m.half() for m in maps], rois, scales, out, ratios, pools)
    assert roi_align.launches == before


def _check_component_stats(lab, roots, launches=1):
    before = tc.component_stats.launches
    boxes, areas = tc.component_stats(lab, roots)
    pb, pa = tc.component_stats_plain(lab, roots)
    torch.cuda.synchronize()
    assert tc.component_stats.launches == before + launches
    assert torch.equal(boxes, pb) and torch.equal(areas, pa)
    return boxes, areas


@pytest.mark.cuda
def test_component_stats_kernel_duplicate_unsorted_and_out_of_range_ids(cuda):
    lab, roots = _labels(cuda)
    hw = lab.shape[1] * lab.shape[2]
    roots = roots.clone()
    roots[:, 7] = roots[:, 2]  # duplicates, of a component and (the padding) of the background
    roots[:, 300] = roots[:, 2]
    roots[:, 3] = -5  # out of range: no pixel
    roots[:, 4] = hw + 1
    roots[:, 5] = 2 ** 31 - 1
    roots = roots.flip(1).contiguous()  # descending, padding first
    boxes, areas = _check_component_stats(lab, roots)
    k = roots.shape[1]
    assert torch.equal(areas[:, k - 1 - 7], areas[:, k - 1 - 2]) and int(areas[0, k - 1 - 2]) > 0
    assert int(areas[:, k - 1 - 3].abs().sum() + areas[:, k - 1 - 4].abs().sum()) == 0
    assert float(boxes[0, k - 1 - 5, 0]) == 1e9
    # the padding id collects the background
    assert int(areas[0, 0]) == int((lab[0] == hw).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("size,k", [(96, 1), (90, 40), (33, 700)], ids=["k1", "w90", "w33"])
def test_component_stats_kernel_other_sizes(cuda, size, k):
    """Widths that forbid 16-byte loads, one id, more ids than components."""
    rng = np.random.RandomState(size)
    mask = torch.from_numpy(rng.rand(3, size, size) < 0.45).to(cuda)
    lab = tc.label_components_raw(mask)
    roots, _ = tc.first_roots(lab, mask, k)
    _check_component_stats(lab, roots)


@pytest.mark.cuda
def test_component_stats_kernel_all_background_and_no_background(cuda):
    hw = 64 * 64
    lab = torch.full((2, 64, 64), hw, dtype=torch.int32, device=cuda)
    lab[1] = 0  # one component fills the second image
    roots = torch.full((2, 16), hw, dtype=torch.int32, device=cuda)
    roots[:, 0] = 0
    boxes, areas = _check_component_stats(lab, roots)
    assert areas[:, :2].tolist() == [[0, hw], [hw, 0]]
    assert boxes[0, 1].tolist() == [0.0, 0.0, 64.0, 64.0] and boxes[0, 0, 0].item() == 1e9


@pytest.mark.cuda
def test_component_stats_kernel_many_ids(cuda):
    """K = 8192 is more than a launch serves: the ids go in two launches, and
    an id listed in both gets the same numbers from each."""
    rng = np.random.RandomState(1)
    mask = torch.from_numpy(rng.rand(2, 128, 128) < 0.4).to(cuda)
    lab = tc.label_components_raw(mask)
    roots, valid = tc.first_roots(lab, mask, 8192)
    assert int(valid.sum(1).min()) > 512
    roots = roots.clone()
    roots[:, -1] = roots[:, 0]
    roots[:, -2] = -1
    boxes, areas = _check_component_stats(lab, roots, launches=2)
    assert torch.equal(boxes[:, -1], boxes[:, 0]) and torch.equal(areas[:, -1], areas[:, 0])
    _check_component_stats(lab, roots[:, :4096].contiguous())


def _backward_case(device, dtype, c, out, ratio, pool_from, seed=0):
    """The stage case with maps and bias that require grad, and an upstream
    gradient (B, R, out, out, C)."""
    maps, rois, bias = _stage_case(device, torch.float32, c, seed=seed)
    maps = [m.to(dtype).requires_grad_(True) for m in maps]
    bias = bias.requires_grad_(True)
    rng = np.random.RandomState(seed + 7)
    g = torch.from_numpy(rng.randn(rois.shape[0], rois.shape[1], out, out, c)
                         .astype(np.float32)).to(device, dtype)
    return maps, rois, bias, g


def test_roi_align_sum_backward_cpu_is_autograd_of_plain():
    """On the CPU the backward wrapper is autograd through the plain
    version, which is what ``roi_align_sum`` differentiates there; the boxes
    take no gradient."""
    before = roi_align_sum_backward.launches
    for out, ratio, pool_from in STAGE_SHAPES:
        maps, rois, bias, g = _backward_case("cpu", torch.float32, 8, out, ratio, pool_from)
        args = _stage_args(out, ratio, pool_from)
        roi_align_sum(maps, rois, *args, bias=bias).backward(g)
        gm, gb = roi_align_sum_backward(g, [tuple(m.shape) for m in maps], rois, *args, True)
        for m, want in zip(maps, gm):
            assert torch.allclose(m.grad, want, atol=1e-5, rtol=0)
            assert want.abs().max().item() > 0.1
        assert torch.allclose(bias.grad, gb, atol=1e-5, rtol=0)
        assert torch.allclose(gb, g.sum((2, 3)), atol=1e-4, rtol=0)
    assert roi_align_sum_backward.launches == before
    with pytest.raises(ValueError):
        roi_align_sum(maps, rois.requires_grad_(True), *_stage_args(7, 2, 14), bias=bias)


@pytest.mark.cuda
@pytest.mark.parametrize("out,ratio,pool_from", STAGE_SHAPES, ids=["bbox", "mask"])
@pytest.mark.parametrize("c", [64, 20, 3])
def test_roi_align_sum_backward_kernel_matches_plain(cuda, out, ratio, pool_from, c):
    """``roi_align_sum`` on CUDA maps that require grad: its grad_fn launches
    the backward kernel once. f32 within 1e-4 of each map's gradient scale
    (the kernel adds in another order); bf16 within 2^-7 of the f32 plain
    gradients' scale (one rounding of the f32 sums). The bias gradient is
    the sum of grad_out over the bins. A second launch on the same inputs
    gives the same bits, in both types (the kernel adds in a fixed order)."""
    args = _stage_args(out, ratio, pool_from)
    maps, rois, bias, g = _backward_case(cuda, torch.float32, c, out, ratio, pool_from)
    before_f, before_b = roi_align.launches, roi_align_sum_backward.launches
    res = roi_align_sum(maps, rois, *args, bias=bias)
    assert res.grad_fn is not None
    res.backward(g)
    torch.cuda.synchronize()
    assert roi_align.launches == before_f + 1
    assert roi_align_sum_backward.launches == before_b + 1
    shapes = [tuple(m.shape) for m in maps]
    want, want_b = roi_align_sum_backward_plain(g, shapes, rois, *args, True)
    for m, w in zip(maps, want):
        scale = w.abs().max().item()
        assert scale > 0.1 and m.grad.dtype == torch.float32
        assert (m.grad - w).abs().max().item() <= 1e-4 * scale
    assert (bias.grad - want_b).abs().max().item() <= 1e-4 * want_b.abs().max().item()
    again, again_b = roi_align_sum_backward(g, shapes, rois, *args, True)
    assert all(torch.equal(m.grad, a) for m, a in zip(maps, again))
    assert torch.equal(bias.grad, again_b)

    maps16, _, bias16, _ = _backward_case(cuda, torch.bfloat16, c, out, ratio, pool_from)
    roi_align_sum(maps16, rois, *args, bias=bias16).backward(g.bfloat16())
    torch.cuda.synchronize()
    assert roi_align_sum_backward.launches == before_b + 3
    want32, _ = roi_align_sum_backward_plain(g.bfloat16().float(), shapes, rois, *args, True)
    for m, w in zip(maps16, want32):
        assert m.grad.dtype == torch.bfloat16
        assert (m.grad.float() - w).abs().max().item() <= 2.0 ** -7 * w.abs().max().item()
    again, again_b = roi_align_sum_backward(g.bfloat16(), shapes, rois, *args, True)
    assert all(torch.equal(m.grad, a) for m, a in zip(maps16, again))
    assert torch.equal(bias16.grad, again_b)


def _pyramid_case(device, dtype, c=64, b=2, side=256, r=120, seed=0):
    """Four levels (strides 4 to 32) of a side² image that require grad, and
    boxes from 2 to 600 px so that every level takes some."""
    rng = np.random.RandomState(seed)
    maps = [torch.from_numpy(rng.randn(b, side // s, side // s, c).astype(np.float32))
            .to(device, dtype).requires_grad_(True) for s in (4, 8, 16, 32)]
    xy = rng.uniform(-10, side - 10, (b, r, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(600), (b, r, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(device)
    return maps, rois


@pytest.mark.cuda
@pytest.mark.parametrize("out", [7, 14])
def test_multilevel_roi_features_kernel_matches_plain(cuda, out):
    """Four K4 launches forward and four backward; f32 within 1e-4 (of each
    map's gradient scale backward), bf16 within 2^-7 of the f32 plain
    version's scale, both against the same function on CPU copies."""
    maps, rois = _pyramid_case(cuda, torch.float32)
    assert len(torch.unique(roi_levels(rois, 4))) == 4
    g = torch.randn((2, rois.shape[1], out, out, 64), generator=torch.Generator().manual_seed(out))
    cpu_maps = [m.detach().cpu().requires_grad_(True) for m in maps]
    want = multilevel_roi_features(cpu_maps, rois.cpu(), out)
    want.backward(g)
    before_f, before_b = roi_align.launches, roi_align_sum_backward.launches
    got = multilevel_roi_features(maps, rois, out)
    got.backward(g.to(cuda))
    torch.cuda.synchronize()
    assert roi_align.launches == before_f + 4 and roi_align_sum_backward.launches == before_b + 4
    assert (got.detach().cpu() - want.detach()).abs().max().item() <= 1e-4
    for m, w in zip(maps, cpu_maps):
        scale = w.grad.abs().max().item()
        assert scale > 0.1 and (m.grad.cpu() - w.grad).abs().max().item() <= 1e-4 * scale

    maps16 = [m.detach().bfloat16().requires_grad_(True) for m in maps]
    got16 = multilevel_roi_features(maps16, rois, out)
    got16.backward(g.to(cuda).bfloat16())
    torch.cuda.synchronize()
    assert got16.dtype == torch.bfloat16
    tol = 2.0 ** -7 * max(m.abs().max().item() for m in maps)
    assert (got16.float().cpu() - want.detach()).abs().max().item() <= tol
    for m, w in zip(maps16, cpu_maps):
        scale = w.grad.abs().max().item()
        assert (m.grad.float().cpu() - w.grad).abs().max().item() <= 2.0 ** -7 * scale


@pytest.mark.cuda
def test_watershed_segmentation_and_cus_train_step_on_the_card(cuda):
    """``watershed_segmentation`` (the ``_Lite_Fuse`` instances) on seeded
    class maps: on the card its boxes and areas come from one K3 launch, and
    every output equals the CPU run (``component_stats_plain``) exactly.
    Then one ``compute_losses`` + backward of the full cascade
    (``HybridTaskCascadeRoIHead_Cus``) on the tiny config at 64², B2: K4
    forward and backward 6 times each, 3 bbox and 3 mask stages."""
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.models.build import build_detector, init_random_weights
    from nuhtc_tpu_torch.ops.morphology import gaussian_blur5
    from nuhtc_tpu_torch.ops.watershed import watershed_segmentation

    gen = torch.Generator().manual_seed(0)
    seg = torch.randn((6, 96, 96), generator=gen)
    for _ in range(4):
        seg = gaussian_blur5(seg)
    seg = seg * 40.0
    before = tc.component_stats.launches
    got = watershed_segmentation(seg.to(cuda), max_instances=64)
    torch.cuda.synchronize()
    assert tc.component_stats.launches == before + 1
    want = watershed_segmentation(seg, max_instances=64)
    assert tc.component_stats.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[1].sum().item() > 10

    cfg = Config.fromfile("configs/nuhtc/htc_lite_tiny_synthetic.py")
    model_cfg = dict(cfg.model)
    model_cfg["roi_head"] = dict(model_cfg["roi_head"], type="HybridTaskCascadeRoIHead_Cus")
    model = build_detector(model_cfg, None, 1.0)
    init_random_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).train()
    rng = np.random.RandomState(0)
    g = 6
    centre = rng.uniform(10, 54, (2, g, 2))
    half = rng.uniform(4, 8, (2, g, 2))
    sem = np.zeros((2, 16, 16), np.int64)
    boxes = np.concatenate([centre - half, centre + half], -1).astype(np.float32)
    for i in range(2):
        for x1, y1, x2, y2 in (boxes[i] / 4).astype(int):
            sem[i, y1:y2 + 1, x1:x2 + 1] = 1
    batch = dict(gt_boxes=boxes, gt_labels=rng.randint(0, 5, (2, g)),
                 gt_valid=np.ones((2, g), bool), gt_patches=np.ones((2, g, 28, 28), np.float32),
                 gt_semantic=sem)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    img = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32)).to(cuda)
    f0, b0 = roi_align.launches, roi_align_sum_backward.launches
    losses, _ = model.compute_losses(img, batch, torch.zeros((3, 5), device=cuda),
                                     torch.Generator(device=cuda).manual_seed(0))
    losses["total"].backward()
    torch.cuda.synchronize()
    assert roi_align.launches - f0 == 6 and roi_align_sum_backward.launches - b0 == 6
    assert all(torch.isfinite(v).item() for v in losses.values())
    assert all(f"s{s}.loss_mask" in losses for s in range(3))
