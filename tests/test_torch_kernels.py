"""Hand kernels of the PyTorch port against their plain PyTorch versions.

These need an NVIDIA GPU (the CUDA kernels have no CPU mode), carry the
``cuda`` marker and skip without one. The file imports no JAX at module
level, so the marked tests also run on a GPU host that has none:
``python -m pytest tests/test_torch_kernels.py -m cuda``.
The CPU wrappers' dispatch to the plain versions is checked here too, and
K2's plain twin ``window_attention_plain`` is held against the Pallas kernel
``window_attention_fused`` in interpret mode (these cases import JAX inside
the test) at the small shapes of test_fused_attention.py, atol 0.06.
"""

import numpy as np
import pytest
import torch

from nuhtc_tpu_torch.ops import components as tc
from nuhtc_tpu_torch.ops.roi_align import roi_align, roi_align_plain
from nuhtc_tpu_torch.ops.window_block import (
    window_attention, window_attention_plain, window_block, window_block_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block_args(device, c=96, nh=3, side=21, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=device) * std

    x = rnd(2, side, side, c, std=0.5).bfloat16()
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
