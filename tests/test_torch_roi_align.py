"""K4's plain version and the RoI extractors of the port against the JAX package.

``roi_align_plain`` (and ``roi_align``, which takes it on CPU tensors) against
JAX ``roi_align(exact=True)`` in f32 for the three sampling modes of the
detector (fixed ratio 2, adaptive grid, ``pool_from=14``), on boxes that leave
the map, have zero size or are larger than the map: atol 1e-4 (f32 sums in
another order). The Pallas K4 is no oracle: its header calls it numerically
wrong. ``gather_reference`` below is the gather form the CUDA kernel uses
(one bilinear sample at a time, per RoI and bin), written in numpy: the plain
version must agree with it too, so the two formulations are pinned to each
other on the CPU.

``stage_roi_features`` (one ``roi_align_sum`` over two levels and the semantic
map, with the attention pools as a per-RoI bias) against the sum of the JAX
extractors it replaces, at both stage shapes of the detector, atol 1e-4; and
``roi_align_sum``'s modes and errors on the CPU.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.models.roi_extractor import attention_roi_features as j_attn_feats
from nuhtc_tpu.models.roi_extractor import single_roi_features as j_single_feats
from nuhtc_tpu.ops.roi_align import roi_align as j_roi_align
from nuhtc_tpu_torch.models.roi_extractor import (
    attention_roi_features, single_roi_features, stage_roi_features,
)
from nuhtc_tpu_torch.ops.roi_align import (
    attention_pool, roi_align, roi_align_plain, roi_align_sum, roi_align_sum_plain,
)
from torch_port_util import f32, n, t

ATOL = 1e-4
MODES = {
    "sr2": dict(output_size=7, sampling_ratio=2),
    "adaptive14": dict(output_size=14, sampling_ratio=0),
    "adaptive7": dict(output_size=7, sampling_ratio=0),
    "pool14": dict(output_size=7, sampling_ratio=0, pool_from=14),
}


def _boxes(rng, r, w, h):
    xy = rng.uniform(-6, [w - 4, h - 4], (r, 2))
    wh = rng.uniform(1.0, 0.7 * min(w, h), (r, 2))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rois[0] = [-9, -7, 3, 2]  # crosses the near border
    rois[1] = [w - 5, h - 6, w + 12, h + 9]  # crosses the far border
    rois[2] = [10, 11, 10, 11]  # zero size
    rois[3] = [10, 10, 10.3, 10.2]  # below one cell
    rois[4] = [-10, -10, w + 10, h + 10]  # larger than the map
    rois[5] = [-40, -40, -20, -25]  # wholly outside
    rois[6] = [0, 0, w, h]  # the whole map
    rois[7] = [3, 20, 3, 40]  # zero width
    return rois


def gather_reference(feat, rois, scale, output_size, sampling_ratio=0, max_grid=8,
                     pool_from=None):
    """mmcv RoIAlign(aligned=True, avg) one sample at a time, in f32 for the
    coordinates and f64 for the sums. feat (H, W, C), rois (R, 4)."""
    h, w, c = feat.shape
    f = np.float32
    out = np.zeros((len(rois), output_size, output_size, c), np.float64)

    def axis(c0, c1, size):
        start = f(f(c0) * f(scale)) - f(0.5)
        extent = f(f(f(c1) * f(scale)) - f(0.5)) - start
        bin_ = f(extent / f(output_size))
        if pool_from is not None:
            k = pool_from // output_size
            grid = k * int(min(max(math.ceil(f(extent / f(pool_from))), 1), max_grid))
        elif sampling_ratio > 0:
            grid = sampling_ratio
        else:
            grid = int(min(max(math.ceil(bin_), 1), max_grid))
        taps = []
        for i in range(output_size):
            row = []
            for s in range(grid):
                y = f(f(start + f(f(i) * bin_)) + f(f(f(s + 0.5) * bin_) / f(grid)))
                if y < -1.0 or y > size:
                    continue
                yc = min(max(y, f(0)), f(size - 1))
                lo = int(math.floor(yc))
                if lo >= size - 1:
                    lo, yc = size - 1, f(size - 1)
                frac = float(yc) - lo
                row.append((lo, min(lo + 1, size - 1), (1 - frac) / grid, frac / grid))
            taps.append(row)
        return taps

    for r, (x1, y1, x2, y2) in enumerate(rois):
        tx, ty = axis(x1, x2, w), axis(y1, y2, h)
        for i in range(output_size):
            for j in range(output_size):
                acc = np.zeros(c, np.float64)
                for y0, y1_, wy0, wy1 in ty[i]:
                    for x0, x1_, wx0, wx1 in tx[j]:
                        acc += (wy0 * wx0 * feat[y0, x0] + wy0 * wx1 * feat[y0, x1_]
                                + wy1 * wx0 * feat[y1_, x0] + wy1 * wx1 * feat[y1_, x1_])
                out[r, i, j] = acc
    return out


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(11)
    feat = rng.randn(2, 36, 28, 6).astype(np.float32)
    rois = np.stack([_boxes(rng, 24, 4 * 28, 4 * 36) for _ in range(2)])
    return feat, rois


@pytest.mark.parametrize("mode", list(MODES))
def test_roi_align_plain_matches_jax_exact(case, mode):
    feat, rois = case
    kw = MODES[mode]
    got = roi_align_plain(t(feat), t(rois), 0.25, **kw)
    assert tuple(got.shape) == (2, 24, kw["output_size"], kw["output_size"], 6)
    for i in range(2):
        with f32():
            want = j_roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), 0.25, exact=True, **kw)
        np.testing.assert_allclose(n(got[i]), np.asarray(want), atol=ATOL, rtol=0)
    assert np.abs(n(got)).max() > 0.5
    # the wrapper takes the plain version on CPU tensors and counts no launch
    before = roi_align.launches
    assert torch.equal(roi_align(t(feat), t(rois), 0.25, **kw), got)
    assert roi_align.launches == before


@pytest.mark.parametrize("mode", list(MODES))
def test_roi_align_plain_matches_gather_form(case, mode):
    feat, rois = case
    kw = MODES[mode]
    got = n(roi_align_plain(t(feat[:1]), t(rois[:1, :12]), 0.25, **kw))[0]
    want = gather_reference(feat[0], rois[0, :12], 0.25, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # boxes wholly outside the map give zeros, zero-size boxes one sample per bin
    assert np.abs(got[5]).max() == 0.0
    assert np.abs(got[2]).max() > 0.0


def test_roi_align_other_scale_and_max_grid(case):
    feat, rois = case
    for scale, max_grid in ((0.125, 8), (0.25, 2)):
        got = roi_align_plain(t(feat[:1]), t(rois[:1]), scale, 14, max_grid=max_grid)
        with f32():
            want = j_roi_align(jnp.asarray(feat[0]), jnp.asarray(rois[0]), scale, 14,
                               max_grid=max_grid, exact=True)
        np.testing.assert_allclose(n(got[0]), np.asarray(want), atol=ATOL, rtol=0)


def test_roi_align_empty_and_bf16():
    feat = torch.zeros(2, 8, 8, 4)
    assert tuple(roi_align(feat, torch.zeros(2, 0, 4), 0.25, 7).shape) == (2, 0, 7, 7, 4)
    rng = np.random.RandomState(3)
    fmap = t(rng.randn(1, 16, 16, 8).astype(np.float32))
    rois = t(_boxes(rng, 10, 64, 64)[None])
    ref = roi_align_plain(fmap.bfloat16().float(), rois, 0.25, 7, sampling_ratio=2)
    got = roi_align_plain(fmap.bfloat16(), rois, 0.25, 7, sampling_ratio=2)
    assert got.dtype == torch.bfloat16
    # bf16 products: a few roundings of values up to ~4
    assert (got.float() - ref).abs().max().item() <= 0.08


@pytest.mark.parametrize("out_size,sampling_ratio", [(7, 2), (14, 0)])
def test_extractors_match_jax(out_size, sampling_ratio):
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, s, s, 8).astype(np.float32) for s in (16, 8, 4, 2)]
    sem = rng.randn(2, 16, 16, 8).astype(np.float32)
    rois = np.stack([_boxes(rng, 20, 64, 64) for _ in range(2)])
    got = attention_roi_features([t(f) for f in feats], t(rois), out_size, sampling_ratio)
    pool_from = 14 if out_size == 7 else None
    got_sem = single_roi_features(t(sem), t(rois), out_size, pool_from=pool_from)
    for i in range(2):
        with f32():
            want = j_attn_feats([jnp.asarray(f[i]) for f in feats], jnp.asarray(rois[i]),
                                out_size, sampling_ratio, exact=True)
            want_sem = j_single_feats(jnp.asarray(sem[i]), jnp.asarray(rois[i]), out_size,
                                      pool_from=pool_from, exact=True)
        np.testing.assert_allclose(n(got[i]), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(n(got_sem[i]), np.asarray(want_sem), atol=ATOL, rtol=0)


STAGES = {"bbox": (7, 2, 14), "mask": (14, 0, None)}


def _stage_inputs(seed=5, c=8):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, s, s, c).astype(np.float32) for s in (16, 8, 4, 2)]
    sem = rng.randn(2, 16, 16, c).astype(np.float32)
    rois = np.stack([_boxes(rng, 20, 64, 64) for _ in range(2)])
    return feats, sem, rois


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_roi_features_match_jax_extractor_sum(stage):
    out_size, sampling_ratio, pool_from = STAGES[stage]
    feats, sem, rois = _stage_inputs()
    before = roi_align.launches
    got = stage_roi_features([t(f) for f in feats], t(sem), t(rois), out_size, sampling_ratio,
                             pool_from)
    assert roi_align.launches == before  # the CPU takes the plain version
    assert tuple(got.shape) == (2, 20, out_size, out_size, 8)
    for i in range(2):
        with f32():
            want = j_attn_feats([jnp.asarray(f[i]) for f in feats], jnp.asarray(rois[i]),
                                out_size, sampling_ratio, exact=True)
            want = want + j_single_feats(jnp.asarray(sem[i]), jnp.asarray(rois[i]), out_size,
                                         pool_from=pool_from, exact=True)
        np.testing.assert_allclose(n(got[i]), np.asarray(want), atol=ATOL, rtol=0)
    # and the port's own unfused composition
    old = (attention_roi_features([t(f) for f in feats], t(rois), out_size, sampling_ratio)
           + single_roi_features(t(sem), t(rois), out_size, pool_from=pool_from))
    np.testing.assert_allclose(n(got), n(old), atol=ATOL, rtol=0)


@pytest.mark.parametrize("stage", list(STAGES))
def test_roi_align_sum_plain_is_the_sum_of_its_parts(stage):
    out_size, sampling_ratio, pool_from = STAGES[stage]
    feats, sem, rois = _stage_inputs(seed=6)
    maps = [t(feats[0]), t(feats[1]), t(sem)]
    args = (t(rois), [0.25, 0.125, 0.25], out_size, [sampling_ratio, sampling_ratio, 0],
            [None, None, pool_from])
    bias = t(np.random.RandomState(1).randn(2, 20, 8).astype(np.float32))
    got = roi_align_sum_plain(maps, *args, bias=bias)
    want = sum(n(roi_align_plain(m, t(rois), sc, out_size, sr, 8, pf))
               for m, sc, sr, pf in zip(maps, *[args[i] for i in (1, 3, 4)]))
    want = want + n(bias)[:, :, None, None, :]
    np.testing.assert_allclose(n(got), want, atol=1e-5, rtol=0)
    assert torch.equal(roi_align_sum(maps, *args, bias=bias), got)
    # bias None; one map is roi_align itself
    assert torch.equal(roi_align_sum(maps, *args), roi_align_sum_plain(maps, *args))
    np.testing.assert_allclose(n(roi_align_sum(maps, *args)), want - n(bias)[:, :, None, None, :],
                               atol=1e-5, rtol=0)
    one = roi_align_sum(maps[2:], t(rois), [0.25], out_size, [0], [pool_from])
    assert torch.equal(one, roi_align(maps[2], t(rois), 0.25, out_size, pool_from=pool_from))


def test_roi_align_sum_empty_rois_and_bf16_bias():
    feats, sem, rois = _stage_inputs(seed=7)
    maps = [t(feats[0]), t(feats[1]), t(sem)]
    args = ([0.25, 0.125, 0.25], 7, [2, 2, 0], [None, None, 14])
    got = roi_align_sum(maps, t(rois[:, :0]), *args, bias=torch.zeros(2, 0, 8))
    assert tuple(got.shape) == (2, 0, 7, 7, 8)
    # bf16 maps: the result keeps the maps' type, the f32 bias is rounded into it
    bias = t(np.random.RandomState(2).randn(2, 20, 8).astype(np.float32))
    got16 = roi_align_sum([m.bfloat16() for m in maps], t(rois), *args, bias=bias)
    ref = roi_align_sum([m.bfloat16().float() for m in maps], t(rois), *args, bias=bias)
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - ref).abs().max().item() <= 0.25  # a few bf16 roundings of sums ~10


def test_attention_pool_out_dtype():
    feats, _, rois = _stage_inputs(seed=8)
    f16 = t(feats[2]).bfloat16()
    kept = attention_pool(f16, t(rois), 16, 0.965926, out_dtype=torch.float32)
    assert kept.dtype == torch.float32
    assert attention_pool(f16, t(rois), 16, 0.965926).dtype == torch.bfloat16
    assert torch.equal(kept.bfloat16(), attention_pool(f16, t(rois), 16, 0.965926))


@pytest.mark.parametrize("fault", ["four_maps", "no_map", "mixed_types", "channels", "batch",
                                   "pool_from", "pool_from_with_ratio", "bias_shape",
                                   "short_list", "rois_shape"])
def test_roi_align_sum_raises_on_what_it_does_not_take(fault):
    feats, sem, rois = _stage_inputs(seed=9)
    maps = [t(feats[0]), t(feats[1]), t(sem)]
    rois = t(rois)
    scales, ratios, pools = [0.25, 0.125, 0.25], [2, 2, 0], [None, None, 14]
    bias = None
    if fault == "four_maps":
        maps, scales, ratios, pools = maps + maps[:1], scales + [0.25], ratios + [0], pools + [None]
    elif fault == "no_map":
        maps, scales, ratios, pools = [], [], [], []
    elif fault == "mixed_types":
        maps[1] = maps[1].bfloat16()
    elif fault == "channels":
        maps[2] = maps[2][..., :4]
    elif fault == "batch":
        maps[1] = maps[1][:1]
    elif fault == "pool_from":
        pools = [None, None, 10]
    elif fault == "pool_from_with_ratio":
        ratios = [2, 2, 2]
    elif fault == "bias_shape":
        bias = torch.zeros(2, 19, 8)
    elif fault == "short_list":
        scales = scales[:2]
    else:
        rois = rois[..., :3]
    with pytest.raises(ValueError):
        roi_align_sum(maps, rois, scales, 7, ratios, pools, bias=bias)
