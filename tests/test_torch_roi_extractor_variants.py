"""The RoI-extractor variants of the PyTorch port against the JAX package.

The port takes batched maps (B, H, W, C) and RoIs (B, R, 4); each image must
equal the JAX function of that image (maps (H, W, C), RoIs (R, 4)). The JAX
side's RoIAlign is given ``exact=True`` (its default accumulates in bf16)
and its products run in f32. Tolerance: atol 1e-4 on O(1) maps, as
tests/test_torch_roi_align.py holds the plain RoIAlign. On the CPU the
port's sums take K4's plain version (``roi_align_sum_plain``) and count no
launch.

- ``selected_roi_features`` over all four levels (two K4 calls: three maps,
  then one) and over a selection of two, in two sampling modes;
- ``local_global_roi_features`` with start level 2 (one call, the coarse
  means as its per-RoI bias), 1 and 0 (no RoIAlign at all);
- ``pos_attention_pool`` with RoIs that share a centre cell, with padding
  RoIs excluded by ``valid``, and with every RoI valid.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.models import roi_extractor_variants as jv
from nuhtc_tpu.ops.roi_align import roi_align as j_roi_align
from nuhtc_tpu_torch.models.roi_extractor_variants import (
    local_global_roi_features, pos_attention_pool, selected_roi_features,
)
from nuhtc_tpu_torch.ops import roi_align as ra
from torch_port_util import f32, n, t

ATOL = 1e-4
STRIDES = (4, 8, 16, 32)


@pytest.fixture(scope="module")
def pyramid():
    """Two images of a 128² input: levels 32², 16², 8², 4², C 6, and 20 RoIs
    each, some across the border, one of zero size."""
    rng = np.random.RandomState(21)
    feats = [rng.randn(2, 128 // s, 128 // s, 6).astype(np.float32) for s in STRIDES]
    xy = rng.uniform(-8, 110, (2, 20, 2))
    rois = np.concatenate([xy, xy + rng.uniform(2, 60, (2, 20, 2))], -1).astype(np.float32)
    rois[:, 0] = [50, 50, 50, 50]
    return feats, rois


@pytest.fixture
def exact_jax(monkeypatch):
    monkeypatch.setattr(jv, "roi_align", functools.partial(j_roi_align, exact=True))


def _per_image(fn, feats, rois, **kw):
    with f32():
        return np.stack([np.asarray(fn([jnp.asarray(f[i]) for f in feats],
                                       jnp.asarray(rois[i]), **kw)) for i in range(len(rois))])


@pytest.mark.parametrize("levels,mode", [(None, dict(output_size=7, sampling_ratio=2)),
                                         (None, dict(output_size=14, sampling_ratio=0)),
                                         ((1, 3), dict(output_size=7, sampling_ratio=0))],
                         ids=["all-sr2", "all-adaptive14", "1and3-adaptive7"])
def test_selected_roi_features_matches_jax(pyramid, exact_jax, levels, mode):
    feats, rois = pyramid
    want = _per_image(jv.selected_roi_features, feats, rois, selected_levels=levels, **mode)
    before = ra.roi_align.launches
    got = selected_roi_features([t(f) for f in feats], t(rois), selected_levels=levels, **mode)
    assert ra.roi_align.launches == before
    np.testing.assert_allclose(n(got), want, atol=ATOL, rtol=0)
    assert np.abs(want).max() > 0.5


def test_selected_roi_features_calls_k4_with_up_to_three_maps(pyramid, monkeypatch):
    feats, rois = pyramid
    calls = []
    real = ra.roi_align_sum

    def spy(maps, *args, **kw):
        calls.append(len(maps))
        return real(maps, *args, **kw)

    import nuhtc_tpu_torch.models.roi_extractor_variants as pv

    monkeypatch.setattr(pv, "roi_align_sum", spy)
    selected_roi_features([t(f) for f in feats], t(rois), 7, 2)
    local_global_roi_features([t(f) for f in feats], t(rois), 7, 2, start_level=2)
    assert calls == [3, 1, 2]


@pytest.mark.parametrize("start_level", [2, 1, 0])
def test_local_global_roi_features_matches_jax(pyramid, exact_jax, start_level):
    feats, rois = pyramid
    want = _per_image(jv.local_global_roi_features, feats, rois, output_size=7,
                      sampling_ratio=0, start_level=start_level)
    got = local_global_roi_features([t(f) for f in feats], t(rois), 7, 0,
                                    start_level=start_level)
    np.testing.assert_allclose(n(got), want, atol=ATOL, rtol=0)


def _pool_case(rng):
    feat = rng.randn(2, 16, 12, 8).astype(np.float32)
    xy = rng.uniform(0, 90, (2, 12, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 30, (2, 12, 2))], -1).astype(np.float32)
    rois[:, 1] = rois[:, 0]  # the same box: the same centre cell
    rois[:, 2] = rois[:, 0] + [1, 1, 1, 1]  # a near box in the same 8-px cell
    rois[:, 3] = [-30, -30, -10, -10]  # its centre clamps to cell (0, 0)
    valid = np.ones((2, 12), bool)
    valid[0, 9:] = False  # padding RoIs
    valid[1, 1] = False  # a duplicate that is padding
    return feat, rois, valid


@pytest.mark.parametrize("with_valid", [True, False])
def test_pos_attention_pool_matches_jax(with_valid):
    feat, rois, valid = _pool_case(np.random.RandomState(22))
    with f32():
        want = np.stack([np.asarray(jv.pos_attention_pool(
            jnp.asarray(feat[i]), jnp.asarray(rois[i]), 8,
            jnp.asarray(valid[i]) if with_valid else None)) for i in range(2)])
    got = pos_attention_pool(t(feat), t(rois), 8, t(valid) if with_valid else None)
    assert tuple(got.shape) == (2, 12, 8)
    np.testing.assert_allclose(n(got), want, atol=ATOL, rtol=0)


def test_pos_attention_pool_ignores_padding_rois():
    """A padding RoI changes no valid RoI's output, wherever it lies."""
    feat, rois, valid = _pool_case(np.random.RandomState(23))
    moved = rois.copy()
    moved[0, 9:] = [[60, 60, 70, 70]] * 3
    a = pos_attention_pool(t(feat), t(rois), 8, t(valid))
    b = pos_attention_pool(t(feat), t(moved), 8, t(valid))
    assert torch.allclose(a[0, :9], b[0, :9], atol=1e-6, rtol=0)
