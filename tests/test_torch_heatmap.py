"""Score heatmaps and the legacy patch generator of the port against the JAX
package's (``nuhtc_tpu.wsi.heatmap``), on a seeded synthetic slide read
through the port's ``ArraySlide`` by both (the JAX functions take any
reader with the same methods).

``vis_heatmap`` over its options (blur, binarize, percentiles, holes, alpha
< 1, a region, ``custom_downsample``, ``max_size``, blank canvas, another
vis level): exactly equal, the blur included (``ops.imgproc.gaussian_blur``
is OpenCV's bit-exact uint8 Gaussian at every kernel size). ``get_seg_mask``, ``iter_patches``,
``to_percentiles``, ``screen_coords`` and the patch filters: equal. The
built-in "coolwarm" table: equal to matplotlib 3.10.8's, indexed as a
``Colormap`` call indexes it; another map name goes through matplotlib and
raises ImportError by name without it.
"""

import sys

import matplotlib
import numpy as np
import pytest

from nuhtc_tpu.wsi import heatmap as J
from nuhtc_tpu_torch.tools.synthetic import slide_and_grid
from nuhtc_tpu_torch.wsi import heatmap as P
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

matplotlib.use("Agg")


@pytest.fixture(scope="module")
def slide_seg_coords():
    slide, seg, coords, _ = slide_and_grid(2304, seed=0, tile=256, step=192)
    assert len(coords) >= 12 and sum(len(h) for h in seg.holes) >= 1
    scores = np.random.RandomState(0).rand(len(coords)) * 100
    return slide, seg, coords, scores


@pytest.mark.parametrize("kw", [
    dict(),
    dict(blur=True),
    dict(binarize=True, thresh=50),
    dict(binarize=True, thresh=-1, blur=True),
    dict(convert_to_percentiles=True, alpha=1.0),
    dict(use_holes=False, alpha=0.7),
    dict(top_left=(100, 150), bot_right=(900, 1000)),
    dict(top_left=(300, 200), bot_right=(2100, 1952), blur=True, alpha=0.5),
    dict(custom_downsample=2, blur=True),
    dict(max_size=20),
    dict(vis_level=3, blur=True),
    dict(vis_level=4, blank_canvas=True, max_size=50),
    dict(segment=False, blur=True, overlap=0.5),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_vis_heatmap_equals_jax(slide_seg_coords, kw):
    slide, seg, coords, scores = slide_seg_coords
    got = P.vis_heatmap(slide, scores, coords, seg, **kw)
    want = J.vis_heatmap(slide, scores, coords, seg, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(int) - want)
    assert d.max() == 0, d.max()


@pytest.mark.parametrize("use_holes", [False, True])
@pytest.mark.parametrize("level,offset", [(5, (0, 0)), (3, (0, 0)), (2, (160, 96))])
def test_get_seg_mask_equals_jax(slide_seg_coords, level, offset, use_holes):
    slide, seg, _, _ = slide_seg_coords
    scale = 1.0 / slide.level_downsamples[level]
    size = slide.level_dimensions[level]
    got = P.get_seg_mask(seg, size, scale, use_holes=use_holes, offset=offset)
    want = J.get_seg_mask(seg, size, scale, use_holes=use_holes, offset=offset)
    assert got.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(custom_downsample=2, step_size=128),
                                dict(patch_level=1, use_padding=False, white_thresh=40)])
def test_iter_patches_equals_jax(slide_seg_coords, kw):
    slide, seg, _, _ = slide_seg_coords
    got = list(P.iter_patches(slide, seg, **kw))
    want = list(J.iter_patches(slide, seg, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_score_utilities_and_patch_filters_equal_jax():
    rng = np.random.RandomState(0)
    scores = rng.randint(0, 10, 50).astype(float)
    np.testing.assert_array_equal(P.to_percentiles(scores), J.to_percentiles(scores))
    coords = rng.randint(0, 1000, (50, 2))
    for a, b in zip(P.screen_coords(scores, coords, (100, 200), (800, 900)),
                    J.screen_coords(scores, coords, (100, 200), (800, 900))):
        np.testing.assert_array_equal(a, b)
    for patch in (np.full((8, 8, 3), 250, np.uint8), np.full((8, 8, 3), 10, np.uint8),
                  rng.randint(0, 256, (8, 8, 3)).astype(np.uint8),
                  np.stack([np.full((8, 8), 200), np.full((8, 8), 198), np.full((8, 8), 199)],
                           -1).astype(np.uint8)):
        for t in (5, 15):
            assert P.is_white_patch(patch, t) == J.is_white_patch(patch, t)
        assert P.is_black_patch(patch) == J.is_black_patch(patch)


def test_coolwarm_table_equals_matplotlib():
    cmap = matplotlib.colormaps["coolwarm"]
    rows = cmap(np.arange(256))  # integers index the look-up table itself
    np.testing.assert_array_equal(P.COOLWARM_U8, (rows * 255)[:, :3].astype(np.uint8))
    x = np.concatenate([np.linspace(-0.5, 1.5, 4001), [0.0, 1.0, 1 - 1e-12, 0.5, np.nan]])
    x = x.reshape(-1, 1)
    want = (cmap(x) * 255)[..., :3].astype(np.uint8)
    np.testing.assert_array_equal(P._cmap("coolwarm")(x), want)
    viridis = matplotlib.colormaps["viridis"]
    np.testing.assert_array_equal(P._cmap("viridis")(x),
                                  (viridis(x) * 255)[..., :3].astype(np.uint8))


def test_other_colour_maps_need_matplotlib(monkeypatch, slide_seg_coords):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        P._cmap("viridis")
    slide, seg, coords, scores = slide_seg_coords
    assert P.vis_heatmap(slide, scores, coords, seg).shape == (72, 72, 3)
