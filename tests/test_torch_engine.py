"""The strict patch path and flip TTA of the PyTorch port against the JAX package.

Host pieces on shared numpy inputs:
- ``paste_masks``: uint8 masks equal to the JAX package's except where the
  pasted probability lies within 1e-4 of the threshold (the JAX side runs its
  products at ``Precision.HIGH``); such ties are counted and nothing else may
  differ;
- ``preprocess_test_image``: the numpy ``INTER_LINEAR`` resize against the JAX
  package's ``cv2.resize``: exactly equal at scale 2.0, within one uint8
  level (0.018 after normalization) at other scales;
- ``ops.rle`` and ``mask_nms``: exactly equal;
- ``to_reference_format``: the per-class result contract.
Whole paths on the tiny synthetic config, weights carried across by
``state_dict_from_jax``, JAX in f32 with ``exact_rois=True``: the strict path
(``device_preprocess=False, compact_masks=False``, scale factor 2) and
``TTAEngine``; detection sets must match one to one, scores and probs to
1e-4, boxes to 1e-3 px (coordinates up to 48 px through three box decodes in
f32), masks equal except at most 3 pixels per detection at threshold ties.
The Swin backbone's three kernel tiers on the CPU against JAX's XLA path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.apis.inference import InferenceEngine as JaxEngine
from nuhtc_tpu.apis.inference import TTAEngine as JaxTTA
from nuhtc_tpu.apis.inference import _box_nms as j_box_nms
from nuhtc_tpu.config import Config
from nuhtc_tpu.data.pipelines import preprocess_test_image as j_preprocess
from nuhtc_tpu.eval.evaluate import mask_nms as j_mask_nms
from nuhtc_tpu.models.build import build_detector
from nuhtc_tpu.models.swin import SwinTransformer as JaxSwin
from nuhtc_tpu.ops import rle as j_rle
from nuhtc_tpu.ops.mask_paste import paste_masks as j_paste_masks
from nuhtc_tpu_torch.apis.inference import TTAEngine, _box_nms, init_detector
from nuhtc_tpu_torch.data.pipelines import IMG_NORM, preprocess_test_image, resize_linear_u8
from nuhtc_tpu_torch.eval.evaluate import mask_nms
from nuhtc_tpu_torch.models.swin import SwinTransformer
from nuhtc_tpu_torch.ops import rle
from nuhtc_tpu_torch.ops.mask_paste import paste_masks
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax
from torch_oracle import OracleArch, apply_sd, build_full_sd, match_detections
from torch_port_util import blob_tiles, f32, n, port_sd, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

CONFIG = "configs/nuhtc/htc_lite_tiny_synthetic.py"
TILE = 48
TIE = 1e-4  # |pasted probability - threshold| below which a pixel may flip


def _paste_case(rng, count, size):
    yy, xx = np.mgrid[:28, :28]
    r = rng.uniform(5, 13, count)[:, None, None]
    cy, cx = rng.uniform(10, 18, (2, count, 1, 1))
    probs = 1.0 / (1.0 + np.exp((np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) - r) * 1.3))
    xy = rng.uniform(-5, size - 10, (count, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 30, (count, 2))], 1)
    boxes[0] = [4, 4, 4, 9]  # zero width
    return probs.astype(np.float32), boxes.astype(np.float32)


@pytest.mark.parametrize("count,size", [(40, (64, 64)), (300, (40, 56))])
def test_paste_masks_matches_jax(count, size):
    probs, boxes = _paste_case(np.random.RandomState(count), count, min(size))
    want = np.asarray(j_paste_masks(jnp.asarray(probs), jnp.asarray(boxes), size, threshold=0.5))
    got = paste_masks(t(probs), t(boxes), size, threshold=0.5)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (count, *size)
    full = n(paste_masks(t(probs), t(boxes), size, threshold=-1.0))
    assert full.dtype == np.float32
    ties = np.abs(full - 0.5) < TIE
    differ = n(got) != want
    assert not (differ & ~ties).any()
    assert differ.sum() <= ties.sum() <= 1e-3 * differ.size
    assert 0.005 < n(got).mean() < 0.6  # real masks, not all background
    np.testing.assert_array_equal(n(got), (full > 0.5).astype(np.uint8))


@pytest.mark.parametrize("scale,shape", [(2.0, (48, 48)), (2.0, (37, 50)), (1.0, (40, 33)),
                                         (1.5, (48, 40)), (0.8, (50, 50)), (3.1, (21, 17))])
def test_preprocess_test_image_matches_jax(scale, shape):
    img = np.random.RandomState(int(scale * 10)).randint(0, 256, (*shape, 3)).astype(np.uint8)
    want = j_preprocess(img, scale)
    got = preprocess_test_image(img, scale)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] % 32 == 0 and got.shape[1] % 32 == 0
    if scale == 2.0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1.0 / min(IMG_NORM["std"]) + 1e-6  # one uint8 level
    rh, rw = int(shape[0] * scale + 0.5), int(shape[1] * scale + 0.5)
    assert (got[rh:] == 0).all() and (got[:, rw:] == 0).all()  # zero pad after Normalize


def test_resize_linear_u8_is_half_pixel_bilinear():
    """Against the half-pixel bilinear definition in f64: within the 1/2048
    coefficient rounding plus the final rounding to nearest."""
    img = np.random.RandomState(2).randint(0, 256, (20, 24, 3)).astype(np.uint8)
    got = resize_linear_u8(img, (40, 48)).astype(np.float64)

    def taps(dst, src):
        f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        lo = np.floor(f).astype(int)
        return np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1), f - lo

    y0, y1, fy = taps(40, 20)
    x0, x1, fx = taps(48, 24)
    src = img.astype(np.float64)
    rows = src[:, x0] * (1 - fx)[None, :, None] + src[:, x1] * fx[None, :, None]
    want = rows[y0] * (1 - fy)[:, None, None] + rows[y1] * fy[:, None, None]
    assert np.abs(got - want).max() <= 0.5 + 255 * 3 / 2048
    with pytest.raises(ValueError):
        resize_linear_u8(img.astype(np.float32), (40, 48))


def _random_masks(rng, count, h, w):
    yy, xx = np.mgrid[:h, :w]
    masks = []
    for _ in range(count):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 9)
        masks.append((((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r).astype(np.uint8))
    masks += [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]
    return masks


def test_rle_matches_jax_package():
    rng = np.random.RandomState(7)
    masks = _random_masks(rng, 20, 33, 41) + [(rng.rand(33, 41) > 0.5).astype(np.uint8)]
    got = [rle.encode(m) for m in masks]
    want = [j_rle.encode(m) for m in masks]
    assert got == want
    for m, r in zip(masks, got):
        np.testing.assert_array_equal(rle.decode(r), m)
        np.testing.assert_array_equal(rle.decode(r), j_rle.decode(r))
        assert rle.area(r) == j_rle.area(r) == int(m.sum())
        np.testing.assert_array_equal(rle.toBbox(r), j_rle.toBbox(r))
    crowd = [0, 1] * 6
    np.testing.assert_array_equal(rle.iou(got, got), j_rle.iou(want, want))
    np.testing.assert_array_equal(rle.iou(got[:9], got[9:21], crowd),
                                  j_rle.iou(want[:9], want[9:21], crowd))
    assert rle.iou([], got).shape == (0, len(got))
    assert rle.merge(got[:5]) == j_rle.merge(want[:5])
    assert rle.merge(got[:5], intersect=True) == j_rle.merge(want[:5], intersect=True)
    assert rle.decode({"size": [33, 41], "counts": got[3]["counts"].decode()}).sum() == masks[3].sum()


@pytest.mark.parametrize("thr", [0.05, 0.5])
def test_mask_nms_and_box_nms_match_jax_package(thr):
    rng = np.random.RandomState(8)
    masks = _random_masks(rng, 60, 40, 40)
    scores = rng.rand(len(masks)).astype(np.float32)
    rles = [rle.encode(m) for m in masks]
    kept, idx = mask_nms(rles, scores, thr=thr)
    jkept, jidx = j_mask_nms(rles, scores, thr=thr)
    np.testing.assert_array_equal(idx, jidx)
    assert kept == jkept and 5 < len(idx) < len(masks)
    assert mask_nms([], np.zeros(0))[1].shape == (0,)
    xy = rng.uniform(0, 40, (80, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 20, (80, 2))], 1).astype(np.float32)
    bs = rng.rand(80).astype(np.float32)
    np.testing.assert_array_equal(_box_nms(boxes, bs, thr), j_box_nms(boxes, bs, thr))


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's on the same weights, scale factor 2."""
    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, cfg.model.get("test_cfg"), 2.0,
                           dtype=jnp.float32).clone(exact_rois=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2 * TILE, 2 * TILE, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    arch = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)
    sd = build_full_sd(np.random.RandomState(0), arch)
    sd["roi_head.semantic_head.conv_logits.bias"] += 2.0  # so components propose boxes
    params = apply_sd(sd, template)
    jax_engine = JaxEngine(model, params, batch_size=2, tile_size=TILE)
    engine = init_detector(CONFIG, None, batch_size=2, tile_size=TILE, device="cpu",
                           scale_factor=2.0)
    engine.model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert not engine.device_preprocess and not engine.compact_masks
    assert engine.scale_factor == jax_engine.scale_factor == 2.0
    assert engine.input_size == jax_engine.input_size == 96
    return jax_engine, engine


def _assert_same_detections(got, want):
    pairs, un_got, un_want = match_detections(got, want, iou_thr=0.5)
    assert len(un_got) == 0 and len(un_want) == 0, (len(un_got), len(un_want))
    gi = np.asarray([p[0] for p in pairs], int)
    wi = np.asarray([p[1] for p in pairs], int)
    np.testing.assert_allclose(got["scores"][gi], want["scores"][wi], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["probs"][gi], want["probs"][wi], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["boxes"][gi], want["boxes"][wi], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got["labels"][gi], want["labels"][wi])
    assert got["masks"].dtype == np.uint8 and got["masks"].shape == want["masks"].shape
    flips = (got["masks"][gi] != want["masks"][wi]).reshape(len(gi), -1).sum(1)
    assert flips.max(initial=0) <= 3, flips.max()
    return len(gi)


def test_strict_path_matches_jax_engine(engines):
    jax_engine, engine = engines
    tiles = blob_tiles(np.random.RandomState(1), 2, TILE, blobs=3)
    tiles[1] = tiles[1][:40, :44]  # an undersized tile
    np.testing.assert_array_equal(engine.preprocess(tiles), jax_engine.preprocess(tiles))
    with f32():
        want = jax_engine.run_batch(tiles)
    got = engine.run_batch(tiles)
    assert len(got) == len(want) == 2
    total = sum(_assert_same_detections(g, w) for g, w in zip(got, want))
    assert total > 10
    assert engine.collect_timing["download_s"] > 0.0
    for g in got:
        assert set(g) == {"boxes", "scores", "labels", "probs", "masks"}
        assert g["masks"].shape[1:] == (TILE, TILE) and g["masks"].max(initial=0) <= 1
        assert g["boxes"].min(initial=0) >= 0 and g["boxes"].max(initial=0) <= TILE

    # the result contract of the reference's tools
    bboxes, segms = engine.to_reference_format(got[0])
    jb, js = jax_engine.to_reference_format(got[0])
    assert len(bboxes) == len(segms) == engine.num_classes == 5
    for c in range(5):
        sel = got[0]["labels"] == c
        assert bboxes[c].shape == (sel.sum(), 5) and bboxes[c].dtype == np.float32
        np.testing.assert_array_equal(bboxes[c], jb[c])
        assert len(segms[c]) == sel.sum() == len(js[c])
        for m, jm in zip(segms[c], js[c]):
            np.testing.assert_array_equal(m, jm)


def test_engine_without_pasting_returns_mask_probs(engines):
    jax_engine, engine = engines
    tiles = blob_tiles(np.random.RandomState(2), 1, TILE, blobs=3)
    from nuhtc_tpu_torch.apis.inference import InferenceEngine

    raw = InferenceEngine(engine.model, batch_size=2, tile_size=TILE, paste_masks=False)
    res = raw.run_batch(tiles)[0]
    assert "masks" not in res and res["mask_probs"].shape == (len(res["scores"]), 28, 28)
    full = engine.run_batch(tiles)[0]
    np.testing.assert_array_equal(res["boxes"], full["boxes"])
    assert raw.to_reference_format(res)[1] == [[]] * 5
    # TTA without masks dedups on box IoU
    merged = TTAEngine(raw).run_batch(tiles)[0]
    assert 0 < len(merged["scores"]) <= 3 * len(res["scores"]) and "masks" not in merged


def test_tta_matches_jax_tta(engines):
    jax_engine, engine = engines
    tiles = blob_tiles(np.random.RandomState(3), 2, TILE, blobs=3)
    tiles[1] = tiles[1][:36, :48]
    with f32():
        want = JaxTTA(jax_engine).run_batch(tiles)
    got = TTAEngine(engine).run_batch(tiles)
    per_view = [engine.run_batch(tiles)]
    for g, w, single in zip(got, want, per_view[0]):
        assert _assert_same_detections(g, w) > 0
        assert len(single["scores"]) <= len(g["scores"]) <= 3 * len(single["scores"])
    # a full-size tile keeps its boxes inside the tile through the flips
    assert got[0]["boxes"].min() >= -1e-3 and got[0]["boxes"].max() <= TILE + 1e-3


@pytest.mark.parametrize("tier", ["block", "attn", "none"])
def test_swin_tiers_match_jax_on_the_cpu(tier):
    """On the CPU every kernel tier takes the exact f32 path."""
    cfg = dict(embed_dims=16, depths=(2, 2), num_heads=(2, 4), window_size=4)
    img = np.random.RandomState(0).randn(2, 44, 36, 3).astype(np.float32)
    jsw = JaxSwin(**cfg, drop_path_rate=0.0, out_indices=(0, 1))
    with f32():
        variables = jax.jit(jsw.init)(jax.random.PRNGKey(0), jnp.asarray(img))
        want = jax.jit(jsw.apply)(variables, jnp.asarray(img))
    model = SwinTransformer(**cfg, out_indices=(0, 1), kernel=tier).eval()
    model.load_state_dict(port_sd("backbone", variables, "backbone."), strict=True)
    assert all(blk.kernel == tier for st in model.stages for blk in st.blocks)
    with torch.no_grad():
        got = model(t(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        SwinTransformer(**cfg, kernel="fused")
