"""The ``_Lite_Fuse`` family through the port against ``nuhtc_tpu``: the
watershed ops, the morphology they use, the seg branch, ``fuse_test`` and
the seg branch's losses.

- ``edt``, ``watershed``, ``watershed_segmentation`` (with and without a
  distance map) and ``watershed_proposals_from_dist``: exactly equal to the
  JAX functions on seeded smooth logits, the JAX side run op by op (its
  jitted blur fuses the products and adds into other roundings, 5e-7 apart,
  which could flip a pixel on the threshold). ``edt`` also against
  ``scipy.ndimage.distance_transform_edt`` with ``tests/test_watershed.py``'s
  bounds (exact on boxes; on random blobs within 1.5 px, off by more than
  1e-3 at < 2 % of the pixels: jump flooding's corner cases).
- ``gaussian_blur5``: exactly equal to the JAX function run op by op, and
  within 1e-6 of its jitted form; ``binary_close`` exactly equal.
- ``HTCSegBranch``: seg, distance and class outputs within 1e-4 of JAX's;
  ``soft_distance_target`` exactly equal.
- ``fuse_test`` of the tiny config with the ``_Lite_Fuse`` roi head (f32,
  HIGHEST precision, scale factor 2, 128² input and a 64² original frame,
  B2, 5 classes, weights carried by ``state_dict_from_jax``, the seg
  logits' bias centred on each class's median so that the maps hold
  instances) against the JAX model's, jitted: the
  seg logits in the original frame within 1e-4. The fused instances: a
  class map's instances depend on the sign of its blurred logit at every
  pixel, and a pixel whose logit lies within the packages' f32 noise of 0
  (1e-4 here, after a deep network) can take either side. So for each of
  the B·C class maps either the instance outputs are exactly equal (boxes,
  valid, instance maps, roots), or the thresholded maps differ only at
  pixels within 1e-4 of 0. On this seed every one of the 10 maps is
  exactly equal.
- ``loss_binary_seg`` with ``gt_ismask`` (some instances box-only, whose
  pixels are left out) and without it, and with ``fuse_aux_losses`` the
  ``loss_dist`` and ``loss_global_cls``: every loss of ``compute_losses``
  within 1e-4 relative of JAX's on shared draws
  (``test_torch_train_step.run_both``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch

from nuhtc_tpu.models.extra_heads import HTCSegBranch as JSegBranch
from nuhtc_tpu.models.extra_heads import soft_distance_target as j_soft_distance
from nuhtc_tpu.ops import morphology as JM
from nuhtc_tpu.ops import watershed as JW
from nuhtc_tpu_torch.models.extra_heads import HTCSegBranch, soft_distance_target
from nuhtc_tpu_torch.ops import morphology as M
from nuhtc_tpu_torch.ops.components import resize_align_corners
from nuhtc_tpu_torch.ops import watershed as W
from nuhtc_tpu_torch.registry import HEADS
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_cus import SIDE, shared_models
from test_torch_train_step import _batch, assert_losses_match, run_both
from torch_port_util import f32, n, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

FUSE = "HybridTaskCascadeRoIHead_Lite_Fuse"
TOL = 1e-4


def smooth_logits(rng, shape, gain):
    """Seeded logits with blobs: gaussian-filtered noise over the last two dims."""
    sigma = (0,) * (len(shape) - 2) + (3, 3)
    return (ndi.gaussian_filter(rng.randn(*shape), sigma) * gain).astype(np.float32)


def test_edt_matches_jax_and_scipy():
    rng = np.random.RandomState(0)
    box = np.zeros((48, 64), bool)
    box[10:30, 12:40] = True
    box[35:44, 50:60] = True
    blobs = [ndi.binary_dilation(rng.rand(48, 64) > 0.92, iterations=3) for _ in range(3)]
    masks = np.stack([box] + blobs)
    got = n(W.edt(t(masks)))
    for g, m in zip(got, masks):
        np.testing.assert_array_equal(g, np.asarray(JW.edt(jnp.asarray(m))))
        want = ndi.distance_transform_edt(m)
        assert np.abs(g - want).max() <= 1.5 and (np.abs(g - want) > 1e-3).mean() < 0.02
    np.testing.assert_allclose(got[0], ndi.distance_transform_edt(box), atol=1e-4)


def test_watershed_matches_jax():
    rng = np.random.RandomState(1)
    masks = np.stack([ndi.binary_dilation(rng.rand(40, 56) > 0.96, iterations=4)
                      for _ in range(3)])
    dist = np.stack([ndi.distance_transform_edt(m) for m in masks]).astype(np.float32)
    markers = np.stack([ndi.label(d > 2.0)[0] for d in dist]).astype(np.int32)
    got = n(W.watershed(t(-dist), t(markers), t(masks)))
    for g, d, mk, m in zip(got, dist, markers, masks):
        want = np.asarray(JW.watershed(jnp.asarray(-d), jnp.asarray(mk), jnp.asarray(m)))
        np.testing.assert_array_equal(g, want)
    assert sum(len(np.unique(g)) - 1 for g in got) > 10  # basins over the three maps


@pytest.mark.parametrize("with_dist", [False, True])
def test_watershed_segmentation_matches_jax(with_dist):
    rng = np.random.RandomState(2)
    seg = smooth_logits(rng, (3, 64, 64), 40.0)
    dist = np.abs(smooth_logits(rng, (64, 64), 30.0)) if with_dist else None
    got = [n(x) for x in W.watershed_segmentation(
        t(seg), None if dist is None else t(dist), max_instances=32)]
    want = [np.asarray(x) for x in JW.watershed_segmentation(
        jnp.asarray(seg.transpose(1, 2, 0)), None if dist is None else jnp.asarray(dist),
        max_instances=32)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 5 and (got[0][got[1]][:, 4] == np.float32(0.36)).all()


def test_watershed_proposals_from_dist_matches_jax():
    rng = np.random.RandomState(3)
    seg = smooth_logits(rng, (2, 64, 64), 40.0)
    dist = smooth_logits(rng, (2, 64, 64), 40.0)
    boxes, valid = (n(x) for x in W.watershed_proposals_from_dist(t(seg), t(dist),
                                                                  max_components=32))
    for i in range(2):
        jb, jv = JW.watershed_proposals_from_dist(jnp.asarray(seg[i]), jnp.asarray(dist[i]),
                                                  max_components=32)
        np.testing.assert_array_equal(boxes[i], np.asarray(jb))
        np.testing.assert_array_equal(valid[i], np.asarray(jv))
    assert valid.sum() > 5


def test_gaussian_blur5_and_binary_close_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 40, 52).astype(np.float32) * 3
    got = n(M.gaussian_blur5(t(x)))
    np.testing.assert_array_equal(got, np.asarray(JM.gaussian_blur5(jnp.asarray(x))))
    np.testing.assert_allclose(got, np.asarray(jax.jit(JM.gaussian_blur5)(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    m = rng.rand(3, 40, 52) > 0.6
    np.testing.assert_array_equal(n(M.binary_close(t(m))), np.asarray(JM.binary_close(
        jnp.asarray(m))))


def test_seg_branch_and_soft_distance_match_jax():
    assert HEADS.get("HTCSegBranch") is HTCSegBranch and "HTCSegHead" in HEADS
    rng = np.random.RandomState(5)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    sem = rng.randn(2, 16, 16, 32).astype(np.float32)
    jhead = JSegBranch(in_channels=32, conv_out_channels=32, num_classes=5)
    variables = jax.jit(jhead.init)(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(sem))
    with f32():
        want = jax.jit(jhead.apply)(variables, jnp.asarray(img), jnp.asarray(sem))
    head = HTCSegBranch(in_channels=32, conv_out_channels=32, num_classes=5)
    sd = state_dict_from_jax({"seg_branch": jax.tree.map(np.asarray, variables["params"])})
    head.load_state_dict({k[len("roi_head.seg_branch."):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = head(t(img), t(sem))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(n(g), np.asarray(w), atol=TOL, rtol=0)
    masks = rng.rand(4, 40, 40) > 0.3
    np.testing.assert_array_equal(n(soft_distance_target(t(masks))),
                                  np.asarray(j_soft_distance(jnp.asarray(masks))))


FUSE_SIDE = 2 * SIDE  # fuse_test's input: the original frame is SIDE²


@pytest.fixture(scope="module")
def fuse():
    """The shared models, the seg logits' bias moved to the median of each
    class's logits over fuse_test's images (so about half of each class map
    lies above 0 and the maps hold instances), and those images."""
    model, params, port = shared_models(FUSE, scale_factor=2.0)
    img = np.random.RandomState(6).randn(2, FUSE_SIDE, FUSE_SIDE, 3).astype(np.float32)
    with torch.no_grad():
        _, sf = port.roi_head.semantic_head(port.extract_feats(t(img)))
        seg = port.roi_head.seg_branch(t(img), sf)[1]
    bias = params["params"]["seg_branch"]["conv_seg"]["bias"]
    bias -= n(seg.reshape(-1, seg.shape[-1]).median(dim=0).values)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return model, params, port, img


def test_fuse_test_matches_jax(fuse):
    model, params, port, img = fuse

    def seg_ori(m, x):
        from nuhtc_tpu.ops.components import resize_align_corners

        _, sf = m.semantic_head(m.extract_feats(x))
        return resize_align_corners(m.seg_branch(x, sf)[1].transpose(0, 3, 1, 2), (SIDE, SIDE))

    with f32():
        want_seg = np.asarray(jax.jit(lambda p, x: model.apply(p, x, method=seg_ori))(
            params, jnp.asarray(img)))
        want = jax.jit(lambda p, x: model.apply(p, x, method="fuse_test"))(params,
                                                                           jnp.asarray(img))
    got = port.fuse_test(t(img))
    with torch.no_grad():
        _, sf = port.roi_head.semantic_head(port.extract_feats(t(img)))
        got_seg = n(resize_align_corners(
            port.roi_head.seg_branch(t(img), sf)[1].permute(0, 3, 1, 2), (SIDE, SIDE)))
    np.testing.assert_allclose(got_seg, want_seg, atol=TOL, rtol=0)
    assert got["fuse_inst"].shape == (2, 5, SIDE, SIDE)
    assert got["fuse_boxes"].shape == (2, 5, 256, 5)
    blurred = n(M.gaussian_blur5(t(want_seg)))
    exact = 0
    for b in range(2):
        for c in range(5):
            same = all(np.array_equal(n(got[k][b, c]), np.asarray(want[k][b, c]))
                       for k in ("fuse_boxes", "fuse_valid", "fuse_inst", "fuse_roots"))
            if not same:
                flips = (n(M.gaussian_blur5(t(got_seg[b, c]))) > 0) != (blurred[b, c] > 0)
                assert flips.any() and (np.abs(blurred[b, c][flips]) < TOL).all(), (b, c)
            exact += same
    assert exact == 10
    assert got["fuse_valid"].sum() > 10


def _fuse_batch():
    """test_torch_train_step's batch with a class map in ``gt_semantic``
    (label + 1 inside each box) and the second half of the instances box-only."""
    img, batch = _batch(np.random.RandomState(7))
    sem = np.zeros_like(batch["gt_semantic"])
    for i in range(img.shape[0]):
        for j in np.nonzero(batch["gt_valid"][i])[0]:
            x1, y1, x2, y2 = (batch["gt_boxes"][i, j] / 4).astype(int)
            sem[i, y1:y2 + 1, x1:x2 + 1] = batch["gt_labels"][i, j] + 1
    batch["gt_semantic"] = sem
    batch["gt_ismask"][:, batch["gt_ismask"].shape[1] // 2:] = 0.0
    return img, batch


@pytest.mark.parametrize("with_ismask", [True, False])
def test_seg_branch_losses_match_jax(fuse, with_ismask):
    model, params, port, _ = fuse
    model = model.clone(fuse_aux_losses=True)
    port.fuse_aux_losses = True
    img, batch = _fuse_batch()
    if not with_ismask:
        batch.pop("gt_ismask")
    port.train()
    try:
        jl, _, _, tl, _, _ = run_both(model, params, port, img, batch,
                                      np.zeros((3, 5), np.float32), grad=False)
    finally:
        port.eval()
        port.fuse_aux_losses = False
    assert_losses_match(jl, tl)
    for k in ("loss_binary_seg", "loss_dist", "loss_global_cls"):
        assert tl[k].item() > 1e-3, k
