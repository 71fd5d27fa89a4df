"""Neck, heads, RoI ops and NMS of the PyTorch port against the JAX package.

Same numpy inputs, same weights (carried by ``state_dict_from_jax``), f32:
FPN, RPN head + proposals, semantic head, ``roi_align`` against
``exact=True``, ``attention_roi_features``, bbox head + seesaw scores and the
mask head at atol 1e-4; NMS keep sets exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.models.bbox_head import Shared2FCBBoxHeadWithProb as JBBox
from nuhtc_tpu.models.bbox_head import seesaw_activation as j_seesaw
from nuhtc_tpu.models.fpn import FPN as JFPN
from nuhtc_tpu.models.mask_head import FusedSemanticHead as JSem
from nuhtc_tpu.models.mask_head import HTCMaskHead as JMask
from nuhtc_tpu.models.roi_extractor import attention_roi_features as j_attn_feats
from nuhtc_tpu.models.rpn_head import RPNHead as JRPN
from nuhtc_tpu.models.rpn_head import rpn_proposals as j_rpn_proposals
from nuhtc_tpu.ops import nms as jnms
from nuhtc_tpu.ops.roi_align import roi_align as j_roi_align
from nuhtc_tpu_torch.models.bbox_head import Shared2FCBBoxHeadWithProb, seesaw_activation
from nuhtc_tpu_torch.models.fpn import FPN
from nuhtc_tpu_torch.models.mask_head import FusedSemanticHead, HTCMaskHead
from nuhtc_tpu_torch.models.roi_extractor import attention_roi_features
from nuhtc_tpu_torch.models.rpn_head import RPNHead, rpn_proposals
from nuhtc_tpu_torch.ops import nms as tnms
from nuhtc_tpu_torch.ops.roi_align import roi_align
from torch_port_util import f32, n, port_sd, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

ATOL = 1e-4
C = 16
SIZES = (16, 8, 4, 2)  # a 64² input at strides 4..32


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(n(got), np.asarray(want), atol=atol, rtol=0)


def _apply(module, *args):
    """JAX init + apply in f32, jitted."""
    with f32():
        variables = jax.jit(module.init)(jax.random.PRNGKey(0), *args)
        return variables, jax.jit(module.apply)(variables, *args)


@pytest.fixture(scope="module")
def pyramid():
    rng = np.random.RandomState(0)
    return [rng.randn(2, s, s, C).astype(np.float32) for s in SIZES]


def _boxes(rng, r, extent, min_size=1.0):
    xy = rng.uniform(-4, extent - 4, (r, 2))
    wh = rng.uniform(min_size, extent * 0.8, (r, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_fpn():
    rng = np.random.RandomState(6)
    chans = (8, 16, 32, 64)
    feats = [rng.randn(2, s, s, c).astype(np.float32) for s, c in zip(SIZES, chans)]
    jm = JFPN(in_channels=chans, out_channels=8)
    variables, want = _apply(jm, tuple(jnp.asarray(f) for f in feats))
    m = FPN(in_channels=chans, out_channels=8)
    m.load_state_dict(port_sd("neck", variables, "neck."), strict=True)
    with torch.no_grad():
        got = m([t(f) for f in feats])
    for g, w in zip(got, want):
        _close(g, w)


def test_semantic_head(pyramid):
    jm = JSem(in_channels=C, conv_out_channels=C)
    variables, (wl, we) = _apply(jm, tuple(jnp.asarray(f) for f in pyramid))
    m = FusedSemanticHead(in_channels=C, conv_out_channels=C)
    m.load_state_dict(port_sd("semantic_head", variables, "roi_head.semantic_head."),
                      strict=True)
    with torch.no_grad():
        gl, ge = m([t(f) for f in pyramid])
    _close(gl, wl)
    _close(ge, we)


def test_rpn_head_and_proposals(pyramid):
    jm = JRPN(in_channels=C, feat_channels=C)
    variables, (wc, wr) = _apply(jm, tuple(jnp.asarray(f) for f in pyramid))
    m = RPNHead(in_channels=C, feat_channels=C)
    m.load_state_dict(port_sd("rpn_head", variables, "rpn_head."), strict=True)
    with torch.no_grad():
        gc, gr = m([t(f) for f in pyramid])
    for g, w in zip(gc + gr, list(wc) + list(wr)):
        _close(g, w)

    kw = dict(nms_pre=200, max_per_img=60, nms_iou=0.7, min_bbox_size=2.0)
    cls = [np.asarray(c) for c in wc]
    reg = [np.asarray(r) * 0.3 for r in wr]
    with f32():
        jb, js, jv = jax.jit(lambda c, r: j_rpn_proposals(c, r, (64, 64), **kw))(cls, reg)
    tb, ts, tv = rpn_proposals([t(c) for c in cls], [t(r) for r in reg], (64, 64), **kw)
    assert int(np.asarray(jv).sum()) > 20
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    _close(tb, jb)
    _close(ts, js, atol=1e-6)


@pytest.mark.parametrize("out_size,sampling_ratio,pool_from", [(7, 2, None), (14, 0, None),
                                                               (7, 0, 14)])
def test_roi_align_matches_exact(out_size, sampling_ratio, pool_from):
    rng = np.random.RandomState(1)
    feat = rng.randn(1, 64, 56, 8).astype(np.float32)
    rois = _boxes(rng, 40, 60.0)
    rois[:3] = [[-6, -6, 2, 3], [50, 58, 70, 70], [10, 10, 10.3, 10.2]]  # out of range, tiny
    want = j_roi_align(jnp.asarray(feat[0]), jnp.asarray(rois), 1.0, out_size,
                       sampling_ratio=sampling_ratio, exact=True, pool_from=pool_from)
    got = roi_align(t(feat), t(rois[None]), 1.0, out_size, sampling_ratio=sampling_ratio,
                    pool_from=pool_from)
    _close(got[0], want)


def test_attention_roi_features(pyramid):
    rng = np.random.RandomState(2)
    rois = np.stack([_boxes(rng, 30, 64.0, min_size=4.0) for _ in range(2)])
    for out_size, sr in ((7, 2), (14, 0)):
        got = attention_roi_features([t(f) for f in pyramid], t(rois), out_size, sr)
        for i in range(2):
            want = j_attn_feats([jnp.asarray(f[i]) for f in pyramid], jnp.asarray(rois[i]),
                                out_size, sr, exact=True)
            _close(got[i], want)


def test_bbox_head_and_seesaw():
    rng = np.random.RandomState(3)
    feats = rng.randn(12, 7, 7, 8).astype(np.float32)
    jm = JBBox(num_classes=5, in_channels=8)
    variables, (wc, wr) = _apply(jm, jnp.asarray(feats))
    m = Shared2FCBBoxHeadWithProb(num_classes=5, in_channels=8)
    m.load_state_dict(port_sd("bbox_heads_0", variables, "roi_head.bbox_head.0."), strict=True)
    with torch.no_grad():
        gc, gr = m(t(feats))
    _close(gc, wc)
    _close(gr, wr)
    _close(seesaw_activation(gc), j_seesaw(wc), atol=1e-6)


def test_mask_head():
    rng = np.random.RandomState(4)
    feats = rng.randn(6, 14, 14, 8).astype(np.float32)
    jm = JMask(in_channels=8, conv_out_channels=8)
    with f32():
        variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, res_feat=None,
                                              return_feat=False))(jnp.asarray(feats))
        want = jax.jit(lambda v, x: jm.apply(v, x, res_feat=None, return_feat=False))(
            variables, jnp.asarray(feats))
    m = HTCMaskHead(in_channels=8, conv_out_channels=8)
    m.load_state_dict(port_sd("mask_head", variables, "roi_head.mask_head."), strict=True)
    with torch.no_grad():
        got = m(t(feats))
    assert tuple(got.shape) == want.shape == (6, 28, 28, 1)
    _close(got, want)


def test_batched_nms_keep_sets():
    rng = np.random.RandomState(5)
    b, count = 2, 300
    boxes = np.stack([_boxes(rng, count, 60.0, min_size=3.0) for _ in range(b)])
    scores = rng.rand(b, count).astype(np.float32)
    labels = rng.randint(0, 3, (b, count)).astype(np.int32)
    valid = rng.rand(b, count) > 0.1
    for iou in (0.5, 0.7):
        tb, ts, ti, tv = tnms.batched_nms(t(boxes), t(scores), t(labels), t(valid), iou, count)
        for i in range(b):
            jb, js, ji, jv = jnms.batched_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                              jnp.asarray(labels[i]), jnp.asarray(valid[i]),
                                              iou, count)
            jv = np.asarray(jv)
            assert 10 < jv.sum() < count
            np.testing.assert_array_equal(n(tv[i]), jv)
            np.testing.assert_array_equal(n(ti[i])[jv], np.asarray(ji)[jv])
            np.testing.assert_array_equal(n(tb[i]), np.asarray(jb))
            np.testing.assert_array_equal(n(ts[i]), np.asarray(js))


@pytest.mark.parametrize("classes, score_thr, max_per_img, candidates", [
    (5, 0.35, 500, 2048),  # NuHTC on PanNuke: every (roi, class) pair a candidate
    (8, 0.05, 100, 1024),  # Mask R-CNN on NuCLS: the top 1,024 of 2,400 pairs
], ids=["nuhtc", "maskrcnn"])
def test_multiclass_nms_one_box_per_roi_equals_one_per_class(classes, score_thr, max_per_img,
                                                             candidates):
    """A roi's box (B, P, 4), gathered by roi, gives exactly what the same
    box repeated for every class (B, P, C, 4), gathered by candidate, gives."""
    rng = np.random.RandomState(7)
    b, p = 2, 300
    boxes = t(np.stack([_boxes(rng, p, 60.0, min_size=3.0) for _ in range(b)]))
    scores = t(rng.dirichlet(np.full(classes + 1, 0.3), (b, p)).astype(np.float32))
    valid = t(rng.rand(b, p) > 0.1)
    args = (classes, score_thr, 0.5, max_per_img, candidates)
    got = tnms.multiclass_nms(boxes, scores, valid, *args)
    want = tnms.multiclass_nms(boxes[:, :, None].expand(b, p, classes, 4), scores, valid, *args)
    assert set(got) == set(want) == {"boxes", "scores", "labels", "probs", "valid"}
    for key in got:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        assert torch.equal(got[key], want[key]), key
    assert got["boxes"].shape == (b, max_per_img, 4) and (got["valid"].sum(1) > 10).all()
    assert set(n(got["labels"][got["valid"]]).tolist()) == set(range(classes))
