"""Losses, assigners, samplers and targets of the port against ``nuhtc_tpu``.

Same numpy inputs through both, f32 on the CPU. Losses agree within 1e-6
relative (and their gradients, where a loss is differentiated in training,
within 1e-6 of the gradient's scale); assignments and samples are exactly
equal when both samplers take the same uniform draws (``jax.random.uniform``
and the port's ``targets.uniform`` are patched to hand out the same arrays,
quantised so that ties occur); bbox targets within 1e-6, mask targets exactly.
``compute_losses`` with the instance-balanced and the OHEM sampler: every
loss within 1e-4 relative of the JAX package's on the setup of
test_torch_train_step.py (loss values only; that file holds the gradients).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.models import losses as JL
from nuhtc_tpu.train import samplers as JS
from nuhtc_tpu.train import targets as JT
from nuhtc_tpu_torch.models import losses as L
from nuhtc_tpu_torch.train import samplers as S
from nuhtc_tpu_torch.train import targets as T
from test_torch_train_step import assert_losses_match, run_both, shared_setup
from torch_port_util import n, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(n(got).astype(np.float64), want, atol=rtol * scale, rtol=0)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_elementwise_losses(rng):
    x = rng.randn(64, 7).astype(np.float32) * 3
    y = (rng.rand(64, 7) > 0.5).astype(np.float32)
    p = rng.randn(64, 4).astype(np.float32)
    q = rng.randn(64, 4).astype(np.float32)
    _close(L.smooth_l1(t(p), t(q), beta=1 / 9), JL.smooth_l1(p, q, beta=1 / 9))
    _close(L.sigmoid_ce(t(x), t(y)), JL.sigmoid_ce(x, y))
    _close(L.sigmoid_focal(t(x), t(y)), JL.sigmoid_focal(x, y))
    labels = rng.randint(0, 8, 64)  # 7 is out of range: zero loss
    _close(L.softmax_ce(t(x), t(labels)), JL.softmax_ce(x, labels))
    w = (rng.rand(64) > 0.3).astype(np.float32)
    for red in ("mean", "sum", "none"):
        _close(L.weight_reduce(t(x[:, 0]), t(w), red), JL.weight_reduce(x[:, 0], w, red))
    _close(L.weight_reduce(t(x[:, 0]), None, "mean", 5.0),
           JL.weight_reduce(x[:, 0], None, "mean", 5.0))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_dice_and_trunc(rng, reduction):
    pred = rng.rand(12, 28, 28).astype(np.float32)
    tgt = (rng.rand(12, 28, 28) > 0.6).astype(np.float32)
    w = (rng.rand(12) > 0.4).astype(np.float32)
    _close(L.dice_loss(t(pred), t(tgt), reduction=reduction),
           JL.dice_loss(pred, tgt, reduction=reduction))
    _close(L.dice_loss(t(pred), t(tgt), t(w), reduction=reduction),
           JL.dice_loss(pred, tgt, w, reduction=reduction))
    zero = np.zeros(12, np.float32)
    _close(L.dice_loss(t(pred), t(tgt), t(zero), reduction=reduction),
           JL.dice_loss(pred, tgt, zero, reduction=reduction))
    _close(L.trunc_loss(t(pred), t(tgt)), JL.trunc_loss(pred, tgt))


def test_loss_classes(rng):
    logits = rng.randn(10, 3, 8, 8).astype(np.float32)
    tgt = (rng.rand(10, 3, 8, 8) > 0.5).astype(np.float32)
    tgt[0, 0, 0, :3] = 2.0  # PartialDiceLoss ignores labels other than 0 and 1
    w = rng.rand(10).astype(np.float32)
    for name, kw in (("DiceLoss", {}), ("SmoothTruncatedLoss", {}), ("PartialDiceLoss", {})):
        _close(L.LOSSES.get(name)(**kw)(t(logits), t(tgt), t(w)),
               JL.LOSSES.get(name)(**kw)(logits, tgt, w))
    cls = rng.randn(40, 5).astype(np.float32)
    lab = rng.randint(0, 6, 40)
    _close(L.MultiLabelFocalLoss()(t(cls), t(lab)), JL.MultiLabelFocalLoss()(cls, lab))
    a, b = rng.rand(40, 4).astype(np.float32), rng.rand(40, 4).astype(np.float32)
    for name in ("WeightMSELoss", "WeightEXPLoss", "SmoothL1Loss"):
        _close(L.LOSSES.get(name)()(t(a), t(b)), JL.LOSSES.get(name)()(a, b))
    _close(L.CrossEntropyLoss()(t(cls), t(lab)), JL.CrossEntropyLoss()(cls, lab))
    _close(L.CrossEntropyLoss(use_sigmoid=True)(t(a), t(b > 0.5)),
           JL.CrossEntropyLoss(use_sigmoid=True)(a, b > 0.5))


def test_seesaw_loss_values_counts_and_gradient(rng):
    c = 5
    score = rng.randn(200, c + 2).astype(np.float32) * 2
    labels = rng.randint(0, c + 1, 200)
    weights = (rng.rand(200) > 0.2).astype(np.float32)
    cum = np.array([30.0, 0.0, 4.0, 120.0, 9.0], np.float32)

    def jfn(s):
        lc, lo, new = JL.seesaw_loss(s, labels, weights, cum)
        return lc + lo, (lc, lo, new)

    (_, (jlc, jlo, jnew)), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(score))
    s = t(score).requires_grad_(True)
    lc, lo, new = L.seesaw_loss(s, t(labels), t(weights), t(cum))
    (lc + lo).backward()
    _close(lc, jlc)
    _close(lo, jlo)
    np.testing.assert_array_equal(n(new), np.asarray(jnew))
    _close(s.grad, jgrad)


class _Draws:
    """Hands out the same uniform arrays to both packages: JAX's sampler
    calls ``jax.random.uniform`` per image, the port's ``targets.uniform``
    once per batch."""

    def __init__(self, rp, rn):
        self.rp, self.rn = rp, rn
        self.jax_calls = 0

    def jax_uniform(self, key, shape, *a, **k):
        i, which = divmod(self.jax_calls, 2)
        self.jax_calls += 1
        return jnp.asarray((self.rn if which else self.rp)[i])

    def port(self):
        seq = iter([self.rp, self.rn])
        return lambda gen, shape, device: t(next(seq)).to(device)


def _candidates(rng, b, n, g):
    gt = np.zeros((b, g, 4), np.float32)
    cx, cy = rng.uniform(10, 90, (2, b, g))
    half = rng.uniform(3, 12, (b, g))
    gt[...] = np.stack([cx - half, cy - half, cx + half, cy + half], -1)
    gt_valid = np.ones((b, g), bool)
    gt_valid[1, g - 3:] = False  # padding slots
    gt_labels = rng.randint(0, 5, (b, g)).astype(np.int32)
    # jittered copies of the gts (positives and low-quality matches) + random boxes
    src = gt[:, rng.randint(0, g, n)]
    boxes = src + rng.uniform(-6, 6, (b, n, 4)).astype(np.float32)
    rand = rng.uniform(0, 100, (b, n, 2)).astype(np.float32)
    far = rng.rand(b, n) < 0.5
    boxes[far] = np.concatenate([rand, rand + rng.uniform(2, 20, (b, n, 2))], -1)[far]
    boxes[:, :5] = gt[:, :5]  # exact duplicates: IoU ties
    valid = rng.rand(b, n) > 0.1
    return boxes.astype(np.float32), valid, gt, gt_valid, gt_labels


def _jax_assign(boxes, valid, gt, gt_valid, gt_labels, **kw):
    return [JT.max_iou_assign(boxes[i], valid[i], gt[i], gt_valid[i], gt_labels[i], **kw)
            for i in range(len(boxes))]


def _assert_same_assign(got, want):
    for field in ("gt_inds", "labels", "max_iou"):
        np.testing.assert_array_equal(
            n(getattr(got, field)), np.stack([np.asarray(getattr(w, field)) for w in want]))


def _assert_same_sample(got, want):
    for field in ("idx", "is_pos", "valid", "gt_inds", "labels"):
        np.testing.assert_array_equal(
            n(getattr(got, field)), np.stack([np.asarray(getattr(w, field)) for w in want]),
            err_msg=field)


@pytest.mark.parametrize("thr", [(0.5, 0.5, 0.5), (0.7, 0.3, 0.3), (0.6, 0.6, 0.0)])
def test_max_iou_assign(rng, thr):
    boxes, valid, gt, gt_valid, gt_labels = _candidates(rng, 3, 300, 12)
    gt_valid[2] = False  # an image without gts: every valid candidate is background
    kw = dict(pos_thr=thr[0], neg_thr=thr[1], min_pos_iou=thr[2])
    got = T.max_iou_assign(t(boxes), t(valid), t(gt), t(gt_valid), t(gt_labels), **kw)
    want = _jax_assign(boxes, valid, gt, gt_valid, gt_labels, **kw)
    _assert_same_assign(got, want)
    assert (n(got.gt_inds)[2][valid[2]] == 0).all()
    assert (n(got.gt_inds) > 0).sum() > 20


@pytest.mark.parametrize("sampler", ["random", "instance_balanced"])
@pytest.mark.parametrize("n_cand,num", [(300, 128), (60, 128)])
def test_samplers_with_shared_draws(rng, monkeypatch, sampler, n_cand, num):
    b, g = 3, 12
    boxes, valid, gt, gt_valid, gt_labels = _candidates(rng, b, n_cand, g)
    kw = dict(pos_thr=0.5, neg_thr=0.5, min_pos_iou=0.5)
    assign = T.max_iou_assign(t(boxes), t(valid), t(gt), t(gt_valid), t(gt_labels), **kw)
    jassign = _jax_assign(boxes, valid, gt, gt_valid, gt_labels, **kw)
    # draws on a grid of 1/8: many equal keys, so the tie rules decide
    draws = _Draws(*(np.floor(rng.rand(2, b, n_cand) * 8).astype(np.float32) / 8))
    monkeypatch.setattr(T, "uniform", draws.port())
    monkeypatch.setattr(jax.random, "uniform", draws.jax_uniform)
    if sampler == "random":
        got = T.random_sample(None, assign, num, 0.25, 5)
        want = [JT.random_sample(jax.random.PRNGKey(0), a, num, 0.25, 5) for a in jassign]
    else:
        got = S.instance_balanced_sample(None, assign, num, 0.25, 5, g)
        want = [JS.instance_balanced_sample(jax.random.PRNGKey(0), a, num, 0.25, 5, g)
                for a in jassign]
    assert draws.jax_calls == 2 * b
    _assert_same_sample(got, want)
    assert n(got.is_pos).sum() > 10 and n(got.valid).sum() > n(got.is_pos).sum()


def test_ohem_sample(rng):
    b, g = 2, 10
    boxes, valid, gt, gt_valid, gt_labels = _candidates(rng, b, 400, g)
    kw = dict(pos_thr=0.5, neg_thr=0.5, min_pos_iou=0.5)
    assign = T.max_iou_assign(t(boxes), t(valid), t(gt), t(gt_valid), t(gt_labels), **kw)
    jassign = _jax_assign(boxes, valid, gt, gt_valid, gt_labels, **kw)
    losses = np.round(rng.rand(b, 400) * 16).astype(np.float32)  # ties among the losses
    got = S.ohem_sample(t(losses), assign, 128, 0.25, 5)
    want = [JS.ohem_sample(losses[i], jassign[i], 128, 0.25, 5) for i in range(b)]
    _assert_same_sample(got, want)


def test_stage_and_mask_targets(rng, monkeypatch):
    b, g, n_cand = 2, 8, 200
    boxes, valid, gt, gt_valid, gt_labels = _candidates(rng, b, n_cand, g)
    kw = dict(pos_thr=0.5, neg_thr=0.5, min_pos_iou=0.5)
    assign = T.max_iou_assign(t(boxes), t(valid), t(gt), t(gt_valid), t(gt_labels), **kw)
    jassign = _jax_assign(boxes, valid, gt, gt_valid, gt_labels, **kw)
    draws = _Draws(*rng.rand(2, b, n_cand).astype(np.float32))
    monkeypatch.setattr(T, "uniform", draws.port())
    monkeypatch.setattr(jax.random, "uniform", draws.jax_uniform)
    samp = T.random_sample(None, assign, 64, 0.25, 5)
    jsamp = [JT.random_sample(jax.random.PRNGKey(0), a, 64, 0.25, 5) for a in jassign]
    rois = torch.gather(t(boxes), 1, samp.idx[..., None].expand(-1, -1, 4))
    stds = (0.1, 0.1, 0.2, 0.2)
    tgt, w = T.encode_stage_targets(rois, samp, t(gt), stds)
    for i in range(b):
        jt, jw = JT.encode_stage_targets(boxes[i][np.asarray(jsamp[i].idx)], jsamp[i], gt[i],
                                         stds)
        _close(tgt[i], jt)
        np.testing.assert_array_equal(n(w[i]), np.asarray(jw))
    # mask targets: patches of blobs and of a 0.5-valued rim, proposals jittered
    m = 64
    yy, xx = np.mgrid[:m, :m]
    patches = np.zeros((b, g, m, m), np.float32)
    for i in range(b):
        for j in range(g):
            r = rng.uniform(10, 30)
            d = np.hypot(yy - 31.5 + rng.uniform(-5, 5), xx - 31.5)
            patches[i, j] = (d < r) + 0.5 * ((d >= r) & (d < r + 1.5))
    props = t(gt[:, rng.randint(0, g, 50)] + rng.uniform(-4, 4, (b, 50, 4)).astype(np.float32))
    gi = t(rng.randint(0, g, (b, 50)))
    got = T.mask_targets_from_patches(props, gi, t(gt), t(patches))
    for i in range(b):
        want = JT.mask_targets_from_patches(n(props[i]), n(gi[i]), gt[i], patches[i])
        np.testing.assert_array_equal(n(got[i]), np.asarray(want))
    assert 0.1 < n(got).mean() < 0.9


@pytest.mark.parametrize("sampler", ["instance_balanced", "ohem"])
def test_compute_losses_other_samplers(sampler):
    model, params, port, img, batch, cum = shared_setup(sampler)
    jl, jcum, _, tl, tcum, draws = run_both(model, params, port, img, batch, cum, grad=False)
    # OHEM draws its pool at random and selects without draws
    assert draws.jax_calls == draws.port_calls == 14
    assert_losses_match(jl, tl)
    np.testing.assert_array_equal(n(tcum), np.asarray(jcum))
