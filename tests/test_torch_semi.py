"""The port's semi-supervised recipe against ``nuhtc_tpu``'s.

On the tiny Mask R-CNN of test_torch_mask_rcnn.py (Swin embed 32, depths
1-1-1-1, FPN 32, 4 classes), f32 on the CPU, JAX products at full f32
precision and its extractor with ``exact=True``, weights carried by
``state_dict_from_jax``, inputs from a numpy seed:

- ``mean_teacher_update``: within 1e-6 relative;
- ``MultiStreamDetector.pseudo_label``: the same confident detections
  (valid flags and labels equal, boxes within 1e-3 px); ``semi_loss``: every
  "sup."/"unsup." key and the total within 1e-4 relative, both branches'
  samplers on one table of draws, JAX's mask targets evaluated op by op (see
  test_torch_mask_rcnn.py);
- ``make_semi_train_step``: three steps against the JAX step on optax, on a
  toy pair whose parameters carry the detector's names (so the frozen and
  no-decay masks act as on the detector) and whose loss reads the teacher:
  student, teacher, every metric (``ema_momentum`` and ``grad_norm``
  included) within 1e-5 relative, across the end of burn-in, with frozen
  leaves and after the unfreeze step;
- ``semi_balance_indices``: equal lists;
- ``SemiPrefetchLoader``: its first batches equal to the JAX loader's
  (crop, resize, strong and weak views, raw supervised pixels under an
  empty pipeline, the fall-back to the labelled images for an empty
  unlabelled split);
- ``tools.train`` on a tiny semi config over a synthetic NuCLS release with
  ``--device cpu``: teacher/student checkpoints, resume, evaluation of both
  streams, the momentum ramp and burn-in; ``init_detector(use_ema=)`` and
  ``tools.test`` on the result.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

import nuhtc_tpu.train.targets as JT
from nuhtc_tpu.config import Config as JConfig
from nuhtc_tpu.data import loader as j_loader
from nuhtc_tpu.data import pipelines as jp
from nuhtc_tpu.models.semi import MultiStreamDetector as JMultiStream
from nuhtc_tpu.models.semi import TeacherStudentState as JTSState
from nuhtc_tpu.models.semi import mean_teacher_update as j_mean_teacher_update
from nuhtc_tpu.train import samplers as JS
from nuhtc_tpu.train import train_state as JTS
from nuhtc_tpu_torch.apis.inference import init_detector
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.data import loader
from nuhtc_tpu_torch.data import pipelines as tp
from nuhtc_tpu_torch.models import semi
from nuhtc_tpu_torch.models.mask_rcnn import MaskRCNN
from nuhtc_tpu_torch.tools import test as test_tool
from nuhtc_tpu_torch.tools import train as train_tool
from nuhtc_tpu_torch.tools.synthetic import synthetic_nucls
from nuhtc_tpu_torch.train import samplers as S
from nuhtc_tpu_torch.train import targets as T
from nuhtc_tpu_torch.train import train_state as TS
from nuhtc_tpu_torch.utils import checkpoint as ckpt
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_mask_rcnn import (B, SIDE, TINY, TINY_BACKBONE, _eager_mask_targets, _loss_batch,
                                  exact_rois, tiny_pair)
from test_torch_train_step import TOY_LEAVES, _Draws, _PortToy, _tree
from torch_port_util import n, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

SEMI_CONFIG = "configs/nuhtc/semi_base.py"


def test_mean_teacher_update_matches_jax():
    rng = np.random.RandomState(0)
    s = {k: rng.randn(*shape).astype(np.float32) for k, shape in TOY_LEAVES.items()}
    te = {k: rng.randn(*shape).astype(np.float32) for k, shape in TOY_LEAVES.items()}
    want = j_mean_teacher_update(JTSState(_tree(s), _tree(te)), momentum=0.9).teacher_params
    want = traverse_util.flatten_dict(want)
    state = semi.TeacherStudentState({k: t(v) for k, v in s.items()},
                                     {k: t(v) for k, v in te.items()})
    got = semi.mean_teacher_update(state, momentum=0.9)
    assert got is state
    for k in TOY_LEAVES:
        np.testing.assert_allclose(n(got.teacher_params[k]), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(n(got.student_params[k]), s[k])


# --------------------------------------------------------------------------- #
# pseudo labels and the semi loss
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def semi_pair():
    """The JAX wrapper and params of student and teacher (the student's plus
    noise), and the port's wrapper on the same weights."""
    jmodel, sparams, student = tiny_pair(seed=1)
    rng = np.random.RandomState(9)
    tparams = jax.tree.map(lambda v: v + 0.02 * rng.randn(*v.shape).astype(np.float32), sparams)
    teacher = MaskRCNN(backbone_cfg=TINY_BACKBONE, **TINY)
    teacher.load_state_dict(state_dict_from_jax(tparams), strict=True)
    jwrap = JMultiStream(jmodel, score_thr=0.75, max_gt=12)
    wrap = semi.MultiStreamDetector(student, teacher, score_thr=0.75, max_gt=12)
    return jwrap, sparams, tparams, wrap


def _unsup_views(seed):
    rng = np.random.RandomState(seed)
    strong = rng.randn(B, SIDE, SIDE, 3).astype(np.float32)
    return strong, strong + 0.1 * rng.randn(B, SIDE, SIDE, 3).astype(np.float32)


def test_pseudo_label_matches_jax(semi_pair):
    jwrap, _, tparams, wrap = semi_pair
    assert not wrap.teacher.training and not any(p.requires_grad
                                                 for p in wrap.teacher.parameters())
    _, weak = _unsup_views(10)
    with exact_rois():
        want = jax.jit(jwrap.pseudo_label)(tparams, jnp.asarray(weak))
    got = wrap.pseudo_label(t(weak))
    assert sorted(got) == sorted(want) == ["gt_boxes", "gt_labels", "gt_valid"]
    valid = np.asarray(want["gt_valid"])
    assert valid.shape == (B, 12) and 0 < valid.sum() < valid.size
    np.testing.assert_array_equal(n(got["gt_valid"]), valid)
    np.testing.assert_array_equal(n(got["gt_labels"]), np.asarray(want["gt_labels"]))
    assert got["gt_labels"].dtype == torch.int32
    np.testing.assert_allclose(n(got["gt_boxes"]), np.asarray(want["gt_boxes"]), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighter"])
def test_semi_loss_matches_jax(semi_pair, weighted):
    from nuhtc_tpu.utils.hooks import build_weighter as j_build_weighter
    from nuhtc_tpu_torch.utils.hooks import build_weighter

    jwrap, sparams, tparams, wrap = semi_pair
    rng = np.random.RandomState(11)
    img = rng.randn(B, SIDE, SIDE, 3).astype(np.float32)
    batch = dict(_loss_batch(rng), img=img)
    strong, weak = _unsup_views(12)
    sched = {"loss_rpn_cls": 3.0, "loss_cls": dict(steps=[5], vals=[0.5, 2.0])}
    jweigh = j_build_weighter(sched) if weighted else None
    weigh = build_weighter(sched) if weighted else None
    cum = np.zeros((1, 4), np.float32)
    draws = _Draws(5)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", draws.jax_uniform)
    mp.setattr(T, "uniform", draws.port_uniform)
    mp.setattr(JT, "mask_targets_from_patches", _eager_mask_targets(JT.mask_targets_from_patches))
    try:
        with exact_rois():
            want, jcum = jax.jit(lambda sp, tpar: jwrap.semi_loss(
                sp, tpar, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(strong),
                jnp.asarray(cum), unsup_weight=2.0,
                rngs={"sampling": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                unsup_img_teacher=jnp.asarray(weak), weighter=jweigh, step=jnp.int32(7)))(
                    sparams, tparams)
        wrap.model.train()
        timing = {}
        got, cum_out = wrap.semi_loss({k: t(v) for k, v in batch.items()}, t(strong), t(cum),
                                      unsup_weight=2.0, generator=torch.Generator(),
                                      unsup_img_teacher=t(weak), weighter=weigh, step=7,
                                      timing=timing)
    finally:
        mp.undo()
    assert draws.jax_calls == draws.port_calls == 12  # 6 per branch, sup first
    assert timing["teacher_s"] > 0
    np.testing.assert_array_equal(n(cum_out), np.asarray(jcum))
    branch = ["loss_bbox", "loss_cls", "loss_mask", "loss_mid_seg", "loss_rpn_bbox",
              "loss_rpn_cls", "total"]
    assert sorted(got) == sorted(want) == sorted(
        [f"sup.{k}" for k in branch] + [f"unsup.{k}" for k in branch] + ["total"])
    for k in want:
        w, g = float(want[k]), got[k].item()
        assert abs(g - w) <= 1e-4 * max(abs(w), 1e-6), (k, g, w)
    # the total takes the unsup branch's cls/bbox/RPN terms, not its mask or mid-seg
    unsup = sum(got[f"unsup.{k}"].item() for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                                                   "loss_bbox"))
    assert abs(got["total"].item() - got["sup.total"].item() - 2.0 * unsup) <= 1e-4
    assert got["unsup.loss_bbox"].item() > 0 and got["unsup.loss_mask"].item() > 0
    if weighted:
        assert abs(got["sup.loss_rpn_cls"].item() / 3.0 - float(want["sup.loss_rpn_cls"]) / 3.0
                   ) <= 1e-4


# --------------------------------------------------------------------------- #
# the semi train step against optax
# --------------------------------------------------------------------------- #
class _JaxToyWrapper:
    """``semi_loss`` of a quadratic supervised term and an unsupervised term
    that reads the teacher: quad = Σ ½·a·s², lin = Σ b·s·t + sin(s)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def semi_loss(self, sp, tpar, batch, unsup_img, cum, unsup_weight=1.0, rngs=None,
                  unsup_img_teacher=None, weighter=None, step=None):
        fs = traverse_util.flatten_dict(sp["params"])
        ft = traverse_util.flatten_dict(tpar["params"])
        quad = sum(jnp.sum(0.5 * self.a[k] * v * v) for k, v in fs.items())
        lin = sum(jnp.sum(self.b[k] * v * ft[k] + jnp.sin(v)) for k, v in fs.items())
        return {"sup.quad": quad, "unsup.lin": lin, "total": quad + unsup_weight * lin}, cum + 1.0


class _PortToyWrapper:
    def __init__(self, student, teacher, a, b):
        self.model, self.teacher, self.a, self.b = student, teacher, a, b

    def semi_loss(self, batch, unsup_img, cum, unsup_weight=1.0, generator=None,
                  unsup_img_teacher=None, weighter=None, step=None, timing=None):
        s = dict(self.model.named_parameters())
        te = dict(self.teacher.named_parameters())
        quad = sum((0.5 * self.a[k] * v * v).sum() for k, v in s.items())
        lin = sum((self.b[k] * v * te[k] + torch.sin(v)).sum() for k, v in s.items())
        if timing is not None:
            timing["teacher_s"] = 0.0
        return {"sup.quad": quad, "unsup.lin": lin, "total": quad + unsup_weight * lin}, cum + 1.0


@pytest.mark.parametrize("finetune_iter", [15000, 1], ids=["frozen", "unfreeze_at_1"])
def test_semi_train_steps_match_optax(finetune_iter):
    rng = np.random.RandomState(5)
    params = {"params": _tree({k: rng.randn(*s).astype(np.float32) for k, s in TOY_LEAVES.items()})}
    a = {k: rng.uniform(0.5, 2.0, s).astype(np.float32) for k, s in TOY_LEAVES.items()}
    b = {k: rng.randn(*s).astype(np.float32) for k, s in TOY_LEAVES.items()}
    sched_kw = dict(base_lr=0.05, warmup_iters=2, step_epochs=(1,), iters_per_epoch=2)
    step_kw = dict(teacher_momentum=0.6, teacher_warmup=1, unsup_weight=2.0, burn_in=2,
                   finetune_iter=finetune_iter)

    jstate, tx = JTS.create_semi_train_state(None, params, num_stages=1, num_classes=3,
                                             schedule=JTS.lr_schedule(**sched_kw))
    jstep = JTS.make_semi_train_step(_JaxToyWrapper(a, b), tx, **step_kw)
    jbatch = {"img": jnp.zeros((1,)), "unsup_img": jnp.zeros((1,))}
    want = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        want.append((state_dict_from_jax(jax.tree.map(np.asarray, jstate.student_params)),
                     state_dict_from_jax(jax.tree.map(np.asarray, jstate.teacher_params)),
                     {k: float(v) for k, v in jm.items()}))

    init = state_dict_from_jax(params)
    a_sd, b_sd = (state_dict_from_jax({"params": _tree(x)}) for x in (a, b))
    student, teacher = _PortToy(init, a_sd, b_sd), _PortToy(init, a_sd, b_sd)
    with torch.no_grad():
        for p in teacher.parameters():
            p.add_(1.0)  # create_semi_train_state clones the student into it
    wrap = _PortToyWrapper(student, teacher.requires_grad_(False), a_sd, b_sd)
    state, ptx = TS.create_semi_train_state(student, teacher, num_stages=1, num_classes=3,
                                            schedule=TS.lr_schedule(**sched_kw))
    for k, v in state.teacher_params.items():
        assert torch.equal(v, init[k]) and v is not state.student_params[k]
    step = TS.make_semi_train_step(wrap, ptx, **step_kw)
    got = []
    for i in range(3):
        timing = {}
        state, m = step(state, {"img": torch.zeros(1), "unsup_img": torch.zeros(1)}, None,
                        timing)
        assert set(timing) == {"teacher_s", "forward_s", "backward_s", "optimizer_s"}
        got.append(({k: v.detach().clone() for k, v in state.student_params.items()},
                    {k: v.clone() for k, v in state.teacher_params.items()},
                    {k: float(v) for k, v in m.items()}))
    assert state.step == 3 and state.opt_state.count == 3
    np.testing.assert_array_equal(n(state.cum_samples), np.full((1, 3), 3.0))

    for i, ((ws, wt, wm), (gs, gt, gm)) in enumerate(zip(want, got)):
        assert sorted(wm) == sorted(gm) == ["ema_momentum", "grad_norm", "sup.quad", "total",
                                            "unsup.lin"]
        for k in wm:
            assert abs(gm[k] - wm[k]) <= 1e-5 * max(abs(wm[k]), 1e-6), (i, k, gm[k], wm[k])
        for name in ws:
            np.testing.assert_allclose(n(gs[name]), ws[name].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
            np.testing.assert_allclose(n(gt[name]), wt[name].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    # momentum 0 at step 0: the teacher becomes the student; then it lags
    assert [g[2]["ema_momentum"] for g in got] == pytest.approx([0.0, 1 / 3, 0.5])
    assert all(torch.equal(got[0][1][k], got[0][0][k]) for k in init)
    assert any(not torch.equal(got[2][1][k], got[2][0][k]) for k in init)
    # burn-in: the unsupervised term is weighted 0 for steps 0 and 1
    for i, g in enumerate(got):
        uw = 0.0 if i < 2 else 2.0
        assert g[2]["total"] == pytest.approx(g[2]["sup.quad"] + uw * g[2]["unsup.lin"],
                                              rel=1e-6)
    frozen = TS.frozen_mask(init)
    for name, v in init.items():
        if frozen[name] and finetune_iter > 3:
            assert torch.equal(got[-1][0][name], v), name  # frozen leaves bit-equal
        else:
            assert not torch.equal(got[-1][0][name], v), name


@pytest.mark.parametrize("n_sup,n_unsup,bs,ratio,seed", [(10, 30, 8, 0.5, 0), (7, 0, 6, 0.34, 3),
                                                         (5, 9, 3, 0.2, 11)])
def test_semi_balance_indices_match_jax(n_sup, n_unsup, bs, ratio, seed):
    want = JS.semi_balance_indices(n_sup, n_unsup, bs, ratio, seed)
    got = S.semi_balance_indices(n_sup, n_unsup, bs, ratio, seed)
    for _ in range(20):
        w, g = next(want), next(got)
        assert g == w and isinstance(g, list) and len(g) == bs


# --------------------------------------------------------------------------- #
# the loader
# --------------------------------------------------------------------------- #
class _MemoryDataset:
    """Numpy-only images with one box each (no masks), shared by both
    packages' loaders."""

    CLASSES = ("a", "b", "c", "d")

    def __init__(self, n, size, seed):
        rng = np.random.RandomState(seed)
        self.imgs = [rng.randint(0, 256, (size, size, 3)).astype(np.uint8) for _ in range(n)]
        self.size = size

    def __len__(self):
        return len(self.imgs)

    def load_image(self, i):
        return self.imgs[i]

    def get_ann_info(self, i):
        s = self.size
        return dict(bboxes=np.asarray([[s / 8, s / 6, s / 2, s / 2 + 3]], np.float32),
                    labels=np.asarray([i % 4], np.int64), masks=[])

    def load_semantic(self, i):
        return None


@pytest.mark.parametrize("sup_size,unsup_size", [(48, 64), (64, 48)], ids=["crop", "resize"])
def test_semi_prefetch_loader_matches_jax(sup_size, unsup_size):
    sup = _MemoryDataset(5, sup_size, 0)
    unsup = _MemoryDataset(7, unsup_size, 1)
    strong = [dict(type="PhotoMetricDistortion"), dict(type="RandPosterize")]
    norm = [dict(type="Normalize", mean=[120.0, 110.0, 100.0], std=[50.0, 60.0, 70.0])]
    for pipe in ([], [dict(type="RandomFlip", flip_ratio=0.5)] + norm):
        jl = j_loader.SemiPrefetchLoader(j_loader.SemiDataset(sup, unsup),
                                         jp.build_train_pipeline(pipe),
                                         strong_pipeline=jp.build_train_pipeline(strong),
                                         batch_size=6, sup_ratio=0.5, seed=4)
        pl = loader.SemiPrefetchLoader(loader.SemiDataset(sup, unsup),
                                       tp.build_train_pipeline(pipe),
                                       strong_pipeline=tp.build_train_pipeline(strong),
                                       batch_size=6, sup_ratio=0.5, seed=4)
        try:
            for want, got in zip([b for _, b in zip(range(2), jl)],
                                 [b for _, b in zip(range(2), pl)]):
                assert sorted(got) == sorted(want)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        finally:
            jl.close()
            pl.close()
        assert got["img"].shape == (3, sup_size, sup_size, 3)
        assert got["unsup_img"].shape == got["unsup_img_teacher"].shape == (3, sup_size,
                                                                            sup_size, 3)
        assert not np.array_equal(got["unsup_img"], got["unsup_img_teacher"])
        if not pipe:
            # the empty pipeline (semi_base.py has none): raw supervised pixels
            # beside unlabelled views normalized with the default Normalize
            assert got["img"].max() > 100 and abs(got["unsup_img_teacher"].mean()) < 3
    again = pl.make_batch(1)
    np.testing.assert_array_equal(again["unsup_img"], got["unsup_img"])


def test_semi_loader_falls_back_to_the_labelled_images():
    """An unlabelled split of length 0 (a json without annotations loses its
    images to filter_empty) gives way to the labelled images, as in JAX."""
    sup = _MemoryDataset(3, 32, 0)
    empty = _MemoryDataset(0, 32, 1)
    pl = loader.SemiPrefetchLoader(loader.SemiDataset(sup, empty), [], batch_size=2)
    jl = j_loader.SemiPrefetchLoader(j_loader.SemiDataset(sup, empty), [], batch_size=2)
    assert pl.unsup is sup and jl.unsup is sup
    with pytest.raises(ValueError, match="sup_ratio < 1"):
        loader.SemiPrefetchLoader(loader.SemiDataset(sup, empty), [], batch_size=2,
                                  sup_ratio=1.0)


# --------------------------------------------------------------------------- #
# the train and test command lines
# --------------------------------------------------------------------------- #
NUCLS_TILE = 64


@pytest.fixture(scope="module")
def nucls(tmp_path_factory):
    """A synthetic NuCLS release of 64² tiles and a tiny semi config on it:
    the tiny model, B2 (1 labelled + 1 unlabelled), pseudo labels from 0.3,
    burn-in of one step, a log line, a checkpoint and an evaluation every
    epoch."""
    root = tmp_path_factory.mktemp("nucls")
    opts = synthetic_nucls(str(root), (("train", 4), ("unlabeled", 4), ("test", 2)),
                           size=NUCLS_TILE, seed=0)
    backbone = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_BACKBONE.items()}
    model = dict(TINY, backbone_cfg=backbone)
    model.pop("num_classes")  # the config's 8 NuCLS classes
    with open(root / "tiny_semi.py", "w") as f:
        f.write(f"_base_ = {os.path.abspath(SEMI_CONFIG)!r}\nmodel = {model!r}\n"
                "semi_wrapper = dict(score_thr=0.3, burn_in=1)\n"
                "data = dict(samples_per_gpu=2)\nlog_interval = 1\ncheckpoint_interval = 1\n"
                "evaluation = dict(interval=1)\n")
    return root, ["--cfg-options"] + [f"{k}={v}" for k, v in opts.items()]


def _rows(work):
    with open(os.path.join(work, "log.json")) as f:
        return [json.loads(line) for line in f]


def test_semi_train_cli_trains_both_streams_resumes_and_tests(nucls, tmp_path, monkeypatch):
    root, opts = nucls
    cfg = str(root / "tiny_semi.py")
    work = str(tmp_path / "work")
    base = [cfg, "--device", "cpu", "--work-dir", work, "--iters-per-epoch", "2"]
    pseudo = []
    plain_label = semi.MultiStreamDetector.pseudo_label

    def counting_label(self, img):
        out = plain_label(self, img)
        pseudo.append(int(out["gt_valid"].sum()))
        return out

    monkeypatch.setattr(semi.MultiStreamDetector, "pseudo_label", counting_label)
    timing = []
    state = train_tool.main(base + ["--max-epochs", "2"] + opts,
                            trainer_kw=dict(record_timing=timing))
    assert isinstance(state, TS.SemiTrainState) and state.step == 4
    assert state.cum_samples.shape == (1, 8)
    assert len(timing) == 4 and all(t_["teacher_s"] > 0 for t_ in timing)
    rows = _rows(work)
    train = [r for r in rows if r["mode"] == "train"]
    val = [r for r in rows if r["mode"] == "val"]
    assert [(r["epoch"], r["iter"]) for r in train] == [(1, 1), (1, 2), (2, 1), (2, 2)]
    assert [(r["epoch"], r["tag"]) for r in val] == [(1, "teacher"), (1, "student"),
                                                   (2, "teacher"), (2, "student")]
    for r in train:
        assert all(np.isfinite(v) for k, v in r.items() if k not in ("mode", "epoch", "iter"))
    # the momentum ramp (warm_up 100) and burn-in 1: unsup weighted 0 at step 0 only
    assert train[0]["ema_momentum"] == 0.0 and train[1]["ema_momentum"] > 0
    assert train[0]["total"] == pytest.approx(train[0]["sup.total"], rel=1e-6)
    unsup = [sum(r[f"unsup.{k}"] for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                                           "loss_bbox")) for r in train]
    for r, u in zip(train[1:], unsup[1:]):
        assert r["total"] == pytest.approx(r["sup.total"] + 2.0 * u, rel=1e-5)
    assert sum(pseudo) > 0  # the teacher labels something at 0.3

    ck = os.path.join(work, "checkpoints")
    assert sorted(os.listdir(ck)) == ["step_1.pt", "step_2.pt"]
    blob = ckpt.read_checkpoint(ck)
    assert {"student_params", "teacher_params", "opt_mu", "opt_nu", "opt_count",
            "cum_samples", "step"} <= set(blob) and "ema_params" not in blob
    assert blob["step"] == blob["opt_count"] == 4
    moved = [k for k, v in blob["teacher_params"].items()
             if not torch.equal(v, blob["student_params"][k])]
    assert moved  # the teacher lags the student after step 0

    state = train_tool.main(base + ["--max-epochs", "3", "--resume-from",
                                    os.path.join(ck, "step_2.pt")] + opts)
    assert state.step == 6 and state.opt_state.count == 6
    with open(os.path.join(work, "train.log")) as f:
        assert "resumed from epoch 2" in f.read()
    last = [r for r in _rows(work) if r["mode"] == "train"][-1]
    assert (last["epoch"], last["iter"]) == (3, 2) and last["ema_momentum"] > 0

    blob = ckpt.read_checkpoint(ck)
    for use_ema, key in ((True, "teacher_params"), (False, "student_params")):
        engine = init_detector(cfg, ck, batch_size=2, device="cpu", use_ema=use_ema,
                               tile_size=NUCLS_TILE)
        assert isinstance(engine.model, MaskRCNN)
        sd = engine.model.state_dict()
        for k, v in blob[key].items():
            assert torch.equal(sd[k], v), (use_ema, k)
    res = engine.run_batch([np.full((NUCLS_TILE, NUCLS_TILE, 3), 200, np.uint8)])
    assert len(res) == 1 and res[0]["probs"].shape[1:] == (8,)

    out = tmp_path / "metrics.json"
    assert test_tool.main([cfg, os.path.join(ck, "step_3.pt"), "--device", "cpu",
                           "--batch-size", "2", "--out-json", str(out)] + opts) == 0
    metrics = json.loads(out.read_text())
    assert "pq" in metrics and all(np.isfinite(v) for v in metrics.values()
                                   if isinstance(v, float))


def test_semi_config_builds_the_recipe():
    """semi_base.py read by the port: its ``semi_wrapper`` as the JAX
    package reads it, and the Trainer's momentum settings (the evaluation
    EMA's, the MeanTeacher hook's, the unfreeze step)."""
    cfg = Config.fromfile(SEMI_CONFIG)
    jcfg = JConfig.fromfile(SEMI_CONFIG)
    assert cfg.to_dict()["semi_wrapper"] == jcfg.to_dict()["semi_wrapper"]
    from nuhtc_tpu_torch.train.trainer import Trainer

    tr = Trainer.__new__(Trainer)  # no work dir
    tr.cfg = cfg
    ema, teacher_momentum, finetune = tr._hook_settings()
    assert (ema, teacher_momentum, finetune) == (0.001, None, 15000)
    cfg.merge_from_options({"custom_hooks": [dict(type="MeanTeacher", momentum=0.99)]})
    assert tr._hook_settings()[1] == 0.99


def test_semi_command_lines_without_device_raise_on_a_host_without_cuda(nucls, tmp_path,
                                                                         monkeypatch):
    root, opts = nucls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tool.main([str(root / "tiny_semi.py"), "--work-dir", str(tmp_path)] + opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_tool.main([str(root / "tiny_semi.py")] + opts)
