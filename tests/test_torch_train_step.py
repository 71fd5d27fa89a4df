"""One train step of the port against ``nuhtc_tpu``.

``compute_losses``: the tiny synthetic config (Swin embed 32, depths
1-1-1-1, FPN 32, drop-path 0) at 64², B2, f32, the JAX model cloned with
``exact_rois=True`` under HIGHEST matmul precision, the same weights (carried
by ``state_dict_from_jax``) and the same batch; both packages' samplers take
the same uniform draws (``jax.random.uniform`` and the port's
``targets.uniform`` patched to hand out one table). Every loss agrees within
1e-4 relative and every parameter's gradient within 1e-4 of that leaf's
largest JAX gradient. The JAX loss and gradient are evaluated once, jitted,
in a module fixture.

Two facts this comparison needs. (1) The JAX package's
``_mask_train_forward`` (nuhtc_tpu/models/detector.py:888-902) does not pass
``exact_rois`` to its extractors, so its mask branch RoIAligns with bf16
products even under ``exact_rois=True``; the port computes the exact
semantics, so the fixture hands the reference's extractors ``exact=True``.
(2) A ReLU whose pre-activation lies within the two packages' f32 noise of
zero (~1e-5 here) can fall on opposite sides of it, which moves one column
of a gradient while both results are right: the batch of seed 1 puts one
unit of stage 2's shared_fc1 at -5.7e-6 in JAX and +2.0e-5 in the port (the
port's own f64 run agrees with the port), and that leaf's gradient then
differs by 3.8e-4 of its scale. The batch here (seed 2) has no such unit;
its gradients agree within 1e-5 of the scale.

``make_train_step`` against the JAX package's optax AdamW + EMA step: three
steps of a small model whose parameters carry the detector's names (so the
no-decay and frozen-stage masks act as on the detector) under a fast
warm-up schedule; parameters and EMA within 1e-5 relative, every metric
within 1e-5; a case with ``finetune_iter=1`` pins the unfreeze step, and one
runs ``build_named_optimizer``'s rule groups against the JAX package's. The
port's masks are also held against the JAX masks on the tiny detector's own
parameter tree.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

import nuhtc_tpu.models.detector as JD
from nuhtc_tpu.config import Config as JConfig
from nuhtc_tpu.models.build import build_detector as j_build
from nuhtc_tpu.train import train_state as JTS
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.models.build import build_detector
from nuhtc_tpu_torch.train import targets as T
from nuhtc_tpu_torch.train.optim_groups import build_named_optimizer
from nuhtc_tpu_torch.train import train_state as TS
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax, torch_key
from torch_oracle import OracleArch, apply_sd, build_full_sd
from torch_port_util import f32, n, t
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

CONFIG = "configs/nuhtc/htc_lite_tiny_synthetic.py"
SIDE, B, G = 64, 2, 10
LOSS_RTOL = GRAD_TOL = 1e-4


class _Draws:
    """One table of uniform arrays handed out in call order to both
    packages: JAX calls ``jax.random.uniform`` once per call site (vmapped
    over the batch, so one (n,) array serves every image), the port's
    ``targets.uniform`` once per site for the whole batch."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.table = []
        self.jax_calls = self.port_calls = 0

    def _get(self, k, size):
        while len(self.table) <= k:
            self.table.append(self.rng.rand(100000).astype(np.float32))
        return self.table[k][:size]

    def jax_uniform(self, key, shape, *a, **k):
        self.jax_calls += 1
        return jnp.asarray(self._get(self.jax_calls - 1, shape[-1]))

    def port_uniform(self, gen, shape, device):
        self.port_calls += 1
        return t(self._get(self.port_calls - 1, shape[-1])).expand(shape).to(device)


def _batch(rng):
    """Blob nuclei: boxes, labels, 64² mask patches and a stride-4 semantic map."""
    img = rng.randn(B, SIDE, SIDE, 3).astype(np.float32)
    gt_boxes = np.zeros((B, G, 4), np.float32)
    gt_valid = np.zeros((B, G), bool)
    patches = np.zeros((B, G, 64, 64), np.float32)
    sem = np.zeros((B, SIDE // 4, SIDE // 4), np.int32)
    yy, xx = np.mgrid[:64, :64]
    for i in range(B):
        k = G - 2 * i  # the second image has padding slots
        c = rng.uniform(8, SIDE - 8, (k, 2))
        half = rng.uniform(3, 8, (k, 2))
        gt_boxes[i, :k] = np.concatenate([c - half, c + half], 1)
        gt_valid[i, :k] = True
        for j in range(k):
            patches[i, j] = ((yy - 31.5) ** 2 + (xx - 31.5) ** 2 <= 30 ** 2)
            x1, y1, x2, y2 = (gt_boxes[i, j] / 4).astype(int)
            sem[i, y1:y2 + 1, x1:x2 + 1] = 1
    gt_labels = rng.randint(0, 5, (B, G)).astype(np.int32)
    ismask = np.ones((B, G), np.float32)
    return img, dict(gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid,
                     gt_patches=patches, gt_ismask=ismask, gt_semantic=sem)


def shared_setup(sampler: str = "random"):
    """JAX model (exact_rois, ``sampler``), its weights, the port's model on
    the same weights, a batch and seesaw counts."""
    cfg = JConfig.fromfile(CONFIG)
    model = j_build(cfg.model, cfg.model.get("test_cfg"), 1.0,
                    dtype=jnp.float32).clone(exact_rois=True, rcnn_sampler=sampler)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    arch = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)
    sd = build_full_sd(np.random.RandomState(0), arch)
    sd["roi_head.semantic_head.conv_logits.bias"] += 2.0  # so components propose boxes
    params = apply_sd(sd, template)
    port = build_detector(Config.fromfile(CONFIG).model, None, 1.0)
    port.rcnn_sampler = sampler
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    port.train()
    img, batch = _batch(np.random.RandomState(2))
    cum = np.zeros((3, 5), np.float32)
    cum[0] = [3, 0, 1, 7, 2]
    return model, params, port, img, batch, cum


def run_both(model, params, port, img, batch, cum, grad: bool):
    """compute_losses of both packages on shared draws → (JAX losses, JAX
    counts, JAX gradients or None, port losses, port counts, draws)."""
    draws = _Draws(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", draws.jax_uniform)
    mp.setattr(T, "uniform", draws.port_uniform)
    mp.setattr(JD, "attention_roi_features", functools.partial(JD.attention_roi_features,
                                                               exact=True))
    mp.setattr(JD, "single_roi_features", functools.partial(JD.single_roi_features, exact=True))
    try:
        def loss_fn(p):
            losses, new_cum = model.apply(
                p, jnp.asarray(img), {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.asarray(cum), deterministic=False, method="compute_losses",
                rngs={"sampling": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
            return losses["total"], (losses, new_cum)

        with f32():
            if grad:
                (_, (jlosses, jcum)), jgrads = jax.jit(
                    jax.value_and_grad(loss_fn, has_aux=True))(params)
            else:
                (_, (jlosses, jcum)), jgrads = jax.jit(loss_fn)(params), None
        tb = {k: t(v) for k, v in batch.items()}
        losses, new_cum = port.compute_losses(t(img), tb, t(cum), torch.Generator())
        if grad:
            losses["total"].backward()
    finally:
        mp.undo()
    return jlosses, jcum, jgrads, losses, new_cum, draws


@pytest.fixture(scope="module")
def step():
    """The JAX and the port's loss and gradient on shared weights, batch and draws."""
    model, params, port, img, batch, cum = shared_setup()
    jlosses, jcum, jgrads, losses, new_cum, draws = run_both(model, params, port, img, batch,
                                                             cum, grad=True)
    return dict(jlosses=jlosses, jcum=jcum, jgrads=jgrads, losses=losses, new_cum=new_cum,
                port=port, draws=draws, batch=batch)


def assert_losses_match(jl, tl):
    assert sorted(jl) == sorted(tl)
    for k in jl:
        want, got = float(jl[k]), tl[k].item()
        assert np.isfinite(got) and abs(got - want) <= LOSS_RTOL * max(abs(want), 1e-6), \
            (k, got, want)


def test_compute_losses_match(step):
    jl, tl = step["jlosses"], step["losses"]
    assert step["draws"].jax_calls == step["draws"].port_calls == 2 + 3 * 4
    assert_losses_match(jl, tl)
    # the losses the batch must exercise
    for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_semantic_seg", "s0.loss_bbox",
              "s2.loss_mask"):
        assert tl[k].item() > 1e-4, k
    np.testing.assert_array_equal(n(step["new_cum"]), np.asarray(step["jcum"]))


def test_gradients_match(step):
    jg = state_dict_from_jax(jax.tree.map(np.asarray, step["jgrads"]))
    params = dict(step["port"].named_parameters())
    assert sorted(jg) == sorted(params)
    nonzero = 0
    for k, want in jg.items():
        want = want.numpy()
        g = params[k].grad
        got = np.zeros_like(want) if g is None else n(g)
        scale = float(np.abs(want).max())
        nonzero += scale > 0
        np.testing.assert_allclose(got, want, atol=GRAD_TOL * max(scale, 1e-12), rtol=0,
                                   err_msg=k)
    assert nonzero >= len(jg) - 2, (nonzero, len(jg))
    # the gradient reaches the pyramid's finest level through the RoI features
    assert np.abs(n(params["neck.fpn_convs.0.conv.weight"].grad)).max() > 0


# --------------------------------------------------------------------------- #
# the AdamW + EMA step against optax
# --------------------------------------------------------------------------- #
# flax paths of a small model named as the detector's leaves: frozen and not,
# decayed and not (norms, the relative-position table), convolution and
# linear layouts
TOY_LEAVES = {
    ("backbone", "patch_embed", "kernel"): (4, 4, 3, 8),
    ("backbone", "patch_embed", "bias"): (8,),
    ("backbone", "patch_norm", "scale"): (8,),
    ("backbone", "stage0_block0", "attn", "relative_position_bias_table"): (9, 2),
    ("backbone", "stage0_block0", "norm1", "scale"): (8,),
    ("backbone", "downsample0", "reduction", "kernel"): (32, 16),
    ("backbone", "out_norm0", "bias"): (8,),
    ("backbone", "stage1_block0", "ffn", "fc1", "kernel"): (16, 24),
    ("backbone", "stage1_block0", "ffn", "fc1", "bias"): (24,),
    ("backbone", "stage1_block0", "norm2", "scale"): (16,),
    ("backbone", "stage1_block0", "attn", "relative_position_bias_table"): (9, 4),
    ("neck", "lateral1", "kernel"): (1, 1, 16, 8),
    ("bbox_heads_0", "shared_fc1", "kernel"): (6, 5),
    ("bbox_heads_0", "fc_cls", "bias"): (7,),
}


def _tree(leaves):
    tree = {}
    for path, value in leaves.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


class _JaxToy:
    """``model.apply(..., method="compute_losses")`` of an elementwise loss:
    Σ ½·a·p² (term "quad") + Σ b·p + sin(p) (term "lin") over every leaf."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def apply(self, params, img, batch, cum, deterministic=False, method=None, rngs=None):
        flat = traverse_util.flatten_dict(params["params"])
        quad = sum(jnp.sum(0.5 * self.a[k] * v * v) for k, v in flat.items())
        lin = sum(jnp.sum(self.b[k] * v + jnp.sin(v)) for k, v in flat.items())
        return {"quad": quad, "lin": lin, "total": quad + lin}, cum + 1.0


class _PortToy(torch.nn.Module):
    """The same loss over parameters named by ``torch_key`` (mmdet names),
    the coefficients carried into the port's layouts as the weights are."""

    def __init__(self, params_sd, a_sd, b_sd):
        super().__init__()
        self.a, self.b = a_sd, b_sd
        for name, value in params_sd.items():
            mod = self
            *path, leaf = name.split(".")
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, torch.nn.Module())
                mod = getattr(mod, p)
            mod.register_parameter(leaf, torch.nn.Parameter(value.clone()))

    def compute_losses(self, img, batch, cum, generator):
        named = dict(self.named_parameters())
        quad = sum((0.5 * self.a[k] * v * v).sum() for k, v in named.items())
        lin = sum((self.b[k] * v + torch.sin(v)).sum() for k, v in named.items())
        return {"quad": quad, "lin": lin, "total": quad + lin}, cum + 1.0


RULES = [dict(pattern="relative_position_bias_table", decay_mult=0.0),
         dict(pattern="norm", lr_mult=0.5, decay_mult=0.0),
         dict(pattern="neck", lr_mult=2.0)]


def _run_steps(finetune_iter, steps=3, rules=None):
    rng = np.random.RandomState(5)
    params = {"params": _tree({k: rng.randn(*s).astype(np.float32)
                               for k, s in TOY_LEAVES.items()})}
    a = {k: rng.uniform(0.5, 2.0, s).astype(np.float32) for k, s in TOY_LEAVES.items()}
    b = {k: rng.randn(*s).astype(np.float32) for k, s in TOY_LEAVES.items()}
    sched_kw = dict(base_lr=0.05, warmup_iters=2, step_epochs=(1,), iters_per_epoch=2)

    jtx = None
    if rules:
        from nuhtc_tpu.train.optim_groups import build_named_optimizer as j_named

        jtx = j_named(params, base_lr=JTS.lr_schedule(**sched_kw), rules=rules)
    jstate, tx = JTS.create_train_state(None, params, schedule=JTS.lr_schedule(**sched_kw),
                                        tx=jtx)
    jstep = JTS.make_train_step(_JaxToy(a, b), tx, ema_momentum=0.3, finetune_iter=finetune_iter)
    jbatch = {"img": jnp.zeros((1,))}
    want = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        want.append((state_dict_from_jax(jax.tree.map(np.asarray, jstate.params)),
                     state_dict_from_jax(jax.tree.map(np.asarray, jstate.ema_params)),
                     {k: float(v) for k, v in jm.items()}))

    model = _PortToy(state_dict_from_jax(params), state_dict_from_jax({"params": _tree(a)}),
                     state_dict_from_jax({"params": _tree(b)}))
    ptx = None
    if rules:
        ptx = build_named_optimizer([k for k, _ in model.named_parameters()],
                                    base_lr=TS.lr_schedule(**sched_kw), rules=rules)
    state, ptx = TS.create_train_state(model, schedule=TS.lr_schedule(**sched_kw), tx=ptx)
    step = TS.make_train_step(model, ptx, ema_momentum=0.3, finetune_iter=finetune_iter)
    got = []
    for _ in range(steps):
        state, m = step(state, {"img": torch.zeros(1)}, None)
        got.append(({k: v.detach().clone() for k, v in state.params.items()},
                    {k: v.clone() for k, v in state.ema_params.items()},
                    {k: float(v) for k, v in m.items()}))
    assert state.step == steps and state.opt_state.count == steps
    np.testing.assert_array_equal(n(state.cum_samples), np.full((3, 5), float(steps)))
    return want, got, state_dict_from_jax(params)


def _assert_steps_close(want, got):
    for (wp, we, wm), (gp, ge, gm) in zip(want, got):
        assert sorted(wm) == sorted(gm) == ["grad_norm", "lin", "quad", "total"]
        for k in wm:
            assert abs(gm[k] - wm[k]) <= 1e-5 * max(abs(wm[k]), 1e-6), (k, gm[k], wm[k])
        for name in wp:
            for w, g in ((wp[name], gp[name]), (we[name], ge[name])):
                np.testing.assert_allclose(n(g), w.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_adamw_ema_steps_match_optax():
    want, got, init = _run_steps(finetune_iter=15000)
    _assert_steps_close(want, got)
    frozen = TS.frozen_mask(init)
    assert sum(frozen.values()) == 7
    for name, v in init.items():
        moved = not torch.equal(got[-1][0][name], v)
        assert moved != frozen[name], name  # frozen leaves bit-equal, the rest moved
        assert not torch.equal(got[-1][1][name], v) or frozen[name]  # the EMA moved


def test_named_optimizer_groups_match_optax():
    """paramwise_cfg.custom_keys: the first matching rule's lr and decay
    multipliers (optax.multi_transform of one AdamW per group)."""
    want, got, _ = _run_steps(finetune_iter=1, rules=RULES)
    _assert_steps_close(want, got)


def test_unfreeze_step_matches_optax():
    want, got, init = _run_steps(finetune_iter=1)
    _assert_steps_close(want, got)
    for name, v in init.items():
        if TS.frozen_mask([name])[name]:
            assert torch.equal(got[0][0][name], v), name  # step 0: still frozen
            assert not torch.equal(got[1][0][name], v), name  # step 1 on: it trains


def test_masks_match_jax_on_the_detector():
    cfg = JConfig.fromfile(CONFIG)
    model = j_build(cfg.model, cfg.model.get("test_cfg"), 1.0, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), method="init_forward"))
    jdecay = traverse_util.flatten_dict(JTS.decay_mask(shapes)["params"])
    jfrozen = traverse_util.flatten_dict(JTS.frozen_mask(shapes)["params"])
    port = build_detector(Config.fromfile(CONFIG).model, None, 1.0)
    names = [k for k, _ in port.named_parameters()]
    decay, frozen = TS.decay_mask(names), TS.frozen_mask(names)
    by_torch = {torch_key(path)[0]: path for path in jdecay}
    assert sorted(by_torch) == sorted(names)
    for name in names:
        assert decay[name] == jdecay[by_torch[name]], name
        assert frozen[name] == jfrozen[by_torch[name]], name
    assert 0 < sum(frozen.values()) < len(names) and 0 < sum(decay.values()) < len(names)
