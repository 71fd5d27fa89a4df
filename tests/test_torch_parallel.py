"""The port's parallel layer (``nuhtc_tpu_torch.parallel``) against
``nuhtc_tpu.parallel`` and the single-process step, with gloo process groups
on the CPU (the ranks: tests/torch_parallel_util.py, one thread each).

- ``leaf_spec`` equals the JAX rule on a grid of shapes, and on the
  flagship detector shards the same logical axis of every parameter as the
  JAX rule on the counterpart leaf (or replicates it where JAX does), with
  the same bytes a shard.
- ``merge_strided_results`` on uneven parts equals the JAX merge;
  ``gather_objects`` without a group is ``[obj]``.
- In a process group the losses' helpers make collectives only inside a
  train step's ``data_parallel()`` scope.
- The data-parallel step at W = 2 (2 images a rank) against the JAX
  package's single-device step on the global batch of 4, which
  tests/test_parallel.py holds equal to its sharded step: the tiny config,
  the weights and draws of tests/test_torch_train_step.py (one table of
  uniforms handed to both packages; the JAX extractors exact), the losses
  within LOSS_RTOL relative, the all-reduced gradients within GRAD_TOL of
  each leaf's largest JAX gradient, the seesaw counts equal, and on both
  ranks the parameters and the EMA after one AdamW + EMA step at the lr
  STEP_LR equal to JAX's step (optax's) on the same all-reduced gradients:
  each element within two roundings of the weight and four of the update,
  a bound that the step's move (~1e-3 an element, ~2e-7 of the EMA)
  exceeds on most elements, so a skipped, doubled or reversed update
  fails. The batch
  is ``blob_batch`` of seed 3. At seeds 2 and 4 one unit of stage 2's
  shared_fc0 lies within f32 noise of its ReLU's kink, in the
  single-process port as in the ranks: the whole gap to JAX (1.0e-4 and
  2.6e-4 of that leaf's scale) sits in that unit's row, the other rows
  agree within 4e-7 (tests/test_torch_train_step.py describes the same
  effect). Seed 5's single-process gap (3.7e-4, spread over the backbone)
  sits in three terms, each downstream of units within 2e-6 of a ReLU's
  kink (two in stage 0's shared_fc1 under its objectness loss, stage 1's
  head, the mask head); every other term's gradient agrees within 5e-6.
- Drop-path 0.3 with the generator's own draws: the two ranks' masks are
  the rows of one process's masks on the global batch, bit for bit, and the
  global losses equal that process's within 1e-5 relative.
- The semi-supervised step (``make_semi_train_step``, a tiny Mask R-CNN
  student and a noisy teacher, pseudo labels from 0.2): two ranks against
  one process on the global batch, every loss and ``grad_norm`` within
  1e-5 relative, each element of the student and teacher within 2 lr (lr
  1e-7, the warm-up's first) and 2 f32 roundings, the ranks' students
  bit-equal.
- ``shard_state`` on a 2 × 2 gloo mesh (one image a rank): the losses and
  gradients equal the W = 2 step's within the same bounds, the parameters
  and EMA equal JAX's step on its own gradients as above; every parameter
  placed as
  ``leaf_spec`` says (``(Replicate(), Shard(d))`` or a plain replicated
  tensor), its EMA and moments alike; the K1 pack key of a sharded Swin
  block changes across an FSDP gather, whose write keeps the version
  counter.
- ``tools.train --launcher pytorch`` with 2 ranks for one step: loader
  seeds ``seed + rank · 100003``, only rank 0 writes, the ranks' weights
  bit-equal; then ``tools.test --launcher pytorch`` on its checkpoint over
  5 tiles (3 + 2), at B1 and on one thread as the run it is held against
  (a batch of other images moves a box by up to 2.5e-4 through the CPU's
  products): rank 0's results in dataset order, each image's
  detections equal to ``--launcher none``'s (counts, boxes and scores
  within 1e-4), the metrics within 1e-4, rank 1 writes nothing.
- The dry run's rank body (``parallel.dryrun.dryrun_rank``) in the
  four-rank session gives its three OK lines on every rank.

The two sessions of ranks run beside each other and beside the JAX
compile, each under a time limit of its own.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import nuhtc_tpu.models.detector as JD
from nuhtc_tpu.config import Config as JConfig
from nuhtc_tpu.models.build import build_detector as j_build
from nuhtc_tpu.models.detector import NuHTC as JNuHTC
from nuhtc_tpu.parallel import mesh as JM
from nuhtc_tpu.parallel import shard_rules as JS
from nuhtc_tpu.train import train_state as JTS
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.models.build import build_detector
from nuhtc_tpu_torch.ops.window_block import source_key, weights_gathered
from nuhtc_tpu_torch.parallel import mesh as P
from nuhtc_tpu_torch.parallel import shard_rules as S
from nuhtc_tpu_torch.parallel.launch import run_ranks
from nuhtc_tpu_torch.tools import preprocess_pannuke
from nuhtc_tpu_torch.tools import test as test_tool
from nuhtc_tpu_torch.tools.synthetic import synthetic_pannuke
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax, torch_key
from torch_oracle import OracleArch, apply_sd, build_full_sd
from torch_parallel_util import (
    CONFIG, SIDE, STEP_LR, Draws, blob_batch, fsdp_rank, pair_rank,
)
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

LOSS_RTOL = GRAD_TOL = 1e-4
DROP_RTOL = 1e-5
B = 4  # the global batch
RANK_TIMEOUT = 240.0


# ---------------------------------------------------------------------------
# the sharding rule
# ---------------------------------------------------------------------------
def test_leaf_spec_matches_jax_on_a_grid():
    rng = np.random.RandomState(0)
    dims = (1, 2, 3, 4, 6, 7, 8, 12, 32, 96, 128, 255, 256, 768, 3072)
    shapes = [tuple(rng.choice(dims, nd)) for nd in (1, 2, 3, 4) for _ in range(60)]
    shapes += [(768, 2304), (2304, 768), (3, 3, 64, 64), (512, 512), (65536,), (65535,)]
    for shape in shapes:
        for n_model in (1, 2, 4, 8):
            want = tuple(JS.leaf_spec(shape, n_model))
            assert S.leaf_spec(shape, n_model) == want, (shape, n_model)
            assert S.leaf_spec(shape, n_model, min_elems=1) == tuple(
                JS.leaf_spec(shape, n_model, min_elems=1)), (shape, n_model)


def test_flagship_parameters_shard_the_jax_axis():
    """For every leaf of the flagship tree: the JAX rule's spec on it, and
    the port's on the counterpart parameter. A leaf whose values count along
    the JAX-sharded axis, carried into the port's layout by
    ``utils/convert.py``, must vary along the port-sharded axis alone."""
    model = JNuHTC(num_classes=5, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)), method="init_forward"))
    port = build_detector(Config.fromfile("configs/nuhtc/htc_lite_swin_fpn_pannuke.py").model,
                          None, 2.0)
    port_params = dict(port.named_parameters())
    n_model = 2
    specs = S.tree_shardings(port, n_model)
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    assert len(leaves) == len(port_params) == 255
    n_sharded = 0
    for path, leaf in leaves:
        names = tuple(k.key for k in path)
        key, transform = torch_key(names)
        jspec = tuple(JS.leaf_spec(leaf.shape, n_model))
        spec = specs[key]
        assert bool(spec) == bool(jspec), (key, spec, jspec)
        assert port_params[key].numel() == int(np.prod(leaf.shape))
        if not jspec:
            continue
        n_sharded += 1
        jd, pd = jspec.index("model"), spec.index("model")
        counts = np.broadcast_to(
            np.arange(leaf.shape[jd], dtype=np.float32).reshape(
                [-1 if d == jd else 1 for d in range(len(leaf.shape))]), leaf.shape)
        moved = np.asarray(transform(np.ascontiguousarray(counts)))
        assert moved.shape == tuple(port_params[key].shape), key
        for d in range(moved.ndim):
            varies = not np.all(np.diff(moved, axis=d) == 0)
            assert varies == (d == pd), (key, spec, jspec, d)
        # the same bytes a shard
        assert moved.shape[pd] // n_model * (moved.size // moved.shape[pd]) * 4 == \
            leaf.shape[jd] // n_model * (int(np.prod(leaf.shape)) // leaf.shape[jd]) * 4
    assert n_sharded >= 40, n_sharded


def test_merge_strided_results_uneven_matches_jax():
    n, nproc = 10, 3
    results = [f"img{i}" for i in range(n)]
    parts = [list(zip(range(pid, n, nproc), results[pid::nproc])) for pid in range(nproc)]
    assert [len(p) for p in parts] == [4, 3, 3]
    assert P.merge_strided_results(parts) == JM.merge_strided_results(parts) == results
    assert not P.is_distributed()
    assert P.gather_objects({"a": 1}) == JM.gather_objects({"a": 1}) == [{"a": 1}]
    assert P.merge_strided_results(P.gather_objects(list(zip(range(n), results)))) == results


def test_losses_span_ranks_only_inside_a_step(tmp_path):
    """In a process group (gloo, one rank, in this process) ``global_sum``,
    ``share``, ``global_rows`` and ``rank_rows`` make no collective outside
    ``data_parallel()``, the scope the train steps enter, and do inside it."""
    import torch.distributed as dist

    x = torch.arange(6.0).reshape(3, 2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        P.reset_collectives()
        assert P.global_sum(x) is x and P.share(x) is x and P.rank_rows(x) is x
        assert P.global_rows((3, 2)) == (3, 2) and P.COLLECTIVES == {}
        with P.data_parallel():
            y = P.global_sum(x)
            assert y is not x and torch.equal(y, x)
            assert P.COLLECTIVES == {"normalizer": [1, 24]}
            assert torch.equal(P.share(x), x) and P.global_rows((3, 2)) == (3, 2)
        assert P.global_sum(x) is x and P.COLLECTIVES == {"normalizer": [1, 24]}
    finally:
        dist.destroy_process_group()
    assert not P.is_distributed()


def test_k1_pack_key_sees_a_write_that_keeps_the_version():
    """FSDP2 writes gathered weights under
    ``_unsafe_preserve_version_counter``: address and version stay, so the
    pack key must take the gather count (``weights_gathered``)."""
    w = torch.randn(96, 32)
    before = source_key([w])
    with torch.no_grad(), torch.autograd._unsafe_preserve_version_counter(w):
        w.add_(1.0)
    assert before[1:] == source_key([w])[1:]
    weights_gathered()
    assert source_key([w]) != before


# ---------------------------------------------------------------------------
# the data-parallel step against JAX's global-batch step
# ---------------------------------------------------------------------------
class _JaxDraws(Draws):
    def jax_uniform(self, key, shape, *a, **k):
        self.calls += 1
        return jnp.asarray(self.row(self.calls - 1, shape[-1]))


class _Linear:
    """A model for JAX's ``make_train_step`` whose loss has the gradient
    ``batch["grads"]``: the optimizer + EMA step on given gradients."""

    def apply(self, params, img, batch, cum, deterministic=False, method=None, rngs=None):
        total = sum(jnp.vdot(p, g) for p, g in zip(jax.tree.leaves(params),
                                                    jax.tree.leaves(batch["grads"])))
        return {"total": total}, cum


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights (the JAX tree and its port state dict), the global batch
    and the seesaw counts; the setup file of the ranks."""
    cfg = JConfig.fromfile(CONFIG)
    model = j_build(cfg.model, cfg.model.get("test_cfg"), 1.0,
                    dtype=jnp.float32).clone(exact_rois=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    arch = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)
    sd = build_full_sd(np.random.RandomState(0), arch)
    sd["roi_head.semantic_head.conv_logits.bias"] += 2.0  # so components propose boxes
    params = apply_sd(sd, template)
    batch = blob_batch(np.random.RandomState(3), B)
    cum = np.zeros((3, 5), np.float32)
    cum[0] = [3, 0, 1, 7, 2]
    tmp = tmp_path_factory.mktemp("parallel")
    ranks_setup = dict(state_dict=state_dict_from_jax(params), batch=batch, cum=cum,
                       draws_seed=2, drop_path_rate=0.3, drop_seed=7)
    torch.save(ranks_setup, tmp / "setup.pt")
    return dict(tmp=tmp, setup=ranks_setup, model=model, template=template, params=params)


@pytest.fixture(scope="module")
def shared(setup, sessions):
    """The JAX step on the global batch, computed while the ranks' sessions
    run."""
    model, template, params = setup["model"], setup["template"], setup["params"]
    batch, cum = setup["setup"]["batch"], setup["setup"]["cum"]
    draws = _JaxDraws(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", draws.jax_uniform)
    for name in ("attention_roi_features", "single_roi_features"):
        mp.setattr(JD, name, functools.partial(getattr(JD, name), exact=True))
    try:
        def loss_fn(p):
            losses, new_cum = model.apply(
                p, jnp.asarray(batch["img"]), {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.asarray(cum), deterministic=False, method="compute_losses",
                rngs={"sampling": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)})
            return losses["total"], (losses, new_cum)

        # LLVM's optimization passes take a sixth of the compile and move
        # no gradient by more than 3e-7 of its leaf's scale
        with jax.default_matmul_precision("highest"):
            (_, (jlosses, jcum)), jgrads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True),
                compiler_options={"xla_backend_optimization_level": 0})(params)
    finally:
        mp.undo()
    jstate, tx = JTS.create_train_state(
        None, params, num_stages=3, num_classes=5,
        schedule=JTS.lr_schedule(STEP_LR, warmup_ratio=1.0))
    jstep = jax.jit(JTS.make_train_step(_Linear(), tx),
                    compiler_options={"xla_backend_optimization_level": 0})

    def port_sd(tree):
        return state_dict_from_jax(jax.tree.map(np.asarray, tree))

    def jax_step(grads):
        """JAX's AdamW + EMA step from the initial state on the port's
        gradients (a state dict) → (params, EMA) as port state dicts."""
        jg = apply_sd({k: v.detach() for k, v in grads.items()}, template)
        new, _ = jstep(jstate, {"img": jnp.zeros((1,)), "grads": jg}, jax.random.PRNGKey(0))
        return port_sd(new.params), port_sd(new.ema_params)

    return dict(tmp=setup["tmp"], setup=setup["setup"],
                jlosses={k: float(v) for k, v in jlosses.items()},
                jcum=np.asarray(jcum), jgrads=port_sd(jgrads), jax_step=jax_step,
                jcalls=draws.calls)


TILE = 128


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A synthetic PanNuke release of 128² tiles (4 train, 5 test) and the
    tiny config with its Resize at 128²."""
    root = tmp_path_factory.mktemp("release")
    images, masks, types = synthetic_pannuke(np.random.RandomState(0), 9, TILE)
    for fold, sl in ((1, slice(0, 4)), (3, slice(4, 9))):
        paths = []
        for name, arr in (("images", images), ("masks", masks), ("types", types)):
            paths.append(str(root / f"{name}{fold}.npy"))
            np.save(paths[-1], arr[sl])
        assert preprocess_pannuke.main([
            "--images", paths[0], "--masks", paths[1], "--types", paths[2],
            "--fold", str(fold), "--out-dir", str(root / "datasets"),
            "--coco-dir", str(root / "coco")]) == 0
    pipeline = Config.fromfile(CONFIG).to_dict()["train_pipeline"]
    for t in pipeline:
        if t["type"] == "Resize":
            t["img_scale"] = (TILE, TILE)
    with open(root / "tiny128.py", "w") as f:
        f.write(f"_base_ = {os.path.abspath(CONFIG)!r}\ntrain_pipeline = {pipeline!r}\n")
    ds = f"{root}/datasets"
    test_opts = [f"data.test.ann_file={root}/coco/PanNuke_annt_RLE_fold3.json",
                 f"data.test.img_prefix={ds}/rgb/", f"data.test.seg_prefix={ds}/rgb_seg"]
    train_opts = ["log_interval=1",
                  f"data.train.dataset.ann_file={root}/coco/PanNuke_annt_RLE_fold1.json",
                  f"data.train.dataset.img_prefix={ds}/rgb/",
                  f"data.train.dataset.seg_prefix={ds}/rgb_seg"]
    return dict(root=root, cfg=str(root / "tiny128.py"), test_opts=test_opts,
                train_opts=train_opts)


def _ranks(fn, world, setup, name, *args):
    out = setup["tmp"] / name
    out.mkdir()
    run_ranks(fn, world, args=(str(setup["tmp"] / "setup.pt"), *args, str(out)),
              timeout=RANK_TIMEOUT)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def sessions(setup, release):
    """The two sessions of ranks, each started from a thread of its own so
    that their processes run beside each other and beside the JAX compile:
    two ranks (the shared-draw, drop-path and semi steps, then
    ``tools.train`` and ``tools.test`` with ``--launcher pytorch``) and four
    (the 2 × 2 ``shard_state`` step, then the dry run)."""
    root = release["root"]
    argv_train = [release["cfg"], "--work-dir", str(root / "work{rank}"), "--launcher",
                  "pytorch", "--device", "cpu", "--max-epochs", "1", "--iters-per-epoch", "1",
                  "--no-validate", "--seed", "3", "--cfg-options",
                  *release["train_opts"], *release["test_opts"]]
    argv_test = [release["cfg"], str(root / "work0" / "checkpoints"), "--launcher", "pytorch",
                 "--device", "cpu", "--batch-size", "1", "--out", str(root / "raw{rank}.pkl"),
                 "--work-dir", str(root / "eval{rank}"), "--cfg-options", *release["test_opts"]]
    with ThreadPoolExecutor(2) as pool:
        yield dict(pair=pool.submit(_ranks, pair_rank, 2, setup, "pair", argv_train, argv_test),
                   fsdp=pool.submit(_ranks, fsdp_rank, 4, setup, "fsdp"))


@pytest.fixture(scope="module")
def two_ranks(sessions):
    return sessions["pair"].result()


@pytest.fixture(scope="module")
def four_ranks(sessions):
    return sessions["fsdp"].result()


def _assert_losses(want, got, rtol):
    assert sorted(want) == sorted(k for k in got if k != "grad_norm")
    for k, w in want.items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= rtol * max(abs(w), 1e-6), (k, got[k], w)


def _assert_leaves(want, got, tol, scale_of):
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        scale = float(scale_of[k].abs().max()) if k in scale_of else float(w.abs().max())
        err = float((got[k] - w).abs().max())
        assert err <= tol * max(scale, 1e-12), (k, err, scale)


def _assert_step(before, want, got):
    """``got`` (params and EMA after one step from ``before``) equals
    ``want``, JAX's step on the same gradients: each element within two f32
    roundings of the weight and four of the update (lr STEP_LR). The bound
    must see the step: on most elements JAX's move exceeds it, for the
    parameters (~lr) and for the EMA (~2e-4 lr)."""
    eps = torch.finfo(torch.float32).eps
    for part, want in zip(("params", "ema"), want):
        assert sorted(want) == sorted(got[part])
        seen = total = 0
        for k, w in want.items():
            w, w0 = torch.as_tensor(np.asarray(w)), before[k]
            tol = 2 * eps * torch.maximum(w0.abs(), w.abs()) + 4 * eps * STEP_LR
            err = (got[part][k] - w).abs()
            assert bool((err <= tol).all()), (part, k, float(err.max()), float(tol.max()))
            seen += int(((w - w0).abs() > tol).sum())
            total += w.numel()
        assert seen >= 0.9 * total, (part, seen, total)


def test_dp_step_matches_the_jax_global_batch(shared, two_ranks):
    jgrads = {k: torch.as_tensor(v) for k, v in shared["jgrads"].items()}
    grads = two_ranks[0]["shared"]["grads"]  # the all-reduced sum, alike on every rank
    jax_after = shared["jax_step"](grads)
    for rec in two_ranks:
        step = rec["shared"]
        # each rank draws every call site once: RPN, then 4 a stage
        assert rec["calls"] == shared["jcalls"] == 2 + 3 * 4
        _assert_losses(shared["jlosses"], step["metrics"], LOSS_RTOL)
        np.testing.assert_array_equal(step["cum"].numpy(), shared["jcum"])
        _assert_leaves(shared["jgrads"], step["grads"], GRAD_TOL, jgrads)
        assert all(torch.equal(step["grads"][k], grads[k]) for k in grads)
        _assert_step(shared["setup"]["state_dict"], jax_after, step)
        assert step["metrics"]["loss_rpn_cls"] > 1e-4 and step["metrics"]["s2.loss_mask"] > 1e-4
    a, b = (rec["shared"] for rec in two_ranks)
    for k in a["params"]:  # one update on every rank
        assert torch.equal(a["params"][k], b["params"][k]) and torch.equal(a["ema"][k], b["ema"][k])
    assert a["metrics"] == b["metrics"]


def test_drop_path_ranks_take_the_global_draws(shared, two_ranks):
    from nuhtc_tpu_torch.models import swin
    from torch_parallel_util import port_model, rows, train_step

    setup = shared["setup"]
    masks = []
    real_keep = swin.keep_mask
    mp = pytest.MonkeyPatch()
    mp.setattr(swin, "keep_mask", lambda *a: masks.append(real_keep(*a)) or masks[-1])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = port_model(setup["state_dict"], setup["drop_path_rate"])
        _, metrics = train_step(model, rows(setup["batch"], 0, 1), setup["cum"],
                                torch.Generator().manual_seed(setup["drop_seed"]))
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    assert len(masks) == 2 * 3  # two branches of the 3 blocks past the first (rate 0)
    assert any(not bool(m.all()) for m in masks) and any(bool(m.any()) for m in masks)
    b = B // 2
    for r, rec in enumerate(two_ranks):
        got = rec["drop"]["masks"]
        assert len(got) == len(masks)
        for g, m in zip(got, masks):
            assert torch.equal(g, m[r * b:(r + 1) * b])
        want = {k: float(v) for k, v in metrics.items() if k != "grad_norm"}
        _assert_losses(want, rec["drop"]["metrics"], DROP_RTOL)
        g = rec["drop"]["metrics"]["grad_norm"]
        assert abs(g - float(metrics["grad_norm"])) <= DROP_RTOL * float(metrics["grad_norm"])


def test_semi_step_ranks_equal_one_process(shared, two_ranks):
    from torch_parallel_util import semi_record

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = semi_record(shared["setup"]["batch"], 0, 1)
    finally:
        torch.set_num_threads(threads)
    for rec in two_ranks:
        got = rec["semi"]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k, w in want["metrics"].items():
            assert abs(got["metrics"][k] - w) <= DROP_RTOL * max(abs(w), 1e-6), (k, got, w)
        assert want["metrics"]["unsup.loss_rpn_cls"] > 0 and want["metrics"]["sup.loss_mask"] > 0
        # at the warm-up's first lr AdamW moves an element by lr·g/(|g| + 1e-8):
        # a gradient near 1e-8 that differs in its last bits moves it by up to
        # 2 lr (the zero-initialised biases show it), plus a rounding of each
        for part in ("student", "teacher"):
            for k, w in want[part].items():
                tol = 2 * 1e-7 + 2 * torch.finfo(torch.float32).eps * w.abs()
                assert bool(((got[part][k] - w).abs() <= tol).all()), (part, k)
    a, b = (rec["semi"]["student"] for rec in two_ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_shard_state_step_on_a_2x2_mesh(shared, two_ranks, four_ranks):
    dp = two_ranks[0]["shared"]
    port = build_detector(Config.fromfile(CONFIG).model, None, 1.0)
    specs = S.tree_shardings(port, 2)
    assert sum(1 for s in specs.values() if s) > 0
    grads = four_ranks[0]["grads"]
    jax_after = shared["jax_step"](grads)
    for rec in four_ranks:
        _assert_losses({k: v for k, v in dp["metrics"].items() if k != "grad_norm"},
                       rec["metrics"], LOSS_RTOL)
        assert abs(rec["metrics"]["grad_norm"] - dp["metrics"]["grad_norm"]) <= \
            GRAD_TOL * dp["metrics"]["grad_norm"]
        np.testing.assert_array_equal(rec["cum"].numpy(), dp["cum"].numpy())
        _assert_leaves(dp["grads"], rec["grads"], GRAD_TOL, dp["grads"])
        assert all(torch.equal(rec["grads"][k], grads[k]) for k in grads)
        _assert_step(shared["setup"]["state_dict"], jax_after, rec)
        for name, spec in specs.items():
            want = (Replicate(), Shard(spec.index("model"))) if spec else None
            assert rec["placements"][name] == dict(param=want, ema=want, mu=want, nu=want), name
        (key0, w0), (key1, w1) = rec["k1"]
        assert not torch.equal(w0, w1)  # the step moved the gathered weight
        assert key0[1][1] == key1[1][1]  # FSDP kept its version counter
        assert key0 != key1
    first = four_ranks[0]["params"]
    for rec in four_ranks[1:]:
        assert all(torch.equal(first[k], rec["params"][k]) for k in first)


# ---------------------------------------------------------------------------
# the command lines and the dry run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tools_run(two_ranks):
    return [rec["tools"] for rec in two_ranks]


def test_train_launcher_pytorch(release, tools_run):
    root = release["root"]
    assert [rec["seeds"] for rec in tools_run] == [[3], [3 + 100003]]
    assert all(rec["step"] == 1 for rec in tools_run)
    a, b = (rec["params"] for rec in tools_run)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(os.listdir(root / "work0" / "checkpoints")) == ["step_1.pt"]
    rows = [line for line in open(root / "work0" / "log.json")]
    assert len(rows) == 1 and '"mode": "train"' in rows[0]
    assert not (root / "work1").exists()


def test_test_launcher_pytorch_matches_none(release, tools_run, tmp_path):
    import json
    import pickle

    root = release["root"]
    assert [rec["rc"] for rec in tools_run] == [0, 0]
    assert not (root / "raw1.pkl").exists() and not (root / "eval1").exists()
    got = pickle.load(open(root / "raw0.pkl", "rb"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: each image meets the same products
    try:
        assert test_tool.main([release["cfg"], str(root / "work0" / "checkpoints"), "--device",
                               "cpu", "--batch-size", "1", "--out", str(tmp_path / "raw.pkl"),
                               "--work-dir", str(tmp_path / "eval"), "--cfg-options",
                               *release["test_opts"]]) == 0
    finally:
        torch.set_num_threads(threads)
    want = pickle.load(open(tmp_path / "raw.pkl", "rb"))
    assert len(got) == len(want) == 5
    assert sum(len(b) for bboxes, _ in want for b in bboxes) > 0
    for (gb, gs), (wb, ws) in zip(got, want):
        for x, y in zip(gb, wb):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
        assert [len(s) for s in gs] == [len(s) for s in ws]
    mg = json.load(open(root / "eval0" / "eval_metrics.json"))
    mw = json.load(open(tmp_path / "eval" / "eval_metrics.json"))
    assert sorted(mg) == sorted(mw)
    for k, v in mw.items():
        np.testing.assert_allclose(np.asarray(mg[k], np.float64), np.asarray(v, np.float64),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_dryrun_multichip_4(four_ranks):
    for rec in four_ranks:
        lines = rec["dryrun"]
        assert len(lines) == 3 and all(line.startswith("dryrun_multichip(4): ")
                                       and line.endswith("OK") for line in lines), lines
        assert "2x2 data x model" in lines[2]
