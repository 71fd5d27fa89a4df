"""The ranks of tests/test_torch_parallel.py: module-level functions that
``nuhtc_tpu_torch.parallel.launch.run_ranks`` starts in processes of their
own (gloo on the CPU, one thread each): ``pair_rank`` for the two-rank
session, ``fsdp_rank`` for the four-rank one (the 2 × 2 mesh, then the dry
run). Each reads its inputs from a
file the test wrote and saves what it computed to ``<out>/rank<r>.pt``.
This module imports no JAX: the ranks run the port alone."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

CONFIG = "configs/nuhtc/htc_lite_tiny_synthetic.py"
SIDE, G = 64, 10
# the constant lr of ``train_step``: one AdamW step moves an element by
# about 1e-3 and its EMA by about 2e-7, both far above an f32 rounding of
# the weights, so a comparison of the step can see a wrong one
STEP_LR = 1e-3


class Draws:
    """One table of uniform arrays handed out in call order: the k-th call
    of either package gets row k's first entries (the JAX package vmaps
    each call site over the batch, so one row serves every image)."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.table = []
        self.calls = 0

    def row(self, k: int, size: int) -> np.ndarray:
        while len(self.table) <= k:
            self.table.append(self.rng.rand(100000).astype(np.float32))
        return self.table[k][:size]

    def port_uniform(self, gen, shape, device):
        self.calls += 1
        return torch.from_numpy(self.row(self.calls - 1, shape[-1]).copy()).expand(
            tuple(shape)).to(device)


def blob_batch(rng: np.random.RandomState, b: int):
    """``b`` images of blob nuclei: boxes, labels, 64² mask patches and a
    stride-4 semantic map; image i has 2·(i mod 2) padding slots."""
    img = rng.randn(b, SIDE, SIDE, 3).astype(np.float32)
    gt_boxes = np.zeros((b, G, 4), np.float32)
    gt_valid = np.zeros((b, G), bool)
    patches = np.zeros((b, G, 64, 64), np.float32)
    sem = np.zeros((b, SIDE // 4, SIDE // 4), np.int32)
    yy, xx = np.mgrid[:64, :64]
    for i in range(b):
        k = G - 2 * (i % 2)
        c = rng.uniform(8, SIDE - 8, (k, 2))
        half = rng.uniform(3, 8, (k, 2))
        gt_boxes[i, :k] = np.concatenate([c - half, c + half], 1)
        gt_valid[i, :k] = True
        for j in range(k):
            patches[i, j] = ((yy - 31.5) ** 2 + (xx - 31.5) ** 2 <= 30 ** 2)
            x1, y1, x2, y2 = (gt_boxes[i, j] / 4).astype(int)
            sem[i, y1:y2 + 1, x1:x2 + 1] = 1
    gt_labels = rng.randint(0, 5, (b, G)).astype(np.int32)
    return dict(img=img, gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid,
                gt_patches=patches, gt_ismask=np.ones((b, G), np.float32), gt_semantic=sem)


def port_model(state_dict, drop_path_rate: float = 0.0):
    """The tiny config's detector (scale 1) on ``state_dict``, in train mode."""
    from nuhtc_tpu_torch.config import Config
    from nuhtc_tpu_torch.models.build import build_detector

    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_options({"model.backbone.drop_path_rate": drop_path_rate})
    model = build_detector(cfg.model, None, 1.0)
    model.load_state_dict(state_dict, strict=True)
    return model.train()


def rows(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, torch.Tensor]:
    """This rank's local batch of the global ``batch``."""
    b = len(batch["img"]) // world
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank * b:(rank + 1) * b]))
            for k, v in batch.items()}


def train_step(model, batch, cum, generator):
    """One ``make_train_step`` step at the lr ``STEP_LR`` from a fresh
    train state with ``cum`` → (state, metrics)."""
    from nuhtc_tpu_torch.train import train_state as TS

    state, tx = TS.create_train_state(model, num_stages=3, num_classes=5,
                                      schedule=TS.lr_schedule(STEP_LR, warmup_ratio=1.0))
    state.cum_samples = torch.from_numpy(cum.copy())
    step = TS.make_train_step(model, tx)
    return step(state, batch, generator)


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value, or the tensor."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _step_record(model, state, metrics) -> dict:
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                cum=state.cum_samples.clone(),
                grads={n: full(p.grad).clone() for n, p in model.named_parameters()},
                params={n: full(p.detach()).clone() for n, p in model.named_parameters()},
                ema={n: full(e).clone() for n, e in state.ema_params.items()})


def pair_rank(rank: int, world: int, setup_path: str, argv_train, argv_test,
              out: str) -> None:
    """A rank of the two-rank session: ``dp_record``, ``semi_record``, then
    ``tools_record``."""
    setup = torch.load(setup_path, weights_only=False)
    torch.save(dict(dp_record(rank, world, setup_path),
                    semi=semi_record(setup["batch"], rank, world),
                    tools=tools_record(rank, argv_train, argv_test)),
               os.path.join(out, f"rank{rank}.pt"))


def semi_record(batch: Dict[str, np.ndarray], rank: int, world: int) -> dict:
    """One step of ``make_semi_train_step`` on this rank's rows of ``batch``
    (the labelled images) and of an unlabelled batch of seed 4: a tiny
    Mask R-CNN student from seed 0 (embed 32, depths 1-1-1-1, FPN 32, 4
    classes), its teacher the student plus noise of seed 9, pseudo labels
    from 0.2 → the metrics and the weights of both."""
    from nuhtc_tpu_torch.models.build import init_random_weights
    from nuhtc_tpu_torch.models.mask_rcnn import MaskRCNN
    from nuhtc_tpu_torch.models.semi import MultiStreamDetector
    from nuhtc_tpu_torch.train import train_state as TS

    def tiny():
        return MaskRCNN(num_classes=4, fpn_channels=32, rpn_nms_pre=128, rpn_max_per_img=64,
                        rcnn_max_per_img=16, nms_candidates=128, backbone_cfg=dict(
                            embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8)))

    student = init_random_weights(tiny(), torch.Generator().manual_seed(0))
    wrapper = MultiStreamDetector(student, tiny(), score_thr=0.2, max_gt=12)
    state, tx = TS.create_semi_train_state(student, wrapper.teacher, num_stages=1,
                                           num_classes=4)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():  # the teacher starts as the student's copy
        for p in state.teacher_params.values():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    unsup = np.random.RandomState(4).randn(*batch["img"].shape).astype(np.float32)
    local = rows(dict(batch, gt_labels=batch["gt_labels"] % 4, unsup_img=unsup), rank, world)
    step = TS.make_semi_train_step(wrapper, tx, burn_in=0)
    state, metrics = step(state, local, torch.Generator().manual_seed(5))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                student={n: p.detach().clone() for n, p in state.student_params.items()},
                teacher={n: p.detach().clone() for n, p in state.teacher_params.items()})


def dp_record(rank: int, world: int, setup_path: str) -> dict:
    """The shared-draw step on this rank's images, then a drop-path step
    with the generator's own draws, each stochastic-depth mask recorded."""
    import pytest

    from nuhtc_tpu_torch.models import swin
    from nuhtc_tpu_torch.train import targets as T

    setup = torch.load(setup_path, weights_only=False)
    draws = Draws(setup["draws_seed"])
    mp = pytest.MonkeyPatch()
    mp.setattr(T, "uniform", draws.port_uniform)
    try:
        model = port_model(setup["state_dict"])
        state, metrics = train_step(model, rows(setup["batch"], rank, world), setup["cum"],
                                    torch.Generator())
    finally:
        mp.undo()
    record = dict(shared=_step_record(model, state, metrics), calls=draws.calls)

    masks = []
    real_keep = swin.keep_mask
    mp.setattr(swin, "keep_mask", lambda *a: masks.append(real_keep(*a)) or masks[-1])
    try:
        model = port_model(setup["state_dict"], setup["drop_path_rate"])
        _, metrics = train_step(model, rows(setup["batch"], rank, world), setup["cum"],
                                torch.Generator().manual_seed(setup["drop_seed"]))
    finally:
        mp.undo()
    record["drop"] = dict(masks=masks, metrics={k: float(v) for k, v in metrics.items()})
    return record


def fsdp_rank(rank: int, world: int, setup_path: str, out: str) -> None:
    """The shared-draw step of ``dp_record`` under ``shard_state`` on a
    (world/2) × 2 mesh, one image a rank; the placements of the parameters,
    EMA and moments; the K1 pack key across an FSDP gather; then
    ``parallel.dryrun.dryrun_rank`` in the same group, its OK lines."""
    import pytest
    from torch.distributed.tensor import DTensor

    from nuhtc_tpu_torch.ops.window_block import source_key
    from nuhtc_tpu_torch.parallel.dryrun import dryrun_rank
    from nuhtc_tpu_torch.parallel.shard_rules import make_mesh_2d, shard_state
    from nuhtc_tpu_torch.train import targets as T

    setup = torch.load(setup_path, weights_only=False)
    model = port_model(setup["state_dict"])
    mesh = make_mesh_2d(world // 2, 2)
    shard_state(model, mesh)

    # a Swin block whose qkv weight the rule shards: its K1 sources as its
    # forward sees them (gathered)
    blk = model.backbone.stages[3].blocks[0]
    seen = []
    blk.register_forward_pre_hook(lambda m, a: seen.append(
        (source_key([m.attn.w_msa.qkv.weight]), m.attn.w_msa.qkv.weight.detach().clone())))
    local = rows(setup["batch"], rank, world)
    with torch.no_grad():
        model.eval()(local["img"])
    model.reshard()

    draws = Draws(setup["draws_seed"])
    mp = pytest.MonkeyPatch()
    mp.setattr(T, "uniform", draws.port_uniform)
    try:
        state, metrics = train_step(model.train(), local, setup["cum"], torch.Generator())
    finally:
        mp.undo()

    def placements(t):
        return tuple(t.placements) if isinstance(t, DTensor) else None

    record = _step_record(model, state, metrics)
    record["placements"] = {n: dict(param=placements(p), ema=placements(state.ema_params[n]),
                                    mu=placements(state.opt_state.mu[n]),
                                    nu=placements(state.opt_state.nu[n]))
                            for n, p in model.named_parameters()}
    with torch.no_grad():
        model.eval()(local["img"])
    record["k1"] = [seen[0], seen[-1]]
    record["dryrun"] = dryrun_rank(rank, world)
    torch.save(record, os.path.join(out, f"rank{rank}.pt"))


def tools_record(rank: int, argv_train, argv_test) -> dict:
    """``tools.train`` then ``tools.test`` with ``--launcher pytorch`` in the
    running group; ``{rank}`` in an argument is this rank's number. → the
    loader seeds, the trained parameters and ``main``'s returns."""
    import pytest

    from nuhtc_tpu_torch.data import loader as LD
    from nuhtc_tpu_torch.tools import test as test_tool
    from nuhtc_tpu_torch.tools import train as train_tool

    seeds = []

    class Recording(LD.PrefetchLoader):
        def __init__(self, *a, **k):
            seeds.append(k["seed"])
            super().__init__(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(LD, "PrefetchLoader", Recording)
    try:
        state = train_tool.main([a.format(rank=rank) for a in argv_train])
    finally:
        mp.undo()
    rc = test_tool.main([a.format(rank=rank) for a in argv_test])
    return dict(seeds=seeds, rc=rc, step=state.step,
                params={n: p.detach().clone() for n, p in state.params.items()})
