"""Multi-process dry run on the CPU (port of __graft_entry__.py
``dryrun_multichip``): the tiny NuHTC over ``n`` gloo processes, one image
each.

  python -m nuhtc_tpu_torch.parallel.dryrun 8

(a) one data-parallel train step (``make_train_step`` in a group of ``n``):
the total loss finite, the step count 1; (b) the sharded evaluation on the
1-D mesh (``make_mesh``, its batch and replicated placements): each
rank's forward on its image, the per-image records gathered
(``gather_objects``) and merged back into order (``merge_strided_results``),
every output's leading axis the global batch and every value finite; (c)
for an even ``n`` ≥ 4, one step of a fresh copy under ``shard_state`` on the
(n/2) × 2 data × model mesh, with at least one parameter sharded. Rank 0
prints one OK line for each, as the JAX dry run does. ``dryrun_rank`` is one
rank's part, for a process group that already exists. Importing this module
starts nothing.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

SIDE, GTS = 64, 8


def tiny_model(seed: int = 0):
    """The JAX dry run's tiny NuHTC (embed 32, depths 1-1-1-1, FPN 32), f32,
    weights from ``seed``."""
    import torch

    from nuhtc_tpu_torch.models.build import init_random_weights
    from nuhtc_tpu_torch.models.detector import NuHTC

    model = NuHTC(num_classes=5, fpn_channels=32,
                  backbone_cfg=dict(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8)),
                  rpn_nms_pre=256, rpn_max_per_img=128, rpn_min_bbox_size=0.0,
                  rcnn_max_per_img=64, watershed_max=64, nms_candidates=256)
    return init_random_weights(model, torch.Generator().manual_seed(seed))


def global_batch(b: int) -> dict:
    """The JAX dry run's batch of ``b`` images, from seed 0."""
    rng = np.random.RandomState(0)
    return {
        "img": rng.randn(b, SIDE, SIDE, 3).astype(np.float32),
        "gt_boxes": np.tile(np.asarray([[4.0, 4.0, 20.0, 20.0]], np.float32), (b, GTS, 1)),
        "gt_labels": np.zeros((b, GTS), np.int32),
        "gt_valid": np.tile(np.arange(GTS) < 3, (b, 1)),
        "gt_patches": np.ones((b, GTS, 28, 28), np.float32),
        "gt_semantic": (rng.rand(b, SIDE // 4, SIDE // 4) > 0.7).astype(np.int32),
    }


def _step(model, batch):
    import torch

    from nuhtc_tpu_torch.train.train_state import create_train_state, make_train_step

    state, tx = create_train_state(model, num_stages=3, num_classes=5)
    step = make_train_step(model, tx, finetune_iter=10)
    return step(state, batch, torch.Generator().manual_seed(1))


def dryrun_rank(rank: int, n: int) -> List[str]:
    """The three parts on rank ``rank`` of a process group of ``n``; → the
    OK lines, which rank 0 prints as each part passes."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from nuhtc_tpu_torch.parallel import mesh as P
    from nuhtc_tpu_torch.parallel.shard_rules import make_mesh_2d, shard_state, tree_shardings

    host = global_batch(n)
    local = P.shard_batch({k: v[rank:rank + 1] for k, v in host.items()}, torch.device("cpu"))

    model = tiny_model()
    state, metrics = _step(model, local)
    total = float(metrics["total"])
    assert np.isfinite(total), f"non-finite loss: {metrics}"
    assert state.step == 1
    ok: List[str] = []

    def passed(line: str) -> None:
        ok.append(line)
        if rank == 0:
            print(line, flush=True)

    passed(f"dryrun_multichip({n}): total loss {total:.4f} OK")

    # sharded eval: each rank's image on the 1-D mesh, the records gathered
    # and merged
    mesh = P.make_mesh()
    assert mesh.size() == n and P.batch_sharding(mesh) == (Shard(0),)
    assert P.replicated_sharding(mesh) == (Replicate(),)
    with torch.no_grad():
        det = {k: v.numpy() for k, v in model.eval()(local["img"]).items()}
    my_idxs = list(range(rank, n, n))
    records = [(i, {k: det[k][j] for k in det}) for j, i in enumerate(my_idxs)]
    merged = P.merge_strided_results(P.gather_objects(records))
    assert len(merged) == n, len(merged)
    for k in det:
        v = np.stack([m[k] for m in merged])
        assert v.shape[0] == n, (k, v.shape)
        assert np.isfinite(np.asarray(v, np.float64)).all(), k
    passed(f"dryrun_multichip({n}): sharded eval + gather/merge OK")

    if n >= 4 and n % 2 == 0:
        mesh2 = make_mesh_2d(n // 2, 2)
        model2 = tiny_model()
        n_sharded = sum(1 for spec in tree_shardings(model2, mesh2).values() if spec)
        assert n_sharded > 0, "no parameter sharded on the model axis"
        shard_state(model2, mesh2)
        _, metrics2 = _step(model2, local)
        total2 = float(metrics2["total"])
        assert np.isfinite(total2), f"non-finite 2-D-mesh loss: {metrics2}"
        passed(f"dryrun_multichip({n}): 2-D mesh ({n // 2}x2 data x model, {n_sharded} "
               f"sharded param leaves) total loss {total2:.4f} OK")
    return ok


def dryrun_multichip(n_devices: int) -> None:
    """Runs the three parts over ``n_devices`` gloo CPU processes (at most
    600 s)."""
    from nuhtc_tpu_torch.parallel.launch import run_ranks

    run_ranks(dryrun_rank, n_devices, timeout=600.0)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
