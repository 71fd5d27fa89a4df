"""Process groups and the data-parallel helpers (port of
nuhtc_tpu/parallel/mesh.py).

The reference's only parallelism is NCCL data-parallel DDP (SURVEY.md §2d;
reference nuhtc/apis/train.py:90-97, tools/train.py:136). The port runs one
process per card, as ``torchrun`` launches them: ``init_distributed`` reads
torchrun's environment and joins the group (NCCL on a card, gloo on the
CPU), ``make_mesh`` is the 1-D ``("data",)`` device mesh, ``shard_batch``
places a rank's local batch, ``replicate`` broadcasts from rank 0, and
``gather_objects`` / ``merge_strided_results`` collect per-rank evaluation
results (reference mmdet ``multi_gpu_test``, tools/test.py:239).

A data-parallel step computes the global batch's loss, as the JAX package's
sharded step does: rank r holds local batch r (``samples_per_gpu`` images;
every rank holds as many) and the global batch is their concatenation in
rank order. So each rank's loss is its share of the global loss:

- ``global_sum``: a normalizer (a count of samples, a sum of weights, the
  seesaw class counts) summed over the ranks;
- ``share``: a mean over the local images or pixels, divided by the world
  size (the rank's share b/B);
- ``global_rows`` / ``rank_rows``: a random draw over the batch axis is made
  for the global batch on every rank, from a generator seeded alike on every
  rank, and each rank takes its own rows;
- ``all_reduce_sum``: the gradients (and the reported losses) summed over
  the ranks in one bucketed all-reduce, so that Σ_r L_r = L_global and the
  gradient is ∇L_global.

``global_sum``, ``share``, ``global_rows`` and ``rank_rows`` span the
ranks only inside ``data_parallel()``, the scope
that the train steps (``train/train_state.py``) enter around their forward:
the step decides that its losses are the global batch's, and a loss or a
draw computed elsewhere, in a process group or not, stays local and makes
no collective. Outside that scope, or without a process group, each of them
is the identity (rank 0 of 1); in a group of one the collectives copy, so a
one-rank run equals an unlaunched one bit for bit. ``COLLECTIVES`` counts every collective these helpers make
and the bytes it moves, by name.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# name → [calls, bytes] of the collectives made since the last reset
COLLECTIVES: Dict[str, List[int]] = {}
# True inside ``data_parallel()``
_DATA_PARALLEL = False


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _count(name: str, nbytes: int) -> None:
    entry = COLLECTIVES.setdefault(name, [0, 0])
    entry[0] += 1
    entry[1] += int(nbytes)


def is_distributed() -> bool:
    """True inside an initialised process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device() -> torch.device:
    """``cuda:LOCAL_RANK``: the card torchrun gives this process."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(backend: Optional[str] = None,
                     device: Optional[torch.device] = None) -> int:
    """Joins the process group torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    returns the world size. Without ``WORLD_SIZE`` in the environment it
    returns 1 and makes no group; inside a group it returns that group's
    size. The backend is NCCL when ``device`` (default ``cuda:LOCAL_RANK``)
    is a card, gloo on the CPU, or ``backend`` when the caller names one;
    a card device becomes the process's current device. An environment that
    asks for a group either gets one or this raises."""
    if is_distributed():
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 1
    device = torch.device(device) if device is not None else local_device()
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_world_size()


def destroy_distributed() -> None:
    """Leaves the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


@contextlib.contextmanager
def launched(launcher: str, device: torch.device, device_named: bool):
    """The process group a command line's ``--launcher`` asks for; yields
    (device, rank, world size). "none": ``device``, 0, 1 and no group.
    "pytorch": the group of torchrun's environment (this raises without
    it), on ``cuda:LOCAL_RANK`` unless the command line named the device;
    a group made here is left on exit."""
    if launcher == "none":
        yield device, 0, 1
        return
    if launcher != "pytorch":
        raise ValueError(f"launcher {launcher!r}: 'none' or 'pytorch'")
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--launcher pytorch: no RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT in "
                           "the environment; start the processes with torchrun")
    if not device_named:
        device = local_device()
    created = not is_distributed()
    size = init_distributed(device=device)
    try:
        yield device, world()[0], size
    finally:
        if created:
            destroy_distributed()


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device_type: Optional[str] = None):
    """The 1-D device mesh ``(axis,)`` over the first ``n_devices`` ranks
    (all by default) of the process group, which must exist
    (``init_distributed``). ``device_type`` defaults to "cuda" under NCCL,
    else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_distributed():
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    n = n_devices or dist.get_world_size()
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    out = []
    _tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor) else None, tree)
    return out


def shard_batch(batch: Any, device: torch.device) -> Any:
    """Places this rank's local batch (numpy arrays or tensors, in a dict,
    list or tuple) on ``device``: the global batch is the ranks' local
    batches in rank order, as the JAX package's
    ``make_array_from_process_local_data`` assembles it."""
    return _tree_map(lambda x: torch.as_tensor(x).to(device, non_blocking=True), batch)


@torch.no_grad()
def _bucketed(tensors: Iterable[torch.Tensor], collective, name: str) -> None:
    """``collective`` on each (dtype, device) bucket of the flattened
    tensors, the results copied back in place."""
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        _count(name, flat.numel() * flat.element_size())
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicate(tree: Any, src: int = 0) -> Any:
    """Broadcasts every tensor of ``tree`` (a module's parameters and
    buffers, or the tensors of a dict, list or tuple) from rank ``src`` in
    place, one broadcast per dtype, and returns ``tree``; the identity
    without a group."""
    if is_distributed():
        _bucketed([x.data for x in _leaves(tree)], lambda flat: dist.broadcast(flat, src),
                  "replicate")
    return tree


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's ``obj`` in rank order, on every rank
    (``all_gather_object``); ``[obj]`` without a group."""
    if not is_distributed():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    _count("gather_objects", 0)
    return out


def merge_strided_results(parts: Sequence[Sequence[Any]]) -> List[Any]:
    """Merge per-process (index, result) lists back into dataset order.

    Processes stride the dataset (``idxs = pid::nproc``, reference
    tools/test.py:239 multi-GPU collect), so per-process lists have uneven
    lengths when ``n % nproc != 0``; the merged list is sorted by the
    original index. Input: ``gather_objects(list(zip(my_idxs, results)))``."""
    merged = sorted((pair for part in parts for pair in part), key=lambda p: p[0])
    return [r for _, r in merged]


def batch_sharding(mesh, axis: str = "data") -> tuple:
    """The placements of a batch on ``mesh``: sharded on its leading axis
    along ``axis``, replicated along the others."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated_sharding(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def barrier() -> None:
    """Waits for every rank; nothing without a group."""
    if is_distributed():
        dist.barrier()


@contextlib.contextmanager
def data_parallel():
    """The scope of a data-parallel step: inside it, in a process group,
    ``global_sum``, ``share``, ``global_rows`` and ``rank_rows`` span the
    ranks."""
    global _DATA_PARALLEL
    outer, _DATA_PARALLEL = _DATA_PARALLEL, True
    try:
        yield
    finally:
        _DATA_PARALLEL = outer


def _spans_ranks() -> bool:
    return _DATA_PARALLEL and is_distributed()


def global_sum(x: torch.Tensor, name: str = "normalizer") -> torch.Tensor:
    """``x`` summed over the ranks (detached: a normalizer carries no
    gradient) inside ``data_parallel()``; ``x`` itself elsewhere."""
    if not _spans_ranks():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    _count(name, y.numel() * y.element_size())
    return y


def share(x: torch.Tensor) -> torch.Tensor:
    """A mean over the local batch as this rank's share of the global mean
    (every rank holds as many images): ``x`` / world size inside
    ``data_parallel()``; ``x`` itself elsewhere."""
    return x / world()[1] if _spans_ranks() else x


def global_rows(shape: Sequence[int]) -> Tuple[int, ...]:
    """The global batch's shape of a per-rank ``shape`` (batch axis first)
    inside ``data_parallel()``; ``shape`` elsewhere."""
    size = world()[1] if _spans_ranks() else 1
    return (shape[0] * size,) + tuple(shape[1:])


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch inside
    ``data_parallel()``; ``x`` elsewhere."""
    if not _spans_ranks():
        return x
    rank, size = world()
    b = x.shape[0] // size
    return x[rank * b:(rank + 1) * b]


def all_reduce_sum(tensors: Iterable[torch.Tensor], name: str = "grads") -> None:
    """Sums each tensor over the ranks in place: one all-reduce per
    (dtype, device) bucket of the flattened tensors; nothing without a
    group."""
    if is_distributed():
        _bucketed(tensors, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM), name)
