"""The data × model mesh (port of nuhtc_tpu/parallel/shard_rules.py).

The JAX package shards large parameters, their EMA and the AdamW moments on
the "model" axis of a 2-D ``Mesh(("data", "model"))`` and lets GSPMD insert
the collectives. The port's counterpart is FSDP2 (``fully_shard``) over the
2-D device mesh, as HSDP: every parameter the rule shards is a DTensor
placed ``(Replicate(), Shard(d))``, replicated along "data" and sharded on
dimension ``d`` along "model"; FSDP all-gathers it before the forward and
reduce-scatters its gradient after the backward. The EMA and the moments
made from a sharded parameter (``train_state.create_train_state``) are
DTensors of the same placements. Every rank is a data-parallel rank of
FSDP's, so the global batch is split over all ``n_data · n_model`` ranks
(``mesh.global_rows``); the gradients are summed over all of them (FSDP's
divide factor 1), as the 1-D step sums them.

``leaf_spec`` is the JAX rule on the leaf's JAX layout: the port's
parameters are the JAX leaves transposed (``utils/convert.py``: a linear
weight (out, in) is the flax kernel (in, out), a convolution (O, I, kh, kw)
the kernel (kh, kw, I, O)), and a tie between equal dimensions goes the way
the JAX rule breaks it on the JAX layout, so each parameter is sharded
along the same logical axis as in the JAX package. A leaf the rule
replicates while the model axis has more than one rank stays a plain
tensor outside FSDP (``ignored_params``); its gradient goes through the
step's all-reduce. On a model axis of one rank, sharding and replication
hold the same bytes, and FSDP takes every leaf (``Shard(0)`` where the
rule replicates).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from torch import nn

# don't bother sharding anything smaller than this (bytes are ~4x this):
# biases, LayerNorm scales, anchors — replication is cheaper than the
# collective traffic
MIN_SHARD_ELEMS = 65536

# the port's dimension of each JAX dimension, by module type (the inverse of
# utils/convert.py's layout transforms)
_JAX_DIMS = {nn.Linear: (1, 0), nn.Conv2d: (2, 3, 1, 0), nn.ConvTranspose2d: (2, 3, 0, 1)}


def make_mesh_2d(n_data: int, n_model: int, axes: Tuple[str, str] = ("data", "model"),
                 device_type: Optional[str] = None):
    """The 2-D device mesh: 'data' major, 'model' minor (the model axis's
    collectives stay among neighbouring ranks). Needs a process group of at
    least ``n_data · n_model`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh_2d: no process group; call init_distributed first")
    need = n_data * n_model
    if dist.get_world_size() < need:
        raise ValueError(f"make_mesh_2d: {dist.get_world_size()} ranks, {need} needed")
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=tuple(axes))


def leaf_spec(shape: Sequence[int], n_model: int, axis: str = "model",
              min_elems: int = MIN_SHARD_ELEMS,
              jax_dims: Optional[Sequence[int]] = None) -> tuple:
    """The JAX package's rule as a tuple spec (``()`` replicated, else one
    entry per dimension, ``axis`` on the sharded one): shard the largest
    ``n_model``-divisible dimension, the trailing one on ties, of the leaf in
    its JAX layout. ``jax_dims[i]``: the dimension of ``shape`` holding JAX
    dimension i (identity when None)."""
    if n_model <= 1 or int(np.prod(shape)) < min_elems:
        return ()
    jax_dims = tuple(range(len(shape))) if jax_dims is None else tuple(jax_dims)
    jshape = [shape[d] for d in jax_dims]
    best = None
    for d in range(len(jshape) - 1, -1, -1):
        if jshape[d] % n_model == 0 and (best is None or jshape[d] > jshape[best]):
            best = d
    if best is None:
        return ()
    spec: list = [None] * len(shape)
    spec[jax_dims[best]] = axis
    return tuple(spec)


def param_jax_dims(model: nn.Module) -> Dict[str, Optional[Tuple[int, ...]]]:
    """Each parameter's ``jax_dims`` (None: the JAX layout is the port's)."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            dims = _JAX_DIMS.get(type(mod)) if pname == "weight" else None
            out[f"{mname}.{pname}" if mname else pname] = dims
    return out


def tree_shardings(model: nn.Module, mesh, axis: str = "model",
                   min_elems: int = MIN_SHARD_ELEMS) -> Dict[str, tuple]:
    """Each parameter's spec (``leaf_spec`` on its JAX layout) on ``mesh``:
    a DeviceMesh, or the model axis's size."""
    n_model = mesh if isinstance(mesh, int) else mesh[axis].size()
    dims = param_jax_dims(model)
    return {name: leaf_spec(p.shape, n_model, axis, min_elems, dims[name])
            for name, p in model.named_parameters()}


def shard_state(model: nn.Module, mesh, axis: str = "model",
                min_elems: int = MIN_SHARD_ELEMS) -> nn.Module:
    """FSDP2 ``fully_shard`` of ``model`` over the 2-D ``mesh`` under the
    sharding rule (HSDP: replicated on the first axis, ``Shard(d)`` on
    ``axis``), gradients summed over every rank, ``compute_losses`` made a
    forward method (FSDP gathers the parameters before it). Call it before
    ``create_train_state``: the EMA and the moments follow the parameters'
    placements. Returns the module, now an ``FSDPModule``."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    from nuhtc_tpu_torch.ops.window_block import weights_gathered

    specs = tree_shardings(model, mesh, axis, min_elems)
    n_model = mesh[axis].size()
    params = dict(model.named_parameters())
    placement, ignored = {}, set()
    for name, spec in specs.items():
        p = params[name]
        if spec:
            placement[id(p)] = Shard(spec.index(axis))
        elif n_model > 1:
            ignored.add(p)
        else:
            placement[id(p)] = Shard(0)
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: placement[id(p)],
                ignored_params=ignored)
    # summed, not averaged, and by a plain SUM (gloo has no pre-scaled sum)
    model.set_gradient_divide_factor(1.0)
    model.set_force_sum_reduction_for_comms(True)
    if hasattr(model, "compute_losses"):
        register_fsdp_forward_method(model, "compute_losses")
    # FSDP writes the gathered weights into reused storage without a version
    # bump: the K1/K2 weight packs key on this count too (runs after FSDP's
    # own pre-forward hook, which gathers)
    model.register_forward_pre_hook(lambda *_: weights_gathered())
    return model
