"""Data-parallel training and evaluation over a process group, and the
data × model mesh (port of nuhtc_tpu/parallel)."""

from nuhtc_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate"]
