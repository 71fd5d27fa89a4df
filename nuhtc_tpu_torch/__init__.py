"""NuHTC on PyTorch and CUDA: the patch-inference, whole-slide,
dataset-evaluation and supervised-training paths of ``nuhtc_tpu`` ported to
an NVIDIA H100, with hand-written Hopper kernels (``csrc/``) in place of the
JAX package's Pallas kernels. Imports ``torch``, never ``jax``.
"""

from nuhtc_tpu_torch.version import __version__

__all__ = ["__version__"]
