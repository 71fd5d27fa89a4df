"""Share of the device's busy time that the deformable attention's bilinear
sampling kernels take, in %: 100 · the traced window's time of kernels whose
name holds ``grid_sampler`` (PyTorch's ``grid_sample``, which the plain core
``ops/ms_deform_attn.py`` runs) or ``ms_deform_attn`` (the name a hand
kernel for the sampling carries) over ``busy_s``. None where no such kernel
ran (no ViT-Adapter)."""

from portbench.harness.trace import kernel_seconds

KERNELS = ("grid_sampler", "ms_deform_attn")


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.get("busy_s"):
        return None
    t = kernel_seconds(tr, KERNELS)
    if t <= 0:
        return None
    return 100.0 * t / tr["busy_s"]
