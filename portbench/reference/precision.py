"""The control of the comparison that decides ``correct``: the reference in
the nearest precision below the configuration's bf16, fp8 (e4m3). Every
linear, convolution and transposed convolution of the reference takes its
weight and its input rounded to e4m3 with one scale a tensor (the tensor's
largest magnitude maps to e4m3's largest, 448) and accumulates in f32, as an
fp8 inference of this model would. The control must come out not correct."""

from __future__ import annotations

import torch
from torch import nn

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, back in x's type."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _round_input(_module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


@torch.no_grad()
def to_fp8(model: nn.Module) -> nn.Module:
    """Rounds ``model``'s linear and convolution weights in place and hooks
    their inputs; returns the model."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(fp8_round(m.weight))
            m.register_forward_pre_hook(_round_input)
    return model
