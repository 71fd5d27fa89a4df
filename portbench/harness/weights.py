"""Random weights, made on the device: a frozen copy of the rule of the
port's ``models/build.py init_random_weights`` (linear and conv weights
normal with std 1/sqrt(fan_in), the cosine classifier's std 0.01, biases 0,
norms 1/0, and what a module class declares in ``INIT`` for the parameters
it owns itself: Swin's relative-position bias tables std 0.02), then the lift
of ``tools/synthetic.py lift_objectness`` (+3 on each cascade head's
positive-objectness logit; on a Mask R-CNN's first class): random weights
score no detection above NuHTC's 0.35 without it.

The draws come from the configuration's ``weights_seed``, not from a run's
``--seed``: a model of random weights is a different model at every seed,
and on the card twelve seeds gave NuHTC 272 to 500 detections a tile and 0
to 348 nuclei, so the seed, not the traffic, set the post-processing's work.
One model serves every run, as one model serves a lab's slides; the runs'
seeds draw the tiles and the check's sample.

All the normal draws come from one ``torch.randn`` on the device, in f32,
cut into the tensors and cast to the serving type. The names and shapes are
read off the reference model, built on the meta device; the same state dict
loads into the port's model and, in f32, into the reference."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from portbench.reference import model as ref_model

LIFT = 3.0


def _rule(model: nn.Module) -> List[Tuple[str, tuple, object]]:
    """(name, shape, std | "zeros" | "ones") for every parameter, in the
    order of the module walk (each module's own ``INIT`` after its type's
    rows): the order of the draws."""
    out, seen = [], set()
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, ref_model.NormedLinear):
            rows = [("weight", 0.01), ("bias", "zeros")]
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            rows = [("weight", m.weight[0].numel() ** -0.5), ("bias", "zeros")]
        elif isinstance(m, nn.ConvTranspose2d):
            rows = [("weight", (m.weight.shape[0] * m.weight[0, 0].numel()) ** -0.5),
                    ("bias", "zeros")]
        elif isinstance(m, nn.LayerNorm):
            rows = [("weight", "ones"), ("bias", "zeros")]
        else:
            rows = []
        rows += list(getattr(type(m), "INIT", {}).items())
        for attr, how in rows:
            t = getattr(m, attr, None)
            if isinstance(t, nn.Parameter):
                out.append((p + attr, tuple(t.shape), how))
                seen.add(p + attr)
    missing = {n for n, _ in model.named_parameters()} - seen
    if missing:
        raise ValueError(f"weights: no rule for {sorted(missing)[:4]}")
    return out


def _lift_entries(cfg: dict, model: nn.Module) -> List[Tuple[str, int]]:
    if cfg["model"]["type"] == "MaskRCNN":
        return [("roi_head.bbox_head.fc_cls.bias", 0)]
    return [(f"roi_head.bbox_head.{i}.fc_cls.bias", h.num_classes)
            for i, h in enumerate(model.roi_head.bbox_head)]


def make(cfg: dict, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The state dict of ``cfg``'s model drawn from ``seed`` (a run passes
    ``cfg["weights_seed"]``), on ``device`` in ``dtype``, objectness lifted."""
    with torch.device("meta"):
        skeleton = ref_model.build(cfg)
    rule = _rule(skeleton)
    total = sum(int(torch.Size(s).numel()) for _, s, how in rule if not isinstance(how, str))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draws = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd, at = {}, 0
    lifts = dict(_lift_entries(cfg, skeleton))
    for name, shape, how in rule:
        if how == "zeros":
            t = torch.zeros(shape, device=device, dtype=torch.float32)
        elif how == "ones":
            t = torch.ones(shape, device=device, dtype=torch.float32)
        else:
            n = int(torch.Size(shape).numel())
            t = draws[at:at + n].view(shape) * how
            at += n
        if name in lifts:
            t = t.clone()
            t[lifts[name]] += LIFT
        sd[name] = t.to(dtype)
    return sd
