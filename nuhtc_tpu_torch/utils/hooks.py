"""Training hooks (port of nuhtc_tpu/utils/hooks.py; reference
nuhtc/utils/hooks/):

- ``WeightSummary``: the parameter table at the start of a run;
- ``MaskVisHook``: prediction overlays of a few images every ``interval``
  steps, to a ``MetricLogger``;
- ``Weighter`` / ``piecewise_schedule`` / ``build_weighter``: scheduled
  loss weights, applied inside the differentiated loss.

EMA and the unfreeze step live in ``train.train_state.make_train_step``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


class WeightSummary:
    def __call__(self, named_params, logger) -> None:
        total = 0
        lines = []
        for name, p in sorted(named_params):
            count = int(np.prod(tuple(p.shape)))
            total += count
            lines.append(f"{name:<80s} {str(tuple(p.shape)):>20s} {count:>12,d}")
        logger.info("parameter summary:\n" + "\n".join(lines))
        logger.info(f"total parameters: {total / 1e6:.2f} M")


class MaskVisHook:
    """Renders the predictions on a fixed sample every ``interval`` steps."""

    def __init__(self, engine_factory: Callable, dataset, metric_logger, interval: int = 2000,
                 num_images: int = 2):
        self.engine_factory = engine_factory
        self.dataset = dataset
        self.metric_logger = metric_logger
        self.interval = interval
        self.num_images = num_images

    def maybe_log(self, step: int, state_dict) -> None:
        if step % self.interval:
            return
        from nuhtc_tpu_torch.utils.visualize import draw_detections

        engine = self.engine_factory(state_dict)
        idxs = list(range(min(self.num_images, len(self.dataset))))
        imgs = [self.dataset.load_image(i) for i in idxs]
        for i, res in zip(idxs, engine.run_batch(imgs)):
            vis = draw_detections(imgs[i], res.get("masks", []), res["labels"],
                                  palette=getattr(self.dataset, "PALETTE", None))
            self.metric_logger.log_image(f"train/pred_{i}", vis, step)


class Weighter:
    """Scales named loss terms by a schedule of the step; "total" becomes
    the sum of the other terms (aggregates ending in ".total" left out)."""

    def __init__(self, schedules: Dict[str, Callable[[int], float]]):
        self.schedules = schedules

    def __call__(self, losses: Dict, step: int) -> Dict:
        out = dict(losses)
        for name, fn in self.schedules.items():
            if name in out:
                out[name] = out[name] * fn(step)
        out["total"] = sum(v for k, v in out.items()
                           if k != "total" and not k.endswith(".total"))
        return out


def piecewise_schedule(boundaries, values):
    """values[i] for steps in [boundaries[i-1], boundaries[i])."""
    boundaries, values = list(boundaries), list(values)
    if len(values) != len(boundaries) + 1:
        raise ValueError("piecewise_schedule: one value more than boundaries")

    def fn(step):
        w = float(values[0])
        for b, v in zip(boundaries, values[1:]):
            if step >= b:
                w = float(v)
        return w

    return fn


def build_weighter(cfg: Optional[Dict]) -> Optional[Weighter]:
    """``loss_weight_schedules``: loss name → a constant or
    ``dict(steps=[...], vals=[...])``."""
    if not cfg:
        return None
    schedules = {}
    for name, spec in cfg.items():
        if isinstance(spec, (int, float)):
            schedules[name] = (lambda v: lambda step: v)(float(spec))
        else:
            schedules[name] = piecewise_schedule(spec["steps"], spec["vals"])
    return Weighter(schedules)
