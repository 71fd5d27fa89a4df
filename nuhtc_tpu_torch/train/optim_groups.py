"""Named per-parameter optimizer groups (port of nuhtc_tpu/train/optim_groups.py;
reference NamedOptimizerConstructor and mmcv ``paramwise_cfg.custom_keys``):
the first rule whose pattern the parameter's name holds gives its lr and
decay multipliers, as ``optax.multi_transform`` of one AdamW per group
(each group's AdamW decays every parameter it holds: no no-decay mask)."""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

from nuhtc_tpu_torch.train.train_state import AdamW


def build_named_optimizer(names: Iterable[str], base_lr=1e-4, weight_decay: float = 0.05,
                          rules: Sequence[Dict] = (), b1: float = 0.9,
                          b2: float = 0.999) -> AdamW:
    """rules: [{"pattern": "relative_position_bias_table", "lr_mult": 1.0,
    "decay_mult": 0.0}, ...]; ``base_lr`` a float or a schedule of the step."""

    def rule_of(name: str):
        for rule in rules:
            if rule["pattern"].lower() in name.lower():
                return rule
        return {}

    schedule = base_lr if callable(base_lr) else (lambda step: base_lr)
    lr_mult, decay = {}, {}
    for n in names:
        rule = rule_of(n)
        lr_mult[n] = float(rule.get("lr_mult", 1.0))
        decay[n] = weight_decay * float(rule.get("decay_mult", 1.0))
    return AdamW(schedule, lr_mult, decay, b1=b1, b2=b2)
