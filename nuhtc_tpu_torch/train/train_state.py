"""Optimizer, schedule, EMA and the train steps (port of
nuhtc_tpu/train/train_state.py).

The reference recipe: AdamW lr 1e-4, betas (0.9, 0.999), weight decay 0.05
except on relative-position bias tables, absolute position embeddings and
every norm; step lr ([30, 160] epochs, ×0.1) after a 1000-iteration linear
warm-up from ratio 1e-3; EMA of the weights with momentum 2e-4; Swin stage 0
frozen until ``finetune_iter``.

``AdamW`` has optax's semantics, which ``torch.optim.AdamW`` does not give:
one global step count for the bias correction and for the schedule (the lr
of an update is the schedule at the count before it, as
``optax.inject_hyperparams``), so a parameter unfrozen late starts with the
global count; a frozen parameter's gradient is zeroed (its moments decay)
and so is its update, weight decay included. Parameters, moments and the EMA
are f32. The step updates the model's parameters, the moments and the EMA
in place (the JAX package returns new arrays).

The semi-supervised step (``make_semi_train_step``, the reference's
MultiStreamDetector + MeanTeacher hook) trains the student of a
``models.semi.MultiStreamDetector`` on the supervised and pseudo-labelled
branches and moves the teacher's parameters, in place, by an EMA whose
momentum warms up: m = min(momentum, 1 - (1 + warm_up) / (step + 1 +
warm_up)), 0 at step 0; the unsupervised branch is weighted 0 during
``burn_in`` steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from nuhtc_tpu_torch.tools.timing import synced_clock

FROZEN_PREFIXES = ("backbone.patch_embed.", "backbone.stages.0.", "backbone.norm0.")
NO_DECAY_KEYS = ("relative_position_bias_table", "absolute_pos_embed", "norm")


def lr_schedule(base_lr: float = 1e-4, warmup_iters: int = 1000, warmup_ratio: float = 1e-3,
                step_epochs: Sequence[int] = (30, 160), iters_per_epoch: int = 1000,
                gamma: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up, then ×gamma at each of ``step_epochs``."""
    boundaries = [e * iters_per_epoch for e in step_epochs]

    def fn(step: int) -> float:
        warm = base_lr * (warmup_ratio + (1 - warmup_ratio) * min(step / warmup_iters, 1.0))
        return warm * math.prod(gamma for b in boundaries if step >= b)

    return fn


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True = weight decay applies (the JAX package's rule on the same names:
    the port's mmdet names keep "norm" wherever the flax names have it)."""
    return {n: not any(k in n.lower() for k in NO_DECAY_KEYS) for n in names}


def frozen_mask(names: Iterable[str], prefixes: Sequence[str] = FROZEN_PREFIXES
                ) -> Dict[str, bool]:
    """True = frozen until the finetune iteration: Swin ``frozen_stages=1``,
    the patch embedding and stage 0 with its PatchMerging (mmdet
    _freeze_stages) and stage 0's output norm."""
    return {n: n.startswith(tuple(prefixes)) for n in names}


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """optax.adamw over named f32 parameters: per parameter an lr multiplier
    and a weight decay (0 where ``decay_mask`` says so, or as a
    ``paramwise_cfg`` rule says); lr = ``schedule(count)``."""

    def __init__(self, schedule: Callable[[int], float], lr_mult: Dict[str, float],
                 weight_decay: Dict[str, float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule, self.lr_mult, self.weight_decay = schedule, lr_mult, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(0, {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
                          {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The updates to add to ``params``; the moments and the count
        advance in place."""
        b1, b2 = self.b1, self.b2
        lr = self.schedule(state.count)
        state.count += 1
        # optax's bias corrections, in f32
        c1 = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** state.count)
        c2 = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** state.count)
        names = list(params)
        g = [grads[n] for n in names]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
        out = {}
        for n, u in zip(names, upd):
            wd = self.weight_decay[n]
            if wd:
                u.add_(params[n], alpha=wd)
            out[n] = u.mul_(-lr * self.lr_mult[n])
        return out


def create_optimizer(names: Iterable[str], schedule, weight_decay: float = 0.05) -> AdamW:
    """The default AdamW: decay 0 on the no-decay keys."""
    mask = decay_mask(names)
    return AdamW(schedule, {n: 1.0 for n in mask},
                 {n: weight_decay if d else 0.0 for n, d in mask.items()})


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # the model's parameters, by name (updated in place)
    opt_state: AdamWState
    ema_params: Dict[str, torch.Tensor]
    cum_samples: torch.Tensor  # (num_stages, num_classes)


def create_train_state(model: torch.nn.Module, num_stages: int = 3, num_classes: int = 5,
                       schedule=None, tx: Optional[AdamW] = None) -> Tuple[TrainState, AdamW]:
    params = dict(model.named_parameters())
    schedule = schedule or lr_schedule()
    tx = tx if tx is not None else create_optimizer(params, schedule)
    dev = next(iter(params.values())).device
    with torch.no_grad():
        ema = {n: p.detach().clone().float() for n, p in params.items()}
    return TrainState(step=0, params=params, opt_state=tx.init(params), ema_params=ema,
                      cum_samples=torch.zeros((num_stages, num_classes), dtype=torch.float32,
                                              device=dev)), tx


def _frozen_names(model: torch.nn.Module) -> list:
    names = [n for n, _ in model.named_parameters()]
    fmask = frozen_mask(names)
    return [n for n in names if fmask[n]]


def _autocast(device: torch.device, compute_dtype: Optional[torch.dtype]):
    return (torch.autocast(device.type, dtype=compute_dtype) if compute_dtype is not None
            else contextlib.nullcontext())


@torch.no_grad()
def _apply_adamw(tx: "AdamW", opt_state: AdamWState, params: Dict[str, torch.Tensor],
                 frozen: Sequence[str], frozen_now: bool) -> torch.Tensor:
    """One AdamW update of ``params`` in place from their ``.grad`` (zero
    where None); while ``frozen_now`` the frozen leaves' gradients and
    updates are zeroed (AdamW's decoupled decay would still move them).
    Returns the global norm of the gradients the optimizer took."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in params.items()}
    if frozen_now:
        for n in frozen:
            grads[n] = torch.zeros_like(grads[n])
    grad_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
    updates = tx.update(grads, opt_state, params)
    if frozen_now:
        for n in frozen:
            updates[n].zero_()
    keys = list(params)
    torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])
    return grad_norm


def make_train_step(model: torch.nn.Module, tx: AdamW, ema_momentum: float = 2e-4,
                    finetune_iter: int = 15000, weighter=None,
                    compute_dtype: Optional[torch.dtype] = None):
    """Returns ``train_step(state, batch, generator, timing=None) -> (state,
    metrics)``. ``batch``: the collated tensors on the model's device, with
    "img". ``weighter``: ``(losses, step) -> losses`` inside the
    differentiated loss (the reference Weighter hook). ``compute_dtype``
    (bf16 on the card): the forward runs under ``torch.autocast`` in that
    type, its products and convolutions in bf16, norms, softmax and losses in
    f32; parameters and gradients stay f32. ``timing``: a dict that receives
    the synchronized seconds of forward, backward and optimizer (+ EMA)."""
    frozen = _frozen_names(model)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], timing: Optional[dict] = None):
        params = state.params
        dev = next(iter(params.values())).device
        model.train()
        for p in params.values():
            p.grad = None
        t0 = synced_clock(dev) if timing is not None else 0.0
        with _autocast(dev, compute_dtype):
            losses, new_cum = model.compute_losses(batch["img"], batch, state.cum_samples,
                                                   generator)
            if weighter is not None:
                losses = weighter(losses, state.step)
        t1 = synced_clock(dev) if timing is not None else 0.0
        losses["total"].backward()
        t2 = synced_clock(dev) if timing is not None else 0.0
        with torch.no_grad():
            grad_norm = _apply_adamw(tx, state.opt_state, params, frozen,
                                     state.step < finetune_iter)
            keys = list(params)
            ema = [state.ema_params[k] for k in keys]
            torch._foreach_mul_(ema, 1.0 - ema_momentum)
            torch._foreach_add_(ema, [params[k] for k in keys], alpha=ema_momentum)
        if timing is not None:
            t3 = synced_clock(dev)
            timing.update(forward_s=t1 - t0, backward_s=t2 - t1, optimizer_s=t3 - t2)
        state.step += 1
        state.cum_samples = new_cum.detach()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step


@dataclasses.dataclass
class SemiTrainState:
    """Teacher/student state (the reference's MultiSteamDetector +
    MeanTeacher hook pair): the student's and the teacher's parameters by
    name, both updated in place, the student's AdamW state, the pass-through
    counts."""
    step: int
    student_params: Dict[str, torch.Tensor]
    teacher_params: Dict[str, torch.Tensor]
    opt_state: AdamWState
    cum_samples: torch.Tensor  # (num_stages, num_classes)


def create_semi_train_state(student: torch.nn.Module, teacher: torch.nn.Module,
                            num_stages: int = 1, num_classes: int = 5, schedule=None,
                            tx: Optional[AdamW] = None) -> Tuple[SemiTrainState, AdamW]:
    """The teacher starts as a clone of the student (the reference MeanTeacher
    before_run: momentum_update(model, 0) at iteration 0): the student's
    state is copied into ``teacher``. ``tx`` overrides the default optimizer
    (e.g. ``build_named_optimizer``'s)."""
    params = dict(student.named_parameters())
    schedule = schedule or lr_schedule()
    tx = tx if tx is not None else create_optimizer(params, schedule)
    with torch.no_grad():
        teacher.load_state_dict(student.state_dict(), strict=True)
    dev = next(iter(params.values())).device
    return SemiTrainState(step=0, student_params=params,
                          teacher_params=dict(teacher.named_parameters()),
                          opt_state=tx.init(params),
                          cum_samples=torch.zeros((num_stages, num_classes), dtype=torch.float32,
                                                  device=dev)), tx


def teacher_momentum_at(step: int, momentum: float, warm_up: int) -> float:
    """min(momentum, 1 - (1 + warm_up) / (step + 1 + warm_up)) in f32, as
    the JAX step computes it (reference mean_teacher.py:46)."""
    f = np.float32
    ramp = f(1.0) - (f(1.0) + f(warm_up)) / (f(step) + f(1.0) + f(warm_up))
    return float(min(f(momentum), ramp))


def make_semi_train_step(wrapper, tx: AdamW, teacher_momentum: float = 0.999,
                         teacher_warmup: int = 100, unsup_weight: float = 1.0, burn_in: int = 0,
                         finetune_iter: int = 15000, weighter=None,
                         compute_dtype: Optional[torch.dtype] = None):
    """Returns ``train_step(state, batch, generator, timing=None) -> (state,
    metrics)`` over a ``MultiStreamDetector``: the student in train mode, the
    teacher in eval mode. ``batch``: the supervised keys of
    ``compute_losses``, "unsup_img" (the strong view) and optionally
    "unsup_img_teacher" (the weak view the teacher labels). The unsupervised
    branch is weighted 0 while ``step < burn_in``; the frozen leaves are
    masked before and after the optimizer as in ``make_train_step``; the
    teacher's EMA is written in place after the student's update. Metrics:
    every loss, ``grad_norm`` and ``ema_momentum``. ``compute_dtype`` and
    ``timing`` as in ``make_train_step``; ``timing`` also receives
    ``teacher_s``, the teacher's forward, which ``forward_s`` leaves out."""
    from nuhtc_tpu_torch.models.semi import TeacherStudentState, mean_teacher_update

    student, teacher = wrapper.model, wrapper.teacher
    frozen = _frozen_names(student)

    def train_step(state: SemiTrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], timing: Optional[dict] = None):
        params = state.student_params
        dev = next(iter(params.values())).device
        student.train()
        teacher.eval()
        for p in params.values():
            p.grad = None
        uw = 0.0 if state.step < burn_in else unsup_weight
        t0 = synced_clock(dev) if timing is not None else 0.0
        with _autocast(dev, compute_dtype):
            losses, new_cum = wrapper.semi_loss(
                batch, batch["unsup_img"], state.cum_samples, unsup_weight=uw,
                generator=generator, unsup_img_teacher=batch.get("unsup_img_teacher"),
                weighter=weighter, step=state.step, timing=timing)
        t1 = synced_clock(dev) if timing is not None else 0.0
        losses["total"].backward()
        t2 = synced_clock(dev) if timing is not None else 0.0
        m = teacher_momentum_at(state.step, teacher_momentum, teacher_warmup)
        grad_norm = _apply_adamw(tx, state.opt_state, params, frozen, state.step < finetune_iter)
        mean_teacher_update(TeacherStudentState(params, state.teacher_params), m)
        if timing is not None:
            t3 = synced_clock(dev)
            timing.update(forward_s=t1 - t0 - timing["teacher_s"], backward_s=t2 - t1,
                          optimizer_s=t3 - t2)
        state.step += 1
        state.cum_samples = new_cum.detach()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        metrics["ema_momentum"] = torch.tensor(m)
        return state, metrics

    return train_step
