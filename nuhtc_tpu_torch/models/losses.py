"""Loss functions and their config classes (port of nuhtc_tpu/models/losses.py).

The reference loss inventory (nuhtc/models/losses/: DiceLoss,
SmoothTruncatedLoss, PartialDiceLoss, MultiLabelFocalLoss, WeightMSELoss,
WeightEXPLoss; mmdet SeesawLoss, CrossEntropyLoss, SmoothL1Loss). Every
function is batched and takes explicit validity weights, so padded samples
add nothing. SeesawLoss's per-class cumulative counts are an argument and a
result (``cum_samples``), carried by the train state as in the JAX package.

Inside a data-parallel step (``parallel.mesh.data_parallel``) every
reduction over the batch spans the global batch, as the JAX package's
sharded step computes it: a sum of weights that normalizes, and the seesaw
counts, are summed over the ranks (``parallel.mesh.global_sum``), and a
plain mean is the rank's share (``parallel.mesh.share``); elsewhere both
are the identity.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nuhtc_tpu_torch.parallel import mesh as P
from nuhtc_tpu_torch.registry import LOSSES


def _one_hot(labels: torch.Tensor, num_classes: int, dtype) -> torch.Tensor:
    """One-hot rows; a label outside [0, num_classes) gives a zero row, as
    ``jax.nn.one_hot``."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).to(dtype)


def weight_reduce(loss, weight=None, reduction: str = "mean", avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        if weight is None:
            return P.share(loss.mean())
        return loss.sum() / P.global_sum(weight.sum()).clamp(min=1e-12)
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor, dtype=loss.dtype), min=1e-12)


def smooth_l1(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def sigmoid_ce(logits, targets):
    """Binary cross entropy with logits, elementwise."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_ce(logits, labels, num_classes: Optional[int] = None):
    """Multiclass CE on int labels; a label out of range gives 0."""
    num_classes = num_classes or logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    return -(_one_hot(labels, num_classes, logits.dtype) * logp).sum(-1)


def sigmoid_focal(logits, targets, gamma: float = 2.0, alpha: float = 0.25):
    """Elementwise sigmoid focal loss on binary targets."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return alpha_t * (1 - p_t) ** gamma * ce


def dice_loss(pred, target, weight=None, eps: float = 1e-3, reduction: str = "mean",
              avg_factor=None):
    """``pred`` already activated, (n, ...) flattened per row. Per-sample
    weights are normalised to sum 1 (reference dice_loss.py:44-52)."""
    n = pred.shape[0]
    p = pred.reshape(n, -1)
    t = target.reshape(n, -1).to(p.dtype)
    a = (p * t).sum(1)
    b = (p * p).sum(1) + eps
    c = (t * t).sum(1) + eps
    loss = 1 - (2 * a) / (b + c)
    if weight is not None:
        wsum = P.global_sum(weight.sum())
        weight = torch.where(wsum == 0, torch.ones_like(weight), weight / wsum.clamp(min=1e-12))
        if reduction == "mean":
            return (loss * weight).sum()
        loss = loss * weight
    return weight_reduce(loss, None, reduction, avg_factor)


def trunc_loss(pred, target, gamma: float = 0.3, eps: float = 1e-3):
    """Smooth truncated loss on activated predictions, the mean per sample
    (reference trunc_loss.py:117-152)."""
    n = pred.shape[0]
    p = pred.reshape(n, -1)
    t = target.reshape(n, -1).to(p.dtype)
    ret = torch.where(t == 1, p, 1 - p)
    st = 0.5 - math.log(gamma) + ((t - 1) * (1 - p) ** 2 - t * p ** 2) / (2 * gamma ** 2)
    return torch.where(ret < gamma, st, -torch.log(ret + eps)).mean(1)


def seesaw_ce(cls_logits, labels, weights, cum_samples, p: float = 0.8, q: float = 2.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cls_logits (N, C), labels (N,) in [0, C), weights (N,), cum_samples
    (C,) → (per-sample loss (N,), updated cum_samples: the counts of the
    global batch)."""
    c = cls_logits.shape[-1]
    onehot = _one_hot(labels, c, cls_logits.dtype)
    new_cum = cum_samples + P.global_sum((onehot * weights[:, None]).sum(0), "seesaw_counts")
    seesaw = torch.ones((c, c), dtype=cls_logits.dtype, device=cls_logits.device)
    if p > 0:
        # mmdet clamps both counts at 1: unseen classes are not annihilated
        cum_c = new_cum.clamp(min=1.0)
        ratio = cum_c[None, :] / cum_c[:, None]  # [gt, other]
        seesaw = seesaw * torch.where(ratio < 1, ratio ** p, torch.ones_like(ratio))
    if q > 0:
        scores = torch.softmax(cls_logits.detach(), dim=-1)
        self_scores = (scores * onehot).sum(-1, keepdim=True)
        score_ratio = scores / self_scores.clamp(min=1e-12)
        compensation = torch.where(score_ratio > 1, score_ratio ** q,
                                   torch.ones_like(score_ratio))
    else:
        compensation = torch.ones_like(cls_logits)
    sample_seesaw = seesaw[labels] * compensation
    adjusted = cls_logits + torch.log(sample_seesaw.clamp(min=1e-12)) * (1 - onehot)
    return softmax_ce(adjusted, labels) * weights, new_cum


def seesaw_loss(cls_score, labels, weights, cum_samples, p: float = 0.8, q: float = 2.0,
                loss_weight: float = 1.0):
    """cls_score (N, C+2), labels (N,) in [0, C] (C background), weights (N,)
    → (loss_classes, loss_objectness, new cum_samples), as mmdet
    SeesawLoss.forward: objectness CE over (pos, neg) for every sample,
    seesaw CE over the classes for the positives, normalised by the total
    sample count."""
    c = cls_score.shape[-1] - 2
    cls_logits, obj_logits = cls_score[:, :c], cls_score[:, c:]
    pos = (labels < c) & (weights > 0)
    obj_labels = (labels == c).long()
    loss_obj = weight_reduce(softmax_ce(obj_logits, obj_labels), weights, "mean")
    cls_labels = torch.where(pos, labels, torch.zeros_like(labels))
    per_sample, new_cum = seesaw_ce(cls_logits, cls_labels, pos.to(cls_score.dtype),
                                    cum_samples, p, q)
    loss_cls = per_sample.sum() / P.global_sum(weights.sum()).clamp(min=1.0)
    return loss_weight * loss_cls, loss_weight * loss_obj, new_cum


# --------------------------------------------------------------------------- #
# config classes
# --------------------------------------------------------------------------- #
@LOSSES.register()
class DiceLoss:
    def __init__(self, use_sigmoid=True, activate=True, reduction="mean", loss_weight=1.0,
                 eps=1e-3):
        self.use_sigmoid, self.activate = use_sigmoid, activate
        self.reduction, self.loss_weight, self.eps = reduction, loss_weight, eps

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if self.activate and self.use_sigmoid:
            pred = torch.sigmoid(pred)
        return self.loss_weight * dice_loss(pred, target, weight, self.eps, self.reduction,
                                            avg_factor)


@LOSSES.register()
class SmoothTruncatedLoss:
    def __init__(self, use_sigmoid=True, activate=True, reduction="mean", loss_weight=1.0,
                 eps=1e-3, gamma=0.3):
        self.use_sigmoid, self.activate = use_sigmoid, activate
        self.reduction, self.loss_weight, self.eps, self.gamma = reduction, loss_weight, eps, gamma

    def __call__(self, pred, target, weight=None, avg_factor=None, mask=None):
        if self.activate and self.use_sigmoid:
            pred = torch.sigmoid(pred)
            if mask is not None:
                pred = pred * mask
        ld = dice_loss(pred, target, weight, self.eps, self.reduction, avg_factor)
        lt = weight_reduce(trunc_loss(pred, target, self.gamma, self.eps), weight,
                           self.reduction, avg_factor)
        return self.loss_weight * (ld + lt)


@LOSSES.register()
class PartialDiceLoss:
    def __init__(self, use_sigmoid=True, activate=True, reduction="mean", loss_weight=1.0,
                 eps=1e-3, gamma=0.3):
        self.use_sigmoid, self.activate = use_sigmoid, activate
        self.reduction, self.loss_weight, self.eps = reduction, loss_weight, eps

    def __call__(self, pred, target, weight=None, avg_factor=None, mask=None):
        if self.activate and self.use_sigmoid:
            pred = torch.sigmoid(pred)
            if mask is None:
                mask = ((target == 1) | (target == 0)).to(pred.dtype)
            pred = pred * mask
            target = target * mask
        return self.loss_weight * dice_loss(pred, target, weight, self.eps, self.reduction,
                                            avg_factor)


@LOSSES.register()
class MultiLabelFocalLoss:
    def __init__(self, use_sigmoid=True, gamma=2.0, alpha=0.25, reduction="mean",
                 size_average=True, loss_weight=1.0):
        self.gamma, self.alpha = gamma, alpha
        self.reduction, self.size_average, self.loss_weight = reduction, size_average, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        num_classes = pred.shape[1]
        onehot = _one_hot(target, num_classes + 1, pred.dtype)[:, :num_classes]
        losses = torch.stack([
            weight_reduce(sigmoid_focal(pred[:, i], onehot[:, i], self.gamma, self.alpha),
                          weight, self.reduction, avg_factor)
            for i in range(num_classes)]) * self.loss_weight
        return losses.mean() if self.size_average else losses.sum()


@LOSSES.register()
class WeightMSELoss:
    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction, self.loss_weight, self.eps = reduction, loss_weight, 1e-2

    def __call__(self, pred, target, weight=None, avg_factor=None):
        w = (2 - self.eps) * target.detach() + self.eps
        return self.loss_weight * weight_reduce((pred - target) ** 2, w, self.reduction,
                                                avg_factor)


@LOSSES.register()
class WeightEXPLoss:
    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction, self.loss_weight = reduction, loss_weight
        self.alpha, self.beta = 2.0, 1.0

    def __call__(self, pred, target, weight=None, avg_factor=None):
        w = self.alpha * torch.exp(-self.beta * (target.detach() - 1) ** 2)
        return self.loss_weight * weight_reduce((pred - target) ** 2, w, self.reduction,
                                                avg_factor)


@LOSSES.register()
class SmoothL1Loss:
    def __init__(self, beta=1.0, reduction="mean", loss_weight=1.0):
        self.beta, self.reduction, self.loss_weight = beta, reduction, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * weight_reduce(smooth_l1(pred, target, self.beta), weight,
                                                self.reduction, avg_factor)


@LOSSES.register()
class CrossEntropyLoss:
    def __init__(self, use_sigmoid=False, use_mask=False, reduction="mean", loss_weight=1.0):
        self.use_sigmoid, self.reduction, self.loss_weight = use_sigmoid, reduction, loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if self.use_sigmoid:
            loss = sigmoid_ce(pred, target.to(pred.dtype))
        else:
            loss = softmax_ce(pred, target)
        return self.loss_weight * weight_reduce(loss, weight, self.reduction, avg_factor)
