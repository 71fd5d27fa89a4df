"""Assignment, sampling and target encoding, batched and static-shape (port
of nuhtc_tpu/train/targets.py).

Every function takes a leading batch axis (the JAX package vmaps over it):

- ``max_iou_assign``: mmdet MaxIoUAssigner's four steps (background below
  ``neg_thr``, positive from ``pos_thr``, each gt's best candidates from
  ``min_pos_iou``, later gts overriding earlier ones); ties in the argmax go
  to the first gt, as ``jnp.argmax``;
- ``random_sample``: RandomSampler with ``num`` slots and ``pos_fraction``,
  as a priority: a random rank among the positives capped at the expected
  count, then the negatives by their random rank. The two uniform draws come
  from ``uniform`` (a seeded ``torch.Generator``); what follows them keeps
  JAX's ties: ``jnp.argsort`` is stable, and ``lax.top_k`` takes the lower
  index among equal values, which a stable ascending sort also does;
- ``encode_stage_targets``: per-sample labels and DeltaXYWH targets;
- ``mask_targets_from_patches``: 28×28 mask targets by bilinear sampling of
  each gt's mask patch (rasterised in its box) over the proposal box.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from nuhtc_tpu_torch.ops import boxes as box_ops
from nuhtc_tpu_torch.parallel import mesh as P

BIG = 1e9  # priority of a slot that takes no candidate


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor  # (B, N) int64: -1 ignore, 0 negative, g+1 positive
    max_iou: torch.Tensor  # (B, N)
    labels: torch.Tensor  # (B, N) class of the assigned gt, or -1


class SampleResult(NamedTuple):
    idx: torch.Tensor  # (B, num) indices into the candidates
    is_pos: torch.Tensor  # (B, num) bool
    valid: torch.Tensor  # (B, num) bool: the slot took a candidate
    gt_inds: torch.Tensor  # (B, num) 0-based assigned gt of a positive, else 0
    labels: torch.Tensor  # (B, num) class of a positive, num_classes otherwise


def uniform(generator: torch.Generator | None, shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """The samplers' uniform draws in [0, 1), f32, from ``generator``: drawn
    for the global batch inside a data-parallel step
    (``parallel.mesh.data_parallel``), this rank's rows
    (``parallel.mesh.rank_rows``); ``shape`` itself elsewhere."""
    return P.rank_rows(torch.rand(P.global_rows(shape), generator=generator, device=device))


def max_iou_assign(boxes, boxes_valid, gt, gt_valid, gt_labels, pos_thr: float,
                   neg_thr: float, min_pos_iou: float = 0.0,
                   match_low_quality: bool = True) -> AssignResult:
    """boxes (B, N, 4), boxes_valid (B, N), gt (B, G, 4), gt_valid (B, G),
    gt_labels (B, G) → AssignResult of (B, N) each."""
    g = gt.shape[1]
    if g == 0:
        raise ValueError("max_iou_assign: pad the gts to at least one slot (gt_valid False)")
    iou = box_ops.pairwise_iou(boxes, gt, eps=1e-6)  # (B, N, G)
    iou = torch.where(gt_valid[:, None, :] & boxes_valid[:, :, None], iou, -1.0)
    max_iou = iou.max(dim=2).values
    argmax = iou.argmax(dim=2)  # the first maximum, as jnp.argmax
    assigned = torch.full_like(argmax, -1)
    assigned = torch.where((max_iou >= 0) & (max_iou < neg_thr), 0, assigned)
    assigned = torch.where(max_iou >= pos_thr, argmax + 1, assigned)
    if match_low_quality:
        gt_best = iou.max(dim=1).values  # (B, G)
        eligible = ((iou == gt_best[:, None, :]) & (gt_best[:, None, :] >= min_pos_iou)
                    & gt_valid[:, None, :])
        # mmdet walks the gts in ascending order, a later one overriding
        gidx = torch.arange(1, g + 1, device=iou.device)
        best_g = torch.where(eligible, gidx, 0).max(dim=2).values
        assigned = torch.where(best_g > 0, best_g, assigned)
    assigned = torch.where(boxes_valid, assigned, -1)
    # no gt at all: every valid candidate is background (mmdet's num_gts == 0)
    no_gt = ~gt_valid.any(dim=1, keepdim=True)
    assigned = torch.where(no_gt & boxes_valid, 0, assigned)
    lab = gt_labels.long().gather(1, (assigned - 1).clamp(0, g - 1))
    labels = torch.where(assigned > 0, lab, -1)
    return AssignResult(assigned, max_iou, labels)


def inverse_rank(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each entry along the last axis under a stable ascending sort
    (``jnp.argsort`` then the scatter of ``arange``)."""
    order = torch.argsort(keys, dim=-1, stable=True)
    ar = torch.arange(keys.shape[-1], device=keys.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def select_slots(prio: torch.Tensor, assign: AssignResult, num: int,
                 num_classes: int) -> SampleResult:
    """The ``num`` lowest priorities, lower index first among equal ones
    (``lax.top_k`` of ``-prio``) → the samples. Priorities below 1e6 are
    positives, below BIG negatives, BIG an empty slot."""
    n = prio.shape[-1]
    if n < num:  # fewer candidates than slots: the rest stay empty
        prio = torch.nn.functional.pad(prio, (0, num - n), value=BIG)
    sel, idx = torch.sort(prio, dim=-1, stable=True)
    sel, idx = sel[:, :num], idx[:, :num].clamp(max=n - 1)
    valid = sel < BIG
    is_pos = valid & (sel < 1e6)
    gt_inds = torch.where(is_pos, assign.gt_inds.gather(1, idx) - 1, 0)
    labels = torch.where(is_pos, assign.labels.gather(1, idx), num_classes)
    labels = torch.where(valid, labels, num_classes)
    return SampleResult(idx, is_pos, valid, gt_inds, labels)


def rank_priority(pos_mask, pos_rank, neg_mask, neg_rank, num_pos_expected: int, num: int):
    """Positives ranked below the expected count, then negatives ranked below
    ``num`` (offset by 1e6), else BIG; f32 as in the JAX package."""
    prio = torch.where(pos_mask & (pos_rank < num_pos_expected), pos_rank.float(),
                       torch.tensor(BIG, device=pos_rank.device))
    return torch.where(neg_mask & (neg_rank < num), 1e6 + neg_rank.float(), prio)


def random_sample(generator: torch.Generator | None, assign: AssignResult, num: int,
                  pos_fraction: float, num_classes: int) -> SampleResult:
    b, n = assign.gt_inds.shape
    dev = assign.gt_inds.device
    num_pos_expected = int(num * pos_fraction)
    pos_mask = assign.gt_inds > 0
    neg_mask = assign.gt_inds == 0
    rp = uniform(generator, (b, n), dev)
    rn = uniform(generator, (b, n), dev)
    inf = torch.tensor(float("inf"), device=dev)
    pos_rank = inverse_rank(torch.where(pos_mask, rp, inf))
    neg_rank = inverse_rank(torch.where(neg_mask, rn, inf))
    prio = rank_priority(pos_mask, pos_rank, neg_mask, neg_rank, num_pos_expected, num)
    return select_slots(prio, assign, num, num_classes)


def encode_stage_targets(rois, sample: SampleResult, gt, stds):
    """rois (B, S, 4), gt (B, G, 4) → (bbox_targets (B, S, 4), bbox_weights (B, S))."""
    tgt_boxes = gt.gather(1, sample.gt_inds[..., None].expand(-1, -1, 4))
    deltas = box_ops.bbox2delta(rois, tgt_boxes, stds=stds)
    return (torch.where(sample.is_pos[..., None], deltas, 0.0),
            sample.is_pos.to(torch.float32))


def _interp_matrix(u: torch.Tensor, m: int) -> torch.Tensor:
    """(..., k) source coordinates → (..., k, m) bilinear weights, 0 outside."""
    low = torch.floor(u)
    frac = u - low
    low_i = low.clamp(-1, m).long()

    def onehot(ix):
        inside = (ix >= 0) & (ix < m)
        oh = torch.nn.functional.one_hot(ix.clamp(0, m - 1), m).to(torch.float32)
        return oh * inside[..., None]

    return onehot(low_i) * (1 - frac)[..., None] + onehot(low_i + 1) * frac[..., None]


def mask_targets_from_patches(proposals, gt_inds, gt_boxes, gt_patches,
                              mask_size: int = 28) -> torch.Tensor:
    """proposals (B, S, 4), gt_inds (B, S), gt_boxes (B, G, 4), gt_patches
    (B, G, M, M) → (B, S, mask_size, mask_size) binary f32 targets."""
    m = gt_patches.shape[-1]
    proposals = proposals.float()
    boxes = gt_boxes.float().gather(1, gt_inds[..., None].expand(-1, -1, 4))
    patches = gt_patches.float().gather(
        1, gt_inds[..., None, None].expand(-1, -1, m, m))  # (B, S, M, M)
    i = torch.arange(mask_size, dtype=torch.float32, device=proposals.device)

    def axis_coords(p0, p1, b0, b1):
        # bin centre i in the image: p0 + (i + .5)(p1 - p0)/mask_size, then
        # in patch pixels: (t - b0)/(b1 - b0)·M - .5
        t = p0[..., None] + (i + 0.5) * (p1 - p0)[..., None] / mask_size
        ext = (b1 - b0).clamp(min=1e-6)
        return (t - b0[..., None]) / ext[..., None] * m - 0.5

    my = _interp_matrix(axis_coords(proposals[..., 1], proposals[..., 3], boxes[..., 1],
                                    boxes[..., 3]), m)
    mx = _interp_matrix(axis_coords(proposals[..., 0], proposals[..., 2], boxes[..., 0],
                                    boxes[..., 2]), m)
    # f32 products even under autocast: the targets are thresholded at 0.5
    with torch.autocast(proposals.device.type, enabled=False):
        out = (my @ patches) @ mx.transpose(-1, -2)
    return (out >= 0.5).to(torch.float32)
