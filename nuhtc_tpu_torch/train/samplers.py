"""The other RoI samplers of the cascade (port of nuhtc_tpu/train/samplers.py;
reference nuhtc/datasets/samplers/), batched and static-shape like
``targets.random_sample``:

- ``instance_balanced_sample``: positive slots dealt round-robin over the gt
  instances (InstanceBalancedPosSampler_Cus);
- ``ohem_sample``: the hardest candidates by their current loss
  (OHEMSampler_HTC), no draws;
- ``semi_balance_indices``: the DistributedGroupSemiBalanceSampler analogue,
  host-side batch indices mixing supervised and unsupervised samples.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from nuhtc_tpu_torch.train import targets as T


def instance_balanced_sample(generator: torch.Generator | None, assign: T.AssignResult,
                             num: int, pos_fraction: float, num_classes: int,
                             num_gts: int) -> T.SampleResult:
    """Positives ranked within their gt, then interleaved over the gts
    (priority = rank within the gt · gts + gt index), so every gt gives its
    first candidate before any gives its second; negatives at random."""
    b, n = assign.gt_inds.shape
    dev = assign.gt_inds.device
    num_pos_expected = int(num * pos_fraction)
    pos_mask = assign.gt_inds > 0
    neg_mask = assign.gt_inds == 0
    rp = T.uniform(generator, (b, n), dev)
    rn = T.uniform(generator, (b, n), dev)
    inf = torch.tensor(float("inf"), device=dev)
    g_eff = max(num_gts, 1)
    grp = (assign.gt_inds - 1).clamp(0, g_eff - 1)
    sorted_rank = T.inverse_rank(torch.where(pos_mask, grp.float() * 10.0 + rp, inf))
    counts = torch.where(pos_mask[..., None], F.one_hot(grp, g_eff), 0).sum(1)  # (B, G)
    offsets = counts.cumsum(1) - counts  # a group's start in the sorted order
    within = sorted_rank - offsets.gather(1, grp)
    prio_pos = torch.where(pos_mask, (within * g_eff + grp).float(),
                           torch.tensor(T.BIG, device=dev))
    rank_pos = T.inverse_rank(prio_pos)
    rank_neg = T.inverse_rank(torch.where(neg_mask, rn, inf))
    prio = T.rank_priority(pos_mask, rank_pos, neg_mask, rank_neg, num_pos_expected, num)
    return T.select_slots(prio, assign, num, num_classes)


def ohem_sample(losses: torch.Tensor, assign: T.AssignResult, num: int, pos_fraction: float,
                num_classes: int) -> T.SampleResult:
    """losses (B, N): each candidate's current classification loss; the
    highest come first among the positives and among the negatives."""
    num_pos_expected = int(num * pos_fraction)
    pos_mask = assign.gt_inds > 0
    neg_mask = assign.gt_inds == 0
    inf = torch.tensor(float("inf"), device=losses.device)
    pos_rank = T.inverse_rank(torch.where(pos_mask, -losses, inf))
    neg_rank = T.inverse_rank(torch.where(neg_mask, -losses, inf))
    prio = T.rank_priority(pos_mask, pos_rank, neg_mask, neg_rank, num_pos_expected, num)
    return T.select_slots(prio, assign, num, num_classes)


def semi_balance_indices(n_sup: int, n_unsup: int, batch_size: int, sup_ratio: float = 0.5,
                         seed: int = 0) -> Iterator[List[int]]:
    """Endless batch indices: ``round(batch_size · sup_ratio)`` (at least 1)
    supervised ones in [0, n_sup), the rest unsupervised in [n_sup, n_sup +
    n_unsup), or supervised again when there are no unsupervised samples;
    drawn from ``np.random.RandomState(seed)`` as the JAX package draws
    them, so a seed gives the same indices."""
    rng = np.random.RandomState(seed)
    n_s = max(int(round(batch_size * sup_ratio)), 1)
    n_u = batch_size - n_s
    while True:
        sup = rng.randint(0, n_sup, n_s)
        unsup = (n_sup + rng.randint(0, max(n_unsup, 1), n_u) if n_unsup
                 else rng.randint(0, n_sup, n_u))
        yield np.concatenate([sup, unsup]).tolist()
