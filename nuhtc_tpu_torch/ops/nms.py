"""Exact greedy NMS with padded, batched shapes (port of nuhtc_tpu/ops/nms.py).

A box is kept iff it is valid and no kept box of higher rank overlaps it by
more than the IoU threshold. Instead of one Python step per box, the keep
set is found as the fixpoint of ``keep = valid & ~any_j(keep[j] & ov[j, k])``
over all earlier boxes j at once: after t rounds the first t boxes are final,
and the loop stops as soon as a round changes nothing (the length of the
longest suppression chain).
"""

from __future__ import annotations

import torch

from nuhtc_tpu_torch.ops.boxes import pairwise_iou
from nuhtc_tpu_torch.utils.profiling import count

NEG_INF = -1e10


def sort_desc(x: torch.Tensor):
    """Stable descending sort (ties keep input order, as ``lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def nms_keep_sorted(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
                    ) -> torch.Tensor:
    """Keep mask (B, N) for boxes (B, N, 4) sorted by descending score."""
    b, n, _ = boxes.shape
    # 0/1 suppression matrix ov[j, k] = (j < k) & IoU > thr, as a matmul
    # operand; half precision on the card (sums of ones stay > 0)
    dt = torch.float16 if boxes.is_cuda else torch.float32
    ov = torch.empty((b, n, n), dtype=dt, device=boxes.device)
    cols = torch.arange(n, device=boxes.device)
    for r0 in range(0, n, 512):  # IoU rows per chunk: (B, 512, N) f32 temporaries
        rows = torch.arange(r0, min(n, r0 + 512), device=boxes.device)
        iou = pairwise_iou(boxes[:, rows], boxes)
        ov[:, rows] = ((iou > iou_threshold) & (rows[:, None] < cols[None, :])).to(dt)
    keep = valid
    for _ in range(n):
        count("nms.rounds")
        sup = (keep.to(dt)[:, None, :] @ ov)[:, 0] > 0
        new = valid & ~sup
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float, max_out: int):
    """Greedy NMS over (B, N). → (boxes (B, max_out, 4), scores, idx, valid),
    kept boxes in descending score order; padding slots are zero/invalid."""
    scores_m = torch.where(valid, scores, NEG_INF)
    _, order = sort_desc(scores_m)
    sboxes = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    keep = nms_keep_sorted(sboxes, valid.gather(1, order), iou_threshold)
    kept_scores = torch.where(keep, scores_m.gather(1, order), NEG_INF)
    if max_out > kept_scores.shape[1]:
        pad = max_out - kept_scores.shape[1]
        kept_scores = torch.nn.functional.pad(kept_scores, (0, pad), value=NEG_INF)
        order = torch.nn.functional.pad(order, (0, pad))
    top_scores, top_pos = sort_desc(kept_scores)
    top_scores, top_pos = top_scores[:, :max_out], top_pos[:, :max_out]
    out_idx = order.gather(1, top_pos)
    out_valid = top_scores > NEG_INF / 2
    out_boxes = torch.where(out_valid[..., None],
                            boxes.gather(1, out_idx[..., None].expand(-1, -1, 4)), 0.0)
    out_scores = torch.where(out_valid, scores.gather(1, out_idx), 0.0)
    return out_boxes, out_scores, out_idx, out_valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                valid: torch.Tensor, iou_threshold: float, max_out: int,
                coord_bound=None):
    """NMS where boxes of different ``idxs`` never suppress each other (each
    group is shifted to its own region, mmcv ``batched_nms``). ``coord_bound``:
    a float or a (B,) tensor; default the largest valid coordinate."""
    if coord_bound is None:
        coord_bound = torch.where(valid[..., None], boxes, 0.0).amax(dim=(1, 2))
    if torch.is_tensor(coord_bound):
        coord_bound = coord_bound[:, None]
    shifted = boxes + (idxs.to(boxes.dtype) * (coord_bound + 1.0))[..., None]
    _, out_scores, out_idx, out_valid = nms(shifted, scores, valid, iou_threshold, max_out)
    out_boxes = torch.where(out_valid[..., None],
                            boxes.gather(1, out_idx[..., None].expand(-1, -1, 4)), 0.0)
    return out_boxes, out_scores, out_idx, out_valid
