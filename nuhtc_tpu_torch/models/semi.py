"""Semi- and partial-supervision components (port of nuhtc_tpu/models/semi.py;
reference multi_stream_detector.py, mask_rcnn_part.py, roi_head_partial.py
and the MeanTeacher hook, nuhtc/utils/hooks/mean_teacher.py).

The JAX package keeps teacher and student as two parameter trees over one
functional module. Here they are two modules of one architecture: the
student trains, the teacher is a copy in eval mode whose parameters follow
the student by an EMA written in place. The teacher labels the unlabelled
batch without gradients; in eval mode on the card its Swin blocks run K1,
whose parameter pack is rebuilt after each EMA write (``source_key``).
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional

import torch

from nuhtc_tpu_torch.registry import DETECTORS
from nuhtc_tpu_torch.tools.timing import synced_clock


class TeacherStudentState(NamedTuple):
    student_params: Dict[str, torch.Tensor]
    teacher_params: Dict[str, torch.Tensor]


@torch.no_grad()
def mean_teacher_update(state: TeacherStudentState, momentum: float = 0.999
                        ) -> TeacherStudentState:
    """EMA of the teacher (the reference MeanTeacher hook), in place:
    teacher = momentum · teacher + (1 - momentum) · student."""
    names = list(state.teacher_params)
    teacher = [state.teacher_params[n] for n in names]
    torch._foreach_mul_(teacher, momentum)
    torch._foreach_add_(teacher, torch._foreach_mul(
        [state.student_params[n] for n in names], 1.0 - momentum))
    return state


@DETECTORS.register()
class MultiStreamDetector:
    """Teacher/student pair over one detector architecture.

    ``model`` is the student; ``teacher`` (a deep copy of the student when
    None) is put in eval mode with its parameters frozen. ``pseudo_label``
    turns the teacher's confident detections into training targets."""

    def __init__(self, model: torch.nn.Module, teacher: Optional[torch.nn.Module] = None,
                 score_thr: float = 0.9, max_gt: int = 128):
        self.model = model
        self.teacher = teacher if teacher is not None else copy.deepcopy(model)
        self.teacher.eval().requires_grad_(False)
        self.score_thr = score_thr
        self.max_gt = max_gt

    @torch.no_grad()
    def pseudo_label(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The teacher's forward on ``img`` (eval mode, no stochastic depth)
        → gt_boxes (B, G, 4) in the input frame, gt_labels (B, G) int32,
        gt_valid (B, G): the valid detections scoring ``score_thr`` or more,
        G = min(max_gt, the detector's slots)."""
        det = self.teacher(img)
        conf = det["valid"] & (det["scores"] >= self.score_thr)
        g = self.max_gt
        conf = conf[:, :g]
        boxes = det["boxes"][:, :g].float() * self.teacher.scale_factor  # back to the input frame
        return dict(gt_boxes=torch.where(conf[..., None], boxes, 0.0),
                    gt_labels=torch.where(conf, det["labels"][:, :g], 0).to(torch.int32),
                    gt_valid=conf)

    def semi_loss(self, sup_batch: Dict[str, torch.Tensor], unsup_img: torch.Tensor,
                  cum_samples: torch.Tensor, unsup_weight: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  unsup_img_teacher: Optional[torch.Tensor] = None, weighter=None,
                  step: Optional[int] = None, timing: Optional[dict] = None):
        """The student's losses on the supervised batch and on the
        unlabelled one against the teacher's pseudo labels → (losses with
        "sup."/"unsup."-prefixed keys and "total", cum_samples).

        ``unsup_img`` is the student's (strong) view; the pseudo labels come
        from ``unsup_img_teacher`` (the weak view) when given. The
        unlabelled batch carries zero mask patches and a zero semantic map;
        only its ``loss_*`` terms that name neither "mask" nor "seg" enter
        the total, times ``unsup_weight`` (which multiplies and never skips
        the branch). ``weighter`` re-weights each branch before they are
        combined. ``generator`` serves both branches' draws, the supervised
        one first. ``timing``: a dict that receives the synchronized seconds
        of the teacher's forward (``teacher_s``)."""
        sup_losses, cum = self.model.compute_losses(sup_batch["img"], sup_batch, cum_samples,
                                                    generator)
        t0 = synced_clock(unsup_img.device) if timing is not None else 0.0
        pseudo = self.pseudo_label(unsup_img if unsup_img_teacher is None else unsup_img_teacher)
        if timing is not None:
            timing["teacher_s"] = synced_clock(unsup_img.device) - t0
        b, g = pseudo["gt_labels"].shape
        dev = unsup_img.device
        unsup_batch = dict(pseudo, img=unsup_img,
                           gt_patches=torch.zeros((b, g, 64, 64), dtype=torch.float32, device=dev),
                           gt_semantic=torch.zeros((b, unsup_img.shape[1] // 4,
                                                    unsup_img.shape[2] // 4),
                                                   dtype=torch.int32, device=dev))
        unsup_losses, cum = self.model.compute_losses(unsup_img, unsup_batch, cum, generator)
        if weighter is not None:
            # per branch, before they are combined: the schedule's keys match
            # and the burn-in / unsup_weight gating of the total holds
            sup_losses = weighter(sup_losses, step)
            unsup_losses = weighter(unsup_losses, step)
        zero = sup_losses["total"] * 0.0
        unsup_keys = [k for k in unsup_losses if k.split(".")[-1].startswith("loss_")
                      and "mask" not in k and "seg" not in k]
        total = sup_losses["total"] + unsup_weight * sum(
            (unsup_losses.get(k, zero) for k in unsup_keys), zero)
        out = {f"sup.{k}": v for k, v in sup_losses.items()}
        out.update({f"unsup.{k}": v for k, v in unsup_losses.items()})
        out["total"] = total
        return out, cum


def partial_mask_loss(mask_probs: torch.Tensor, mask_targets: torch.Tensor,
                      ismask: torch.Tensor, pos_weight: torch.Tensor) -> torch.Tensor:
    """Partial-supervision mask loss (the reference RoIHead_Partial /
    PartialDiceLoss): instances with ``ismask == 0`` (box-only annotations,
    NuCLS) give no mask loss."""
    from nuhtc_tpu_torch.models.losses import dice_loss

    return dice_loss(mask_probs, mask_targets, weight=pos_weight * ismask.float())
