"""The system under test and its reference, built from one configuration
file and one state dict.

``engine`` goes through the port's own entry, ``init_detector`` (bf16 on
the card, TF32 off, the configuration's Swin kernel tier, WSI mode), then
loads the benchmark's weights. ``reference`` is the frozen plain model in
f32 (or the fp8 control) on the same weights; ``reference_detect`` runs it
over uint8 tiles in blocks of ``batch``."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.harness import check
from portbench.reference import model as RM
from portbench.reference import post as ref_post
from portbench.reference import precision


def engine(cfg: dict, state: Dict[str, torch.Tensor], batch: int, device):
    from nuhtc_tpu_torch.apis.inference import init_detector
    from nuhtc_tpu_torch.config import Config

    eng = init_detector(Config({"model": cfg["model"], "scale_factor": cfg["scale_factor"]}),
                        None, batch_size=batch, device=device,
                        device_preprocess=cfg["engine"]["device_preprocess"],
                        compact_masks=cfg["engine"]["compact_masks"],
                        scale_factor=cfg["scale_factor"], tile_size=cfg["tile"],
                        swin_kernel=cfg["swin_kernel"])
    eng.model.load_state_dict(state, strict=True)
    return eng


def reference(cfg: dict, state: Dict[str, torch.Tensor], device, fp8: bool = False):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = RM.build(cfg)
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    model = model.to(device).eval()
    return precision.to_fp8(model) if fp8 else model


def reference_detect(model, tiles: Sequence[np.ndarray], cfg: dict, batch: int, device
                     ) -> List[dict]:
    """Per-tile dicts of the reference's valid detections with their masks."""
    out = []
    for i in range(0, len(tiles), batch):
        chunk = np.stack(tiles[i:i + batch])
        det = RM.detect(model, torch.from_numpy(chunk).to(device), cfg["scale_factor"])
        det = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
               for k, v in det.items()}
        out += RM.split_results(det, len(chunk))
    return out


def reference_nuclei(results: Sequence[dict], coords, tile: int, traffic: dict) -> List[dict]:
    """The reference's post-processing of each tile's detections."""
    out = []
    for res, coord in zip(results, coords):
        conts, labels, scores = ref_post.postprocess_tile(
            res, tuple(int(c) for c in coord), tile, margin=traffic["margin"],
            min_area=traffic["min_area"], score_thr=traffic["score_thr"])
        out.append(dict(contours=conts, labels=np.asarray(labels), scores=np.asarray(scores)))
    return out


def detection_numbers(got, want, ref_model, tiles, cfg: dict, tr: dict, device
                      ) -> Dict[str, object]:
    """The numbers of detections ``got`` (per tile: boxes, scores, labels,
    masks) against the reference's ``want`` on the same ``tiles``."""
    det, counts = check.unmatched(got, want)
    score_gap, box_gap = check.pair_gaps(got, want)
    bad = fg = 0
    t = tr["tile"]
    for i in range(0, len(tiles), tr["batch"]):
        chunk = torch.from_numpy(np.stack(tiles[i:i + tr["batch"]])).to(device)
        dets = got[i:i + tr["batch"]]
        probs, boxes, _ = RM.mask_probs_at(ref_model, chunk, dets, cfg["scale_factor"])
        for j, g in enumerate(dets):
            n = len(g["boxes"])
            lab = torch.from_numpy(check.label_map_of(g["masks"], (t, t))).to(device)
            full = RM.pasted_probs(probs[j, :n], boxes[j, :n], (t, t))
            b, f = mask_px_wrong(lab, full, ref_model.mask_thr_binary, MASK_BAND)
            bad, fg = bad + b, fg + f
    return {"det_unmatched": det, "top_unmatched": check.top_unmatched(got, want),
            "score_gap": score_gap, "box_gap": box_gap, "mask_px_wrong": bad / fg if fg else 0.0,
            "det_counts": counts}


# the half-width of the band of thresholds around the paste's within which
# the reference may put a mask's edge: bf16's error in a probability there
# stays far inside it, fp8's does not (PERF.md §2)
MASK_BAND = 0.01


def mask_px_wrong(lab: torch.Tensor, full: torch.Tensor, thr: float, delta: float):
    """Pixels of a program label map ``lab`` (H, W; 0 background, i + 1 the
    i-th detection, the first owning a shared pixel) that no threshold
    within ``thr`` ± ``delta`` gives the reference's pasted probabilities
    ``full`` (D, H, W) of the same detections, and the pixels either gives to
    a detection → (wrong, foreground)."""
    if full.shape[0] == 0:
        fg = lab > 0
        return int(fg.sum()), int(fg.sum())
    lo, hi = thr - delta, thr + delta
    prefix = torch.cummax(full, dim=0).values  # max over the detections up to each
    top = prefix[-1]
    idx = (lab - 1).clamp(min=0).long()
    p_own = full.gather(0, idx[None])[0]
    before = torch.where(idx > 0, prefix.gather(0, (idx - 1).clamp(min=0)[None])[0],
                         torch.zeros_like(p_own))
    ok_fg = torch.maximum(before, torch.full_like(before, lo)) < torch.minimum(
        p_own, torch.full_like(p_own, hi))
    ok = torch.where(lab > 0, ok_fg, top <= hi)
    fg = (lab > 0) | (top > thr)
    return int((fg & ~ok).sum()), int(fg.sum())
