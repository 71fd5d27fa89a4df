"""The comparison that decides ``correct``: what the timed path produced
against the frozen f32 reference on the same tiles and weights.

Detections are matched one to one per tile (same label, box IoU > 0.5,
greedily in the reference's score order, the best IoU first). Random
weights put many boxes of near-equal scores side by side, so any rounding
flips some of the discrete decisions (the score threshold, NMS, the top-k
cut); the numbers compared are ones that such flips move a little and a
path computed one precision lower moves a lot (readings in PERF.md §2):

- ``det_unmatched``: 1 - 2·matched / (program's + reference's detections),
  over the sampled tiles (1 - F1);
- ``top_unmatched``: of each side's top half by score, the share left
  without a partner;
- ``score_gap``, ``box_gap``: medians over the matched pairs of |Δscore|
  and of 1 - box IoU.

Two numbers follow the program's own discrete decisions (its detections)
instead, so that no rounding can flip them:

- ``mask_px_wrong``: pixels of the program's label maps that no threshold
  within 0.5 ± 0.01 gives the reference's masks at the program's boxes,
  pasted in the program's order (``program.mask_px_wrong``);
- ``nuclei_off``: 1 - F1 of the exported nuclei against the reference's
  post-processing of the program's detections, equal point for point.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-12)


def match(got: dict, want: dict, iou_thr: float = 0.5) -> List[Tuple[int, int, float]]:
    """(got index, want index, IoU) pairs: same label, IoU > ``iou_thr``."""
    pairs = []
    if not len(got["scores"]) or not len(want["scores"]):
        return pairs
    free = np.ones(len(got["scores"]), bool)
    iou = box_iou(got["boxes"], want["boxes"])
    for wi in np.argsort(-np.asarray(want["scores"]), kind="stable"):
        cand = np.where(free & (got["labels"] == want["labels"][wi]) & (iou[:, wi] > iou_thr))[0]
        if len(cand):
            gi = cand[np.argmax(iou[cand, wi])]
            free[gi] = False
            pairs.append((int(gi), int(wi), float(iou[gi, wi])))
    return pairs


def unmatched(got: Sequence[dict], want: Sequence[dict]) -> Tuple[float, dict]:
    """1 - F1 over tiles, and the counts."""
    m = n_got = n_want = 0
    for g, w in zip(got, want, strict=True):
        m += len(match(g, w))
        n_got += len(g["scores"])
        n_want += len(w["scores"])
    total = n_got + n_want
    return (1.0 - 2.0 * m / total if total else 0.0), dict(matched=m, got=n_got, want=n_want)


def label_map_of(masks: np.ndarray, shape) -> np.ndarray:
    """Disjoint (n, H, W) masks → a label map, mask i drawn as i + 1."""
    lab = np.zeros(shape, np.int64)
    for i, m in enumerate(masks):
        lab[m > 0] = i + 1
    return lab


def top_unmatched(got: Sequence[dict], want: Sequence[dict]) -> float:
    """Of each side's top half by score (per tile), the share the one-to-one
    matching leaves without a partner: the cap and the threshold flip the
    last ranks under any rounding, the first ranks only under a wrong path."""
    miss = total = 0
    for g, w in zip(got, want, strict=True):
        pairs = match(g, w)
        gm = {gi for gi, _, _ in pairs}
        wm = {wi for _, wi, _ in pairs}
        for side, matched in ((g, gm), (w, wm)):
            n = len(side["scores"])
            top = np.argsort(-np.asarray(side["scores"]), kind="stable")[: (n + 1) // 2]
            total += len(top)
            miss += sum(1 for i in top if int(i) not in matched)
    return miss / total if total else 0.0


def pair_gaps(got: Sequence[dict], want: Sequence[dict]) -> Tuple[float, float]:
    """Medians over the matched pairs of |Δscore| and of 1 - box IoU."""
    ds, di = [], []
    for g, w in zip(got, want, strict=True):
        for gi, wi, iou in match(g, w):
            ds.append(abs(float(g["scores"][gi]) - float(w["scores"][wi])))
            di.append(1.0 - iou)
    return (float(np.median(ds)) if ds else 1.0), (float(np.median(di)) if di else 1.0)


def nuclei_exact(got: Sequence[dict], want: Sequence[dict]) -> Tuple[float, dict]:
    """1 - F1 of two sets of nuclei a tile, a pair only where the label and
    every contour point are equal."""
    m = n_got = n_want = 0
    for g, w in zip(got, want, strict=True):
        key = lambda lab, c: (int(lab), np.asarray(c, np.int64).reshape(-1, 2).tobytes())  # noqa
        gk = [key(lab, c) for lab, c in zip(g["labels"], g["contours"])]
        wk = [key(lab, c) for lab, c in zip(w["labels"], w["contours"])]
        left = list(wk)
        for k in gk:
            if k in left:
                left.remove(k)
                m += 1
        n_got, n_want = n_got + len(gk), n_want + len(wk)
    total = n_got + n_want
    return (1.0 - 2.0 * m / total if total else 0.0), dict(matched=m, got=n_got, want=n_want)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """Every number at or under its limit → (correct, [{name, value, limit}])."""
    rows = [{"name": k, "value": float(numbers[k]), "limit": float(limits[k])} for k in limits]
    return all(r["value"] <= r["limit"] for r in rows), rows
