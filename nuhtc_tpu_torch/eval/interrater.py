"""Interrater-agreement analysis (NuCLS subtree capability); port of
nuhtc_tpu/eval/interrater.py, numpy only.

Own implementations of the three analysis primitives the reference vendors in
its NuCLS subtree (reference nuhtc/datasets/nucls/interrater/):

- Dawid & Skene (1979) EM ground-truth inference from multi-rater labels
  (DawidAndSkene1979_EMGtruthInference.py:44-303): per-worker confusion
  matrices + label priors estimated by EM, per-example posterior over labels.
- Krippendorff's alpha (krippendorff.py:162-266): chance-corrected
  agreement from the coincidence matrix, nominal/ordinal/interval/ratio
  metrics, any number of raters, missing data allowed.
- Constrained agglomerative clustering
  (constrained_agglomerative_clustering.py:7-291): average-linkage
  agglomeration of multi-rater nucleus anchors under a don't-link constraint
  (no cluster may contain two anchors from the same rater).

Pure numpy — this is offline host-side analysis, not device compute.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

MISSING = None


# --------------------------------------------------------------------------- #
# Dawid & Skene EM
# --------------------------------------------------------------------------- #
class DawidSkeneEM:
    """EM inference of true labels from noisy multi-rater annotations.

    ``responses``: {example_id: {worker_id: label}}. Labels may be any
    hashable. Mirrors the reference EM class (e2wl/w2el structure,
    DawidAndSkene1979_EMGtruthInference.py:44-303): init example posteriors
    from (smoothed) vote fractions via an ``initquality`` diagonal confusion
    prior, then alternate M (priors + per-worker confusion) and E (example
    posteriors) steps.
    """

    def __init__(
        self,
        responses: Mapping[Hashable, Mapping[Hashable, Hashable]],
        label_set: Optional[Sequence[Hashable]] = None,
        initquality: float = 0.7,
    ):
        self.responses = {e: dict(ws) for e, ws in responses.items()}
        if label_set is None:
            label_set = sorted({l for ws in self.responses.values() for l in ws.values()})
        self.labels: List[Hashable] = list(label_set)
        self.lidx = {l: i for i, l in enumerate(self.labels)}
        self.workers = sorted({w for ws in self.responses.values() for w in ws})
        self.widx = {w: i for i, w in enumerate(self.workers)}
        self.examples = list(self.responses)
        self.initquality = float(initquality)

        k = len(self.labels)
        # votes[e, w] = label index or -1
        self.votes = np.full((len(self.examples), len(self.workers)), -1, np.int64)
        for ei, e in enumerate(self.examples):
            for w, l in self.responses[e].items():
                self.votes[ei, self.widx[w]] = self.lidx[l]
        self.k = k

    def run(self, n_iter: int = 20, tol: float = 1e-7):
        """Returns (e2lpd {example: {label: prob}}, worker_cm (W, K, K),
        priors (K,))."""
        n, m = self.votes.shape
        k = self.k
        has = self.votes >= 0  # (N, W)
        onehot = np.zeros((n, m, k))
        ii, ww = np.nonzero(has)
        onehot[ii, ww, self.votes[ii, ww]] = 1.0

        # init: confusion = initquality on diagonal, uniform off-diagonal
        q = self.initquality
        off = (1.0 - q) / max(k - 1, 1)
        cm = np.full((m, k, k), off)
        cm[:, np.arange(k), np.arange(k)] = q if k > 1 else 1.0
        priors = np.full(k, 1.0 / k)

        post = None
        prev_ll = -np.inf
        for _ in range(n_iter):
            # E step: log p(true=t | votes) ∝ log prior + Σ_w log cm[w, t, vote]
            logcm = np.log(np.clip(cm, 1e-12, None))  # (W, K, K)
            # contribution (N, K): for each example sum over observed workers
            contrib = np.einsum("nwv,wtv->nt", onehot, logcm)
            logpost = np.log(np.clip(priors, 1e-12, None))[None, :] + contrib
            logpost -= logpost.max(axis=1, keepdims=True)
            post = np.exp(logpost)
            post /= post.sum(axis=1, keepdims=True)

            # M step
            priors = post.mean(axis=0)
            # cm[w, t, v] ∝ Σ_n post[n, t] · onehot[n, w, v]
            num = np.einsum("nt,nwv->wtv", post, onehot)
            denom = num.sum(axis=2, keepdims=True)
            uniform = np.full((1, 1, k), 1.0 / k)
            cm = np.where(denom > 0, num / np.clip(denom, 1e-12, None), uniform)

            ll = self._loglik(onehot, cm, priors)
            if abs(ll - prev_ll) < tol:
                break
            prev_ll = ll

        e2lpd = {
            e: {l: float(post[ei, li]) for li, l in enumerate(self.labels)}
            for ei, e in enumerate(self.examples)
        }
        return e2lpd, cm, priors

    def _loglik(self, onehot, cm, priors):
        logcm = np.log(np.clip(cm, 1e-12, None))
        contrib = np.einsum("nwv,wtv->nt", onehot, logcm)
        joint = np.log(np.clip(priors, 1e-12, None))[None, :] + contrib
        mx = joint.max(axis=1, keepdims=True)
        return float(np.sum(mx[:, 0] + np.log(np.exp(joint - mx).sum(axis=1))))


def truth_from_posteriors(e2lpd: Mapping, rng: Optional[np.random.RandomState] = None):
    """MAP label per example (random tie-break, reference gettruthfrompd
    DawidAndSkene1979_EMGtruthInference.py:306-327)."""
    rng = rng or np.random.RandomState(0)
    out = {}
    for e, lpd in e2lpd.items():
        mx = max(lpd.values())
        cands = [l for l, p in lpd.items() if p == mx]
        out[e] = cands[rng.randint(len(cands))] if len(cands) > 1 else cands[0]
    return out


# --------------------------------------------------------------------------- #
# Krippendorff's alpha
# --------------------------------------------------------------------------- #
def _metric_matrix(domain: np.ndarray, counts_per_value: np.ndarray, level: str):
    """delta²(v1, v2) for each pair in the value domain."""
    nv = len(domain)
    d = np.zeros((nv, nv))
    if level == "nominal":
        d = 1.0 - np.eye(nv)
    elif level == "interval":
        d = (domain[:, None] - domain[None, :]) ** 2
    elif level == "ratio":
        denom = domain[:, None] + domain[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(denom != 0, ((domain[:, None] - domain[None, :]) / denom) ** 2, 0.0)
    elif level == "ordinal":
        # (Σ_{g=i..j} n_g − (n_i + n_j)/2)² over the value ranks
        for i in range(nv):
            for j in range(nv):
                lo, hi = min(i, j), max(i, j)
                s = counts_per_value[lo : hi + 1].sum()
                d[i, j] = (s - (counts_per_value[i] + counts_per_value[j]) / 2.0) ** 2
    else:
        raise ValueError(f"unknown level_of_measurement: {level}")
    return d


def krippendorff_alpha(
    reliability_data: Sequence[Sequence],
    level_of_measurement: str = "nominal",
    value_domain: Optional[Sequence] = None,
    missing=MISSING,
) -> float:
    """Krippendorff's alpha (reference krippendorff.py:162-266 semantics).

    ``reliability_data``: rows = raters, columns = units; ``missing`` (None or
    np.nan) marks absent ratings. Units rated by fewer than 2 raters are
    dropped. Returns alpha in [-1, 1] (1 = perfect agreement).
    """
    rows = [list(r) for r in reliability_data]
    if not rows or not any(rows):
        return np.nan  # no data → the same insufficient-data contract as below
    n_units = max(len(r) for r in rows)

    def is_missing(v):
        if v is None:
            return True
        if isinstance(v, float) and np.isnan(v):
            return True
        return missing is not None and v == missing

    # value domain
    seen = []
    for r in rows:
        for v in r:
            if not is_missing(v) and v not in seen:
                seen.append(v)
    if value_domain is None:
        try:
            domain = sorted(seen)
        except TypeError:
            domain = seen
    else:
        domain = list(value_domain)
    vidx = {v: i for i, v in enumerate(domain)}
    nv = len(domain)

    # value counts per unit (units × values)
    counts = np.zeros((n_units, nv))
    for r in rows:
        for u, v in enumerate(r):
            if u < n_units and not is_missing(v):
                if v not in vidx:
                    raise ValueError(
                        f"observed value {v!r} outside value_domain {domain!r}"
                    )
                counts[u, vidx[v]] += 1

    m_u = counts.sum(axis=1)  # raters per unit
    usable = m_u >= 2
    counts = counts[usable]
    m_u = m_u[usable]
    if counts.size == 0 or counts.sum() <= 1:
        return np.nan

    # coincidence matrix: o[v1, v2] = Σ_u n_uv1 (n_uv2 − δ) / (m_u − 1)
    pairable = counts / (m_u - 1)[:, None]
    o = np.einsum("uv,uw->vw", counts, pairable)
    o[np.arange(nv), np.arange(nv)] -= (counts * 1.0 / (m_u - 1)[:, None]).sum(axis=0) * 1.0
    # (above subtracts Σ_u n_uv (1)/(m_u−1) = self-pairing)

    n_total = o.sum()
    nc = o.sum(axis=1)  # marginal coincidences per value

    dom_arr = np.asarray(
        domain if np.issubdtype(np.asarray(domain).dtype, np.number) else np.arange(nv),
        dtype=float,
    )
    delta = _metric_matrix(dom_arr, nc, level_of_measurement)

    d_o = (o * delta).sum()
    e = np.outer(nc, nc) - np.diag(nc)  # expected coincidences × (n−1)
    d_e = (e * delta).sum() / (n_total - 1)
    if d_e == 0:
        return 1.0
    return float(1.0 - d_o / d_e)


# --------------------------------------------------------------------------- #
# Constrained agglomerative clustering
# --------------------------------------------------------------------------- #
class ConstrainedAgglomerativeClustering:
    """COMPLETE-linkage agglomeration with a don't-link constraint: no
    cluster may contain two points from the same rater (reference
    constrained_agglomerative_clustering.py:7-291 — its default linkage is
    'complete'; the reference enforces the constraint by post-hoc eviction
    on the dendrogram, we enforce it at merge time, a documented deviation
    that keeps the same invariant).

    ``points``: (N, D) coordinates. ``raters``: (N,) rater id per point.
    ``linkage_thresh``: stop merging when the closest admissible pair of
    clusters is farther than this.

    The pairwise cluster-distance matrix is maintained incrementally with
    the Lance-Williams complete-linkage update (max of the merged rows) —
    O(N² ) per merge instead of recomputing all mean-pairwise distances.
    """

    def __init__(self, points: np.ndarray, raters: Sequence, linkage_thresh: float):
        self.points = np.asarray(points, float)
        self.raters = list(raters)
        self.thresh = float(linkage_thresh)

    def run(self) -> List[List[int]]:
        n = len(self.points)
        if n == 0:
            return []
        clusters: List[List[int]] = [[i] for i in range(n)]
        rsets = [{self.raters[i]} for i in range(n)]
        d = np.linalg.norm(
            self.points[:, None, :] - self.points[None, :, :], axis=-1
        )
        np.fill_diagonal(d, np.inf)
        blocked = np.array(
            [[bool(rsets[i] & rsets[j]) for j in range(n)] for i in range(n)]
        )
        np.fill_diagonal(blocked, True)
        alive = np.ones(n, bool)

        while alive.sum() > 1:
            dm = np.where(blocked, np.inf, d)
            flat = np.argmin(dm)
            i, j = np.unravel_index(flat, dm.shape)
            if not np.isfinite(dm[i, j]) or dm[i, j] > self.thresh:
                break
            # merge j into i: complete linkage → max of the two rows
            clusters[i] += clusters[j]
            rsets[i] |= rsets[j]
            d[i] = np.maximum(d[i], d[j])
            d[:, i] = d[i]
            d[i, i] = np.inf
            blocked[i] = blocked[i] | blocked[j] | np.array(
                [not alive[k] or bool(rsets[i] & rsets[k]) for k in range(n)]
            )
            blocked[:, i] = blocked[i]
            blocked[i, i] = True
            alive[j] = False
            d[j] = d[:, j] = np.inf
            blocked[j] = blocked[:, j] = True
        return [clusters[i] for i in range(n) if alive[i]]

    def medoids(self, clusters: List[List[int]]) -> np.ndarray:
        """Mean anchor per cluster (the consensus nucleus location)."""
        return np.stack([self.points[c].mean(axis=0) for c in clusters])
