"""Per-nucleus morphometric / intensity / texture features on the host (port
of nuhtc_tpu/wsi/features.py).

A self-contained stand-in for histomicstk's ``compute_nuclei_features``
(~90 columns; the names and their order are those of the JAX module and
docs/FEATURES.md):

- shape: area, perimeter, circularity, eccentricity, solidity, extent,
  equivalent diameter, major/minor axis length, orientation, bbox, Hu
  moments, Fourier shape descriptors, fractal dimension;
- intensity (hematoxylin and eosin by Ruifrok-Johnston colour deconvolution,
  and R, G, B): mean/std/min/max/median/MAD/entropy and more;
- gradient: Sobel magnitude statistics and Canny edge density;
- texture: GLCM Haralick statistics, mean and range over 4 offsets.

OpenCV's geometry and filters come from ``ops.contours`` and ``ops.imgproc``,
which equal cv2 5.0.0; ``fit_ellipse`` holds to the tolerance its docstring
states, and so do the columns taken from it (major/minor axis, their
ratio, eccentricity, orientation).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from nuhtc_tpu_torch.ops import contours as cnt
from nuhtc_tpu_torch.ops.imgproc import canny, rgb_to_gray_u8, sobel3

# Ruifrok & Johnston H&E stain vectors (rows: H, E, residual)
_STAIN_MATRIX = np.array(
    [
        [0.650, 0.704, 0.286],
        [0.072, 0.990, 0.105],
        [0.268, 0.570, 0.776],
    ]
)
_STAIN_MATRIX = _STAIN_MATRIX / np.linalg.norm(_STAIN_MATRIX, axis=1, keepdims=True)
_STAIN_INV = np.linalg.inv(_STAIN_MATRIX.T)


def color_deconvolution(rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 → stain concentration maps (H, E, residual), float32 (H, W, 3)."""
    od = -np.log10((rgb.astype(np.float64) + 1.0) / 256.0)
    conc = od.reshape(-1, 3) @ _STAIN_INV.T
    return conc.reshape(rgb.shape).astype(np.float32)


def _glcm_single(p2: np.ndarray, levels: int) -> Dict[str, float]:
    """Full Haralick statistic set for one normalized co-occurrence matrix
    (histomicstk compute_haralick_features / Haralick 1973)."""
    i_idx, j_idx = np.mgrid[:levels, :levels]
    diff = i_idx - j_idx
    out: Dict[str, float] = {}
    out["contrast"] = float((p2 * diff**2).sum())
    out["dissimilarity"] = float((p2 * np.abs(diff)).sum())
    out["homogeneity"] = float((p2 / (1.0 + diff**2)).sum())
    out["idm"] = out["homogeneity"]  # inverse difference moment
    asm = float((p2**2).sum())
    out["asm"] = asm
    px = p2.sum(1)
    py = p2.sum(0)
    mu_i = float((px * np.arange(levels)).sum())
    mu_j = float((py * np.arange(levels)).sum())
    sd_i = math.sqrt(max(float((px * (np.arange(levels) - mu_i) ** 2).sum()), 1e-12))
    sd_j = math.sqrt(max(float((py * (np.arange(levels) - mu_j) ** 2).sum()), 1e-12))
    out["correlation"] = float(((p2 * (i_idx - mu_i) * (j_idx - mu_j)).sum()) / (sd_i * sd_j))
    out["sum_of_squares"] = float((p2 * (i_idx - mu_i) ** 2).sum())
    nz = p2[p2 > 0]
    out["entropy"] = float(-(nz * np.log2(nz)).sum())
    # p_{x+y}(k), k = 0..2(L-1); p_{x-y}(k), k = 0..L-1
    psum = np.zeros(2 * levels - 1)
    np.add.at(psum, (i_idx + j_idx).ravel(), p2.ravel())
    pdiff = np.zeros(levels)
    np.add.at(pdiff, np.abs(diff).ravel(), p2.ravel())
    ks = np.arange(2 * levels - 1)
    out["sum_average"] = float((psum * ks).sum())
    out["sum_variance"] = float((psum * (ks - out["sum_average"]) ** 2).sum())
    nzs = psum[psum > 0]
    out["sum_entropy"] = float(-(nzs * np.log2(nzs)).sum())
    kd = np.arange(levels)
    davg = float((pdiff * kd).sum())
    out["difference_variance"] = float((pdiff * (kd - davg) ** 2).sum())
    nzd = pdiff[pdiff > 0]
    out["difference_entropy"] = float(-(nzd * np.log2(nzd)).sum())
    # information measures of correlation
    nzx, nzy = px[px > 0], py[py > 0]
    hx = float(-(nzx * np.log2(nzx)).sum())
    hy = float(-(nzy * np.log2(nzy)).sum())
    pxy = px[:, None] * py[None, :]
    sel = (p2 > 0) & (pxy > 0)
    hxy1 = float(-(p2[sel] * np.log2(pxy[sel])).sum())
    selxy = pxy > 0
    hxy2 = float(-(pxy[selxy] * np.log2(pxy[selxy])).sum())
    out["imc1"] = (out["entropy"] - hxy1) / max(hx, hy, 1e-12)
    out["imc2"] = math.sqrt(max(1.0 - math.exp(-2.0 * (hxy2 - out["entropy"])), 0.0))
    return out


def _glcm(gray: np.ndarray, mask: np.ndarray, levels: int = 16) -> Dict[str, float]:
    """Haralick features over 4 offsets → per-stat mean and range
    (histomicstk reports .Mean/.Range over directions)."""
    g = np.clip((gray / 256.0 * levels).astype(np.int32), 0, levels - 1)
    offsets = [(0, 1), (1, 0), (1, 1), (1, -1)]
    per_offset: List[Dict[str, float]] = []
    for dy, dx in offsets:
        h, w = g.shape
        src = g[max(-dy, 0) : h - max(dy, 0), max(-dx, 0) : w - max(dx, 0)]
        dst = g[max(dy, 0) : h - max(-dy, 0), max(dx, 0) : w - max(-dx, 0)]
        msrc = mask[max(-dy, 0) : h - max(dy, 0), max(-dx, 0) : w - max(dx, 0)]
        mdst = mask[max(dy, 0) : h - max(-dy, 0), max(dx, 0) : w - max(-dx, 0)]
        sel = (msrc > 0) & (mdst > 0)
        if sel.sum() < 4:
            continue
        pairs = src[sel] * levels + dst[sel]
        p = np.bincount(pairs, minlength=levels * levels).astype(np.float64)
        p /= p.sum()
        per_offset.append(_glcm_single(p.reshape(levels, levels), levels))
    feats: Dict[str, float] = {}
    if not per_offset:
        keys = list(_glcm_single(np.full((levels, levels), 1.0 / levels**2), levels))
        for k in keys + ["energy"]:
            feats[k] = 0.0
            feats[f"{k}_range"] = 0.0
        return feats
    # histomicstk reports every Haralick stat per direction then Mean/Range —
    # energy included: energy_d = sqrt(ASM_d) per offset, THEN mean/range
    # (sqrt(mean(asm)) != mean(sqrt(asm)) on anisotropic textures)
    for po in per_offset:
        po["energy"] = math.sqrt(max(po["asm"], 0.0))
    keys = per_offset[0].keys()
    for k in keys:
        vals = [po[k] for po in per_offset]
        feats[k] = float(np.mean(vals))
        feats[f"{k}_range"] = float(np.max(vals) - np.min(vals))
    return feats


def _skew_kurt(vals: np.ndarray):
    mu = vals.mean()
    sd = vals.std()
    if sd < 1e-12:
        return 0.0, 0.0
    z = (vals - mu) / sd
    return float((z**3).mean()), float((z**4).mean() - 3.0)


def _gradient_stats(gray: np.ndarray, mask: np.ndarray) -> Dict[str, float]:
    """Nucleus.Gradient.* block (histomicstk compute_gradient_features):
    Sobel magnitude stats + Canny edge density inside the mask."""
    gx, gy = sobel3(gray)
    mag = np.sqrt(gx**2 + gy**2)
    vals = mag[mask > 0].astype(np.float64)
    if len(vals) == 0:
        return {k: 0.0 for k in (
            "grad_mag_mean", "grad_mag_std", "grad_mag_skewness",
            "grad_mag_kurtosis", "grad_mag_entropy", "grad_mag_energy",
            "grad_canny_sum", "grad_canny_mean")}
    hist, _ = np.histogram(vals, bins=32)
    p = hist / max(hist.sum(), 1)
    nzp = p[p > 0]
    skew, kurt = _skew_kurt(vals)
    edges = canny(gray.astype(np.uint8), 50, 150)
    cvals = (edges[mask > 0] > 0).astype(np.float64)
    return {
        "grad_mag_mean": float(vals.mean()),
        "grad_mag_std": float(vals.std()),
        "grad_mag_skewness": skew,
        "grad_mag_kurtosis": kurt,
        "grad_mag_entropy": float(-(nzp * np.log2(nzp)).sum()),
        "grad_mag_energy": float((p**2).sum()),
        "grad_canny_sum": float(cvals.sum()),
        "grad_canny_mean": float(cvals.mean()),
    }


def _fsd(cont: np.ndarray, k: int = 6, n_boundary: int = 128) -> Dict[str, float]:
    """Fourier shape descriptors (histomicstk compute_fsd_features): the
    boundary is resampled to ``n_boundary`` points, FFT'd as complex
    z = x + iy, and spectral energy is grouped into ``k`` wedges of
    increasing frequency (normalized by total non-DC energy)."""
    pts = cont.reshape(-1, 2).astype(np.float64)
    if len(pts) < 4:
        return {f"fsd{i + 1}": 0.0 for i in range(k)}
    # resample boundary uniformly by arc length
    d = np.sqrt(((np.roll(pts, -1, 0) - pts) ** 2).sum(1))
    cum = np.concatenate([[0.0], np.cumsum(d)])
    total = cum[-1]
    if total < 1e-9:
        return {f"fsd{i + 1}": 0.0 for i in range(k)}
    t = np.linspace(0, total, n_boundary, endpoint=False)
    xs = np.interp(t, cum, np.concatenate([pts[:, 0], pts[:1, 0]]))
    ys = np.interp(t, cum, np.concatenate([pts[:, 1], pts[:1, 1]]))
    z = xs + 1j * ys
    f = np.fft.fft(z)
    power = np.abs(f) ** 2
    power[0] = 0.0  # drop DC (position)
    tot = power.sum()
    if tot < 1e-12:
        return {f"fsd{i + 1}": 0.0 for i in range(k)}
    # frequency wedges: indices 1..n/2 folded with their negatives
    half = n_boundary // 2
    folded = power[1 : half + 1].copy()  # j = 1..half (half = Nyquist)
    folded[: half - 1] += power[:half:-1]  # fold -j onto +j (j = 1..half-1)
    edges = np.unique(np.round(np.logspace(0, math.log10(half), k + 1)).astype(int))
    while len(edges) < k + 1:  # tiny contours: pad edge list
        edges = np.concatenate([edges, [edges[-1] + 1]])
    out = {}
    for i in range(k):
        # the LAST wedge closes at the Nyquist bin folded[half-1] inclusive
        # (edges[-1] == half; a bound of edges[i+1]-1 would drop it from
        # every wedge while the normalizer tot still counts it)
        lo = edges[i] - 1
        hi = half if i == k - 1 else min(edges[i + 1] - 1, half)
        out[f"fsd{i + 1}"] = float(folded[lo:hi].sum() / tot)
    return out


def _fractal_dimension(mask: np.ndarray) -> float:
    """Minkowski–Bouligand box-counting dimension of the boundary."""
    edge = canny(mask * 255, 50, 150) > 0
    if not edge.any():
        return 0.0
    s = max(edge.shape)
    n = 2 ** int(np.ceil(np.log2(max(s, 2))))
    padded = np.zeros((n, n), bool)
    padded[: edge.shape[0], : edge.shape[1]] = edge
    sizes, counts = [], []
    size = n
    while size >= 2:
        blocks = padded.reshape(n // size, size, n // size, size).any(axis=(1, 3))
        c = int(blocks.sum())
        if c > 0:
            sizes.append(size)
            counts.append(c)
        size //= 2
    if len(sizes) < 2:
        return 0.0
    coeffs = np.polyfit(np.log(1.0 / np.asarray(sizes)), np.log(np.asarray(counts)), 1)
    return float(coeffs[0])


def _intensity_stats(ch: np.ndarray, mask: np.ndarray, prefix: str) -> Dict[str, float]:
    keys = ("mean", "std", "min", "max", "median", "mad", "entropy",
            "mean_median_diff", "iqr", "skewness", "kurtosis", "hist_energy")
    vals = ch[mask > 0].astype(np.float64)
    if len(vals) == 0:
        return {f"{prefix}_{k}": 0.0 for k in keys}
    hist, _ = np.histogram(vals, bins=32)
    p = hist / max(hist.sum(), 1)
    nz = p[p > 0]
    med = float(np.median(vals))
    skew, kurt = _skew_kurt(vals)
    q75, q25 = np.percentile(vals, [75, 25])
    return {
        f"{prefix}_mean": float(vals.mean()),
        f"{prefix}_std": float(vals.std()),
        f"{prefix}_min": float(vals.min()),
        f"{prefix}_max": float(vals.max()),
        f"{prefix}_median": med,
        f"{prefix}_mad": float(np.median(np.abs(vals - med))),
        f"{prefix}_entropy": float(-(nz * np.log2(nz)).sum()),
        f"{prefix}_mean_median_diff": float(vals.mean() - med),
        f"{prefix}_iqr": float(q75 - q25),
        f"{prefix}_skewness": skew,
        f"{prefix}_kurtosis": kurt,
        f"{prefix}_hist_energy": float((p**2).sum()),
    }


def nucleus_features(
    rgb: np.ndarray,  # crop around the nucleus, RGB uint8
    mask: np.ndarray,  # same-size binary mask
    offset=(0, 0),  # crop origin in slide coords
    with_texture: bool = True,
    with_intensity: bool = True,
) -> Optional[Dict[str, float]]:
    mask = (mask > 0).astype(np.uint8)
    contours, _ = cnt.find_contours(mask, cnt.RETR_EXTERNAL, cnt.CHAIN_APPROX_NONE)
    if not contours:
        return None
    cont = max(contours, key=cnt.contour_area)
    if cnt.contour_area(cont) <= 0:
        return None
    # histomicstk Size.Area/ConvexHullArea are regionprops PIXEL COUNTS
    # (the published rows in reference README.md:281-287 are integers);
    # the polygon area through pixel centres runs ~4-5% low
    area = float(int(mask.sum()))
    perimeter = float(cnt.arc_length(cont, True))
    m = cnt.contour_moments(cont)
    cx = m["m10"] / max(m["m00"], 1e-9) + offset[0]
    cy = m["m01"] / max(m["m00"], 1e-9) + offset[1]
    hull = cnt.convex_hull(cont)
    hull_img = np.zeros_like(mask)
    cnt.fill_convex_poly(hull_img, hull[:, 0], 1)
    hull_area = max(float(int(hull_img.sum())), 1.0)
    x, y, bw, bh = cnt.bounding_rect(cont)

    # ellipse fit (needs ≥5 points)
    if len(cont) >= 5:
        (_, _), (ma, mi), angle = cnt.fit_ellipse(cont)
        major, minor = max(ma, mi), min(ma, mi)
    else:
        major = max(bw, bh)
        minor = min(bw, bh)
        angle = 0.0
    ecc = math.sqrt(max(1 - (minor / max(major, 1e-9)) ** 2, 0.0))

    feats = {
        "centroid_x": cx,
        "centroid_y": cy,
        "area": area,
        "perimeter": perimeter,
        "circularity": 4 * math.pi * area / max(perimeter**2, 1e-9),
        "eccentricity": ecc,
        "major_axis_length": major,
        "minor_axis_length": minor,
        "minor_major_axis_ratio": minor / max(major, 1e-9),
        "orientation": angle,
        "solidity": area / hull_area,
        "convex_hull_area": hull_area,
        "extent": area / max(bw * bh, 1e-9),
        "equivalent_diameter": math.sqrt(4 * area / math.pi),
        "fractal_dimension": _fractal_dimension(mask),
        "bbox_x": x + offset[0],
        "bbox_y": y + offset[1],
        "bbox_w": bw,
        "bbox_h": bh,
    }
    # Hu moment invariants of the binary shape (Shape.HuMoments1-7)
    hu = cnt.hu_moments(cnt.image_moments(mask, binary=True))
    for i, v in enumerate(hu):
        feats[f"hu_moment{i + 1}"] = float(v)
    # Fourier shape descriptors (Shape.FSD1-6)
    feats.update(_fsd(cont))
    gray = rgb_to_gray_u8(rgb)
    # weighted centroid + weighted Hu moments (intensity-weighted shape,
    # histomicstk Identifier.WeightedCentroid* / Shape.WeightedHuMoments*)
    weighted = gray.astype(np.float32) * mask
    mw = cnt.image_moments(weighted)
    feats["weighted_centroid_x"] = mw["m10"] / max(mw["m00"], 1e-9) + offset[0]
    feats["weighted_centroid_y"] = mw["m01"] / max(mw["m00"], 1e-9) + offset[1]
    hu_w = cnt.hu_moments(mw)
    for i, v in enumerate(hu_w):
        feats[f"weighted_hu_moment{i + 1}"] = float(v)
    if with_intensity:
        conc = color_deconvolution(rgb)
        feats.update(_intensity_stats(conc[..., 0], mask, "hematoxylin"))
        feats.update(_intensity_stats(conc[..., 1], mask, "eosin"))
        for i, name in enumerate(("r", "g", "b")):
            feats.update(_intensity_stats(rgb[..., i].astype(np.float64), mask, name))
        feats.update(_gradient_stats(gray, mask))
    if with_texture:
        for k, v in _glcm(gray, mask).items():
            feats[f"haralick_{k}"] = v
    return feats


# --------------------------------------------------------------------------- #
# histomicstk column map
# --------------------------------------------------------------------------- #

def _histomicstk_column_map() -> Dict[str, List[str]]:
    """histomicstk.features.compute_nuclei_features column → the column(s)
    here that carry the same quantity (reference tools/wsi_feat_extract.py:
    93-107 and the golden feature rows in reference README.md:281-287).

    Semantics notes (documented in docs/FEATURES.md):
    - Orientation.Orientation is regionprops radians; ``orientation`` is the
      fit_ellipse angle (OpenCV's fitEllipse convention) in degrees.
    - Nucleus.Intensity.* are computed on 255-minus-hematoxylin uint8
      (reference :95-96); ``hematoxylin_*`` use the Ruifrok-Johnston
      concentration map directly, so absolute values differ by an affine
      rescale while the distribution-shape stats (skewness, kurtosis,
      entropy, hist_energy) are directly comparable.
    - Identifier.Xmax/Ymax are bbox_x + bbox_w / bbox_y + bbox_h.
    """
    m: Dict[str, List[str]] = {
        "Label": ["label"],
        "Identifier.Xmin": ["bbox_x"],
        "Identifier.Ymin": ["bbox_y"],
        "Identifier.Xmax": ["bbox_x", "bbox_w"],
        "Identifier.Ymax": ["bbox_y", "bbox_h"],
        "Identifier.CentroidX": ["centroid_x"],
        "Identifier.CentroidY": ["centroid_y"],
        "Identifier.WeightedCentroidX": ["weighted_centroid_x"],
        "Identifier.WeightedCentroidY": ["weighted_centroid_y"],
        "Orientation.Orientation": ["orientation"],
        "Size.Area": ["area"],
        "Size.ConvexHullArea": ["convex_hull_area"],
        "Size.MajorAxisLength": ["major_axis_length"],
        "Size.MinorAxisLength": ["minor_axis_length"],
        "Size.Perimeter": ["perimeter"],
        "Shape.Circularity": ["circularity"],
        "Shape.Eccentricity": ["eccentricity"],
        "Shape.EquivalentDiameter": ["equivalent_diameter"],
        "Shape.Extent": ["extent"],
        "Shape.FractalDimension": ["fractal_dimension"],
        "Shape.MinorMajorAxisRatio": ["minor_major_axis_ratio"],
        "Shape.Solidity": ["solidity"],
        "Nucleus.Gradient.Mag.Mean": ["grad_mag_mean"],
        "Nucleus.Gradient.Mag.Std": ["grad_mag_std"],
        "Nucleus.Gradient.Mag.Skewness": ["grad_mag_skewness"],
        "Nucleus.Gradient.Mag.Kurtosis": ["grad_mag_kurtosis"],
        "Nucleus.Gradient.Mag.HistEntropy": ["grad_mag_entropy"],
        "Nucleus.Gradient.Mag.HistEnergy": ["grad_mag_energy"],
        "Nucleus.Gradient.Canny.Sum": ["grad_canny_sum"],
        "Nucleus.Gradient.Canny.Mean": ["grad_canny_mean"],
        # CSV context columns appended by extract_slide_features
        "cell_type": ["class"],
    }
    for i in range(1, 8):
        m[f"Shape.HuMoments{i}"] = [f"hu_moment{i}"]
        m[f"Shape.WeightedHuMoments{i}"] = [f"weighted_hu_moment{i}"]
    for i in range(1, 7):
        m[f"Shape.FSD{i}"] = [f"fsd{i}"]
    for hk, ok in (("Min", "min"), ("Max", "max"), ("Mean", "mean"),
                   ("Median", "median"), ("MeanMedianDiff", "mean_median_diff"),
                   ("Std", "std"), ("IQR", "iqr"), ("MAD", "mad"),
                   ("Skewness", "skewness"), ("Kurtosis", "kurtosis"),
                   ("HistEnergy", "hist_energy"), ("HistEntropy", "entropy")):
        m[f"Nucleus.Intensity.{hk}"] = [f"hematoxylin_{ok}"]
    for hk, ok in (("ASM", "asm"), ("Contrast", "contrast"),
                   ("Correlation", "correlation"),
                   ("SumOfSquares", "sum_of_squares"), ("IDM", "idm"),
                   ("SumAverage", "sum_average"), ("SumVariance", "sum_variance"),
                   ("SumEntropy", "sum_entropy"), ("Entropy", "entropy"),
                   ("DifferenceVariance", "difference_variance"),
                   ("DifferenceEntropy", "difference_entropy"),
                   ("IMC1", "imc1"), ("IMC2", "imc2")):
        m[f"Nucleus.Haralick.{hk}.Mean"] = [f"haralick_{ok}"]
        m[f"Nucleus.Haralick.{hk}.Range"] = [f"haralick_{ok}_range"]
    return m


HISTOMICSTK_COLUMN_MAP = _histomicstk_column_map()
