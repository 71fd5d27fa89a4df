"""The cross-tile nucleus merge of the port against the JAX package's, on
seeded polygons, exactly: ``raster_iou`` gives the same float on ≥ 200 pairs
(near the 0.05 threshold, supersampled nuclei, and joint boxes over the 4M
px budget), ``merge_features`` keeps the same features for both strategies
on a GeoJSON with cross-tile duplicates, ``merge_geojson_file`` writes the
same JSON, and the command line ``nuhtc_tpu_torch.tools.nuclei_merge``
writes what ``tools/nuclei_merge.py`` writes."""

import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest

from nuhtc_tpu.wsi import merge as J
from nuhtc_tpu_torch.tools import nuclei_merge as cli
from nuhtc_tpu_torch.wsi import merge as P
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blob_ring(rng, cx, cy, r):
    """A closed pixel contour of a random blob around (cx, cy)."""
    size = int(2 * r + 8)
    yy, xx = np.mgrid[:size, :size]
    ang = np.arctan2(yy - size / 2, xx - size / 2)
    rad = r * (1 + 0.25 * np.sin(3 * ang + rng.uniform(0, 6)) * rng.uniform(0, 1))
    m = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2 <= rad ** 2).astype(np.uint8)
    found, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    ring = max(found, key=len).reshape(-1, 2).astype(np.float64) + [cx - size / 2, cy - size / 2]
    return np.concatenate([ring, ring[:1]])


def _pairs(rng):
    pairs = []
    for _ in range(120):  # overlapping nuclei, shifted by up to their size
        r = rng.uniform(3, 15)
        a = _blob_ring(rng, 100, 100, r)
        b = _blob_ring(rng, 100 + rng.uniform(-2 * r, 2 * r), 100 + rng.uniform(-2 * r, 2 * r), r)
        pairs.append((a, b))
    for _ in range(60):  # near the threshold: a ring and its shifted copy
        r = rng.uniform(4, 12)
        a = _blob_ring(rng, 50, 50, r)
        pairs.append((a, a + [rng.uniform(1.6, 1.95) * r, rng.uniform(-1, 1)]))
    for _ in range(20):  # merged mega-regions: joint boxes of 1M to 9M px
        s = rng.uniform(1100, 2900)
        a = np.array([[0, 0], [s, 0], [s, s * 0.9], [0, s * 0.8]]) + rng.uniform(0, 50, 2)
        pairs.append((a, a + rng.uniform(-s / 3, s / 3, 2)))
    return pairs


def test_raster_iou_equals_jax():
    rng = np.random.RandomState(0)
    pairs = _pairs(rng)
    assert len(pairs) >= 200
    ious = []
    for a, b in pairs:
        got, want = P.raster_iou(a, b), J.raster_iou(a, b)
        assert got == want, (a.tolist(), b.tolist())
        ious.append(got)
    ious = np.asarray(ious)
    assert ((ious > 0.02) & (ious < 0.1)).sum() >= 10  # near the default threshold
    assert (ious == 0).any() and (ious > 0.5).any()


def _collection(seed, tiles=3):
    """Nuclei of a 3 × 3 grid of 256² tiles at step 192: a nucleus in an
    overlap is reported by each tile that holds it, its ring moved by a
    pixel or so and its score changed, as two tiles' detections differ."""
    rng = np.random.RandomState(seed)
    feats = []
    for _ in range(70):
        x, y = rng.uniform(10, 192 * (tiles - 1) + 246, 2)
        r = rng.uniform(4, 10)
        ring = _blob_ring(rng, x, y, r)
        copies = 1 + sum(1 for t in range(1, tiles) if abs(x - 192 * t - 32) < 32) \
            + sum(1 for t in range(1, tiles) if abs(y - 192 * t - 32) < 32)
        for _ in range(copies):
            moved = ring + rng.randint(-1, 2, 2)
            feats.append({"type": "Feature",
                          "geometry": {"type": "Polygon", "coordinates": [moved.tolist()]},
                          "properties": {"score": float(rng.uniform(0.3, 1.0)), "label": 1,
                                         "classification": {"name": "A", "color": [1, 2, 3]}}})
    order = rng.permutation(len(feats))
    return [feats[i] for i in order]


@pytest.mark.parametrize("strategy", ["probability", "area"])
@pytest.mark.parametrize("threshold", [0.05, 0.3])
def test_merge_features_keeps_what_jax_keeps(strategy, threshold):
    feats = _collection(1)
    got = P.merge_features(feats, threshold, strategy)
    want = J.merge_features(feats, threshold, strategy)
    assert [id(f) for f in got] == [id(f) for f in want]
    assert len(got) < len(feats)  # the duplicates went


@pytest.mark.parametrize("uniform", [False, True])
def test_merge_geojson_file_equals_jax(tmp_path, uniform):
    src = tmp_path / "slide.geojson"
    src.write_text(json.dumps({"type": "FeatureCollection", "features": _collection(2)}))
    got = P.merge_geojson_file(str(src), out_path=str(tmp_path / "port.geojson"),
                               uniform_classification=uniform)
    want = J.merge_geojson_file(str(src), out_path=str(tmp_path / "jax.geojson"),
                                uniform_classification=uniform)
    assert json.load(open(got)) == json.load(open(want))
    # the default output name, and a bare list of features
    bare = tmp_path / "bare.geojson"
    bare.write_text(json.dumps(_collection(3)))
    assert P.merge_geojson_file(str(bare)) == str(tmp_path / "bare_merged.geojson")
    port = json.load(open(tmp_path / "bare_merged.geojson"))
    J.merge_geojson_file(str(bare))
    assert port == json.load(open(tmp_path / "bare_merged.geojson"))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_nuclei_merge", os.path.join(REPO, "tools", "nuclei_merge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--merge_strategy", "area", "--uniform_classification"]])
def test_cli_writes_what_tools_nuclei_merge_writes(tmp_path, monkeypatch, extra):
    src = tmp_path / "S.geojson"
    src.write_text(json.dumps({"type": "FeatureCollection", "features": _collection(4)}))
    assert cli.main(["--geojson", str(src), "--output_name", "port"] + extra) == 0
    monkeypatch.setattr(sys, "argv", ["nuclei_merge.py", "--geojson", str(src),
                                      "--output_name", "jax"] + extra)
    _jax_cli().main()
    got = json.load(open(tmp_path / "port.geojson"))
    assert got == json.load(open(tmp_path / "jax.geojson"))
    assert 0 < len(got["features"]) < len(_collection(4))
