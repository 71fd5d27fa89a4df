"""Per-nucleus features, stain normalization and the two feature tools of
the port against the JAX package's, on seeded inputs.

- ``nucleus_features`` on 120 shapes (discs, ellipses, concave blobs, 1–4
  px specks, shapes cut by the crop's border, shapes with a hole): the same
  keys in the same order, ``None`` where JAX gives ``None``, integer
  columns exactly equal, float columns within 1e-6 relative (1e-12
  absolute where JAX's value is 0); the columns taken from the ellipse fit
  (major/minor axis, ratio, eccentricity, orientation modulo 180) at
  ``fit_ellipse``'s tolerance, 1e-4 relative, on contours that span three
  rows and three columns (on thinner ones OpenCV's fit is random).
- ``HISTOMICSTK_COLUMN_MAP`` equal.
- ``extract_slide_features`` (at 40× and at 20×, with ``--sql``) and both
  modes of ``nuclei_feat_extract`` (directory mode with a resize, a skip and
  a resume; single-JSON mode with ``--sql``): CSV and SQLite parsed equal to
  what ``tools/wsi_feat_extract.py`` and ``tools/nuclei_feat_extract.py``
  write — the same columns in the same order, pandas' index column, the
  same SQL types, the values as above.
- ``reinhard_normalize`` within 3 levels of JAX's (OpenCV's LAB → RGB is
  not reproduced bit for bit, ``ops.imgproc.lab_to_rgb_u8``).
"""

import csv
import importlib.util
import json
import math
import os
import sqlite3
import sys

import cv2
import numpy as np
import pytest

from nuhtc_tpu.ops import rle as jax_rle
from nuhtc_tpu.wsi import features as J
from nuhtc_tpu.wsi import stain as jax_stain
from nuhtc_tpu_torch.tools import nuclei_feat_extract as nfe
from nuhtc_tpu_torch.tools import wsi_feat_extract as wfe
from nuhtc_tpu_torch.tools.synthetic import synthetic_slide, synthetic_tiles
from nuhtc_tpu_torch.wsi import features as P
from nuhtc_tpu_torch.wsi import stain
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELLIPSE_COLUMNS = ("major_axis_length", "minor_axis_length", "minor_major_axis_ratio",
                   "eccentricity", "orientation")
INTEGER_COLUMNS = ("area", "convex_hull_area", "bbox_x", "bbox_y", "bbox_w", "bbox_h",
                   "grad_canny_sum")


def shape_zoo(seed=0, n=120):
    """(rgb crop, mask, kind) of seeded nucleus shapes."""
    rng = np.random.RandomState(seed)
    out = []
    kinds = ["disc", "ellipse", "concave", "speck", "border", "holed"]
    for i in range(n):
        kind = kinds[i % len(kinds)]
        h, w = rng.randint(14, 48, 2)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.uniform(h * 0.3, h * 0.7), rng.uniform(w * 0.3, w * 0.7)
        if kind == "disc":
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(2, min(h, w) / 2.5) ** 2
        elif kind in ("ellipse", "holed", "border"):
            a, b, t = rng.uniform(2.5, w / 2.2), rng.uniform(2.5, h / 2.2), rng.uniform(0, np.pi)
            if kind == "border":
                cy, cx = rng.choice([0.0, h - 1.0]), rng.uniform(0, w)
            u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
            v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
            m = (u / a) ** 2 + (v / b) ** 2 <= 1
            if kind == "holed":
                m &= (u / a) ** 2 + (v / b) ** 2 > 0.15
        elif kind == "concave":
            ang = np.arctan2(yy - cy, xx - cx)
            r = min(h, w) / 3 * (1 + 0.45 * np.sin(rng.randint(2, 5) * ang + rng.uniform(0, 6)))
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r ** 2
        else:  # 1-4 px specks
            m = np.zeros((h, w), bool)
            y0, x0 = rng.randint(1, h - 3), rng.randint(1, w - 3)
            k = rng.randint(1, 5)
            m[y0, x0:x0 + k] = True
            if rng.rand() < 0.5:
                m[y0:y0 + k, x0] = True
        rgb = np.clip(rng.normal(170, 30, (h, w, 3)) - 70 * m[..., None] * [1, 0.6, 0.2], 0, 255)
        out.append((rgb.astype(np.uint8), m.astype(np.uint8), kind))
    return out


def _thick(mask) -> bool:
    """The largest outer contour spans three rows and three columns."""
    found, _ = cv2.findContours((mask > 0).astype(np.uint8), cv2.RETR_EXTERNAL,
                                cv2.CHAIN_APPROX_NONE)
    p = max(found, key=cv2.contourArea).reshape(-1, 2)
    return min(len(np.unique(p[:, 0])), len(np.unique(p[:, 1]))) >= 3


def assert_rows_equal(got: dict, want: dict, ellipse_checked: bool = True):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str) or isinstance(g, str) or w is None or g is None:
            assert g == w, k
        elif k in ELLIPSE_COLUMNS:
            if not ellipse_checked:
                continue
            if k == "orientation":
                turn = abs(g - w) % 180
                assert min(turn, 180 - turn) <= 1e-3, (k, g, w)
            else:
                assert math.isclose(g, w, rel_tol=1e-4, abs_tol=1e-9), (k, g, w)
        elif k in INTEGER_COLUMNS:
            assert g == w, (k, g, w)
        else:
            assert math.isclose(g, w, rel_tol=1e-6, abs_tol=1e-12), (k, g, w)


def test_nucleus_features_equal_jax():
    zoo = shape_zoo()
    kinds = {}
    for rgb, mask, kind in zoo:
        want = J.nucleus_features(rgb, mask, offset=(3, 4))
        got = P.nucleus_features(rgb, mask, offset=(3, 4))
        if want is None:
            assert got is None
            continue
        assert_rows_equal(got, want, ellipse_checked=_thick(mask))
        kinds[kind] = kinds.get(kind, 0) + 1
    assert set(kinds) == {"disc", "ellipse", "concave", "speck", "border", "holed"}
    assert sum(kinds.values()) >= 100


def test_histomicstk_column_map_equals_jax():
    assert P.HISTOMICSTK_COLUMN_MAP == J.HISTOMICSTK_COLUMN_MAP
    assert list(P.HISTOMICSTK_COLUMN_MAP) == list(J.HISTOMICSTK_COLUMN_MAP)


def test_reinhard_within_three_levels_of_jax():
    tiles = synthetic_tiles(np.random.RandomState(0), 4, 128)
    tiles.append(np.full((16, 16, 3), 200, np.uint8))  # flat: std 0
    for t in tiles:
        d = np.abs(stain.reinhard_normalize(t).astype(int) - jax_stain.reinhard_normalize(t))
        assert d.max() <= 3


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse(text):
    if text == "":
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def read_csv(path):
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        return header, [dict(zip(header, map(_parse, cells))) for cells in reader]


def assert_csv_equal(got_path, want_path):
    gh, got = read_csv(got_path)
    wh, want = read_csv(want_path)
    assert gh == wh
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_rows_equal(g, w)


def assert_sqlite_equal(got_path, want_path, table="nuclei_features"):
    def load(path):
        conn = sqlite3.connect(path)
        cols = [(r[1], r[2]) for r in conn.execute(f'PRAGMA table_info("{table}")')]
        rows = conn.execute(f'SELECT * FROM "{table}"').fetchall()
        conn.close()
        return cols, rows

    gc, gr = load(got_path)
    wc, wr = load(want_path)
    assert gc == wc
    assert len(gr) == len(wr) > 0
    names = [c for c, _ in wc]
    for g, w in zip(gr, wr):
        assert_rows_equal(dict(zip(names, g)), dict(zip(names, w)))


def _slide_and_geojson(tmp_path, n=40):
    """A 384² synthetic slide as a PNG and a GeoJSON of blob nuclei on it."""
    rng = np.random.RandomState(1)
    img = synthetic_slide(np.random.RandomState(0), 384)
    path = tmp_path / "slide.png"
    assert cv2.imwrite(str(path), img[..., ::-1])
    feats = []
    for i in range(n):
        m = np.zeros((384, 384), np.uint8)
        cv2.ellipse(m, (int(rng.randint(0, 384)), int(rng.randint(0, 384))),
                    (int(rng.randint(3, 14)), int(rng.randint(3, 14))), float(rng.uniform(0, 180)),
                    0, 360, 1, -1)
        found, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        ring = max(found, key=len).reshape(-1, 2).tolist()
        feats.append({"type": "Feature",
                      "geometry": {"type": "Polygon", "coordinates": [ring + ring[:1]]},
                      "properties": {"label": i % 5, "score": float(rng.uniform(0.3, 1)),
                                     "classification": {"name": "ABCDE"[i % 5]}}})
    gj = tmp_path / "slide.geojson"
    gj.write_text(json.dumps({"type": "FeatureCollection", "features": feats}))
    return str(path), str(gj)


@pytest.mark.parametrize("mag", [40, 20])
def test_extract_slide_features_equals_jax_tool(tmp_path, mag):
    slide, gj = _slide_and_geojson(tmp_path)
    n = wfe.extract_slide_features(slide, gj, str(tmp_path / "port.csv"), mag=mag, sql=True)
    m = _load("wsi_feat_extract").extract_slide_features(slide, gj, str(tmp_path / "jax.csv"),
                                                         mag=mag, sql=True)
    assert n == m > 30
    assert_csv_equal(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert_sqlite_equal(tmp_path / "port.db", tmp_path / "jax.db")
    header, _ = read_csv(tmp_path / "port.csv")
    assert header == list(P.nucleus_features(*shape_zoo(0, 1)[0][:2])) + [
        "label", "class", "score", "nucleus_id"]


def _disk(h, w, cy, cx, r):
    yy, xx = np.mgrid[:h, :w]
    return ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)


def _coco_dir(root, specs):
    """A slide directory with coco_nuclei.json over PNG patches: per image a
    list of (cy, cx, r) discs; later annotations occlude earlier ones."""
    slide = root / "slideA"
    (slide / "patches").mkdir(parents=True)
    rng = np.random.RandomState(0)
    images, annotations, aid = [], [], 1
    for iid, inst in enumerate(specs):
        img = (rng.rand(64, 64, 3) * 200 + 30).astype(np.uint8)
        assert cv2.imwrite(str(slide / "patches" / f"{iid}.png"), img)
        images.append(dict(id=iid, file_name=f"patches/{iid}.png", height=64, width=64,
                           n_objects=len(inst)))
        for cy, cx, r in inst:
            rle = jax_rle.encode(_disk(64, 64, cy, cx, r))
            annotations.append(dict(id=aid, image_id=iid, category_id=1 + aid % 2,
                                    bbox=jax_rle.toBbox(rle).tolist(),
                                    area=int(jax_rle.area(rle)), iscrowd=0,
                                    score=round(0.5 + 0.01 * aid, 2),
                                    segmentation=dict(size=rle["size"],
                                                      counts=rle["counts"].decode())))
            aid += 1
    coco = dict(images=images, annotations=annotations,
                categories=[dict(id=1, name="Neoplastic"), dict(id=2, name="Inflammatory")])
    (slide / "coco_nuclei.json").write_text(json.dumps(coco))
    return slide / "coco_nuclei.json"


SPECS = [[(20, 20, 6), (20, 20, 8), (44, 44, 6), (10, 50, 5)], [(30, 30, 6)],
         [(15, 40, 7), (40, 15, 9)]]


def _run_jax_tool(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["nuclei_feat_extract.py"] + argv)
    _load("nuclei_feat_extract").main()


def test_nuclei_feat_dir_mode_equals_jax_tool(tmp_path, monkeypatch):
    roots = {k: tmp_path / k for k in ("port", "jax")}
    for root in roots.values():
        _coco_dir(root, SPECS)
    out = {k: r / "nuclei_feat" / "slideA" / "nuclei_feat.csv" for k, r in roots.items()}
    # images of ≥ 2 nuclei, resized 64 → 128
    args = ["--min_num", "2", "--patch_size", "128"]
    assert nfe.main([str(roots["port"])] + args) == 0
    _run_jax_tool(monkeypatch, [str(roots["jax"])] + args)
    assert_csv_equal(out["port"], out["jax"])
    # all wanted images done: the file is left alone
    before = out["port"].read_bytes()
    stamp = os.path.getmtime(out["port"])
    nfe.main([str(roots["port"])] + args)
    assert os.path.getmtime(out["port"]) == stamp and out["port"].read_bytes() == before
    # resume: now images of one nucleus are wanted too
    args = ["--min_num", "1", "--patch_size", "128"]
    nfe.main([str(roots["port"])] + args)
    _run_jax_tool(monkeypatch, [str(roots["jax"])] + args)
    assert_csv_equal(out["port"], out["jax"])
    header, rows = read_csv(out["port"])
    assert header[0] == "" and {r["img_id"] for r in rows} == {0, 1, 2}


def test_nuclei_feat_json_mode_equals_jax_tool(tmp_path, monkeypatch):
    """The JAX tool's single-JSON mode hands OpenCV a column-major crop of
    the decoded RLE (``np.zeros_like`` keeps the order) and
    ``cv2.fillConvexPoly`` rejects it, so it is run here with the decoded
    masks made row-major; the port has no such fault."""
    decode = jax_rle.decode
    monkeypatch.setattr(jax_rle, "decode", lambda r: np.ascontiguousarray(decode(r)))
    coco = _coco_dir(tmp_path, SPECS)
    root = str(coco.parent)
    nfe.main([str(coco), "--img-root", root, "--out", str(tmp_path / "port.csv"), "--sql"])
    _run_jax_tool(monkeypatch, [str(coco), "--img-root", root, "--out",
                                str(tmp_path / "jax.csv"), "--sql"])
    assert_csv_equal(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert_sqlite_equal(tmp_path / "port.db", tmp_path / "jax.db")
