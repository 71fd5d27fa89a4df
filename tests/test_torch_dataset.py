"""The port's dataset readers and dataset evaluation against the JAX
package's, on the CPU.

- ``tools.preprocess_pannuke``: both packages' command lines on one synthetic
  release (``tools.synthetic.synthetic_pannuke``, three 256² tiles from a
  seed; the JAX tool through its ``main`` with ``sys.argv`` patched) write
  the same tree: equal json, equal PNG pixels, equal types file.
- ``data.coco``: ``COCO``, ``get_ann_info``, ``load_image``,
  ``load_semantic``, ``build_dataset`` (with ``CASDataset``'s class index and
  sampling, and ``SemiDataset``) equal to ``nuhtc_tpu.data``'s on those
  trees; ``ann_to_rle`` equal for polygons (also leaving the frame),
  uncompressed and compressed RLE.
- Image reading as OpenCV reads: ``read_image`` = ``cv2.imread(IMREAD_COLOR)``
  → RGB for grey, grey + alpha, RGB, RGBA and palette PNGs; ``read_gray`` =
  ``IMREAD_GRAYSCALE`` (libpng's conversion, not ``cvtColor``'s).
- ``ops.contours.rectangle`` = ``cv2.rectangle``, and
  ``utils.visualize.draw_detections`` = the JAX package's at thickness 1
  (exact); at its default thickness 2 the coloured pixels overlap with an
  IoU ≥ 0.97.
- ``eval.evaluate``: ``convert_format`` in the three layouts,
  ``update_confusion_matrix`` and ``evaluate_dataset`` on shared predictions
  (ground truth moved, grown, shrunk, relabelled, dropped, duplicated, plus
  false positives; scores below ``fg_thr`` too): metrics within 1e-12, the
  saved ``.npy``/``.mat`` files equal, overlays at IoU ≥ 0.97, and
  ``format_only``.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import scipy.io

from nuhtc_tpu.data import coco as j_coco
from nuhtc_tpu.eval import evaluate as j_eval
from nuhtc_tpu.ops import rle as j_rle
from nuhtc_tpu.utils.visualize import draw_detections as j_draw
from nuhtc_tpu_torch.data import coco
from nuhtc_tpu_torch.eval import evaluate
from nuhtc_tpu_torch.ops import rle
from nuhtc_tpu_torch.ops.contours import rectangle
from nuhtc_tpu_torch.tools import preprocess_pannuke
from nuhtc_tpu_torch.tools.synthetic import synthetic_pannuke
from nuhtc_tpu_torch.utils.imageio import read_gray, read_image
from nuhtc_tpu_torch.utils.visualize import draw_detections
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_tool(monkeypatch, script, argv):
    """Runs tools/<script> of the JAX package through its ``main``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_{script[:-3]}", os.path.join(REPO, "tools", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    return mod.main()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One synthetic release converted by both packages' tools: {pkg: root}."""
    root = tmp_path_factory.mktemp("release")
    images, masks, types = synthetic_pannuke(np.random.RandomState(1), 3)
    paths = {}
    for name, arr in (("images", images), ("masks", masks), ("types", types)):
        paths[name] = str(root / f"{name}.npy")
        np.save(paths[name], arr)
    out = {}
    mp = pytest.MonkeyPatch()
    for pkg in ("jax", "port"):
        d = root / pkg
        argv = ["--images", paths["images"], "--masks", paths["masks"], "--types",
                paths["types"], "--fold", "2", "--out-dir", str(d / "datasets"),
                "--coco-dir", str(d / "coco")]
        if pkg == "jax":
            run_jax_tool(mp, "preprocess_pannuke.py", argv)
        else:
            assert preprocess_pannuke.main(argv) == 0
        out[pkg] = d
    mp.undo()
    return out


def dataset_cfg(root, **kw):
    return dict(type="PanNukeCocoDataset",
                ann_file=str(root / "coco" / "PanNuke_annt_RLE_fold2.json"),
                img_prefix=str(root / "datasets" / "rgb"),
                seg_prefix=str(root / "datasets" / "rgb_seg"), **kw)


def test_preprocess_pannuke_trees_equal(trees):
    files = {pkg: sorted(os.path.relpath(os.path.join(d, f), root)
                         for d, _, fs in os.walk(root) for f in fs)
             for pkg, root in trees.items()}
    assert files["port"] == files["jax"] and len(files["port"]) == 2 + 2 * 3
    name = "PanNuke_annt_RLE_fold2.json"
    got = json.load(open(trees["port"] / "coco" / name))
    want = json.load(open(trees["jax"] / "coco" / name))
    assert got == want
    assert len(got["annotations"]) > 60 and {a["category_id"] for a in got["annotations"]} == {
        1, 2, 3, 4, 5}
    for f in files["port"]:
        if f.endswith(".png"):
            np.testing.assert_array_equal(
                cv2.imread(str(trees["port"] / f), cv2.IMREAD_UNCHANGED),
                cv2.imread(str(trees["jax"] / f), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(np.load(trees["port"] / "coco" / "types_fold2.npy"),
                                  np.load(trees["jax"] / "coco" / "types_fold2.npy"))


@pytest.mark.parametrize("test_mode", [True, False])
def test_coco_dataset_equal_jax(trees, test_mode):
    got = coco.build_dataset(dataset_cfg(trees["port"], test_mode=test_mode))
    want = j_coco.build_dataset(dataset_cfg(trees["jax"], test_mode=test_mode))
    assert type(got).__name__ == type(want).__name__ == got.dataset_name
    assert len(got) == len(want) == 3 and got.img_ids == want.img_ids
    assert got.CLASSES == want.CLASSES and got.PALETTE == want.PALETTE
    assert got.coco.get_cat_ids() == want.coco.get_cat_ids()
    for i in range(len(got)):
        assert got.img_info(i) == want.img_info(i)
        a, b = got.get_ann_info(i), want.get_ann_info(i)
        assert list(a) == list(b) and a["masks"] == b["masks"]
        for k in ("bboxes", "labels", "ismask"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        img = got.load_image(i)
        assert img.dtype == np.uint8 and img.shape == (256, 256, 3)
        np.testing.assert_array_equal(img, want.load_image(i))
        np.testing.assert_array_equal(got.load_semantic(i), want.load_semantic(i))
    assert got.build_class_index() == want.build_class_index()


def test_build_dataset_wrappers_equal_jax(trees):
    inner = dataset_cfg(trees["port"])
    got = coco.build_dataset(dict(type="CASDataset", dataset=inner))
    want = j_coco.build_dataset(dict(type="CASDataset", dataset=dataset_cfg(trees["jax"])))
    assert got.class_index == want.class_index and got.classes == want.classes
    assert got.CLASSES == want.CLASSES and got.PALETTE == want.PALETTE and len(got) == 3
    r1, r2 = np.random.RandomState(4), np.random.RandomState(4)
    assert [got.sample_index(r1) for _ in range(20)] == [want.sample_index(r2) for _ in range(20)]
    assert got.img_info(0) == want.img_info(0)  # delegated
    semi = coco.build_dataset(dict(type="SemiDataset", sup=inner, unsup=inner))
    j_semi = j_coco.build_dataset(dict(type="SemiDataset", sup=dataset_cfg(trees["jax"]),
                                       unsup=dataset_cfg(trees["jax"])))
    assert len(semi) == len(j_semi) == 6 and semi.CLASSES == j_semi.CLASSES
    # default_args fill gaps and never override
    ds = coco.build_dataset(dict(inner, test_mode=True), dict(test_mode=False, img_prefix="x"))
    assert ds.test_mode and ds.img_prefix == inner["img_prefix"]
    with pytest.raises(KeyError):
        coco.build_dataset(dict(inner, type="NoSuchDataset"))


POLYGONS = {
    "inside": [[10.2, 10.7, 30.5, 12.0, 25.0, 31.4, 8.0, 22.6]],
    "two_rings": [[5, 5, 15, 5, 15, 15, 5, 15], [30, 30, 44, 33, 36, 47]],
    "leaves_left_top": [[-12.4, -3.0, 20.0, -8.6, 14.3, 18.0, -5.0, 25.5]],
    "leaves_right_bottom": [[40.0, 30.0, 70.5, 42.0, 52.0, 66.7, 35.5, 58.0]],
    "wholly_outside": [[-30, -30, -10, -30, -20, -5]],
    "self_crossing": [[5, 5, 40, 40, 40, 5, 5, 40]],
}


@pytest.mark.parametrize("kind", sorted(POLYGONS))
def test_ann_to_rle_polygons_equal_jax(kind):
    ann = dict(segmentation=POLYGONS[kind])
    got, want = coco.ann_to_rle(ann, 48, 52), j_coco.ann_to_rle(ann, 48, 52)
    assert got == want
    np.testing.assert_array_equal(rle.decode(got), j_rle.decode(want))
    if kind != "wholly_outside":
        assert rle.area(got) > 10


@pytest.mark.parametrize("form", ["compressed_str", "compressed_bytes", "uncompressed"])
def test_ann_to_rle_rle_forms_equal_jax(form):
    mask = (np.random.RandomState(0).rand(20, 24) > 0.6).astype(np.uint8)
    r = rle.encode(mask)
    if form == "compressed_str":
        seg = dict(size=r["size"], counts=r["counts"].decode())
    elif form == "compressed_bytes":
        seg = dict(r)
    else:
        seg = dict(size=r["size"], counts=[int(v) for v in rle._counts_of(r)])
    got, want = coco.ann_to_rle(dict(segmentation=seg), 20, 24), j_coco.ann_to_rle(
        dict(segmentation=seg), 20, 24)
    np.testing.assert_array_equal(rle.decode(got), mask)
    np.testing.assert_array_equal(rle.decode(got), j_rle.decode(want))
    with pytest.raises(ValueError):
        coco.ann_to_rle(dict(segmentation=3), 20, 24)


def _write_png(path, kind, rng):
    """A PNG of one colour type: written by cv2 (grey, BGR, BGRA) or Pillow
    (grey + alpha, palette)."""
    from PIL import Image

    rgb = rng.randint(0, 256, (21, 26, 3)).astype(np.uint8)
    rgb[:4] = rgb[:4, :, :1]  # some grey pixels in colour images
    if kind == "grey":
        assert cv2.imwrite(path, rgb[..., 0])
    elif kind == "rgb":
        assert cv2.imwrite(path, rgb[..., ::-1])
    elif kind == "rgba":
        alpha = rng.randint(0, 256, (21, 26, 1)).astype(np.uint8)
        assert cv2.imwrite(path, np.concatenate([rgb[..., ::-1], alpha], 2))
    elif kind == "grey_alpha":
        Image.fromarray(np.stack([rgb[..., 0], rgb[..., 1]], 2), "LA").save(path)
    elif kind == "palette":
        Image.fromarray(rgb).convert("P").save(path)


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "grey_alpha", "palette"])
def test_image_reading_like_cv2(tmp_path, kind):
    path = str(tmp_path / f"{kind}.png")
    _write_png(path, kind, np.random.RandomState(len(kind)))
    want_colour = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(read_image(path), want_colour)
    got = read_gray(path)
    assert got.dtype == np.uint8 and got.ndim == 2
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("pt1,pt2", [((3, 4), (20, 15)), ((20, 15), (3, 4)), ((-5, 6), (12, 40)),
                                     ((10, -3), (45, 9)), ((7, 7), (7, 7)), ((-9, -9), (-2, -1)),
                                     ((0, 0), (29, 34))])
@pytest.mark.parametrize("thickness", [1, -1])
def test_rectangle_like_cv2(pt1, pt2, thickness):
    got = np.zeros((35, 30, 3), np.uint8)
    want = got.copy()
    rectangle(got, pt1, pt2, (10, 200, 30), thickness)
    cv2.rectangle(want, pt1, pt2, (10, 200, 30), thickness)
    np.testing.assert_array_equal(got, want)


def _instances(rng, size=64, count=9):
    yy, xx = np.mgrid[:size, :size]
    masks = []
    for _ in range(count):
        cy, cx = rng.uniform(-4, size + 4, 2)
        a, b = rng.uniform(3, 12, 2)
        m = (((yy - cy) / a) ** 2 + ((xx - cx) / b) ** 2 <= 1).astype(np.uint8)
        m[rng.rand(size, size) < 0.03] = 0  # holes
        masks.append(m)
    masks.append(np.zeros((size, size), np.uint8))
    return masks


def _changed(img, ov):
    return (ov != img).any(-1)


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_detections_like_jax(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    masks = _instances(rng)
    labels = rng.randint(0, 8, len(masks))
    boxes = rng.uniform(-10, 70, (len(masks), 4))
    for kw in (dict(thickness=1), dict(thickness=1, boxes=boxes, draw_boxes=True,
                                        palette=[(1, 2, 3), (200, 100, 50)])):
        np.testing.assert_array_equal(draw_detections(img, masks, labels, **kw),
                                      j_draw(img, masks, labels, **kw))
    got, want = draw_detections(img, masks, labels), j_draw(img, masks, labels)
    assert _changed(img, want).sum() > 200
    assert _iou(_changed(img, got), _changed(img, want)) >= 0.97


def shared_results(dataset, seed, num_classes=5):
    """Predictions made from each image's ground truth: masks moved by a
    pixel, grown, shrunk, relabelled, dropped or doubled (the double at a lower
    score, for mask NMS), false positives, and scores on both sides of fg_thr."""
    rng = np.random.RandomState(seed)
    results = []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        h, w = ann["height"], ann["width"]
        preds = []
        for m_rle, lab in zip(ann["masks"], ann["labels"]):
            m = rle.decode(m_rle).astype(bool)
            u = rng.rand()
            if u < 0.1:
                continue
            if u < 0.3:
                m = np.roll(m, rng.randint(-2, 3, 2), axis=(0, 1))
            elif u < 0.4:
                m = m | np.roll(m, 1, 0) | np.roll(m, 1, 1)
            elif u < 0.5:
                m = m & np.roll(m, 1, 0) & np.roll(m, -1, 1)
            if rng.rand() < 0.15:
                lab = rng.randint(num_classes)
            score = rng.uniform(0.02, 1.0)
            preds.append((m, lab, score))
            if rng.rand() < 0.1:
                preds.append((m, lab, score * 0.5))
        yy, xx = np.mgrid[:h, :w]
        for _ in range(rng.randint(0, 6)):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 9)
            preds.append(((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r, rng.randint(num_classes),
                          rng.uniform(0.0, 1.0)))
        bboxes, segms = [], []
        for c in range(num_classes):
            sel = [p for p in preds if p[1] == c and p[0].any()]
            rows = []
            for m, _, s in sel:
                x, y, bw, bh = rle.toBbox(rle.encode(m.astype(np.uint8)))
                rows.append([x, y, x + bw, y + bh, s])
            bboxes.append(np.asarray(rows, np.float32).reshape(-1, 5))
            segms.append([rle.encode(m.astype(np.uint8)) for m, _, _ in sel])
        results.append((bboxes, segms))
    return results


def _assert_metrics_close(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                   rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("fmt", ["pannuke", "conic", "consep"])
@pytest.mark.parametrize("empty", [False, True])
def test_convert_format_equal_jax(fmt, empty):
    rng = np.random.RandomState(3)
    masks = [] if empty else [m for m in _instances(rng, 40, 7) if m.any()]
    rles = [rle.encode(m) for m in masks]
    labels = rng.randint(0, 5, len(rles))
    got = evaluate.convert_format(rles, labels, 40, 40, 5, fmt)
    want = j_eval.convert_format(rles, labels, 40, 40, 5, fmt)
    if fmt == "consep":
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        if not empty:  # the JAX package's inst_uid: one entry fewer than instances
            assert len(got["inst_uid"]) == len(rles) - 1
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_update_confusion_matrix_equal_jax(seed):
    rng = np.random.RandomState(seed)
    iou = rng.rand(12, 15) * (rng.rand(12, 15) < 0.3)
    gt, pred = rng.randint(0, 5, 12), rng.randint(0, 5, 15)
    got, want = np.zeros((6, 6)), np.zeros((6, 6))
    evaluate.update_confusion_matrix(got, iou, gt, pred)
    j_eval.update_confusion_matrix(want, iou, gt, pred, tp_iou_thr=0.5)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


@pytest.mark.parametrize("fmt,overlay,format_only", [
    ("pannuke", True, False), ("conic", False, False), ("consep", True, False),
    ("pannuke", True, True), ("consep", False, True)])
def test_evaluate_dataset_equal_jax(trees, tmp_path, fmt, overlay, format_only):
    got_ds = coco.build_dataset(dataset_cfg(trees["port"], test_mode=True))
    want_ds = j_coco.build_dataset(dataset_cfg(trees["jax"], test_mode=True))
    results = shared_results(got_ds, seed=7)
    kw = dict(save=True, data_format=fmt, overlay=overlay, overlay_score_thr=0.3,
              format_only=format_only)
    got = evaluate.evaluate_dataset(got_ds, results, save_path=str(tmp_path / "port"), **kw)
    want = j_eval.evaluate_dataset(want_ds, results, save_path=str(tmp_path / "jax"), **kw)
    _assert_metrics_close(got, want)
    if format_only:
        assert not got
    else:
        assert 0.3 < got["pq"] < 1 and 0 < got["multi_pq"] < 1
        assert np.asarray(got["confusion_matrix"]).shape == (6, 6)
    out = {pkg: tmp_path / pkg / "PanNukeCocoDataset" for pkg in ("port", "jax")}
    files = {pkg: sorted(os.path.relpath(os.path.join(d, f), root)
                         for d, _, fs in os.walk(root) for f in fs) for pkg, root in out.items()}
    assert files["port"] == files["jax"]
    assert len(files["port"]) == 3 * (1 + overlay) + (fmt != "consep")
    for f in files["port"]:
        a, b = out["port"] / f, out["jax"] / f
        if f.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        elif f.endswith(".mat"):
            x, y = scipy.io.loadmat(a), scipy.io.loadmat(b)
            keys = sorted(k for k in y if not k.startswith("__"))
            assert sorted(k for k in x if not k.startswith("__")) == keys
            for k in keys:
                np.testing.assert_array_equal(x[k], y[k])
        else:  # overlays, thickness 2
            idx = got_ds.img_ids.index(int(f.split("_")[1]))
            img = got_ds.load_image(idx)
            x, y = read_image(str(a)), cv2.imread(str(b))[..., ::-1]
            assert x.shape == y.shape
            assert _iou(_changed(img, x), _changed(img, y)) >= 0.97
