"""The whole-slide path of the PyTorch port against the JAX package's.

Host code on shared pixels, **exactly equal** unless said otherwise:
- stage A: ``segment_tissue`` and ``grid_coords`` on an ``ArraySlide``
  against ``nuhtc_tpu.wsi.tissue`` on the same pixels through its
  ``ImageReader`` (contours, holes, coords); ``stitch_coords``;
  ``vis_tissue_mask`` with its coloured pixels held to an IoU ≥ 0.98 (thick
  lines are not OpenCV's bit for bit), exactly at thickness 1;
- ``utils.imageio``: PNGs written here read back bit-equal by ``cv2.imread``,
  PNGs written by OpenCV (sub filter) and by Pillow (adaptive filters) read
  bit-equal here;
- stage B with a stub engine that replays recorded per-image results: both
  ``infer_slide`` write byte-equal JSON, equal SQLite rows and rtree,
  pixel-equal patch PNGs, equal overlays and counts; ``tile_stream``.
The slice as a whole on the CPU in f32: a tiny detector on shared weights
(``state_dict_from_jax``; JAX in full f32 with ``exact_rois=True``), the same
256² synthetic slide and coords through both ``infer_slide``: features one to
one, labels equal, scores within 1e-4, box centres within 1e-3 px, polygons
equal or, where a mask differs by tie pixels, the filled rings differ in at
most 3 pixels.
The command line: ``nuhtc_tpu_torch.tools.infer_wsi.main`` on a directory
with one PNG writes the stage A files ``tools/infer_wsi.py`` writes, and a
parsable stage B.
"""

import json
import os
import runpy
import sqlite3
import sys
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from nuhtc_tpu.wsi import infer as j_infer
from nuhtc_tpu.wsi import stitch as j_stitch
from nuhtc_tpu.wsi import tissue as j_tissue
from nuhtc_tpu.wsi.slide import ImageReader as JaxImageReader
from nuhtc_tpu_torch.tools import infer_wsi as cli
from nuhtc_tpu_torch.tools.synthetic import synthetic_slide
from nuhtc_tpu_torch.utils import imageio
from nuhtc_tpu_torch.wsi import infer, stitch, tissue
from nuhtc_tpu_torch.wsi.export import NucleiExporter, random_colors
from nuhtc_tpu_torch.wsi.slide import ArraySlide, ImageReader, open_slide
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("A", "B", "C", "D", "E")


@pytest.fixture(scope="module")
def slide_pixels():
    """A 1152² synthetic slide and its pyramid down to 36²."""
    img = synthetic_slide(np.random.RandomState(0), 1152)
    return ArraySlide(img, (1, 2, 4, 8, 16, 32))


def _jax_reader(tmp_path, pixels, name="level.png"):
    path = str(tmp_path / name)
    assert cv2.imwrite(path, pixels[..., ::-1])
    return JaxImageReader(path)


def _assert_same_seg(got, want):
    assert len(got.contours) == len(want.contours)
    assert got.seg_level == want.seg_level and got.downsample == want.downsample
    for g, w in zip(got.contours, want.contours):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    for gh, wh in zip(got.holes, want.holes):
        assert len(gh) == len(wh)
        for g, w in zip(gh, wh):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("level,seg_kw", [
    (5, dict(ref_patch_size=1, a_t=1, a_h=1)),
    (5, dict(ref_patch_size=2, a_t=4, a_h=1)),
    (4, dict(ref_patch_size=1, a_t=1, a_h=1, use_otsu=True)),
    (3, dict(ref_patch_size=1, a_t=1, a_h=1)),
    (3, dict(ref_patch_size=1, a_t=1, a_h=1, use_otsu=True, mthresh=5, close=0)),
    (3, dict(ref_patch_size=1, a_t=1, a_h=0.01, max_n_holes=1, sthresh=20)),
    (3, dict()),  # the defaults drop everything on so small a slide
])
def test_stage_a_equals_jax(slide_pixels, tmp_path, level, seg_kw):
    pixels = slide_pixels._levels[level]
    want_slide, got_slide = _jax_reader(tmp_path, pixels), ArraySlide(pixels)
    want = j_tissue.segment_tissue(want_slide, **seg_kw)
    got = tissue.segment_tissue(got_slide, **seg_kw)
    _assert_same_seg(got, want)
    if seg_kw:  # the hole survives the median only on the finer levels
        assert len(got.contours) >= 1 and sum(len(h) for h in got.holes) >= (level == 3)
    else:
        assert got.contours == []
    n_coords = 0
    for use_padding in (True, False):
        for patch, step in ((24, 24), (16, 12)):
            wc = j_tissue.grid_coords(want_slide, want, patch, step, use_padding=use_padding)
            gc = tissue.grid_coords(got_slide, got, patch, step, use_padding=use_padding)
            assert gc.dtype == wc.dtype and gc.shape == wc.shape
            np.testing.assert_array_equal(gc, wc)
            n_coords += len(gc)
    if seg_kw:
        assert n_coords > 8
        np.testing.assert_array_equal(stitch.stitch_coords(got_slide, gc, 24, 4),
                                      j_stitch.stitch_coords(want_slide, wc, 24, 4))
        for thickness, floor in ((1, 1.0), (32, 0.98)):
            wv = j_stitch.vis_tissue_mask(want_slide, want, line_thickness=thickness)
            gv = stitch.vis_tissue_mask(got_slide, got, line_thickness=thickness)
            a, b = (wv != pixels).any(-1), (gv != pixels).any(-1)
            assert a.sum() > 50 and (a & b).sum() / (a | b).sum() >= floor
            assert set(map(tuple, gv[b].tolist())) <= {(0, 255, 0), (0, 0, 255)}


def test_stage_a_on_the_pyramid(slide_pixels):
    """The multi-level ``ArraySlide`` as the smoke run reads it: level 5 for
    segmentation, contours scaled to level 0, the grid on level 0."""
    s = slide_pixels
    assert s.level_dimensions[0] == (1152, 1152) and s.level_dimensions[5] == (36, 36)
    assert s.get_best_level_for_downsample(64) == 5 and s.level_downsamples[5] == 32.0
    seg = tissue.segment_tissue(s, ref_patch_size=32, a_t=20, a_h=2)
    assert seg.seg_level == 5 and seg.downsample == 32.0 and len(seg.contours) >= 1
    seg = tissue.segment_tissue(s, seg_level=3, ref_patch_size=32, a_t=20, a_h=2)
    assert seg.seg_level == 3 and len(seg.contours) >= 1 and sum(map(len, seg.holes)) >= 1
    assert max(c.max() for c in seg.contours) > 144  # level-0 coordinates
    coords = tissue.grid_coords(s, seg, 128, 96)
    assert len(coords) > 10 and coords.dtype == np.int64
    assert (np.unique(coords, axis=0) == coords).all()
    # level reads: the level-1 image is the 2 × 2 mean, a region is addressed in level-0 pixels
    a = s._levels[0][:2, :2].astype(int).sum((0, 1))
    np.testing.assert_array_equal(s._levels[1][0, 0], (a + 2) >> 2)
    np.testing.assert_array_equal(s.read_region((64, 32), 1, (8, 4)), s._levels[1][16:20, 32:40])
    edge = s.read_region((1100, -10), 0, (100, 30))
    assert edge.shape == (30, 100, 3) and (edge[:10] == 0).all() and (edge[:, 52:] == 0).all()
    np.testing.assert_array_equal(edge[10:, :52], s._levels[0][:20, 1100:])
    mosaic = stitch.stitch_coords(s, coords, 128, 32)
    assert mosaic.shape == (36, 36, 3) and mosaic.any()
    with pytest.raises(ValueError):
        ArraySlide(s._levels[0], (1, 4))


def test_coords_h5_round_trip(tmp_path):
    coords = np.array([[0, 0], [192, 0], [192, 384]], np.int64)
    path = str(tmp_path / "c.h5")
    tissue.save_coords_h5(path, coords, attrs=dict(patch_size=256, name="s"))
    got, attrs = tissue.load_coords_h5(path)
    want, want_attrs = j_tissue.load_coords_h5(path)
    np.testing.assert_array_equal(got, coords)
    np.testing.assert_array_equal(want, coords)
    assert attrs["patch_size"] == want_attrs["patch_size"] == 256 and attrs["name"] == "s"


@pytest.mark.parametrize("kind", ["rgb", "grey"])
def test_png_round_trips_through_cv2_and_pillow(tmp_path, kind):
    from PIL import Image

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    img[5:20] = np.linspace(0, 255, 53).astype(np.uint8)[None, :, None]  # smooth rows
    if kind == "grey":
        img = img[..., 0]
    ours = str(tmp_path / "ours.png")
    imageio.write_png(ours, img)
    back = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if kind == "grey" else back[..., ::-1], img)
    np.testing.assert_array_equal(imageio.read_png(ours), img)
    theirs = str(tmp_path / "cv2.png")
    cv2.imwrite(theirs, img if kind == "grey" else img[..., ::-1])
    np.testing.assert_array_equal(imageio.read_png(theirs), img)
    pil = str(tmp_path / "pil.png")
    Image.fromarray(img).save(pil, optimize=True)  # adaptive filters: average and Paeth too
    np.testing.assert_array_equal(imageio.read_png(pil), img)
    rgb = imageio.read_image(pil)
    assert rgb.shape == (37, 53, 3)
    np.testing.assert_array_equal(rgb, img if kind == "rgb" else np.repeat(img[..., None], 3, 2))
    if kind == "rgb":
        rgba = str(tmp_path / "rgba.png")
        cv2.imwrite(rgba, np.dstack([img[..., ::-1], np.full(img.shape[:2], 99, np.uint8)]))
        np.testing.assert_array_equal(imageio.read_image(rgba), img)  # alpha dropped
        jpg = str(tmp_path / "x.jpg")
        imageio.write_jpg(jpg, img)
        np.testing.assert_array_equal(imageio.read_image(jpg), cv2.imread(jpg)[..., ::-1])
        assert np.abs(imageio.read_image(jpg)[9:16].astype(int) - img[9:16]).max() <= 8
        reader = open_slide(ours)
        assert isinstance(reader, ImageReader) and reader.dimensions == (53, 37)
        np.testing.assert_array_equal(reader.read_region((3, 2), 0, (10, 8)), img[2:10, 3:13])
        with pytest.raises(FileNotFoundError):
            ImageReader(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        imageio.write_png(ours, img.astype(np.float32))
    with pytest.raises(ValueError):
        imageio.read_png(__file__)


def test_missing_optional_packages_raise_by_name(monkeypatch):
    """h5py and PIL are imported inside the one function that needs them; a
    missing one raises ImportError with its name and takes no other route."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="h5py"):
        tissue.save_coords_h5("unused.h5", np.zeros((0, 2), np.int64))
    with pytest.raises(ImportError, match="h5py"):
        tissue.load_coords_h5("unused.h5")
    with pytest.raises(ImportError, match="PIL"):
        imageio.write_jpg("unused.jpg", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ImportError, match="PIL"):
        imageio.read_image(__file__)


T = 64


def _disc(cx, cy, r):
    yy, xx = np.mgrid[:T, :T]
    return ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)


def test_native_rle_equals_its_plain_version(tmp_path, monkeypatch):
    """``csrc/rle.c`` through ``ops.rle`` against the numpy code, and
    ``csrc/contours.c`` through ``find_contours`` against the Python tracer:
    exactly equal, each call counted by the path it took. Without the
    library (``kernels.host()`` None) both run in Python. A C compiler that
    is installed and fails raises; where none is installed, Python."""
    import shutil

    from nuhtc_tpu_torch import kernels
    from nuhtc_tpu_torch.ops import contours, rle
    from nuhtc_tpu_torch.utils import profiling

    def traced(mask):
        with profiling.spans():
            found = contours.find_contours(mask)
            return found, dict(profiling.COUNTERS)

    rng = np.random.RandomState(0)
    masks = [_disc(rng.randint(0, 64), rng.randint(0, 64), rng.randint(1, 20)) for _ in range(30)]
    masks += [np.zeros((T, T), np.uint8), np.ones((T, T), np.uint8),
              (rng.rand(T, T) < 0.5).astype(np.uint8)]
    assert kernels.host() is not None
    got = [rle.encode(m) for m in masks]
    assert got == [rle.encode_plain(m) for m in masks]
    for r, m in zip(got, masks):
        np.testing.assert_array_equal(rle.decode(r), m)
        np.testing.assert_array_equal(rle.decode_plain(r), m)
        assert rle.area(r) == int(m.sum())
    crowd = [0, 1] * 6
    np.testing.assert_array_equal(rle.iou(got, got), rle.iou_plain(got, got))
    np.testing.assert_array_equal(rle.iou(got[:9], got[9:21], crowd),
                                  rle.iou_plain(got[:9], got[9:21], crowd))
    assert rle.iou([], got).shape == (0, len(got))
    as_text = dict(got[3], counts=got[3]["counts"].decode())
    np.testing.assert_array_equal(rle.decode(as_text), masks[3])
    for m in masks:
        (found, tree), counters = traced(m)
        want, want_tree = contours.find_contours_plain(m)
        assert counters == {"contours.native": 1}
        assert len(found) == len(want) and all(np.array_equal(a, b) for a, b in zip(found, want))
        np.testing.assert_array_equal(tree, want_tree)
    uncached = kernels.host.__wrapped__  # builds and loads anew at each call
    monkeypatch.setattr(kernels, "host", lambda: None)
    assert rle.encode(masks[0]) == got[0]
    np.testing.assert_array_equal(rle.iou(got[:5], got[:5]), rle.iou_plain(got[:5], got[:5]))
    (found, tree), counters = traced(masks[0])
    assert counters == {"contours.plain": 1}
    np.testing.assert_array_equal(found[0], contours.find_contours_plain(masks[0])[0][0])

    # no library yet in an empty build directory: a failing compiler raises
    monkeypatch.setattr(kernels, "host", uncached)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_COMPILERS", ("false",))
    with pytest.raises(RuntimeError, match="failed to build"):
        rle.encode(masks[0])
    with pytest.raises(RuntimeError, match="failed to build"):
        contours.find_contours(masks[0])
    monkeypatch.setattr(shutil, "which", lambda name: None)  # nothing to build with: Python
    assert kernels.host() is None and rle.encode(masks[0]) == got[0]
    (found, _), counters = traced(masks[0])
    assert counters == {"contours.plain": 1}
    np.testing.assert_array_equal(found[0], contours.find_contours_plain(masks[0])[0][0])


@pytest.mark.parametrize("shape", [(T, T), (37, 53), (8, 8), (1, 9)])
def test_mask_extents_and_crop_rle_equal_the_full_frame(shape):
    """The host library's passes over masks held whole, against numpy on
    the full frame and against their numpy versions: ``extents`` gives
    numpy's sum and the ``np.nonzero`` extents; ``encode_crop`` of a mask's
    box, of a larger crop and of the whole frame gives ``encode``'s bytes,
    empty masks and crops at every edge and corner included;
    ``intersections`` gives the pixels two masks share."""
    from nuhtc_tpu_torch import kernels
    from nuhtc_tpu_torch.ops import rle

    assert kernels.host() is not None
    h, w = shape
    rng = np.random.RandomState(h * w)
    masks = [(rng.rand(h, w) < p).astype(np.uint8) for p in (0.05, 0.5, 0.95)]
    masks += [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]
    for y0, y1, x0, x1 in [(0, 1, 0, 1), (0, h, 0, 1), (0, 1, 0, w), (h - 1, h, w - 1, w),
                           (0, h, w - 1, w), (h - 1, h, 0, w), (0, 1, w - 1, w),
                           (h - 1, h, 0, 1), (h // 3, h // 2 + 1, w // 4, w // 2 + 1)]:
        m = np.zeros((h, w), np.uint8)
        m[y0:y1, x0:x1] = rng.rand(y1 - y0, x1 - x0) < 0.6
        m[y0, x0] = m[y1 - 1, x1 - 1] = 1
        masks.append(m)
    masks = np.stack(masks)
    n = len(masks)

    area, box = rle.extents(masks)
    want_box = np.zeros((n, 4), np.int64)
    for k, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            want_box[k] = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    np.testing.assert_array_equal(area, masks.reshape(n, -1).sum(1))
    np.testing.assert_array_equal(box, want_box)
    for got in (rle.extents_plain(masks), rle.extents(masks.astype(bool)),
                rle.extents(masks * 7)):
        np.testing.assert_array_equal(got[0], area)
        np.testing.assert_array_equal(got[1], box)

    for m, (y0, y1, x0, x1) in zip(masks, box.tolist()):
        want = rle.encode(m)
        assert want == rle.encode_plain(m)
        py0, px0 = max(y0 - 1, 0), max(x0 - 1, 0)
        for cy, cx, crop in ((y0, x0, m[y0:y1, x0:x1]), (py0, px0, m[py0:y1 + 1, px0:x1 + 1]),
                             (0, 0, m)):
            assert rle.encode_crop(crop, cy, cx, (h, w)) == want
            assert rle.encode_crop_plain(crop, cy, cx, (h, w)) == want
        assert rle.encode_crop(m[y0:y1, x0:x1].astype(bool), y0, x0, (h, w)) == want
    with pytest.raises(ValueError, match="not inside"):
        rle.encode_crop(masks[0], 1, 0, (h, w))

    first, second = np.triu_indices(n, 1)
    want = np.asarray([np.count_nonzero(masks[i] & masks[j]) for i, j in zip(first, second)])
    np.testing.assert_array_equal(rle.intersections(masks, box, first, second), want)
    np.testing.assert_array_equal(rle.intersections_plain(masks, box, first, second), want)
    with pytest.raises(ValueError, match="inside the frame"):
        rle.intersections(masks, box, first, second + 1)


def _ellipses(rng, n, lo=2.0, hi=9.0):
    """n filled T² ellipses of random centre (some past the tile's edge),
    axes and angle."""
    yy, xx = np.mgrid[:T, :T]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(-3, T + 3, 2)
        a, b = rng.uniform(lo, hi, 2)
        t = rng.uniform(0, np.pi)
        u = (yy - cy) * np.cos(t) + (xx - cx) * np.sin(t)
        v = (xx - cx) * np.cos(t) - (yy - cy) * np.sin(t)
        out.append((u / a) ** 2 + (v / b) ** 2 <= 1)
    return np.stack(out).astype(np.uint8)


def _from_label_map(masks):
    """The masks a label map gives: disjoint, the lowest index winning where
    they overlap (so some are cut in two, some emptied)."""
    taken = np.zeros((T, T), bool)
    out = np.zeros_like(masks)
    for k, m in enumerate(masks):
        out[k] = m.astype(bool) & ~taken
        taken |= m.astype(bool)
    return out


def _edge_masks():
    """Masks along each edge of the tile and in each corner, one-pixel
    masks (two in corners), a ring, two components, an empty mask and the
    whole tile."""
    masks = []
    for sl in (np.s_[0:3, 10:30], np.s_[20:40, 0:4], np.s_[T - 2:T, 30:50], np.s_[35:55, T - 5:],
               np.s_[0:5, 0:6], np.s_[0:4, T - 4:], np.s_[T - 6:, 0:3], np.s_[T - 3:, T - 7:],
               np.s_[30:31, 30:31], np.s_[0:1, 0:1], np.s_[T - 1:, T - 1:]):
        m = np.zeros((T, T), np.uint8)
        m[sl] = 1
        masks.append(m)
    ring = _disc(32, 20, 9)
    ring[_disc(32, 20, 4) > 0] = 0
    masks += [ring, _disc(12, 45, 4) | _disc(24, 52, 3), np.zeros((T, T), np.uint8),
              np.ones((T, T), np.uint8)]
    return np.stack(masks)


def _post_case(case):
    """(an engine's result for one tile, the post-processing settings)."""
    rng = np.random.RandomState(["label_map", "overlap", "edges", "margin"].index(case))
    kw = dict(margin=0, min_area=10, score_thr=0.0)
    if case == "label_map":
        masks = _from_label_map(_ellipses(rng, 60))
    elif case == "overlap":  # overlapping masks, five of them twice: the NMS suppresses
        masks = _ellipses(rng, 30, 3.0, 12.0)
        masks[:, 0:22, 48:62] = masks[:, 28:57, 38:54] = 0  # room for two pairs alone
        near = np.zeros((4, T, T), np.uint8)
        near[0, 2:12, 50:60] = near[1, 11:21, 50:60] = 1  # IoU 10 / 190: one goes
        near[2, 30:45, 40:47] = near[3, 40:55, 45:52] = 1  # IoU 10 / 200 = thr: both stay
        masks = np.concatenate([masks, masks[:5], np.roll(masks[5:8], 1, axis=2), near])
    elif case == "edges":
        masks = _edge_masks()
        kw["min_area"] = 0
    else:
        masks = _from_label_map(_ellipses(rng, 60))
        kw.update(margin=6, min_area=20, score_thr=0.2)
    boxes = np.zeros((len(masks), 4), np.float32)
    for k, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            boxes[k] = xs.min(), ys.min(), xs.max() + 1, ys.max() + 1
    boxes += rng.uniform(0, 0.3, boxes.shape).astype(np.float32)
    res = dict(boxes=boxes, scores=rng.uniform(0.1, 1, len(masks)).astype(np.float32),
               labels=rng.randint(0, 5, len(masks)).astype(np.int64), masks=masks)
    return res, kw


@pytest.mark.parametrize("host", ["library", "numpy"])
@pytest.mark.parametrize("case", ["label_map", "overlap", "edges", "margin"])
def test_postprocess_tile_equals_jax(case, host, monkeypatch):
    """``postprocess_tile`` works on each detection's crop; the JAX
    package's works on the full frame (its RLE, its mask NMS over every
    pair, OpenCV's ``findContours``). Contours, labels, scores, slide boxes
    and RLE bytes are exactly equal: on disjoint label-map masks, on
    overlapping masks the NMS suppresses, on masks at each edge and corner
    of the tile (one pixel, a hole, two components, empty), with a margin,
    ``min_area`` and ``score_thr``; with the host library, and with its numpy
    versions and the Python contour tracer (``kernels.host`` None)."""
    from nuhtc_tpu_torch import kernels
    from nuhtc_tpu_torch.utils import profiling

    if host == "numpy":
        monkeypatch.setattr(kernels, "host", lambda: None)
    res, kw = _post_case(case)
    coord = (448, 192)
    with profiling.spans():
        got = infer.postprocess_tile(res, coord, T, infer.TilePostprocessConfig(**kw))
        counters = dict(profiling.COUNTERS)
    want = j_infer.postprocess_tile(res, coord, T, j_infer.TilePostprocessConfig(**kw))
    assert len(got[0]) == len(want[0]) >= 3
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1:4], want[1:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]
    met, pairs = counters["wsi.nms_pairs"], counters["wsi.nms_pairs_all"]
    assert 0 < met < pairs
    if case == "overlap":
        assert met >= 8  # the copies meet their originals
    assert counters["contours." + ("plain" if host == "numpy" else "native")] >= len(got[0])


# --------------------------------------------------------------------------- #
# stage B on replayed results

def _recorded_tile(rng, k):
    """One tile's engine result: seeded blobs, an overlapping pair, a mask
    whose first contour has one point, a 2-pixel mask; tile 3 is empty."""
    if k == 3:
        return dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros(0, np.float32),
                    labels=np.zeros(0, np.int64), masks=np.zeros((0, T, T), np.uint8))
    masks = [_disc(rng.randint(8, 56), rng.randint(8, 56), rng.randint(3, 9)) for _ in range(6)]
    half = masks[0].copy()
    half[:, :T // 2] = 0  # overlaps mask 0: one of the two is suppressed
    masks.append(half)
    stray = _disc(20, 20, 5)
    stray[40, 20] = 1  # found[0] is this pixel's 1-point contour: dropped
    masks.append(stray)
    masks.append(np.pad(np.ones((1, 2), np.uint8), ((50, T - 51), (5, T - 7))))  # 2 points: dropped
    masks.append(_disc(1, 30, 4))  # crosses the margin: dropped
    masks = np.stack(masks)
    boxes = []
    for m in masks:
        ys, xs = np.nonzero(m)
        boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
    boxes = np.asarray(boxes, np.float32) + rng.uniform(0, 0.3, (len(masks), 4)).astype(np.float32)
    boxes[:, 2:] -= 0.3
    return dict(boxes=boxes, scores=rng.uniform(0.1, 1, len(masks)).astype(np.float32),
                labels=rng.randint(0, 5, len(masks)).astype(np.int64), masks=masks)


class ReplayEngine:
    """Stands where the engine stands in ``infer_slide``: ``dispatch`` hands
    out the next recorded results, ``collect`` returns them."""

    batch_size = 2

    def __init__(self, recorded):
        self.recorded, self.at = recorded, 0
        self.collect_timing = {"device_s": 0.0, "download_s": 0.0}
        self.order = []

    def dispatch(self, tiles):
        out = self.recorded[self.at:self.at + len(tiles)]
        self.at += len(tiles)
        self.order.append(("dispatch", self.at))
        return out

    def collect(self, handle):
        self.order.append(("collect", self.at))
        return handle


def _rows(path, table):
    conn = sqlite3.connect(path)
    try:
        return conn.execute(f"SELECT * FROM {table}").fetchall()
    finally:
        conn.close()


def test_stage_b_replayed_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    recorded = [_recorded_tile(rng, k) for k in range(5)]
    pixels = rng.randint(0, 255, (200, 200, 3)).astype(np.uint8)
    coords = np.array([[0, 0], [64, 0], [100, 100], [30, 90], [150, 150]], np.int64)
    kw = dict(classes=CLASSES, patch_size=T, mode="all", margin=2, min_area=3, progress=False)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = j_infer.infer_slide(ReplayEngine(recorded), _jax_reader(tmp_path, pixels), coords,
                               jdir, "s", det_dir=os.path.join(jdir, "infer"), **kw)
    engine = ReplayEngine(recorded)
    got = infer.infer_slide(engine, ArraySlide(pixels), coords, pdir, "s",
                            det_dir=os.path.join(pdir, "infer"), **kw)
    assert got["tiles"] == want["tiles"] == 5
    assert got["nuclei"] == want["nuclei"] and 10 < got["nuclei"] < 4 * 7
    # batch N+1 is dispatched before batch N is collected
    assert engine.order == [("dispatch", 2), ("dispatch", 4), ("collect", 4), ("dispatch", 5),
                            ("collect", 5), ("collect", 5)]
    parts = ("read_wait_s", "dispatch_s", "collect_s", "post_s")
    assert set(got) == set(want) and set(parts) <= set(got)
    assert {"collect_device_s", "collect_download_s"} <= set(got)
    assert 0 < sum(got[k] for k in parts) <= got["seconds"]

    for name in ("s.geojson", "s_point.geojson", "s_dsa.json", "coco_nuclei.json"):
        with open(os.path.join(pdir, name), "rb") as f, open(os.path.join(jdir, name), "rb") as g:
            data = f.read()
            assert data == g.read(), name
        assert len(json.loads(data)) > 0
    for table in ("contour", "rtree"):
        rows = _rows(os.path.join(pdir, "s_dql.db"), table)
        assert rows == _rows(os.path.join(jdir, "s_dql.db"), table) and len(rows) == got["nuclei"]
    names = sorted(os.listdir(os.path.join(jdir, "patches")))
    assert names == sorted(os.listdir(os.path.join(pdir, "patches"))) and len(names) == 5
    for name in names:
        np.testing.assert_array_equal(cv2.imread(os.path.join(pdir, "patches", name)),
                                      cv2.imread(os.path.join(jdir, "patches", name)))
    overlays = sorted(os.listdir(os.path.join(jdir, "infer")))
    assert overlays == sorted(os.listdir(os.path.join(pdir, "infer"))) and len(overlays) == 4
    for name in overlays:  # thickness-1 contours are exact; the encoders may differ by rounding
        a = cv2.imread(os.path.join(pdir, "infer", name)).astype(int)
        b = cv2.imread(os.path.join(jdir, "infer", name)).astype(int)
        assert np.abs(a - b).max() <= 2

    with open(os.path.join(pdir, "coco_nuclei.json")) as f:
        coco = json.load(f)
    assert len(coco["images"]) == 5 and coco["images"][3]["n_objects"] == 0


@pytest.mark.parametrize("mode,files", [
    ("qupath", {"s.geojson", "s_point.geojson"}), ("dsa", {"s_dsa.json"}),
    ("coco", {"coco_nuclei.json", "patches"}), ("sql", {"s_dql.db"})])
def test_exporter_single_modes_equal_jax(tmp_path, mode, files):
    from nuhtc_tpu.wsi.export import NucleiExporter as JaxExporter
    from nuhtc_tpu.wsi.export import random_colors as j_random_colors

    assert random_colors(5) == j_random_colors(5)
    rng = np.random.RandomState(1)
    res = _recorded_tile(rng, 0)
    conts, labels, scores, boxes, rles = infer.postprocess_tile(
        res, (10, 20), T, infer.TilePostprocessConfig(min_area=3))
    w = j_infer.postprocess_tile(res, (10, 20), T, j_infer.TilePostprocessConfig(min_area=3))
    assert len(conts) == len(w[0]) > 3
    for a, b in zip(conts, w[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(boxes, w[3])
    assert rles == w[4]
    tile = rng.randint(0, 255, (T, T, 3)).astype(np.uint8)
    for cls, out in ((NucleiExporter, tmp_path / "p"), (JaxExporter, tmp_path / "j")):
        ex = cls("s", str(out), CLASSES, mode=mode)
        ex.add_tile(1, conts, labels, scores, boxes, rles, (T, T), tile=tile)
        ex.close()
    assert set(os.listdir(tmp_path / "p")) == set(os.listdir(tmp_path / "j")) == files
    for name in files - {"patches", "s_dql.db"}:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    if mode == "sql":
        for table in ("contour", "rtree"):
            assert _rows(str(tmp_path / "p" / "s_dql.db"), table) == _rows(
                str(tmp_path / "j" / "s_dql.db"), table)
    if mode == "coco":
        np.testing.assert_array_equal(imageio.read_png(str(tmp_path / "p" / "patches" / "1.png")),
                                      tile)


@pytest.mark.parametrize("threads", [1, 3])
def test_tile_stream_is_ordered_and_stops(threads):
    pixels = np.random.RandomState(0).randint(0, 255, (96, 96, 3)).astype(np.uint8)
    coords = np.array([[x, y] for y in range(0, 80, 8) for x in range(0, 80, 16)], np.int64)

    class SlowSlide(ArraySlide):
        def read_region(self, location, level, size):
            time.sleep(0.002 * ((location[0] // 16) % 3))  # batches finish out of order
            return super().read_region(location, level, size)

    slide = SlowSlide(pixels)
    got = list(infer.tile_stream(slide, coords, 16, num_threads=threads, batch_size=4))
    assert len(coords) == 50 and len(got) == 13 and [len(t) for t, _ in got] == [4] * 12 + [2]
    np.testing.assert_array_equal(np.concatenate([bc for _, bc in got]), coords)
    for tiles, bc in got:
        for tile, (x, y) in zip(tiles, bc):
            np.testing.assert_array_equal(tile, pixels[y:y + 16, x:x + 16])

    # abandoned after one batch with the queue full: the workers must stop
    before = threading.active_count()
    stream = infer.tile_stream(slide, coords, 16, num_threads=threads, batch_size=2, prefetch=1)
    next(stream)
    assert threading.active_count() > before
    stream.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


# --------------------------------------------------------------------------- #
# the slice as a whole, tiny detector, shared weights, f32

TINY = dict(num_classes=5, fpn_channels=32,
            backbone_cfg=dict(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8)),
            rpn_nms_pre=128, rpn_max_per_img=64, rpn_min_bbox_size=0.0, rcnn_max_per_img=32,
            rcnn_score_thr=0.05, watershed_max=32, nms_candidates=128, scale_factor=1.0)


@pytest.fixture(scope="module")
def tiny_engines():
    import jax
    import jax.numpy as jnp

    from nuhtc_tpu.apis.inference import InferenceEngine as JaxEngine
    from nuhtc_tpu.models.detector import NuHTC as JaxNuHTC
    from nuhtc_tpu_torch.apis.inference import InferenceEngine
    from nuhtc_tpu_torch.models.detector import NuHTC
    from nuhtc_tpu_torch.utils.convert import state_dict_from_jax
    from torch_oracle import OracleArch, apply_sd, build_full_sd

    model = JaxNuHTC(**TINY, dtype=jnp.float32, exact_rois=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T, T, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    arch = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)
    sd = build_full_sd(np.random.RandomState(0), arch)
    sd["roi_head.semantic_head.conv_logits.bias"] += 2.0  # so components propose boxes
    params = apply_sd(sd, template)
    jax_engine = JaxEngine(model, params, batch_size=2, tile_size=T, scale_factor=1.0)
    port = NuHTC(**TINY)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jax_engine, InferenceEngine(port, batch_size=2, tile_size=T, scale_factor=1.0)


def _filled(ring, shape=(256, 256)):
    out = np.zeros(shape, np.uint8)
    cv2.fillPoly(out, [np.asarray(ring, np.int32)], 1)
    return out


def test_slide_run_matches_jax(tiny_engines, tmp_path):
    from torch_port_util import f32

    jax_engine, engine = tiny_engines
    pixels = np.full((256, 256, 3), 240, np.uint8)
    cv2.circle(pixels, (128, 128), 90, (190, 120, 160), -1)
    for cx, cy in ((100, 100), (150, 120), (120, 170), (80, 150), (170, 170)):
        cv2.circle(pixels, (cx, cy), 9, (110, 60, 130), -1)  # nuclei
    coords = np.array([[0, 0], [64, 64], [128, 128], [64, 128], [192, 192]], np.int64)
    kw = dict(classes=CLASSES, patch_size=T, mode="all", progress=False)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with f32():
        want = j_infer.infer_slide(jax_engine, _jax_reader(tmp_path, pixels), coords, jdir, "s", **kw)
    with torch.no_grad():
        got = infer.infer_slide(engine, ArraySlide(pixels), coords, pdir, "s", **kw)
    assert got["tiles"] == want["tiles"] == 5
    assert got["nuclei"] == want["nuclei"] > 5
    assert got["collect_download_s"] > 0.0

    def load(d, name):
        with open(os.path.join(d, name)) as f:
            return json.load(f)

    gf, wf = load(pdir, "s.geojson"), load(jdir, "s.geojson")
    gp, wp = load(pdir, "s_point.geojson"), load(jdir, "s_point.geojson")
    assert len(gf) == len(wf) == len(gp) == len(wp) == got["nuclei"]
    equal = 0
    for g, w, gpt, wpt in zip(gf, wf, gp, wp):
        assert g["properties"]["label"] == w["properties"]["label"]
        assert g["properties"]["classification"] == w["properties"]["classification"]
        assert abs(g["properties"]["score"] - w["properties"]["score"]) <= 1e-4
        np.testing.assert_allclose(gpt["geometry"]["coordinates"], wpt["geometry"]["coordinates"],
                                   atol=1e-3, rtol=0)
        gr, wr = g["geometry"]["coordinates"][0], w["geometry"]["coordinates"][0]
        assert gr[0] == gr[-1] and len(gr) >= 4
        if gr == wr:
            equal += 1
        else:  # tie pixels of the pasted mask moved the ring
            assert (_filled(gr) != _filled(wr)).sum() <= 3
    assert equal >= len(gf) - 2
    gc, wc = load(pdir, "coco_nuclei.json"), load(jdir, "coco_nuclei.json")
    assert gc["images"] == wc["images"] and gc["categories"] == wc["categories"]
    assert len(gc["annotations"]) == len(wc["annotations"]) == got["nuclei"]
    assert len(load(pdir, "s_dsa.json")["elements"]) == got["nuclei"]
    assert len(_rows(os.path.join(pdir, "s_dql.db"), "rtree")) == got["nuclei"]


# --------------------------------------------------------------------------- #
# the command line

class _StageADone(Exception):
    pass


def test_cli_writes_the_tree_of_tools_infer_wsi(tmp_path, monkeypatch, capsys):
    src = tmp_path / "slides"
    src.mkdir()
    pixels = np.full((256, 256, 3), 240, np.uint8)
    cv2.circle(pixels, (128, 128), 90, (190, 120, 160), -1)
    cv2.circle(pixels, (128, 120), 20, (240, 240, 240), -1)  # a hole
    assert cv2.imwrite(str(src / "s.png"), pixels[..., ::-1])
    preset = tmp_path / "preset.csv"
    preset.write_text("a_t,a_h,use_padding,sthresh,use_otsu\n1,1,True,8,False\n")
    plist = tmp_path / "list.csv"
    plist.write_text("slide_id,process,sthresh\ns,1,8\nabsent,1,\nskipped,0,\n")
    config = os.path.join(REPO, "configs/nuhtc/htc_lite_tiny_synthetic.py")
    argv = [str(src), config, "--patch", "--seg", "--stitch", "--mode", "all", "--patch_size", "64",
            "--step_size", "48", "--mag", "80", "--batch_size", "2", "--preset", str(preset),
            "--process_list", str(plist), "--det"]

    # the JAX package's CLI up to the end of stage A: its engine is not built
    import nuhtc_tpu.apis

    def stop(*a, **k):
        raise _StageADone

    monkeypatch.setattr(nuhtc_tpu.apis, "init_detector", stop)
    monkeypatch.setattr(sys, "argv", ["infer_wsi.py", *argv, "--save_dir", str(tmp_path / "jax")])
    with pytest.raises(_StageADone):
        runpy.run_path(os.path.join(REPO, "tools", "infer_wsi.py"), run_name="__main__")

    out = tmp_path / "port"
    assert cli.main([*argv, "--save_dir", str(out), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "s: 14 patches" in printed and "'tiles': 14" in printed

    def tree(root, skip=()):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs
                      if not os.path.relpath(d, root).startswith(skip))

    assert tree(out, skip="nuclei") == tree(tmp_path / "jax", skip="nuclei") == [
        "masks/s.png", "patches/s.h5", "process_list_autogen.csv", "stitches/s.jpg"]
    gc, ga = tissue.load_coords_h5(str(out / "patches" / "s.h5"))
    wc, wa = j_tissue.load_coords_h5(str(tmp_path / "jax" / "patches" / "s.h5"))
    np.testing.assert_array_equal(gc, wc)
    assert len(gc) == 14 and dict(ga) == dict(wa)
    a = cv2.imread(str(out / "masks" / "s.png"))
    b = cv2.imread(str(tmp_path / "jax" / "masks" / "s.png"))
    da, db = (a != pixels[..., ::-1]).any(-1), (b != pixels[..., ::-1]).any(-1)
    assert (da & db).sum() / (da | db).sum() >= 0.98  # thickness 32: close, not bit-equal
    a = cv2.imread(str(out / "stitches" / "s.jpg")).astype(int)
    b = cv2.imread(str(tmp_path / "jax" / "stitches" / "s.jpg")).astype(int)
    assert a.shape == b.shape == (4, 4, 3) and np.abs(a - b).max() <= 2  # two JPEG encoders
    got_rows = cli.read_csv_rows(str(out / "process_list_autogen.csv"))
    want_rows = cli.read_csv_rows(str(tmp_path / "jax" / "process_list_autogen.csv"))
    assert [list(r) for r in got_rows] == [list(r) for r in want_rows]
    assert [(r["slide_id"], r["status"], r["n_patches"]) for r in got_rows] == [
        (r["slide_id"], r["status"], r["n_patches"]) for r in want_rows] == [
        ("s.png", "processed", 14)]

    # stage B: every file parses and the counts agree
    ndir = out / "nuclei" / "s"
    with open(ndir / "s.geojson") as f:
        feats = json.load(f)
    with open(ndir / "coco_nuclei.json") as f:
        coco = json.load(f)
    assert len(coco["images"]) == 14 and len(coco["annotations"]) == len(feats)
    assert len(_rows(str(ndir / "s_dql.db"), "contour")) == len(feats)
    assert coco["categories"][0]["name"] == "Neoplastic"
    assert len(os.listdir(ndir / "patches")) == 14
    if feats:
        assert os.listdir(ndir / "infer")

    # a second run skips stage A's work for the slide it finds done
    assert cli.main([*argv, "--save_dir", str(out), "--device", "cpu"]) == 0
    assert cli.read_csv_rows(str(out / "process_list_autogen.csv")) == [
        dict(slide_id="s.png", status="already_exist")]


def test_cli_raises_without_a_cuda_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "slides").mkdir()
    config = os.path.join(REPO, "configs/nuhtc/htc_lite_tiny_synthetic.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(tmp_path / "slides"), config, "--save_dir", str(tmp_path / "out")])
    assert cli.main([str(tmp_path / "slides"), config, "--save_dir", str(tmp_path / "out"),
                     "--device", "cpu", "--batch_size", "1", "--patch_size", "64"]) == 0
    assert os.path.exists(tmp_path / "out" / "process_list_autogen.csv")
