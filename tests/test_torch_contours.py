"""The port's OpenCV-free geometry and image operations against OpenCV itself.

``nuhtc_tpu_torch.ops.contours`` and ``nuhtc_tpu_torch.ops.imgproc`` stand
where the JAX package calls ``cv2``. Everything here is held **exactly equal**
to cv2 (5.0.0) on seeded inputs, except thick lines (``draw_contours`` with
thickness > 1), which are held to an IoU of the coloured pixels: ≥ 0.97 at
the thicknesses the tissue preview draws at power-of-two downsamples (2, 8,
16, 32), ≥ 0.85 at any other.
"""

import cv2
import numpy as np
import pytest
from scipy import ndimage

from nuhtc_tpu_torch.ops import contours as C
from nuhtc_tpu_torch.ops import imgproc as I
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

MODES = [(cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE), (cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE),
         (cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE), (cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)]
EXTERNAL = [(cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE), (cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)]


@pytest.fixture
def native():
    """``find_contours`` on the host C library: required, never the Python
    fallback."""
    from nuhtc_tpu_torch import kernels

    assert kernels.host() is not None


def _assert_same(got, got_h, want, want_h):
    """Equal contours and hierarchy: same order, points, start, way round, dtypes."""
    assert len(got) == len(want)
    if want_h is None:
        assert got_h is None
        return
    np.testing.assert_array_equal(got_h, want_h)  # order, siblings, children, parents
    assert got_h.dtype == want_h.dtype
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape  # (P, 1, 2) int32
        np.testing.assert_array_equal(g, w)  # same points from the same start, same way round


def _disc(shape, cx, cy, r):
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def _smooth_blobs(seed, size=48, sigma=2.0):
    return (ndimage.gaussian_filter(np.random.RandomState(seed).rand(size, size), sigma) > 0.5)


def _zoo():
    s = (40, 48)
    zoo = {}
    zoo["blob"] = _disc(s, 20, 18, 9)
    zoo["smooth_blobs"] = _smooth_blobs(0)
    zoo["blob_with_hole"] = _disc(s, 22, 20, 14) & ~_disc(s, 22, 20, 6)
    zoo["blob_inside_hole"] = zoo["blob_with_hole"] | _disc(s, 22, 20, 3)
    zoo["two_components"] = _disc(s, 10, 10, 6) | _disc(s, 34, 26, 8)
    zoo["stray_pixel_below"] = _disc(s, 20, 15, 8).copy()
    zoo["stray_pixel_below"][33, 20] = True
    line = np.zeros(s, bool)
    line[7, 5:30] = True
    zoo["line_1px"] = line
    diag = np.zeros(s, bool)
    diag[np.arange(5, 30), np.arange(8, 33)] = True
    zoo["diagonal_1px"] = diag
    zoo["rectangle"] = np.zeros(s, bool)
    zoo["rectangle"][5:20, 8:30] = True
    zoo["two_pixels"] = np.zeros(s, bool)
    zoo["two_pixels"][12, 9:11] = True
    for name, (cx, cy) in dict(top=(24, 0), bottom=(24, 39), left=(0, 20), right=(47, 20)).items():
        zoo[f"touches_{name}"] = _disc(s, cx, cy, 7)
    zoo["corner"] = _disc(s, 0, 0, 9)
    zoo["empty"] = np.zeros(s, bool)
    zoo["full"] = np.ones(s, bool)
    zoo["full_with_holes"] = ~(_disc(s, 12, 12, 5) | _disc(s, 30, 25, 7))
    rng = np.random.RandomState(3)
    for p in (0.2, 0.5, 0.8, 0.95):  # salt-and-pepper: deep nesting, many 1-pixel borders
        zoo[f"noise_{p}"] = rng.rand(30, 37) < p
    zoo["nested_rings"] = (_disc(s, 24, 20, 18) & ~_disc(s, 24, 20, 14)) | (
        _disc(s, 24, 20, 10) & ~_disc(s, 24, 20, 6)) | _disc(s, 24, 20, 2)
    zoo["single_row"] = np.array([[1, 1, 0, 1, 0, 0, 1, 1, 1]], bool)
    zoo["single_pixel_image"] = np.ones((1, 1), bool)
    return zoo


ZOO = _zoo()


@pytest.mark.parametrize("mode,method", MODES + EXTERNAL)
@pytest.mark.parametrize("name", sorted(ZOO))
def test_find_contours_equals_cv2(name, mode, method, native):
    mask = ZOO[name].astype(np.uint8)
    _assert_same(*C.find_contours(mask, mode, method), *cv2.findContours(mask, mode, method))


@pytest.mark.parametrize("mode,method", MODES + EXTERNAL)
@pytest.mark.parametrize("name", sorted(ZOO))
def test_find_contours_plain_equals_cv2(name, mode, method):
    mask = ZOO[name].astype(np.uint8)
    _assert_same(*C.find_contours_plain(mask, mode, method),
                 *cv2.findContours(mask, mode, method))


def test_find_contours_first_contour_is_the_last_found(native):
    """``postprocess_tile`` reads ``found[0]`` only: with a stray pixel below
    a nucleus that is the pixel's 1-point contour, and the detection is
    dropped by the ``len(cont) < 3`` rule."""
    found, _ = C.find_contours(ZOO["stray_pixel_below"].astype(np.uint8))
    assert len(found) == 2 and found[0].reshape(-1, 2).tolist() == [[20, 33]]
    assert len(found[1]) > 8
    # a 255-valued and a bool mask read like a 0/1 one; a full 256² frame crops to the blob
    big = np.zeros((256, 256), np.uint8)
    big[100:120, 200:230] = 255
    (rect,), hier = C.find_contours(big)
    assert rect.reshape(-1, 2).tolist() == [[200, 100], [200, 119], [229, 119], [229, 100]]
    assert hier.tolist() == [[[-1, -1, -1, -1]]]
    (rect_b,), _ = C.find_contours(big > 0)
    np.testing.assert_array_equal(rect_b, rect)
    with pytest.raises(ValueError):
        C.find_contours(big, mode=cv2.RETR_LIST)
    with pytest.raises(ValueError):
        C.find_contours(big, method=cv2.CHAIN_APPROX_TC89_L1)


def _random_masks_equal_cv2(find, seed):
    rng = np.random.RandomState(seed)
    total = 0
    for _ in range(40):
        h, w = rng.randint(1, 40, 2)
        mask = (rng.rand(h, w) < rng.choice([0.2, 0.5, 0.8, 0.95])).astype(np.uint8)
        for mode, method in MODES[:2]:
            got = find(mask, mode, method)
            _assert_same(*got, *cv2.findContours(mask, mode, method))
            total += len(got[0])
    assert total > 500


@pytest.mark.parametrize("seed", range(4))
def test_find_contours_equals_cv2_on_random_masks(seed, native):
    _random_masks_equal_cv2(C.find_contours, seed)


@pytest.mark.parametrize("seed", range(4))
def test_find_contours_plain_equals_cv2_on_random_masks(seed):
    _random_masks_equal_cv2(C.find_contours_plain, seed)


def _ragged(rng, h, w):
    """Thresholded smooth noise (components, holes, holes in holes) with
    single pixels, one-pixel-wide lines and foreground on the image's edges."""
    m = ndimage.gaussian_filter(rng.rand(h, w), rng.uniform(0.6, 2.5))
    m = m > np.quantile(m, rng.uniform(0.2, 0.8))
    for _ in range(rng.randint(0, 6)):
        m[rng.randint(h), rng.randint(w)] ^= True
    y, x = rng.randint(h), rng.randint(w)
    n = rng.randint(2, max(3, min(h, w)))
    m[y, x:x + n] = True  # a horizontal line
    m[y:y + n, x] = True  # and a vertical one from the same pixel
    d = np.arange(min(n, h - y, w - x))
    m[y + d, x + d] = True  # a diagonal
    for side in rng.choice(4, rng.randint(1, 5), replace=False):
        edge = (m[0], m[-1], m[:, 0], m[:, -1])[side]
        edge[rng.rand(len(edge)) < 0.5] = True
    return m.astype(np.uint8)


def test_native_tracer_equals_plain_on_ragged_masks(native):
    """200 seeded ragged masks, every mode: the library and the Python
    tracer give the same contours and hierarchy (and so does cv2)."""
    rng = np.random.RandomState(19)
    borders = holes = 0
    for _ in range(200):
        mask = _ragged(rng, *rng.randint(2, 72, 2))
        for mode, method in MODES + EXTERNAL:
            got = C.find_contours(mask, mode, method)
            _assert_same(*got, *C.find_contours_plain(mask, mode, method))
            _assert_same(*got, *cv2.findContours(mask, mode, method))
            if mode == cv2.RETR_CCOMP:
                borders += len(got[0])
                holes += int((got[1][0, :, 3] >= 0).sum())
    assert borders > 5000 and holes > 1000


def test_native_tracer_at_the_slide_shape(native):
    """256² masks as the slide cell's detections give them: a roughened
    blob of the benchmark traffic's size anywhere in the tile, at times with
    a fragment or a stray pixel beside it; and a bool copy of each."""
    rng = np.random.RandomState(256)
    yy, xx = np.mgrid[:256, :256]
    for _ in range(64):
        cy, cx = rng.randint(-8, 264, 2)
        r2 = (yy - cy) ** 2 + (xx - cx) ** 2
        rough = ndimage.gaussian_filter(rng.rand(256, 256), 1.2) * 60
        mask = r2 + rough < 150 + 30
        if rng.rand() < 0.5:
            mask |= ((yy - cy - 14) ** 2 + (xx - cx + 9) ** 2 + rough) < 40
        if rng.rand() < 0.5:
            mask[rng.randint(256), rng.randint(256)] = True
        for m in (mask.astype(np.uint8), mask):
            got = C.find_contours(m)
            _assert_same(*got, *C.find_contours_plain(m))
            _assert_same(*got, *cv2.findContours(m.astype(np.uint8), cv2.RETR_TREE,
                                                  cv2.CHAIN_APPROX_SIMPLE))


def test_native_tracer_reads_any_dtype_and_layout(native):
    """The library reads uint8 and bool masks in place and any other dtype
    or layout through a copy: empty shapes, ints, floats, Fortran order,
    reversed and strided views all give the Python tracer's contours."""
    base = _ragged(np.random.RandomState(5), 23, 31)
    masks = [np.zeros((0, 5), np.uint8), np.zeros((5, 0), bool), base.astype(np.int64) * 7,
             base * 0.5, np.asfortranarray(base), base.astype(bool)[::-1, ::2],
             base[:, 3:-2]]
    for mask in masks:
        for mode, method in MODES + EXTERNAL:
            _assert_same(*C.find_contours(mask, mode, method),
                         *C.find_contours_plain(mask, mode, method))


def test_native_tracer_on_a_thumbnail(native):
    """A 2000 × 1500 binarized thumbnail as ``wsi/tissue.py`` traces it
    (``RETR_CCOMP``, ``CHAIN_APPROX_NONE``): large regions, holes, specks;
    a 0/255 uint8 mask and an int32 one read alike."""
    rng = np.random.RandomState(2000)
    thumb = ndimage.zoom(rng.rand(60, 45), (2000 / 60, 1500 / 45), order=1)
    thumb = ((thumb + 0.08 * rng.rand(2000, 1500)) > 0.55).astype(np.uint8) * 255
    got = C.find_contours(thumb, C.RETR_CCOMP, C.CHAIN_APPROX_NONE)
    assert len(got[0]) > 50 and sum(len(c) for c in got[0]) > 20000
    _assert_same(*got, *C.find_contours_plain(thumb, C.RETR_CCOMP, C.CHAIN_APPROX_NONE))
    _assert_same(*got, *cv2.findContours(thumb, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE))
    _assert_same(*C.find_contours(thumb.astype(np.int32), C.RETR_CCOMP, C.CHAIN_APPROX_NONE),
                 *got)


@pytest.mark.parametrize("method", [cv2.CHAIN_APPROX_NONE, cv2.CHAIN_APPROX_SIMPLE])
def test_area_rect_and_point_test_equal_cv2(method):
    rng = np.random.RandomState(5)
    checked = {1: 0, 0: 0, -1: 0}
    for seed in range(12):
        conts, _ = cv2.findContours(_smooth_blobs(seed).astype(np.uint8), cv2.RETR_CCOMP, method)
        for c in conts:
            for cont in (c, (c * 37.5).astype(np.int32)):  # also as tissue.py scales them
                assert C.contour_area(cont) == cv2.contourArea(cont)
                assert C.bounding_rect(cont) == cv2.boundingRect(cont)
                hi = int(cont.max()) + 3
                pts = rng.randint(-2, hi, (40, 2)).tolist()
                pts += cont.reshape(-1, 2)[:6].tolist()  # vertices
                mid = (cont.reshape(-1, 2)[:-1] + cont.reshape(-1, 2)[1:]) // 2
                pts += mid[:6].tolist()  # on or next to an edge
                for pt in pts:
                    want = int(cv2.pointPolygonTest(cont, (int(pt[0]), int(pt[1])), False))
                    assert C.point_polygon_test(cont, pt) == want, (pt, want)
                    checked[want] += 1
    assert min(checked.values()) > 100  # inside, outside and on the border all occurred
    assert C.contour_area(np.array([[[3, 4]]], np.int32)) == 0.0  # a 1-point contour
    sq = np.array([[0, 0], [0, 10], [10, 10], [10, 0]], np.int32).reshape(-1, 1, 2)
    assert C.point_polygon_test(sq, (5, 5)) == 1 and C.point_polygon_test(sq, (11, 5)) == -1
    assert C.point_polygon_test(sq, (10, 5)) == 0 and C.point_polygon_test(sq, (10, 10)) == 0
    assert C.contour_area(sq) == 100.0 and C.bounding_rect(sq) == (0, 0, 11, 11)


def test_draw_contours_thickness_1_equals_cv2():
    rng = np.random.RandomState(7)
    for seed in range(10):
        for method in (cv2.CHAIN_APPROX_NONE, cv2.CHAIN_APPROX_SIMPLE):
            conts, _ = cv2.findContours(_smooth_blobs(seed).astype(np.uint8), cv2.RETR_TREE, method)
            want = np.zeros((48, 48, 3), np.uint8)
            got = want.copy()
            cv2.drawContours(want, conts, -1, (255, 150, 0), 1)
            assert C.draw_contours(got, conts, (255, 150, 0), 1) is got
            np.testing.assert_array_equal(got, want)
        # segments of any slope, end points inside the image
        poly = rng.randint(0, 160, (7, 1, 2)).astype(np.int32)
        want = np.zeros((160, 160, 3), np.uint8)
        got = want.copy()
        cv2.drawContours(want, [poly], -1, (0, 255, 0), 1)
        C.draw_contours(got, [poly], (0, 255, 0), 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thickness,floor", [(2, 0.97), (8, 0.97), (16, 0.97), (32, 0.97),
                                             (3, 0.85), (5, 0.85)])
def test_draw_contours_thick_lines_overlap_cv2(thickness, floor):
    rng = np.random.RandomState(thickness)
    for seed in range(8):
        conts, _ = cv2.findContours(_smooth_blobs(seed, sigma=3.0).astype(np.uint8),
                                    cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE)
        scale = rng.choice([3, 7.3, 16])
        conts = [np.round(c * scale).astype(np.int32) for c in conts]
        side = int(48 * scale) + 40
        want = np.zeros((side, side, 3), np.uint8)
        got = want.copy()
        cv2.drawContours(want, conts, -1, (0, 255, 0), thickness)
        C.draw_contours(got, conts, (0, 255, 0), thickness)
        a, b = want.any(-1), got.any(-1)
        assert (a & b).sum() / max((a | b).sum(), 1) >= floor


@pytest.mark.parametrize("thickness", [2, 5, 16])
def test_draw_contours_thick_lines_same_in_any_number_of_passes(monkeypatch, thickness):
    """A thick outline is drawn in passes of at most ``_THICK_CHUNK`` candidate
    pixels; passes of a few hundred give the pixels of one pass, for rings
    that cross the border and rings of one point."""
    rng = np.random.RandomState(thickness)
    conts = [rng.randint(-30, 130, (n, 1, 2)).astype(np.int32) for n in (1, 2, 9, 25)]
    one = np.zeros((100, 110, 3), np.uint8)
    C.draw_contours(one, conts, (0, 255, 0), thickness, offset=(3, -2))
    monkeypatch.setattr(C, "_THICK_CHUNK", 300)
    many = np.zeros_like(one)
    C.draw_contours(many, conts, (0, 255, 0), thickness, offset=(3, -2))
    assert one.any() and np.array_equal(one, many)


def test_saturation_equals_cv2():
    rng = np.random.RandomState(0)
    g = np.arange(0, 256, 5, dtype=np.uint8)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 1, 3)
    corners = np.array([[0, 0, 0], [255, 255, 255], [7, 7, 7], [255, 0, 0], [0, 255, 0], [1, 0, 0],
                        [0, 0, 255], [255, 254, 255], [2, 1, 1], [128, 127, 0]], np.uint8)
    rgb = np.concatenate([grid, corners[:, None], rng.randint(0, 256, (100000, 1, 3)).astype(np.uint8)])
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)[..., 1]
    got = I.rgb_to_saturation_u8(rgb)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the table is not a float division: these are where the two part
    v = rgb.max(-1).astype(np.float64)
    naive = np.where(v > 0, np.rint((v - rgb.min(-1)) * 255.0 / np.maximum(v, 1)), 0)
    assert (naive != want).any()
    with pytest.raises(ValueError):
        I.rgb_to_saturation_u8(rgb.astype(np.float32))


@pytest.mark.parametrize("seed", range(3))
def test_median_threshold_otsu_close_equal_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(6):
        h, w = rng.randint(3, 70, 2)
        x = rng.randint(0, 256, (h, w)).astype(np.uint8)
        for k in (3, 5, 7):
            np.testing.assert_array_equal(I.median_blur_u8(x, k), cv2.medianBlur(x, k))
        for thr in (0, 8, 8.5, 254, 255):
            np.testing.assert_array_equal(I.threshold_binary(x, thr),
                                          cv2.threshold(x, thr, 255, cv2.THRESH_BINARY)[1])
        two = np.where(x > 128, 200, 10).astype(np.uint8)
        for img in (x, (x // 32 * 7).astype(np.uint8), two, np.full((h, w), 7, np.uint8),
                    (x > 250).astype(np.uint8) * 255, np.where(x > 100, x, 0).astype(np.uint8)):
            thr, want = cv2.threshold(img, 0, 255, cv2.THRESH_OTSU + cv2.THRESH_BINARY)
            assert I.otsu_threshold_value(img) == thr
            np.testing.assert_array_equal(I.threshold_otsu(img), want)
        b = ((rng.rand(h, w) < rng.choice([0.1, 0.5, 0.9])) * 255).astype(np.uint8)
        for k in (2, 3, 4, 5):
            want = cv2.morphologyEx(b, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))
            np.testing.assert_array_equal(I.morph_close(b, k), want)


def test_even_close_is_not_the_symmetric_close():
    """cv2 anchors a 4 × 4 kernel at (2, 2) in both passes; scipy's close
    mirrors the window between its passes and gives another image."""
    b = ((np.random.RandomState(0).rand(40, 40) < 0.5) * 255).astype(np.uint8)
    sym = ndimage.binary_closing(b > 0, np.ones((4, 4), bool)).astype(np.uint8) * 255
    assert (sym != I.morph_close(b, 4)).any()


@pytest.mark.parametrize("src,dst", [(256, 4), (512, 4), (128, 4), (16, 4), (8, 4), (4, 4),
                                     (37, 4), (256, 8), (4, 1), (3, 1)])
def test_resize_u8_equals_cv2(src, dst):
    """The stitched preview's resize, down to the 64× (and 128×) reduction of
    a level-0 tile, the exact halving (cv2 switches to its area method) and
    the equal size."""
    x = np.random.RandomState(src).randint(0, 256, (src, src, 3)).astype(np.uint8)
    np.testing.assert_array_equal(I.resize_u8(x, (dst, dst)), cv2.resize(x, (dst, dst)))
