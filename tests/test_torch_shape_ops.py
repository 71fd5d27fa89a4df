"""The port's OpenCV-free shape and image operations of the offline slide
tools, against cv2 5.0.0 (which only the tests import), on seeded inputs.

Exactly equal: ``fill_poly`` (rings inside the image and across its border,
several at once, with an offset), filled ``draw_contours`` with an offset
and thin outlines across the border, ``fill_convex_poly`` of
``convex_hull`` (and the hull's vertices in OpenCV's cyclic order),
``find_contours(RETR_EXTERNAL)``, ``arc_length``, contour and binary-image
moments, Hu moments of both, ``sobel3``, ``canny``, ``rgb_to_gray_u8``,
``rgb_to_lab_u8``, ``add_weighted_u8``, ``resize_nearest`` and the uint8
Gaussian up to size 11.
Within a stated tolerance: float-image moments and their Hu moments (1e-9
relative; OpenCV sums in tiles), ``fit_ellipse`` (1e-4 relative on the
axes, 1e-3° on the angle modulo 180, 1e-3 px on the centre, on every point
set that spans three rows and three columns and on which two calls of cv2
agree), ``lab_to_rgb_u8`` (≤ 3 levels, ≤ 2 on
LAB bytes of real colours), the uint8 Gaussian at sizes ≥ 13 (≤ 2 levels)
and the float64 Gaussian (1e-14).
"""

import cv2
import numpy as np
import pytest

from nuhtc_tpu_torch.ops import contours as C
from nuhtc_tpu_torch.ops import imgproc as I
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)


def _rings(rng, h, w, margin, count):
    return [np.stack([rng.randint(-margin, w + margin, n), rng.randint(-margin, h + margin, n)],
                     1).astype(np.int32) for n in rng.randint(1, 10, count)]


def _random_contours(seed, n, density=(0.3, 0.6, 0.9), size=(2, 40)):
    """The largest outer contour of each of n random masks."""
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        h, w = rng.randint(*size, 2)
        m = (rng.rand(h, w) < rng.choice(density)).astype(np.uint8)
        found, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        if found:
            out.append((m, max(found, key=len)))
    return out


@pytest.mark.parametrize("margin", [0, 15])
@pytest.mark.parametrize("seed", range(2))
def test_fill_poly_equals_cv2(seed, margin):
    rng = np.random.RandomState(seed)
    for _ in range(400):
        h, w = rng.randint(3, 60, 2)
        rings = _rings(rng, h, w, margin, rng.randint(1, 4))
        offset = (int(rng.randint(-4, 5)), int(rng.randint(-4, 5)))
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, rings, 7, offset=offset)
        got = C.fill_poly(np.zeros((h, w), np.uint8), rings, 7, offset=offset)
        np.testing.assert_array_equal(got, want, err_msg=f"{[r.tolist() for r in rings]} {offset}")


def test_fill_poly_on_nucleus_scale_rings():
    """Rings as the merge rasterizes them: a pixel contour scaled up 16×."""
    for _, cont in _random_contours(7, 60, density=(0.7,), size=(10, 30)):
        ring = cont.reshape(-1, 2) * 16 + 3
        h, w = ring[:, 1].max() + 4, ring[:, 0].max() + 4
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [ring], 1)
        np.testing.assert_array_equal(C.fill_poly(np.zeros((h, w), np.uint8), [ring], 1), want)


@pytest.mark.parametrize("thickness", [-1, 1])
def test_draw_contours_with_offset_equals_cv2(thickness):
    rng = np.random.RandomState(3 + thickness)
    for _ in range(400):
        h, w = rng.randint(5, 50, 2)
        conts = [r.reshape(-1, 1, 2) for r in _rings(rng, h, w, 10, rng.randint(1, 4))]
        offset = (int(rng.randint(-6, 6)), int(rng.randint(-6, 6)))
        idx = int(rng.randint(-1, len(conts)))
        want = np.zeros((h, w), np.uint8)
        cv2.drawContours(want, conts, idx, 1, thickness=thickness, offset=offset)
        got = C.draw_contours(np.zeros((h, w), np.uint8), conts if idx < 0 else [conts[idx]], 1,
                              thickness=thickness, offset=offset)
        np.testing.assert_array_equal(got, want)


def test_convex_hull_and_its_fill_equal_cv2():
    for m, cont in _random_contours(0, 600):
        want_hull = cv2.convexHull(cont).reshape(-1, 2).tolist()
        hull = C.convex_hull(cont)
        got = hull.reshape(-1, 2).tolist()
        assert hull.dtype == np.int32 and got[0] in want_hull
        k = want_hull.index(got[0])
        assert want_hull[k:] + want_hull[:k] == got
        want = np.zeros_like(m)
        cv2.fillConvexPoly(want, cv2.convexHull(cont)[:, 0], 1)
        np.testing.assert_array_equal(C.fill_convex_poly(np.zeros_like(m), hull[:, 0], 1), want)


def test_external_contours_equal_cv2():
    rng = np.random.RandomState(5)
    for _ in range(150):
        m = (rng.rand(25, 25) < 0.45).astype(np.uint8)
        want, want_h = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        got, got_h = C.find_contours(m, C.RETR_EXTERNAL, C.CHAIN_APPROX_NONE)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got_h, want_h)


def test_arc_length_and_moments_equal_cv2():
    rng = np.random.RandomState(2)
    for m, cont in _random_contours(1, 300):
        assert C.arc_length(cont, True) == cv2.arcLength(cont, True)
        assert C.arc_length(cont, False) == cv2.arcLength(cont, False)
        for got, want in ((C.contour_moments(cont), cv2.moments(cont)),
                          (C.image_moments(m, binary=True), cv2.moments(m, binaryImage=True))):
            assert got == want
            np.testing.assert_array_equal(C.hu_moments(got), cv2.HuMoments(want).ravel())
        f = (rng.rand(*m.shape) * 255).astype(np.float32) * m
        got, want = C.image_moments(f), cv2.moments(f)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-9 * abs(want["m00"]), err_msg=k)
        np.testing.assert_allclose(C.hu_moments(got), cv2.HuMoments(want).ravel(), rtol=1e-9,
                                   atol=1e-15)


def _singular(points):
    """The points lie on one or two rows or columns, or fit_ellipse's first
    design matrix is nearly singular: OpenCV 5.0.0 then nudges them at
    random, and the "ellipse" is a line."""
    p = points.reshape(-1, 2).astype(np.float32)
    if min(len(np.unique(p[:, 0])), len(np.unique(p[:, 1]))) <= 2:
        return True
    d = (p - p.mean(0)).astype(np.float64)
    d *= 100.0 / max(np.abs(d).sum(), 1e-7)  # fit_ellipse's scale
    px, py = d[:, 0], d[:, 1]
    w = np.linalg.svd(np.stack([px * px, py * py, px * py, px, py], 1), compute_uv=False)
    return w[0] * np.finfo(np.float32).eps > w[-1]


def test_fit_ellipse_within_its_tolerance_of_cv2():
    checked = 0
    for _, cont in _random_contours(4, 1500, size=(1, 40)):
        if len(cont) < 5 or _singular(cont):
            continue
        want = cv2.fitEllipse(cont)
        if cv2.fitEllipse(cont) != want:
            continue  # cv2 itself differs from call to call here
        checked += 1
        (cx, cy), (w, h), angle = C.fit_ellipse(cont)
        np.testing.assert_allclose((cx, cy), want[0], atol=1e-3)
        np.testing.assert_allclose((w, h), want[1], rtol=1e-4, atol=1e-6)
        turn = abs(angle - want[2]) % 180
        assert min(turn, 180 - turn) <= 1e-3, (angle, want)
        assert w <= h
    assert checked > 1000


def test_sobel_canny_gray_equal_cv2():
    rng = np.random.RandomState(0)
    for _ in range(150):
        h, w = rng.randint(1, 40, 2)
        rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        gray = I.rgb_to_gray_u8(rgb)
        np.testing.assert_array_equal(gray, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
        gx, gy = I.sobel3(gray)
        np.testing.assert_array_equal(gx, cv2.Sobel(gray, cv2.CV_32F, 1, 0, ksize=3))
        np.testing.assert_array_equal(gy, cv2.Sobel(gray, cv2.CV_32F, 0, 1, ksize=3))
        smooth = cv2.GaussianBlur(gray, (5, 5), 0)
        for img in (gray, smooth, (rng.rand(h, w) < 0.5).astype(np.uint8) * 255):
            np.testing.assert_array_equal(I.canny(img, 50, 150), cv2.Canny(img, 50, 150))


def test_gray_and_lab_on_sampled_colours():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    np.testing.assert_array_equal(I.rgb_to_gray_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    lab = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    np.testing.assert_array_equal(I.rgb_to_lab_u8(rgb), lab)
    back = np.abs(I.lab_to_rgb_u8(lab).astype(int) - cv2.cvtColor(lab, cv2.COLOR_LAB2RGB))
    assert back.max() <= 2
    any_lab = rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    d = np.abs(I.lab_to_rgb_u8(any_lab).astype(int) - cv2.cvtColor(any_lab, cv2.COLOR_LAB2RGB))
    assert d.max() <= 3


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13, 17, 33])
def test_gaussian_blur_against_cv2(k):
    rng = np.random.RandomState(k)
    for shape in ((40, 50), (40, 50, 3), (7, 3), (1, 9)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        d = np.abs(I.gaussian_blur(img, (k, k)).astype(int) - cv2.GaussianBlur(img, (k, k), 0))
        assert d.max() <= (0 if k <= 11 else 2), (shape, d.max())
        f = rng.rand(*shape)
        np.testing.assert_allclose(I.gaussian_blur(f, (k, k)), cv2.GaussianBlur(f, (k, k), 0),
                                   rtol=0, atol=1e-14)
    img = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    d = np.abs(I.gaussian_blur(img, (k, 5)).astype(int) - cv2.GaussianBlur(img, (k, 5), 0))
    assert d.max() <= (0 if k <= 11 else 2)


def test_add_weighted_and_nearest_resize_equal_cv2():
    a, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    for alpha in (0.4, 0.5, 0.7, 0.9, 0.123):
        np.testing.assert_array_equal(I.add_weighted_u8(a, alpha, b, 1 - alpha, 0),
                                      cv2.addWeighted(a, alpha, b, 1 - alpha, 0))
    rng = np.random.RandomState(0)
    for _ in range(300):
        h, w = rng.randint(1, 300, 2)
        oh, ow = rng.randint(1, 600, 2)
        img = rng.randint(0, 256, (h, w)).astype(np.uint8)
        np.testing.assert_array_equal(
            I.resize_nearest(img, (oh, ow)),
            cv2.resize(img, (int(ow), int(oh)), interpolation=cv2.INTER_NEAREST))
