"""The corruption catalog of the port (``data.pipelines.CORRUPTIONS``) and the
OpenCV calls it makes (``ops.imgproc``, ``ops.contours.circle``), on the CPU.

- Each OpenCV call against cv2 5.0.0 (which only the tests import) on seeded
  inputs: ``filter2d`` (uint8 and float32, odd and even kernels, sparse
  taps, 3 channels, images narrower than the kernel), ``gaussian_blur`` with
  a sigma (uint8 every size; float32, within 1e-7 on the last W mod 4
  values of a row where W is not a multiple of 4), ``get_rotation_matrix_2d``,
  ``warp_affine`` (float32 kernels as the catalog warps them),
  ``remap`` (uint8, BORDER_REFLECT, points far outside), ``resize_linear_f32``,
  ``rgb_to_hsv_u8`` on all 2²⁴ colours, ``hsv_to_rgb_u8`` on all 2²⁴ inputs
  at widths 1 and 64 and on widths across cv2's 32-pixel vector step, and
  the filled ``circle``: equal, but for ``filter2d`` with 130 taps or more
  (cv2's DFT): float32 within 4e-7, uint8 within 1 level on at most 0.1 %
  of the values.
- Each of the 19 corruptions at severities 1-5 against ``nuhtc_tpu``'s
  ``CORRUPTIONS`` on a seeded 64² RGB image with equal ``RandomState``
  seeds: equal, dtype and shape included, but for ``snow`` at severities 4
  and 5, within 2e-5 of 255 (its float32 ``filter2D`` goes through cv2's
  DFT); ``jpeg_compression`` (Pillow's codec in the port, OpenCV's in the
  JAX package) decodes to equal pixels here.
- ``CORRUPTION_GROUPS`` equal, 19 corruptions.
"""

import cv2
import numpy as np
import pytest

from nuhtc_tpu.data import pipelines as jax_pipelines
from nuhtc_tpu_torch.data import pipelines
from nuhtc_tpu_torch.ops import imgproc as I
from nuhtc_tpu_torch.ops.contours import circle
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

F2D_DFT_TOL = 4e-7  # float32 filter2d with ≥ 130 taps against cv2's DFT, values in [0, 1]
F2D_DFT_U8_SHARE = 1e-3  # uint8 filter2d with ≥ 130 taps: share of values 1 level off
GAUSS_F32_TAIL_TOL = 1e-7  # float32 Gaussian, the last W mod 4 values of a row
SNOW_TOL = 2e-5  # snow at severities 4 and 5, on the 0..255 scale


def _kernel(rng, kh, kw, sparse):
    k = rng.rand(kh, kw).astype(np.float32)
    if sparse:
        k[k < 0.4] = 0
    return k / k.sum()


@pytest.mark.parametrize("kh,kw", [(3, 3), (4, 4), (5, 5), (2, 6), (7, 3), (9, 9), (11, 11),
                                   (12, 12), (13, 13), (15, 15)])
def test_filter2d_against_cv2(kh, kw):
    rng = np.random.RandomState(kh * 31 + kw)
    for shape in ((40, 50, 3), (33, 47), (6, 5, 3)):
        k = _kernel(rng, kh, kw, sparse=kh % 2 == 0)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got, want = I.filter2d(img, k).astype(int), cv2.filter2D(img, -1, k).astype(int)
        if kh * kw < 130:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1
            assert (got != want).mean() <= F2D_DFT_U8_SHARE
        f = rng.rand(*shape).astype(np.float32)
        got, want = I.filter2d(f, k), cv2.filter2D(f, -1, k)
        assert got.dtype == want.dtype == np.float32
        if kh * kw < 130:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=F2D_DFT_TOL)


@pytest.mark.parametrize("sigma", [0.5, 0.7, 0.9, 1.1, 1.3, 1.5, 2.0, 2.5, 3.0, 4.0, 8.0])
def test_gaussian_blur_with_sigma_against_cv2(sigma):
    rng = np.random.RandomState(int(sigma * 10))
    for shape in ((64, 64, 3), (31, 45), (9, 70)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(I.gaussian_blur(img, (0, 0), sigma),
                                      cv2.GaussianBlur(img, (0, 0), sigma))
    if sigma >= 1.0:  # float32 kernels of 9 taps and more
        for shape in ((64, 64), (40, 32), (40, 30), (33, 47)):
            f = (rng.rand(*shape).astype(np.float32) * 2 - 1)
            got, want = I.gaussian_blur(f, (0, 0), sigma), cv2.GaussianBlur(f, (0, 0), sigma)
            if shape[1] % 4 == 0:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_F32_TAIL_TOL)


@pytest.mark.parametrize("k", [13, 15, 17, 21, 33])
def test_gaussian_blur_large_uint8_kernels_against_cv2(k):
    rng = np.random.RandomState(k)
    img = rng.randint(0, 256, (40, 50, 3)).astype(np.uint8)
    np.testing.assert_array_equal(I.gaussian_blur(img, (k, k)), cv2.GaussianBlur(img, (k, k), 0))


def test_rotation_matrix_and_warp_affine_against_cv2():
    rng = np.random.RandomState(0)
    for n in (5, 7, 9, 11, 13, 15):
        for _ in range(8):
            angle = rng.uniform(-180, 180)
            m = I.get_rotation_matrix_2d((n / 2 - 0.5, n / 2 - 0.5), angle, 1.0)
            np.testing.assert_array_equal(
                m, cv2.getRotationMatrix2D((n / 2 - 0.5, n / 2 - 0.5), angle, 1.0))
            for k in (np.zeros((n, n), np.float32), rng.rand(n, n).astype(np.float32)):
                k[n // 2, :] += 1.0 / n
                np.testing.assert_array_equal(I.warp_affine(k, m, (n, n)),
                                              cv2.warpAffine(k, m, (n, n)))
    m = cv2.getRotationMatrix2D((3.5, 2.0), 33.0, 1.3)
    k = rng.rand(9, 12).astype(np.float32)
    np.testing.assert_array_equal(I.warp_affine(k, m, (14, 11)), cv2.warpAffine(k, m, (14, 11)))


def test_remap_against_cv2():
    rng = np.random.RandomState(1)
    xx, yy = np.meshgrid(np.arange(64, dtype=np.float32), np.arange(48, dtype=np.float32))
    for shape in ((48, 64, 3), (48, 64)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        for scale in (0.3, 2.0, 20.0, 200.0):
            mx = xx + (rng.rand(48, 64).astype(np.float32) - 0.5) * scale
            my = yy + (rng.rand(48, 64).astype(np.float32) - 0.5) * scale
            want = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
            np.testing.assert_array_equal(I.remap(img, mx, my), want)


def test_resize_linear_f32_against_cv2():
    rng = np.random.RandomState(2)
    g = rng.rand(2, 2).astype(np.float32)
    for n in (3, 5, 9, 17, 33, 65):  # the plasma cloud's growth
        want = cv2.resize(g, (n, n), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(I.resize_linear_f32(g, (n, n)), want)
        g = want + (rng.rand(n, n).astype(np.float32) - 0.5) * 0.3
    for src, dst in (((7, 11), (20, 13)), ((16, 16), (23, 41)), ((5, 9, 3), (12, 30))):
        x = rng.rand(*src).astype(np.float32)
        np.testing.assert_array_equal(I.resize_linear_f32(x, dst),
                                      cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR))


def _all_colours(chunk, parts=8):
    codes = np.arange(1 << 24, dtype=np.int64)
    for c in np.array_split(codes, parts):
        yield np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(
            -1, chunk, 3)


def test_rgb_to_hsv_on_all_colours():
    for rgb in _all_colours(64):
        np.testing.assert_array_equal(I.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [1, 64])
def test_hsv_to_rgb_on_all_inputs(width):
    """All 2²⁴ byte triples (H beyond 180 included) in rows of ``width``."""
    for hsv in _all_colours(width):
        np.testing.assert_array_equal(I.hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_hsv_to_rgb_across_the_vector_step():
    rng = np.random.RandomState(3)
    for width in (3, 31, 32, 33, 47, 63, 65, 100, 130):
        hsv = np.stack([rng.randint(0, 180, (20, width)), rng.randint(0, 256, (20, width)),
                        rng.randint(0, 256, (20, width))], -1).astype(np.uint8)
        np.testing.assert_array_equal(I.hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_filled_circle_against_cv2():
    for r in range(0, 30):
        for center in ((r, r), (5, 7), (20, 3), (-3, 12), (40, 40)):
            for dtype, color in ((np.float32, 1.0), (np.uint8, (200, 10, 50))):
                shape = (2 * r + 11, 2 * r + 6) + ((3,) if dtype == np.uint8 else ())
                want = np.zeros(shape, dtype)
                cv2.circle(want, center, r, color, -1)
                np.testing.assert_array_equal(circle(np.zeros(shape, dtype), center, r, color),
                                              want)


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(5).randint(0, 256, (64, 64, 3)).astype(np.uint8)


@pytest.mark.parametrize("sev", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", list(jax_pipelines.CORRUPTIONS))
def test_corruption_equals_jax(image, name, sev):
    want = np.asarray(jax_pipelines.CORRUPTIONS[name](image.copy(), sev,
                                                      np.random.RandomState(10 * sev + 1)))
    got = np.asarray(pipelines.CORRUPTIONS[name](image.copy(), sev,
                                                 np.random.RandomState(10 * sev + 1)))
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "snow" and sev >= 4:
        np.testing.assert_allclose(got, want, rtol=0, atol=SNOW_TOL)
        assert not np.array_equal(got, image)
    else:
        np.testing.assert_array_equal(got, want)


def test_corruption_catalog_and_groups_equal_jax():
    assert list(pipelines.CORRUPTIONS) == list(jax_pipelines.CORRUPTIONS)
    assert len(pipelines.CORRUPTIONS) == 19
    assert pipelines.CORRUPTION_GROUPS == jax_pipelines.CORRUPTION_GROUPS
    assert set(pipelines.CORRUPTION_GROUPS["all"]) == set(pipelines.CORRUPTIONS)


def test_jpeg_without_pillow_raises_by_name(monkeypatch, image):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        pipelines.CORRUPTIONS["jpeg_compression"](image, 1, np.random.RandomState(0))
