"""The deep-feature path of the port (``nuhtc_tpu_torch.tools
.extract_features_nuhtc``) against the JAX package's, on the CPU in f32 with
shared weights (``tests/torch_oracle.py build_full_sd``, loaded by the
port's ``init_detector`` and mapped for JAX by the converter's key map;
JAX's products at full f32 precision). The JAX tool is run with that engine
in place of its ``init_detector``, which would compile the whole detector.

- ``iter_slide_features`` + ``write_slide_features`` against the JAX tool's
  ``_slide_features`` with its jitted ``feat_fn``: the pooled vectors of
  every level concatenated, and of one level, within 1e-4; coords equal.
- The command line in reference mode against ``tools/extract_features_nuhtc.py``
  on a CSV of two slides, one skipped because its bag exists: the same
  files, h5 features and .npy bags within 1e-4, coords equal; then with
  ``--stain_norm --target_patch_size 48 --no_auto_skip`` within 5e-3, since
  the port's LAB → RGB differs from OpenCV's by a few levels on some pixels
  (``ops.imgproc.lab_to_rgb_u8``), and within 1e-4 with the JAX package's
  normalizer swapped in; and legacy positional mode.
"""

import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from nuhtc_tpu.wsi.tissue import save_coords_h5
from nuhtc_tpu_torch.tools import extract_features_nuhtc as efn
from nuhtc_tpu_torch.tools.synthetic import synthetic_slide
from nuhtc_tpu_torch.wsi.slide import ArraySlide
from torch_oracle import OracleArch, build_full_sd
from torch_port_util import f32
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_tiny_synthetic.py")
ARCH = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_extract_features", os.path.join(REPO, "tools", "extract_features_nuhtc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pth"
    torch.save({"state_dict": build_full_sd(np.random.RandomState(0), ARCH)}, path)
    return str(path)


@pytest.fixture(scope="module")
def engines(checkpoint):
    """The JAX engine of the tiny config, its parameters made from the
    checkpoint through the converter's key map (shapes by ``eval_shape``: no
    compile of the whole detector), and the port's from ``init_detector``."""
    import jax
    import jax.numpy as jnp

    from nuhtc_tpu.apis.inference import InferenceEngine as JaxEngine
    from nuhtc_tpu.config import Config as JaxConfig
    from nuhtc_tpu.models.build import build_detector as jax_build
    from nuhtc_tpu_torch.apis.inference import init_detector
    from torch_oracle import apply_sd

    cfg = JaxConfig.fromfile(CFG)
    model = jax_build(cfg.model, cfg.model.get("test_cfg"), 1.0, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = apply_sd(torch.load(checkpoint, weights_only=True)["state_dict"], template)
    jax_engine = JaxEngine(model, params, batch_size=2, tile_size=256, scale_factor=1.0)
    return jax_engine, init_detector(CFG, checkpoint, batch_size=2, device="cpu")


def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return f["features"][:], f["coords"][:]


@pytest.mark.parametrize("level", [None, 2])
def test_slide_features_equal_jax(engines, tmp_path, level):
    jax_engine, engine = engines
    slide = ArraySlide(synthetic_slide(np.random.RandomState(0), 256))
    coords = np.array([[0, 0], [64, 0], [0, 64], [128, 96], [200, 200]], np.int64)
    # 64² tiles into the engine's 256² frame, zero-padded on both sides
    tool = _jax_tool()
    with f32():
        tool._slide_features(jax_engine, tool._build_feat_fn(jax_engine, level), slide, coords,
                             64, 0, 2, str(tmp_path / "jax.h5"))
    timing = {}
    n = efn.write_slide_features(str(tmp_path / "port.h5"), efn.iter_slide_features(
        engine, slide, coords, 64, level=level, timing=timing))
    got, got_coords = _read_h5(tmp_path / "port.h5")
    want, want_coords = _read_h5(tmp_path / "jax.h5")
    assert n == len(coords) and got.shape == want.shape == (5, 32 if level == 2 else 128)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got_coords, want_coords)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got).max() > 1e-2
    assert set(timing) == set(efn.TIMING_KEYS) and all(v >= 0 for v in timing.values())


@pytest.fixture()
def slide_tree(tmp_path):
    """Two 192² slides as PNGs, their coords files and the process list."""
    (tmp_path / "slides").mkdir()
    (tmp_path / "feat" / "patches").mkdir(parents=True)
    for i, name in enumerate(("s1", "s2")):
        img = synthetic_slide(np.random.RandomState(i), 192)
        assert cv2.imwrite(str(tmp_path / "slides" / f"{name}.png"), img[..., ::-1])
        coords = np.array([[0, 0], [64, 0], [0, 64], [96, 96], [128, 64]][:4 + i], np.int64)
        save_coords_h5(str(tmp_path / "feat" / "patches" / f"{name}.h5"), coords,
                       attrs=dict(patch_size=64, patch_level=0))
    (tmp_path / "list.csv").write_text("slide_id\ns1.png\ns2.png\n")
    return tmp_path


def _reference_argv(root, feat_dir, checkpoint, extra=()):
    return ["--config", CFG, "--checkpoint", checkpoint, "--data_h5_dir", str(root / "feat"),
            "--data_slide_dir", str(root / "slides"), "--slide_ext", ".png",
            "--csv_path", str(root / "list.csv"), "--feat_dir", str(feat_dir),
            "--batch_size", "2", *extra]


def _run_both(monkeypatch, root, checkpoint, jax_engine, extra=()):
    port, jax_dir = root / "port", root / "jax"
    for d in (port, jax_dir):
        (d / "pt_files").mkdir(parents=True, exist_ok=True)
        # s2's bag exists: the reference mode skips it unless --no_auto_skip
        np.save(d / "pt_files" / "s2.npy", np.zeros((1, 1), np.float32))
    assert efn.main(_reference_argv(root, port, checkpoint, extra) + ["--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["extract_features_nuhtc.py"]
                        + _reference_argv(root, jax_dir, checkpoint, extra))
    monkeypatch.setattr("nuhtc_tpu.apis.init_detector", lambda *a, **k: jax_engine)
    with f32():
        _jax_tool().main()
    return port, jax_dir


def test_reference_mode_equals_jax_tool(slide_tree, checkpoint, engines, monkeypatch):
    port, jax_dir = _run_both(monkeypatch, slide_tree, checkpoint, engines[0])
    assert sorted(os.listdir(port / "h5_files")) == sorted(os.listdir(jax_dir / "h5_files")) \
        == ["s1.h5"]
    got, got_coords = _read_h5(port / "h5_files" / "s1.h5")
    want, want_coords = _read_h5(jax_dir / "h5_files" / "s1.h5")
    np.testing.assert_array_equal(got_coords, want_coords)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.load(port / "pt_files" / "s1.npy"), got)
    assert np.load(port / "pt_files" / "s2.npy").shape == (1, 1)  # skipped


def test_stain_norm_and_target_size_against_jax_tool(slide_tree, checkpoint, engines,
                                                     monkeypatch):
    """With its own normalizer the port is within 5e-3 of the JAX tool (the
    LAB → RGB step differs by a few levels on some pixels); with the JAX
    package's normalizer in its place, within 1e-4: the rest of the path is
    the same."""
    from nuhtc_tpu.wsi.stain import reinhard_normalize as jax_reinhard

    extra = ("--stain_norm", "--target_patch_size", "48", "--no_auto_skip")
    port, jax_dir = _run_both(monkeypatch, slide_tree, checkpoint, engines[0], extra)
    same = slide_tree / "same"
    monkeypatch.setattr(efn, "reinhard_normalize", jax_reinhard)
    efn.main(_reference_argv(slide_tree, same, checkpoint, extra) + ["--device", "cpu"])
    for name, rows in (("s1", 4), ("s2", 5)):
        got, got_coords = _read_h5(port / "h5_files" / f"{name}.h5")
        want, want_coords = _read_h5(jax_dir / "h5_files" / f"{name}.h5")
        assert got.shape == want.shape == (rows, 128)
        np.testing.assert_array_equal(got_coords, want_coords)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
        np.testing.assert_array_equal(np.load(port / "pt_files" / f"{name}.npy"), got)
        np.testing.assert_allclose(_read_h5(same / "h5_files" / f"{name}.h5")[0], want,
                                   rtol=0, atol=1e-4)


def test_legacy_mode_equals_jax_tool(slide_tree, checkpoint, engines, monkeypatch):
    save = {k: slide_tree / k for k in ("port", "jax")}
    for d in save.values():
        (d / "patches").mkdir(parents=True)
        for name in ("s1", "s2"):
            os.link(slide_tree / "feat" / "patches" / f"{name}.h5", d / "patches" / f"{name}.h5")
    src, ckpt = str(slide_tree / "slides"), checkpoint
    assert efn.main([src, CFG, ckpt, "--save_dir", str(save["port"]), "--batch_size", "2",
                     "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["extract_features_nuhtc.py", src, CFG, ckpt,
                                      "--save_dir", str(save["jax"]), "--batch_size", "2"])
    monkeypatch.setattr("nuhtc_tpu.apis.init_detector", lambda *a, **k: engines[0])
    with f32():
        _jax_tool().main()
    for name in ("s1", "s2"):
        got, got_coords = _read_h5(save["port"] / "features" / f"{name}.h5")
        want, want_coords = _read_h5(save["jax"] / "features" / f"{name}.h5")
        np.testing.assert_array_equal(got_coords, want_coords)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_entry_point_raises_without_a_cuda_device(slide_tree, checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        efn.main(_reference_argv(slide_tree, slide_tree / "out", checkpoint))
