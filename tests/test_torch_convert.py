"""Weights and imports of the PyTorch port.

(a) ``state_dict_from_jax`` inverts the torch → flax converter bit for bit,
    and its output loads into the port's detector with strict key checking.
(b) Importing every port module and running a tiny CPU forward imports
    neither jax nor flax nor anything of the JAX package ``nuhtc_tpu``, and
    no source file of the port names such an import.
(c) ``init_detector`` takes the CPU only when asked for it.
"""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nuhtc_tpu.models.detector import NuHTC as JaxNuHTC
from nuhtc_tpu.utils.checkpoint import convert_torch_state_dict, map_torch_key
from nuhtc_tpu_torch.models.detector import NuHTC
from nuhtc_tpu_torch.utils.convert import state_dict_from_jax, torch_key
from torch_oracle import OracleArch, build_full_sd
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = dict(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8))


@pytest.fixture(scope="module")
def converted():
    model = JaxNuHTC(num_classes=5, fpn_channels=16, backbone_cfg=BACKBONE)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    arch = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=16)
    sd = build_full_sd(np.random.RandomState(0), arch)
    params, info = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, template)
    assert not info["unmatched_torch"] and not info["uninitialized"]
    return sd, params


def test_state_dict_from_jax_round_trips(converted):
    sd, params = converted
    back = state_dict_from_jax(params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_port_keys_invert_map_torch_key(converted):
    """Every port key maps back, through map_torch_key, to its flax path."""
    _, params = converted

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,)

    for path in walk(params["params"]):
        key, _ = torch_key(path)
        assert map_torch_key(key)[0] == path, (key, path)


def test_state_dict_loads_strictly(converted):
    sd, params = converted
    model = NuHTC(num_classes=5, fpn_channels=16, backbone_cfg=BACKBONE)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert set(model.state_dict()) == set(sd)


def test_init_detector_loads_reference_pth(tmp_path):
    """A reference-format .pth (mmdet names, with the buffers the reference
    also stores) loads through init_detector without conversion."""
    from nuhtc_tpu_torch.apis.inference import init_detector

    arch = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)
    sd = build_full_sd(np.random.RandomState(1), arch)
    stored = dict(sd)
    stored["backbone.stages.0.blocks.0.attn.w_msa.relative_position_index"] = torch.zeros(
        49, 49, dtype=torch.long)
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": stored}, path)
    engine = init_detector(os.path.join(REPO, "configs/nuhtc/htc_lite_tiny_synthetic.py"),
                           str(path), batch_size=1, tile_size=64, device="cpu")
    loaded = engine.model.state_dict()
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k


def test_reference_pth_in_module_list_form_loads_as_jax_loads_it(converted, tmp_path, capsys):
    """A real HTC .pth stores the lite mask head as ``roi_head.mask_head.0.*``
    and SeesawLoss's ``cum_samples`` buffer: the port loads the first into
    its one head and skips the second, counted, as the JAX loader does."""
    from nuhtc_tpu_torch.apis.inference import load_reference_checkpoint

    sd, params = converted
    stored = {k.replace("roi_head.mask_head.", "roi_head.mask_head.0."): v for k, v in sd.items()}
    assert sum(k.startswith("roi_head.mask_head.0.") for k in stored) > 4
    stored["roi_head.bbox_head.0.loss_cls.cum_samples"] = torch.arange(6, dtype=torch.float32)
    path = tmp_path / "htc.pth"
    torch.save({"state_dict": stored}, path)
    model = NuHTC(num_classes=5, fpn_channels=16, backbone_cfg=BACKBONE)
    unmatched = load_reference_checkpoint(model, str(path))
    assert unmatched == ["roi_head.bbox_head.0.loss_cls.cum_samples"]
    assert "[init_detector] 1 torch keys unmatched" in capsys.readouterr().out
    jax_params, info = convert_torch_state_dict({k: v.numpy() for k, v in stored.items()}, params)
    assert info["unmatched_torch"] == unmatched
    want, got = state_dict_from_jax(jax_params), model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fault,match", [("missing", "missing key"), ("shape", "shape mismatch")])
def test_reference_pth_without_a_port_key_or_of_another_shape_raises(converted, tmp_path,
                                                                     fault, match):
    from nuhtc_tpu_torch.apis.inference import load_reference_checkpoint

    sd, _ = converted
    stored = dict(sd)
    key = "neck.fpn_convs.0.conv.weight"
    if fault == "missing":
        del stored[key]
    else:
        stored[key] = torch.zeros(1, *sd[key].shape[1:])
    path = tmp_path / "bad.pth"
    torch.save(stored, path)
    with pytest.raises((RuntimeError, ValueError), match=match):
        load_reference_checkpoint(NuHTC(num_classes=5, fpn_channels=16, backbone_cfg=BACKBONE),
                                  str(path))


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import pkgutil, sys
        before = set(sys.modules)
        import numpy as np, torch
        import nuhtc_tpu_torch
        for m in pkgutil.walk_packages(nuhtc_tpu_torch.__path__, "nuhtc_tpu_torch."):
            __import__(m.name)
        from nuhtc_tpu_torch.apis.inference import init_detector
        eng = init_detector("configs/nuhtc/htc_lite_tiny_synthetic.py", None, batch_size=1,
                            tile_size=64, device="cpu")
        res = eng.run_batch([np.full((64, 64, 3), 200, np.uint8)])
        assert len(res) == 1
        # one train step on the CPU: collate, compute_losses, AdamW + EMA
        from nuhtc_tpu_torch.data.loader import collate_train
        from nuhtc_tpu_torch.train.train_state import create_train_state, make_train_step
        model = eng.model.float()
        masks = np.zeros((2, 64, 64), np.uint8)
        masks[0, 10:20, 12:24] = 1
        masks[1, 30:44, 40:52] = 1
        sample = dict(img=np.random.RandomState(0).randn(64, 64, 3).astype(np.float32),
                      gt_bboxes=np.float32([[12, 10, 24, 20], [40, 30, 52, 44]]),
                      gt_labels=np.int64([1, 3]), gt_masks=masks,
                      gt_semantic_seg=masks.max(0)[::4, ::4])
        batch = {k: torch.from_numpy(v) for k, v in collate_train([sample, sample]).items()}
        state, tx = create_train_state(model)
        state, metrics = make_train_step(model, tx)(state, batch, torch.Generator())
        assert state.step == 1 and np.isfinite(float(metrics["total"]))
        new = set(sys.modules) - before
        assert "nuhtc_tpu_torch.config.config" in new
        walked = ("wsi.slide", "wsi.tissue", "wsi.stitch", "wsi.export", "wsi.infer",
                  "ops.contours", "ops.imgproc", "utils.imageio", "tools.infer_wsi",
                  "data.classes", "wsi.merge", "wsi.stain", "wsi.features", "wsi.heatmap",
                  "tools.nuclei_merge", "tools.wsi_feat_extract", "tools.nuclei_feat_extract",
                  "tools.extract_features_nuhtc", "utils.tables", "registry", "data.coco",
                  "data.loader", "eval.stats", "eval.evaluate", "eval.coco_map", "eval.nucls",
                  "eval.interrater", "utils.visualize", "tools.test", "tools.preprocess_pannuke",
                  "tools.infer", "tools.infer_patch", "tools.image_demo", "tools.feat_map",
                  "data.pipelines", "tools.dataset.convert_format",
                  "tools.analysis_tools.test_robustness", "tools.analysis_tools.viz_utils",
                  "tools.analysis_tools.pannuke.compute_stats_all",
                  "tools.analysis_tools.conic.compute_stats",
                  "tools.analysis_tools.conic.misc.patch_extractor",
                  "tools.analysis_tools.consep.compute_stats",
                  "tools.analysis_tools.coco_error_analysis",
                  "tools.analysis_tools.print_metric", "models.losses", "train.targets",
                  "train.samplers", "train.train_state", "train.optim_groups", "train.trainer",
                  "utils.checkpoint", "utils.hooks", "utils.logging", "apis.train",
                  "tools.train", "ops.watershed", "models.extra_heads")
        missing = [m for m in walked if "nuhtc_tpu_torch." + m not in new]
        assert not missing, missing
        bad = sorted(m for m in new
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                            "nuhtc_tpu", "cv2", "pandas",
                                            "skimage", "shapely", "h5py", "PIL", "matplotlib",
                                            "sklearn", "pycocotools"))
        print("IMPORTED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "IMPORTED []" in res.stdout


def test_port_sources_name_no_jax_package_import():
    """No file of the port nor chip_smoke.py imports jax, flax or anything of
    ``nuhtc_tpu`` (``nuhtc_tpu_torch`` is another name: the pattern ends the
    word)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|nuhtc_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "nuhtc_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [os.path.relpath(f, REPO) for f in files if pat.search(open(f).read())]
    assert not bad, bad
    assert pat.search("from nuhtc_tpu.config import Config")
    assert pat.search("    import nuhtc_tpu") and pat.search("from nuhtc_tpu import x")
    assert not pat.search("from nuhtc_tpu_torch.config import Config")


def test_port_sources_name_no_opencv_or_pandas_import():
    """The port's host code stands without OpenCV, pandas, scikit-image,
    shapely, scikit-learn and pycocotools: no file of it, nor chip_smoke.py,
    names such an import. h5py, PIL and matplotlib are named only inside the
    function that needs them (indented)."""
    pat = re.compile(r"^\s*(import|from)\s+(cv2|pandas|skimage|shapely|sklearn|pycocotools)"
                     r"(\.|\s|$)", re.M)
    lazy = re.compile(r"^(import|from)\s+(h5py|PIL|matplotlib)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "nuhtc_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert any(f.endswith(os.path.join("wsi", "infer.py")) for f in files)
    assert any(f.endswith(os.path.join("consep", "compute_stats.py")) for f in files)
    assert any(f.endswith(os.path.join("dataset", "convert_format.py")) for f in files)
    assert any(f.endswith(os.path.join("ops", "watershed.py")) for f in files)
    assert any(f.endswith(os.path.join("models", "extra_heads.py")) for f in files)
    sources = {os.path.relpath(f, REPO): open(f).read() for f in files}
    assert not [f for f, text in sources.items() if pat.search(text)]
    assert not [f for f, text in sources.items() if lazy.search(text)]
    assert pat.search("import cv2") and pat.search("    from pandas import DataFrame")
    assert lazy.search("import h5py") and not lazy.search("        import h5py")
    assert lazy.search("import matplotlib.pyplot as plt")
    assert not pat.search("# as cv2 does") and not pat.search("import cv2_free")
    assert pat.search("from sklearn.metrics import roc_auc_score")
    assert pat.search("    from pycocotools.cocoeval import COCOeval")


def test_init_detector_takes_the_cpu_only_when_asked(monkeypatch):
    from nuhtc_tpu_torch.apis import inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "configs/nuhtc/htc_lite_tiny_synthetic.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.init_detector(config, None, batch_size=1, tile_size=64)
    engine = inference.init_detector(config, None, batch_size=1, tile_size=64, device="cpu")
    assert engine.device.type == "cpu" and engine.dtype == torch.float32
    assert not engine.device_preprocess and not engine.compact_masks  # the JAX defaults
