"""The slice as a whole: dataset evaluation and the patch command lines of the
port against the JAX package's, on the CPU.

One shared state dict (``tests/torch_oracle.py build_full_sd`` at the tiny
synthetic config, the semantic logits' bias raised so that components
propose boxes) is saved as a reference-named ``.pth``: the port's command
lines load it through ``init_detector``; the JAX tools get an engine made
from it by the converter's key map (shapes by ``eval_shape``, f32,
``exact_rois=True``) in place of their ``init_detector``, and run under full
f32 matmul precision. The dataset is a synthetic PanNuke release of four
256² tiles (``tools.synthetic.synthetic_pannuke``) converted by the port's
``preprocess_pannuke``.

- ``tools.test`` against tools/test.py with the same arguments (batches of 2,
  ``save=True format=pannuke``, ``--show-dir``, ``--work-dir``, ``--out``):
  the detections of every image one to one (scores and class probabilities
  1e-4, boxes 1e-3 px, masks equal but for at most 3 pixels a detection at
  threshold ties), the metrics within 1e-6, and the same file tree (names,
  json keys, array shapes and dtypes); ``run_dataset`` is the loop both
  run.
- ``tools.infer``, ``tools.infer_patch``, ``tools.image_demo`` and
  ``tools.feat_map`` (maps with ``--vis``, ``--pooled``, dataset mode) against
  their JAX tools: the same files, keys, shapes and dtypes, detections one to
  one, feature maps within 1e-4; ``infer_patch`` keeps an image column's text.
- Each command line raises without CUDA when ``--device`` is not given.
- ``utils.visualize.apply_viridis`` is ``cv2.applyColorMap(…,
  COLORMAP_VIRIDIS)`` exactly.
"""

import csv
import json
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from nuhtc_tpu_torch.apis.inference import init_detector
from nuhtc_tpu_torch.data.coco import build_dataset
from nuhtc_tpu_torch.ops import rle
from nuhtc_tpu_torch.tools import feat_map, image_demo, infer, infer_patch, preprocess_pannuke
from nuhtc_tpu_torch.tools import test as test_tool
from nuhtc_tpu_torch.tools.synthetic import synthetic_pannuke
from nuhtc_tpu_torch.utils.imageio import read_image
from nuhtc_tpu_torch.utils.visualize import VIRIDIS_U8, apply_viridis
from test_torch_dataset import run_jax_tool
from torch_oracle import OracleArch, build_full_sd, match_detections
from torch_port_util import f32
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_tiny_synthetic.py")
ARCH = OracleArch(embed_dims=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), fpn_c=32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The checkpoint, the JAX engine made from it, and the dataset tree."""
    import jax
    import jax.numpy as jnp

    from nuhtc_tpu.apis.inference import InferenceEngine as JaxEngine
    from nuhtc_tpu.config import Config as JaxConfig
    from nuhtc_tpu.models.build import build_detector as jax_build
    from torch_oracle import apply_sd

    root = tmp_path_factory.mktemp("slice")
    sd = build_full_sd(np.random.RandomState(0), ARCH)
    sd["roi_head.semantic_head.conv_logits.bias"] += 2.0  # so components propose boxes
    ckpt = str(root / "tiny.pth")
    torch.save({"state_dict": sd}, ckpt)
    cfg = JaxConfig.fromfile(CFG)
    model = jax_build(cfg.model, cfg.model.get("test_cfg"), 1.0,
                      dtype=jnp.float32).clone(exact_rois=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), method="init_forward"))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jax_engine = JaxEngine(model, apply_sd(sd, template), batch_size=2, tile_size=256,
                           scale_factor=1.0)

    images, masks, types = synthetic_pannuke(np.random.RandomState(0), 4)
    for name, arr in (("images", images), ("masks", masks), ("types", types)):
        np.save(root / f"{name}.npy", arr)
    assert preprocess_pannuke.main([
        "--images", str(root / "images.npy"), "--masks", str(root / "masks.npy"),
        "--types", str(root / "types.npy"), "--fold", "3", "--out-dir", str(root / "datasets"),
        "--coco-dir", str(root / "coco")]) == 0
    data = ["data.test.ann_file=" + str(root / "coco" / "PanNuke_annt_RLE_fold3.json"),
            "data.test.img_prefix=" + str(root / "datasets" / "rgb"),
            "data.test.seg_prefix=" + str(root / "datasets" / "rgb_seg")]
    return dict(root=root, ckpt=ckpt, jax_engine=jax_engine, cfg_options=data,
                rgb=root / "datasets" / "rgb")


def run_jax(world, script, argv):
    """The JAX tool through its ``main``, with the shared engine in place of
    its ``init_detector`` and f32 products."""
    mp = pytest.MonkeyPatch()
    mp.setattr("nuhtc_tpu.apis.init_detector", lambda *a, **k: world["jax_engine"])
    try:
        with f32():
            return run_jax_tool(mp, script, argv)
    finally:
        mp.undo()


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def as_detections(result):
    """A result tuple → dict of boxes, scores, labels, masks."""
    bboxes, segms = result
    boxes = np.concatenate(bboxes) if bboxes else np.zeros((0, 5), np.float32)
    labels = np.concatenate([np.full(len(b), c) for c, b in enumerate(bboxes)])
    masks = [rle.decode(r) for s in segms for r in s]
    return dict(boxes=boxes[:, :4], scores=boxes[:, 4], labels=labels,
                masks=np.stack(masks) if masks else np.zeros((0, 256, 256), np.uint8))


def assert_one_to_one(got, want, probs=False):
    pairs, un_got, un_want = match_detections(got, want, iou_thr=0.5)
    assert len(un_got) == 0 and len(un_want) == 0, (len(un_got), len(un_want))
    gi = np.asarray([p[0] for p in pairs], int)
    wi = np.asarray([p[1] for p in pairs], int)
    np.testing.assert_allclose(got["scores"][gi], want["scores"][wi], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["boxes"][gi], want["boxes"][wi], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got["labels"][gi], want["labels"][wi])
    if probs:
        np.testing.assert_allclose(got["probs"][gi], want["probs"][wi], atol=1e-4, rtol=0)
    if "masks" in want and len(gi):
        flips = (got["masks"][gi] != want["masks"][wi]).reshape(len(gi), -1).sum(1)
        assert flips.max(initial=0) <= 3, flips.max()
    return len(gi)


@pytest.fixture(scope="module")
def eval_runs(world):
    """tools/test.py and ``tools.test`` with the same arguments: {pkg: dir}."""
    out = {}
    for pkg in ("jax", "port"):
        d = world["root"] / f"eval_{pkg}"
        argv = [CFG, world["ckpt"], "--batch-size", "2", "--eval-options", "save=True",
                "format=pannuke", "--show-dir", str(d / "show"), "--work-dir", str(d / "work"),
                "--out", str(d / "raw.pkl"), "--cfg-options", *world["cfg_options"]]
        os.makedirs(d)
        if pkg == "jax":
            run_jax(world, "test.py", argv)
        else:
            assert test_tool.main(argv + ["--device", "cpu"]) == 0
        out[pkg] = d
    return out


def test_eval_slice_matches_jax(eval_runs):
    """Detections one to one, image by image, and the metrics within 1e-6."""
    raw = {pkg: pickle.load(open(d / "raw.pkl", "rb")) for pkg, d in eval_runs.items()}
    assert len(raw["port"]) == len(raw["jax"]) == 4
    n = 0
    for got, want in zip(raw["port"], raw["jax"]):
        assert [b.dtype for b in got[0]] == [b.dtype for b in want[0]] == [np.float32] * 5
        n += assert_one_to_one(as_detections(got), as_detections(want))
    assert n >= 100
    metrics = {pkg: json.load(open(d / "work" / "eval_metrics.json"))
               for pkg, d in eval_runs.items()}
    assert list(metrics["port"]) == list(metrics["jax"])
    for k, v in metrics["jax"].items():
        np.testing.assert_allclose(np.asarray(metrics["port"][k], float), np.asarray(v, float),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_eval_cli_tree_matches_jax(eval_runs):
    files = {pkg: tree(d) for pkg, d in eval_runs.items()}
    assert files["port"] == files["jax"]
    show = "show/PanNukeCocoDataset/"
    assert {f for f in files["port"] if f.startswith(show + "overlay/")} == {
        f"{show}overlay/fold3_{i}_overlay.png" for i in range(4)}
    for f in files["port"]:
        a, b = eval_runs["port"] / f, eval_runs["jax"] / f
        if f.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == y.shape
        elif f.endswith(".png"):
            assert read_image(str(a)).shape == cv2.imread(str(b)).shape
    assert np.load(eval_runs["port"] / show / "preds_pannuke.npy").shape == (4, 256, 256, 6)


def test_run_dataset_is_the_loop_of_the_command_line(world, eval_runs):
    engine = init_detector(CFG, world["ckpt"], batch_size=2, device="cpu")
    dataset = build_dataset(dict(
        type="PanNukeCocoDataset", test_mode=True,
        **{o.split("=")[0].split(".")[-1]: o.split("=", 1)[1] for o in world["cfg_options"]}))
    timing = {}
    results = test_tool.run_dataset(engine, dataset, 2, limit=3, timing=timing)
    want = pickle.load(open(eval_runs["port"] / "raw.pkl", "rb"))[:3]
    assert len(results) == 3 and set(timing) == set(test_tool.TIMING_KEYS)
    for (gb, gs), (wb, ws) in zip(results, want):
        for x, y in zip(gb, wb):
            np.testing.assert_array_equal(x, y)
        assert gs == ws


@pytest.mark.parametrize("tool", ["test", "train"])
def test_launcher_offers_none_and_pytorch(tool):
    """``--launcher`` takes the reference's "none" (the default) and
    "pytorch" (data-parallel over torchrun's processes); the JAX scripts'
    "jax" is theirs alone."""
    from nuhtc_tpu_torch.tools import train as train_tool

    parse = {"test": test_tool, "train": train_tool}[tool].parse_args
    assert parse([CFG]).launcher == "none"
    assert parse([CFG, "--launcher", "pytorch"]).launcher == "pytorch"
    with pytest.raises(SystemExit):
        parse([CFG, "--launcher", "jax"])


def _json_dets(path):
    dets = json.load(open(path))
    return dict(boxes=np.asarray([d["bbox"] for d in dets]).reshape(-1, 4),
                scores=np.asarray([d["score"] for d in dets]),
                labels=np.asarray([d["label"] for d in dets]),
                probs=np.asarray([d["prob"] for d in dets]),
                masks=np.stack([rle.decode(d["segmentation"]) for d in dets])), dets


def test_infer_matches_jax(world, tmp_path):
    args = [str(world["rgb"]), CFG, world["ckpt"], "--batch-size", "2", "--save-json"]
    run_jax(world, "infer.py", args + ["--out", str(tmp_path / "jax")])
    assert infer.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    files = tree(tmp_path / "port")
    assert files == tree(tmp_path / "jax") and len(files) == 8
    for f in files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".json"):
            (got, gd), (want, wd) = _json_dets(a), _json_dets(b)
            assert [list(d) for d in gd] == [list(d) for d in wd]
            assert assert_one_to_one(got, want, probs=True) > 10
        else:
            assert read_image(str(a)).shape == cv2.imread(str(b)).shape == (256, 256, 3)


def _coco_dets(doc, image_id):
    anns = [a for a in doc["annotations"] if a["image_id"] == image_id]
    bb = np.asarray([a["bbox"] for a in anns], float).reshape(-1, 4)
    return dict(boxes=np.concatenate([bb[:, :2], bb[:, :2] + bb[:, 2:]], 1),
                scores=np.asarray([a["score"] for a in anns]),
                labels=np.asarray([a["category_id"] for a in anns]),
                masks=np.stack([rle.decode(a["segmentation"]) for a in anns])
                if anns else np.zeros((0, 256, 256), np.uint8))


def test_infer_patch_matches_jax(world, tmp_path):
    names = sorted(os.listdir(world["rgb"]))
    with open(tmp_path / "list.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["slide", "image_path"])
        w.writerows([[i, n] for i, n in enumerate(names)])
    args = [str(tmp_path / "list.csv"), CFG, world["ckpt"], "--img-root", str(world["rgb"]),
            "--batch-size", "2", "--mag", "80", "--score-thr", "0.2", "--vis-samples", "3"]
    run_jax(world, "infer_patch.py", args + ["--out", str(tmp_path / "jax.json"),
                                             "--vis-dir", str(tmp_path / "vis_jax")])
    assert infer_patch.main(args + ["--out", str(tmp_path / "port.json"), "--vis-dir",
                                    str(tmp_path / "vis_port"), "--device", "cpu"]) == 0
    got, want = json.load(open(tmp_path / "port.json")), json.load(open(tmp_path / "jax.json"))
    assert list(got) == list(want) and got["images"] == want["images"]
    assert got["categories"] == want["categories"]
    assert [list(a) for a in got["annotations"]] == [list(a) for a in want["annotations"]]
    n = sum(assert_one_to_one(_coco_dets(got, i), _coco_dets(want, i)) for i in range(4))
    assert n == len(got["annotations"]) == len(want["annotations"]) > 5
    assert all(a["score"] >= 0.2 for a in got["annotations"])
    assert tree(tmp_path / "vis_port") == tree(tmp_path / "vis_jax") == [
        f"{k:04d}_{n}" for k, n in enumerate(names[:3])]


def test_infer_patch_keeps_the_image_column_as_text(world, tmp_path):
    """A cell such as ``0001`` names a file: it stays text (pandas would read
    the integer 1)."""
    shutil.copy(world["rgb"] / "fold3_0.png", tmp_path / "0001")
    with open(tmp_path / "list.csv", "w") as f:
        f.write("image\n0001\nmissing.png\n")
    assert infer_patch.main([str(tmp_path / "list.csv"), CFG, world["ckpt"], "--img-root",
                             str(tmp_path), "--out", str(tmp_path / "out.json"), "--mag", "80",
                             "--batch-size", "2", "--device", "cpu"]) == 0
    doc = json.load(open(tmp_path / "out.json"))
    assert doc["images"] == [dict(id=0, file_name="0001", height=256, width=256)]


def test_image_demo_matches_jax(world, tmp_path):
    src = tmp_path / "imgs"
    src.mkdir()
    for name in ("fold3_1.png", "fold3_2.png"):
        shutil.copy(world["rgb"] / name, src / name)
    args = [str(src / "*.png"), CFG, world["ckpt"], "--score-thr", "0.15"]
    run_jax(world, "image_demo.py", args + ["--output", str(tmp_path / "jax")])
    assert image_demo.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    files = tree(tmp_path / "port")
    assert files == tree(tmp_path / "jax") == ["fold3_1.json", "fold3_1_demo.png",
                                               "fold3_2.json", "fold3_2_demo.png"]
    for f in files[::2]:
        got, want = (json.load(open(tmp_path / d / f)) for d in ("port", "jax"))
        assert list(got) == list(want) == ["boxes", "scores", "labels"]
        as_dict = lambda d: dict(boxes=np.asarray(d["boxes"]).reshape(-1, 4),  # noqa: E731
                                 scores=np.asarray(d["scores"]), labels=np.asarray(d["labels"]))
        assert assert_one_to_one(as_dict(got), as_dict(want)) >= 3


def test_feat_map_matches_jax(world, tmp_path):
    src = tmp_path / "imgs"
    src.mkdir()
    for name in ("fold3_0.png", "fold3_3.png"):
        shutil.copy(world["rgb"] / name, src / name)
    runs = {
        "maps": ([str(src), CFG, world["ckpt"], "--vis"], 2 * (1 + 4)),
        "pooled": ([str(src / "fold3_0.png"), CFG, world["ckpt"], "--pooled", "--name", "p"], 1),
        "dataset": (["--config", CFG, "--checkpoint", world["ckpt"], "--batch-size", "2",
                     "--cfg-options", *world["cfg_options"]], 4),
    }
    for mode, (args, n_files) in runs.items():
        run_jax(world, "feat_map.py", args + ["--out", str(tmp_path / "jax" / mode)])
        assert feat_map.main(args + ["--out", str(tmp_path / "port" / mode),
                                     "--device", "cpu"]) == 0
        files = tree(tmp_path / "port" / mode)
        assert files == tree(tmp_path / "jax" / mode) and len(files) == n_files
        for f in files:
            a, b = tmp_path / "port" / mode / f, tmp_path / "jax" / mode / f
            if f.endswith(".npz"):
                x, y = np.load(a), np.load(b)
                assert sorted(x) == sorted(y) == [f"level{i}" for i in range(4)]
                for k in y:
                    assert x[k].dtype == y[k].dtype == np.float32 and x[k].shape == y[k].shape
                    np.testing.assert_allclose(x[k], y[k], rtol=0, atol=1e-4)
                assert x["level0"].shape == (64, 64, 32)
            elif f.endswith(".npy"):
                x, y = np.load(a), np.load(b)
                assert x.dtype == y.dtype == np.float32 and x.shape == y.shape == (128,)
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-4)
            else:  # the viridis PNG: the same colours up to a level of the mean
                x, y = read_image(str(a)), cv2.imread(str(b))[..., ::-1]
                assert x.shape == y.shape
                level = lambda im: np.abs(  # noqa: E731
                    VIRIDIS_U8[None, None].astype(int) - im[:, :, None].astype(int)
                ).sum(-1).argmin(-1)
                assert np.abs(level(x) - level(y)).max() <= 1


def test_apply_viridis_is_opencv():
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(apply_viridis(ramp),
                                  cv2.applyColorMap(ramp, cv2.COLORMAP_VIRIDIS)[..., ::-1])
    with pytest.raises(ValueError):
        apply_viridis(ramp.astype(np.float32))


@pytest.mark.parametrize("tool,argv", [
    (test_tool, [CFG]),
    (infer, ["imgs", CFG]),
    (infer_patch, ["list.csv", CFG]),
    (image_demo, ["img.png", CFG]),
    (feat_map, ["imgs", CFG]),
])
def test_command_lines_raise_without_cuda(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
