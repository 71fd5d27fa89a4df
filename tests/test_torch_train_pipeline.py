"""The port's train pipeline, collation and loader against ``nuhtc_tpu``'s.

On a synthetic PanNuke release (``tools.synthetic.synthetic_pannuke``,
seed 3, four 256² tiles, converted by ``tools.preprocess_pannuke``), read by
both packages' datasets:

- every train transform the shipped configs use, alone and as the PanNuke
  config's whole ``train_pipeline``, with one ``np.random.RandomState``
  seed on each side: exactly equal images, boxes, labels, masks and
  semantic maps, and the two random states equal afterwards (the same
  draws). The OpenCV calls of the JAX transforms are the port's numpy
  versions, equal to cv2 5.0.0 (``warpAffine`` bilinear on float32 RGB at
  width 512 and nearest on uint8 with a border value, ``resize`` bilinear on
  float32 RGB and on the mask crops, HSV both ways). ``RandCorrupt`` alone
  takes the catalog without ``jpeg_compression`` (Pillow's codec in the
  port, OpenCV's in the JAX package) and ``snow`` (a float32 DFT filter at
  severities 4-5), whose bounds tests/test_torch_corruptions.py states; the
  config's ``RandCorrupt`` draws severity 1 of every type, and its images
  are compared exactly too;
- the rest of the JAX module's transforms, which no shipped config uses: the
  color ops (``AutoContrast``, ``RandEqualize``, ``RandSolarize`` with a
  scalar threshold, which draws uniform(0, threshold), and with one per
  channel, ``RandColor``, ``RandBrightness``, ``RandContrast``,
  ``RandSharpness``), ``RandErase``, ``Resize_Scale``, ``SmartResize``
  exactly, and both views of a ``MultiBranch``. Their OpenCV calls are
  ``equalizeHist`` and the float32 3×3 ``GaussianBlur`` of sigma 0, whose
  numpy versions equal cv2 5.0.0 (the latter's taps are 1/4, 1/2, 1/4, so
  its products are exact and its sums the same in any form);
- the crops (``RandomCrop``, ``CusRandomCrop``, ``FOVCrop``) on samples with
  a field of view and masks for a prefix of the boxes, None on both sides
  where no box is left; the ``train_pipeline`` of every other config that
  has one, on two seeded samples;
- ``instance_patches``, ``collate_train``, ``sample_train_valid`` and the
  first batches of ``PrefetchLoader`` (class-aware sampling, two threads,
  seed 0): exactly equal arrays, for the PanNuke, CoNIC and NuCLS pipelines
  (NuCLS on a release of its own schema with fields of view).
"""

import copy
import os
import pathlib

import numpy as np
import pytest

from nuhtc_tpu.config import Config as JConfig
from nuhtc_tpu.data import build_dataset as j_build_dataset
from nuhtc_tpu.data import loader as j_loader
from nuhtc_tpu.data import pipelines as jp
from nuhtc_tpu_torch.config import Config
from nuhtc_tpu_torch.data import loader
from nuhtc_tpu_torch.data import pipelines as tp
from nuhtc_tpu_torch.data.coco import build_dataset
from nuhtc_tpu_torch.tools import preprocess_pannuke
from nuhtc_tpu_torch.tools.synthetic import synthetic_nucls, synthetic_pannuke
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

PANNUKE = "configs/nuhtc/htc_lite_swin_fpn_pannuke.py"
EXACT_CORRUPTIONS = [n for n in tp.CORRUPTIONS if n not in ("jpeg_compression", "snow")]


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    images, masks, types = synthetic_pannuke(np.random.RandomState(3), 4)
    for name, arr in (("images", images), ("masks", masks), ("types", types)):
        np.save(root / f"{name}.npy", arr)
    argv = ["--images", str(root / "images.npy"), "--masks", str(root / "masks.npy"),
            "--types", str(root / "types.npy"), "--fold", "1",
            "--out-dir", str(root / "datasets"), "--coco-dir", str(root / "coco")]
    assert preprocess_pannuke.main(argv) == 0
    cfg = dict(type="CASDataset", dataset=dict(
        type="PanNukeCocoDataset", ann_file=str(root / "coco" / "PanNuke_annt_RLE_fold1.json"),
        img_prefix=str(root / "datasets" / "rgb"), seg_prefix=str(root / "datasets" / "rgb_seg")))
    return j_build_dataset(copy.deepcopy(cfg)), build_dataset(copy.deepcopy(cfg))


def _results(ds, idx):
    """What prepare_train_sample hands the pipeline, before any transform."""
    inner = ds.dataset
    img = inner.load_image(idx).astype(np.float32)
    ann = inner.get_ann_info(idx)
    from nuhtc_tpu_torch.ops import rle

    masks = np.stack([rle.decode(m) for m in ann["masks"]])
    return dict(img=img, gt_bboxes=ann["bboxes"], gt_labels=ann["labels"], gt_masks=masks,
                gt_semantic_seg=inner.load_semantic(idx), ismask=ann.get("ismask"))


def _assert_results_equal(got, want):
    assert sorted(k for k in got if got[k] is not None) == \
        sorted(k for k in want if want[k] is not None)
    for k, w in want.items():
        if w is None or k == "img_info":
            continue
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


TRANSFORMS = [
    dict(type="PhotoMetricDistortion", brightness_delta=32, contrast_range=(0.5, 1.5),
         saturation_range=(0.5, 1.5), hue_delta=9),
    dict(type="Resize", img_scale=(512, 512), keep_ratio=True),
    dict(type="Resize", img_scale=(300, 200), keep_ratio=False),
    dict(type="RandomFlip", flip_ratio=0.9, direction=["horizontal", "vertical", "diagonal"]),
    dict(type="RandTranslate", x=(-0.1, 0.1), y=(-0.1, 0.1), seg_ignore_label=3),
    dict(type="RandRotate", angle=(-10, 10), seg_ignore_label=0),
    [dict(type="RandShear", x=(-10, 10)), dict(type="RandShear", y=(-10, 10))],
    [dict(type="RandRotate", angle=(-30, 30)), dict(type="RecomputeBox")],
    dict(type="ShuffledSequential", transforms=[dict(type="RandTranslate", x=(-0.2, 0.2)),
                                               dict(type="RandomFlip", flip_ratio=1.0)]),
    dict(type="RandCorrupt", prob=0.8, severity=(1, 5), corruption=EXACT_CORRUPTIONS),
    dict(type="RandPosterize", prob=0.8),
    [dict(type="Normalize"), dict(type="Pad", size_divisor=96),
     dict(type="SegRescale", scale_factor=0.25)],
    dict(type="RandomCrop", crop_size=(128, 128)),
    dict(type="CusRandomCrop", crop_size=(96, 300), allow_negative_crop="True"),
    dict(type="FOVCrop", allow_negative_crop="True"),
    [dict(type="FOVCrop"), dict(type="CusRandomCrop", crop_size=(256, 256))],
    dict(type="AutoContrast", prob=0.8),
    dict(type="RandEqualize", prob=0.8),
    dict(type="RandSolarize", prob=0.8, threshold=160),
    dict(type="RandSolarize", prob=0.8, threshold=(100, 128, 200)),
    dict(type="RandColor", prob=0.8, factor=(0.2, 1.8)),
    dict(type="RandBrightness", prob=0.8),
    dict(type="RandContrast", prob=0.8),
    dict(type="RandSharpness", prob=0.8),
    dict(type="RandErase", prob=0.9, size=(0.05, 0.3), squared=False),
    dict(type="Resize_Scale", scale_factor=1.5),
    dict(type="SmartResize", img_scale=(300, 200)),
]
CROPS = ("RandomCrop", "CusRandomCrop", "FOVCrop")


def _for_crops(r, seed):
    """A crop case's sample: a field of view in ``img_info`` (its far edges
    past the tile for the larger seeds); for odd seeds masks for all but the
    last three instances (``ismask`` 1 then 0, the NuCLS prefix); seed 5
    with every box in the tile's top-left 20² corner, which the field of view
    and most random crops miss."""
    r["img_info"] = dict(fovloc=[8 * seed + 30, 5 * seed + 20, 230 + 9 * seed, 250 + 3 * seed])
    n = len(r["gt_bboxes"])
    if seed % 2:
        r["gt_masks"] = r["gt_masks"][:n - 3]
        r["ismask"] = np.asarray([1] * (n - 3) + [0] * 3, np.int64)
    if seed == 5:
        r["gt_bboxes"] = np.tile(np.float32([[2, 3, 18, 20]]), (n, 1))
    return r


@pytest.mark.parametrize("cfg", TRANSFORMS, ids=lambda c: (
    "+".join(t["type"] for t in c) if isinstance(c, list) else c["type"]))
def test_each_transform_equals_jax(release, cfg):
    """The crops also: None on both sides where no box is left, and where
    negative crops are allowed ('True', a string, as the configs pass it)
    no box and the crop all the same."""
    jds, ds = release
    cfgs = cfg if isinstance(cfg, list) else [cfg]
    jpipe = jp.build_train_pipeline(copy.deepcopy(cfgs))
    pipe = tp.build_train_pipeline(copy.deepcopy(cfgs))
    crop = any(c["type"] in CROPS for c in cfgs)
    for seed in range(6):
        base = _results(ds, seed % len(ds))
        if crop:
            base = _for_crops(base, seed)
        jr, r = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jp.run_pipeline(jpipe, copy.deepcopy(base), jr)
        got = tp.run_pipeline(pipe, copy.deepcopy(base), r)
        if crop and seed == 5:
            negative = all(c.get("allow_negative_crop") == "True" for c in cfgs)
            assert (want is None) != negative
            assert negative or got is None
        if want is not None:
            _assert_results_equal(got, want)
        assert jr.randint(1 << 30) == r.randint(1 << 30)


def test_multi_branch_equals_jax(release):
    """Both views of a MultiBranch, drawn one after the other from one rng."""
    jds, ds = release
    cfg = [dict(type="MultiBranch",
                student=[dict(type="RandomFlip", flip_ratio=0.5), dict(type="RandErase", prob=0.9),
                         dict(type="RandSharpness", prob=0.9)],
                teacher=[dict(type="RandColor", prob=0.9), dict(type="RandEqualize", prob=0.5)])]
    jpipe = jp.build_train_pipeline(copy.deepcopy(cfg))
    pipe = tp.build_train_pipeline(copy.deepcopy(cfg))
    for seed in range(4):
        base = _results(ds, seed % len(ds))
        jr, r = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jp.run_pipeline(jpipe, copy.deepcopy(base), jr)
        got = tp.run_pipeline(pipe, copy.deepcopy(base), r)
        assert list(got) == list(want) == ["student", "teacher"]
        for name in want:
            _assert_results_equal(got[name], want[name])
        assert jr.randint(1 << 30) == r.randint(1 << 30)


def _config_pipelines_equal(ds, path, seeds, prepare=lambda r, seed: r):
    """The config's train_pipeline through both packages on seeded samples:
    equal outputs (None on both sides or equal arrays) and equal random
    states. Returns the outputs and their inputs."""
    jpipe = jp.build_train_pipeline(JConfig.fromfile(path).train_pipeline)
    pipe = tp.build_train_pipeline(Config.fromfile(path).train_pipeline)
    assert [type(t).__name__ for t in pipe] == [type(t).__name__ for t in jpipe]
    runs = []
    for seed in seeds:
        base = prepare(_results(ds, seed % len(ds)), seed)
        jr, r = np.random.RandomState(100 + seed), np.random.RandomState(100 + seed)
        want = jp.run_pipeline(jpipe, copy.deepcopy(base), jr)
        got = tp.run_pipeline(pipe, copy.deepcopy(base), r)
        assert (got is None) == (want is None)
        if want is not None:
            _assert_results_equal(got, want)
        assert jr.randint(1 << 30) == r.randint(1 << 30)
        runs.append((got, base))
    return runs


def test_pannuke_train_pipeline_equals_jax(release):
    jds, ds = release
    warped = 0
    for got, base in _config_pipelines_equal(ds, PANNUKE, range(8)):
        assert got["img"].shape == (512, 512, 3) and got["gt_semantic_seg"].shape == (128, 128)
        warped += len(got["gt_bboxes"]) != len(base["gt_bboxes"]) or not np.array_equal(
            got["gt_bboxes"], base["gt_bboxes"] * 2)
    assert warped >= 4


CONFIGS = sorted(p.name for p in pathlib.Path("configs/nuhtc").glob("*.py")
                 if "train_pipeline" in Config.fromfile(str(p)).to_dict())


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != os.path.basename(PANNUKE)])
def test_config_train_pipeline_equals_jax(release, name):
    """Every other config in configs/nuhtc/ that has a train_pipeline (the
    PanNuke one has the test above): two seeded samples, a field of view
    and partial masks as the crop cases have them (NuCLS's FOVCrop reads the
    one, its loader keeps the other), equal to the JAX package's."""
    jds, ds = release
    for got, base in _config_pipelines_equal(ds, f"configs/nuhtc/{name}", range(1, 3),
                                              _for_crops):
        assert got is not None and got["img"].shape[0] % 32 == 0


def test_every_config_with_a_train_pipeline_is_tested():
    assert len(CONFIGS) == 6 and "semi_base.py" not in CONFIGS


def test_instance_patches_and_collate_equal_jax(release):
    jds, ds = release
    pipe = tp.build_train_pipeline(Config.fromfile(PANNUKE).train_pipeline)
    samples = [tp.run_pipeline(pipe, _results(ds, i), np.random.RandomState(i))
               for i in range(3)]
    s0 = samples[0]
    np.testing.assert_array_equal(loader.instance_patches(s0["gt_masks"], s0["gt_bboxes"]),
                                  j_loader.instance_patches(s0["gt_masks"], s0["gt_bboxes"]))
    samples[2]["ismask"] = None
    samples[2]["gt_masks"] = samples[2]["gt_masks"][:-3]  # box-only trailing instances
    for max_gt in (160, 20):
        got = loader.collate_train(copy.deepcopy(samples), max_gt=max_gt)
        want = j_loader.collate_train(copy.deepcopy(samples), max_gt=max_gt)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if max_gt == 160:
            assert got["gt_ismask"][2].min() == 0.0 and got["gt_valid"].sum() > 20


def _loaders_equal(jds, ds, path, batches, again=True):
    """The first ``batches`` batches of both packages' PrefetchLoader (B2,
    seed 0, two threads) over the config's train_pipeline: equal arrays;
    with ``again``, the last one once more from ``make_batch``. Returns it."""
    jpipe = jp.build_train_pipeline(JConfig.fromfile(path).train_pipeline)
    pipe = tp.build_train_pipeline(Config.fromfile(path).train_pipeline)
    jl = j_loader.PrefetchLoader(jds, jpipe, batch_size=2, seed=0)
    pl = loader.PrefetchLoader(ds, pipe, batch_size=2, seed=0)
    assert pl.class_aware
    try:
        for want, got in zip([b for _, b in zip(range(batches), jl)],
                             [b for _, b in zip(range(batches), pl)]):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # batch k is built from RandomState(seed + k), whatever thread built it
        if again:
            rebuilt = pl.make_batch(batches - 1)
            for k in want:
                np.testing.assert_array_equal(rebuilt[k], got[k], err_msg=k)
    finally:
        jl.close()
        pl.close()
    return got


def test_prefetch_loader_batches_equal_jax(release):
    jds, ds = release
    _loaders_equal(jds, ds, PANNUKE, 2)


@pytest.fixture(scope="module")
def nucls_release(tmp_path_factory):
    """Four 256² tiles in the NuCLS schema (``synthetic_nucls``: eight
    classes, every other annotation box-only) with a field of view in each
    image record, read by both packages' datasets."""
    root = tmp_path_factory.mktemp("nucls")
    opts = synthetic_nucls(str(root), splits=(("train", 4),), seed=3, fovloc=True)
    cfg = dict(type="CASDataset", dataset=dict(
        type="NuCLSCocoDataset", ann_file=opts["data.train.sup.ann_file"],
        img_prefix=opts["data.train.sup.img_prefix"], seg_prefix=opts["data.train.sup.seg_prefix"]))
    return j_build_dataset(copy.deepcopy(cfg)), build_dataset(copy.deepcopy(cfg))


@pytest.mark.parametrize("name", ["conic", "nucls"])
def test_prefetch_loader_batches_equal_jax_with_crops(release, nucls_release, name):
    """CoNIC's RandomCrop on the PanNuke release; NuCLS's FOVCrop and
    CusRandomCrop on a NuCLS release whose images carry a field of view and
    whose annotations are half box-only (``gt_ismask`` 0 for those)."""
    jds, ds = nucls_release if name == "nucls" else release
    batch = _loaders_equal(jds, ds, f"configs/nuhtc/htc_lite_swin_fpn_{name}.py", 1, again=False)
    if name == "nucls":
        assert 0 < batch["gt_ismask"][batch["gt_valid"]].mean() < 1


def test_synthetic_nucls_fovloc_is_opt_in(tmp_path):
    """``fovloc=True`` adds a field of view inside the tile to each image
    record and changes nothing else: the files of the default call stay as
    they were."""
    import json

    paths = {}
    for fov in (False, True):
        opts = synthetic_nucls(str(tmp_path / str(fov)), splits=(("train", 2),), size=64,
                               fovloc=fov)
        paths[fov] = opts["data.train.sup.ann_file"]
    plain, fov = (json.load(open(paths[k])) for k in (False, True))
    assert all("fovloc" not in img for img in plain["images"])
    for img in fov["images"]:
        x1, y1, x2, y2 = img.pop("fovloc")
        assert 0 <= x1 < x2 <= 64 and 0 <= y1 < y2 <= 64
    assert fov == plain
    for name in sorted(os.listdir(tmp_path / "False" / "datasets" / "NuCLS" / "rgb")):
        a, b = (open(tmp_path / str(k) / "datasets" / "NuCLS" / "rgb" / name, "rb").read()
                for k in (False, True))
        assert a == b
