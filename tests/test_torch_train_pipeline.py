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
- ``instance_patches``, ``collate_train``, ``sample_train_valid`` and the
  first batches of ``PrefetchLoader`` (class-aware sampling, two threads,
  seed 0): exactly equal arrays.
"""

import copy

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
from nuhtc_tpu_torch.tools.synthetic import synthetic_pannuke

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
]


@pytest.mark.parametrize("cfg", TRANSFORMS, ids=lambda c: (
    "+".join(t["type"] for t in c) if isinstance(c, list) else c["type"]))
def test_each_transform_equals_jax(release, cfg):
    jds, ds = release
    cfgs = cfg if isinstance(cfg, list) else [cfg]
    jpipe = jp.build_train_pipeline(copy.deepcopy(cfgs))
    pipe = tp.build_train_pipeline(copy.deepcopy(cfgs))
    for seed in range(6):
        base = _results(ds, seed % len(ds))
        jr, r = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jp.run_pipeline(jpipe, copy.deepcopy(base), jr)
        got = tp.run_pipeline(pipe, copy.deepcopy(base), r)
        _assert_results_equal(got, want)
        assert jr.randint(1 << 30) == r.randint(1 << 30)


def test_pannuke_train_pipeline_equals_jax(release):
    jds, ds = release
    jpipe = jp.build_train_pipeline(JConfig.fromfile(PANNUKE).train_pipeline)
    pipe = tp.build_train_pipeline(Config.fromfile(PANNUKE).train_pipeline)
    assert [type(t).__name__ for t in pipe] == [type(t).__name__ for t in jpipe]
    warped = 0
    for seed in range(8):
        base = _results(ds, seed % len(ds))
        jr, r = np.random.RandomState(100 + seed), np.random.RandomState(100 + seed)
        want = jp.run_pipeline(jpipe, copy.deepcopy(base), jr)
        got = tp.run_pipeline(pipe, copy.deepcopy(base), r)
        _assert_results_equal(got, want)
        assert got["img"].shape == (512, 512, 3) and got["gt_semantic_seg"].shape == (128, 128)
        warped += len(got["gt_bboxes"]) != len(base["gt_bboxes"]) or not np.array_equal(
            got["gt_bboxes"], base["gt_bboxes"] * 2)
    assert warped >= 4


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


def test_prefetch_loader_batches_equal_jax(release):
    jds, ds = release
    jpipe = jp.build_train_pipeline(JConfig.fromfile(PANNUKE).train_pipeline)
    pipe = tp.build_train_pipeline(Config.fromfile(PANNUKE).train_pipeline)
    jl = j_loader.PrefetchLoader(jds, jpipe, batch_size=2, seed=0)
    pl = loader.PrefetchLoader(ds, pipe, batch_size=2, seed=0)
    assert pl.class_aware
    try:
        for want, got in zip([b for _, b in zip(range(2), jl)], [b for _, b in zip(range(2), pl)]):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # batch k is built from RandomState(seed + k), whatever thread built it
        again = pl.make_batch(1)
        for k in want:
            np.testing.assert_array_equal(again[k], got[k], err_msg=k)
    finally:
        jl.close()
        pl.close()
