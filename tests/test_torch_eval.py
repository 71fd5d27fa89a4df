"""The port's metric suite against the JAX package's, exactly.

``nuhtc_tpu_torch.eval.{stats,coco_map,nucls,interrater}`` against
``nuhtc_tpu.eval.*`` on the same numpy inputs, made from a seed: random
instance label maps, their mask stacks and RLE lists, detection sets, rater
tables. Tolerance: none. Every value (tables, metrics, pairings, posteriors,
alphas, clusters) must be equal, NaN where JAX has NaN. The edge cases are
cases of their own: empty ground truth, empty predictions, both empty,
disjoint sets, and ``match_iou`` below 0.5 (Hungarian pairing).
"""

import numpy as np
import pytest

from nuhtc_tpu.eval import coco_map as j_map
from nuhtc_tpu.eval import interrater as j_ir
from nuhtc_tpu.eval import nucls as j_nucls
from nuhtc_tpu.eval import stats as j_stats
from nuhtc_tpu.ops import rle as j_rle
from nuhtc_tpu_torch.eval import coco_map, interrater, nucls, stats
from nuhtc_tpu_torch.ops import rle
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)


def label_map(rng, size, count, shift=(0, 0), holes=True):
    """An instance label map of ``count`` discs (later ones over earlier
    ones), ids in random order with gaps, shifted by ``shift``."""
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((size, size), np.int32)
    ids = rng.permutation(np.arange(1, 3 * count + 1))[:count]
    for i in range(count):
        cy, cx = rng.uniform(0, size, 2) + shift
        r = rng.uniform(2, size / 6)
        out[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = ids[i]
    if holes and count:
        out[rng.rand(size, size) < 0.02] = 0
    return out


def case(name, seed=0):
    """(true, pred) label maps of one named case."""
    rng = np.random.RandomState(seed)
    size = 48
    if name == "overlapping":
        true = label_map(rng, size, 9)
        pred = label_map(np.random.RandomState(seed), size, 9, shift=(1.5, -1.0))
        pred[label_map(rng, size, 4) > 0] = 0
        return true, pred
    if name == "random":
        return label_map(rng, size, 12), label_map(rng, size, 15)
    if name == "empty_gt":
        return np.zeros((size, size), np.int32), label_map(rng, size, 6)
    if name == "empty_pred":
        return label_map(rng, size, 6), np.zeros((size, size), np.int32)
    if name == "both_empty":
        return np.zeros((size, size), np.int32), np.zeros((size, size), np.int32)
    if name == "disjoint":
        true = label_map(rng, size, 5)
        pred = label_map(rng, size, 5)
        pred[true > 0] = 0
        return true, pred
    if name == "identical":
        true = label_map(rng, size, 8)
        return true, true.copy()
    raise KeyError(name)


CASES = ["overlapping", "random", "empty_gt", "empty_pred", "both_empty", "disjoint",
         "identical"]


def stacks(lab):
    ids = [i for i in np.unique(lab) if i]
    return np.stack([(lab == i).astype(np.uint8) for i in ids]) if ids else np.zeros(
        (0,) + lab.shape, np.uint8)


def assert_same(got, want):
    """Equal values, recursively through dicts, lists and tuples; NaN = NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", CASES)
def test_tables_equal_jax(name):
    true, pred = map(stats.remap_label, case(name))
    assert_same(stats.tables_from_labelmaps(true, pred),
                j_stats.tables_from_labelmaps(true, pred))
    ts, ps = stacks(true), stacks(pred)
    if len(ts) and len(ps):
        assert_same(stats.tables_from_masks(ts, ps), j_stats.tables_from_masks(ts, ps))
    else:  # both reshape an empty stack to (0, -1) and fail alike
        for fn in (stats.tables_from_masks, j_stats.tables_from_masks):
            with pytest.raises(ValueError):
                fn(ts, ps)
    t_rles = [rle.encode(m) for m in ts]
    p_rles = [rle.encode(m) for m in ps]
    assert t_rles == [j_rle.encode(m) for m in ts]
    assert_same(stats.tables_from_rles(t_rles, p_rles), j_stats.tables_from_rles(t_rles, p_rles))


@pytest.mark.parametrize("match_iou", [0.5, 0.7, 0.3, 0.1])
@pytest.mark.parametrize("name", CASES)
def test_table_metrics_equal_jax(name, match_iou):
    true, pred = map(stats.remap_label, case(name, seed=3))
    tables = stats.tables_from_rles([rle.encode(m) for m in stacks(true)],
                                    [rle.encode(m) for m in stacks(pred)])
    assert_same(stats.pq_from_tables(*tables, match_iou=match_iou),
                j_stats.pq_from_tables(*tables, match_iou=match_iou))
    assert_same(stats.stat_calc_tables(*tables, match_iou=match_iou),
                j_stats.stat_calc_tables(*tables, match_iou=match_iou))
    assert stats.aji_from_tables(*tables) == j_stats.aji_from_tables(*tables)
    assert stats.aji_plus_from_tables(*tables) == j_stats.aji_plus_from_tables(*tables)
    assert stats.dice2_from_tables(*tables) == j_stats.dice2_from_tables(*tables)
    iou = tables[0] / (tables[1] + 1e-6)
    paired = np.nonzero(iou > match_iou)
    assert (stats.aji_plus_from_tables(*tables, paired)
            == j_stats.aji_plus_from_tables(*tables, paired))
    assert stats.dice2_from_tables(*tables, paired) == j_stats.dice2_from_tables(*tables, paired)
    if name in ("overlapping", "identical") and match_iou == 0.5:
        assert stats.stat_calc_tables(*tables)["pq"] > 0.3  # real pairs, not a trivial case


def test_reference_quirks_kept():
    """AJI reuses a prediction for two ground-truth instances; the ensemble
    dice is 1.0 when no pair survives, disjoint non-empty sets included;
    both-empty images are skipped (None)."""
    true, pred = case("disjoint")
    assert stats.get_fast_dice_2(true, pred) == 1.0 == j_stats.get_fast_dice_2(true, pred)
    true = np.zeros((10, 10), np.int32)
    true[1:4, 1:4], true[1:4, 5:8] = 1, 2
    pred = np.zeros_like(true)
    pred[1:4, 1:8] = 1
    inter, union, ta, pa = stats.tables_from_labelmaps(true, pred)
    # each ground truth pairs with the one prediction, whose 21 pixels count twice
    assert stats.aji_from_tables(inter, union, ta, pa) == pytest.approx(18 / 42)
    assert stats.aji_from_tables(inter, union, ta, pa) == j_stats.aji_from_tables(inter, union, ta, pa)
    assert stats.stat_calc(np.zeros((4, 4), int), np.zeros((4, 4), int)) is None


@pytest.mark.parametrize("name", CASES)
def test_label_map_api_equal_jax(name):
    true, pred = case(name, seed=5)
    for by_size in (False, True):
        assert_same(stats.remap_label(pred, by_size), j_stats.remap_label(pred, by_size))
    assert_same(stats.get_fast_pq(true, pred), j_stats.get_fast_pq(true, pred))
    assert_same(stats.get_fast_pq(true, pred, 0.3), j_stats.get_fast_pq(true, pred, 0.3))
    assert stats.get_fast_aji(true, pred) == j_stats.get_fast_aji(true, pred)
    assert stats.get_fast_aji_plus(true, pred) == j_stats.get_fast_aji_plus(true, pred)
    assert stats.get_fast_dice_2(true, pred) == j_stats.get_fast_dice_2(true, pred)
    assert stats.get_dice_1(true, pred) == j_stats.get_dice_1(true, pred)
    assert_same(stats.stat_calc(true, pred), j_stats.stat_calc(true, pred))


@pytest.mark.parametrize("na,nb,radius", [(12, 15, 6.0), (10, 10, 100.0), (0, 5, 6.0),
                                          (5, 0, 6.0), (8, 8, 0.5)])
def test_pair_coordinates_equal_jax(na, nb, radius):
    rng = np.random.RandomState(na * 31 + nb)
    a, b = rng.uniform(0, 64, (na, 2)), rng.uniform(0, 64, (nb, 2))
    assert_same(stats.pair_coordinates(a, b, radius), j_stats.pair_coordinates(a, b, radius))


def detections(seed, n_img=4, num_classes=3, empty_class=None):
    """Per-image entries of boxes, scores, labels and masks-as-boxes for the
    COCO protocol: ground truth, and detections near it, with misses, false
    positives and ties in score."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_img):
        ng = rng.randint(0 if i == 0 else 3, 12)
        xy = rng.uniform(0, 80, (ng, 2))
        gt = np.concatenate([xy, xy + rng.uniform(4, 20, (ng, 2))], 1)
        gl = rng.randint(0, num_classes, ng)
        if empty_class is not None:
            gl[gl == empty_class] = (empty_class + 1) % num_classes
        keep = rng.rand(ng) < 0.8
        dt = gt[keep] + rng.normal(0, 1.5, (keep.sum(), 4))
        dl = gl[keep].copy()
        dl[rng.rand(len(dl)) < 0.15] = rng.randint(0, num_classes)
        nf = rng.randint(0, 4)
        fxy = rng.uniform(0, 80, (nf, 2))
        dt = np.concatenate([dt, np.concatenate([fxy, fxy + 8], 1)])
        dl = np.concatenate([dl, rng.randint(0, num_classes, nf)])
        scores = np.round(rng.rand(len(dt)), 1)  # ties
        out.append(dict(dt_boxes=dt, dt_scores=scores, dt_labels=dl, gt_boxes=gt, gt_labels=gl,
                        gt_ignore=rng.rand(ng) < 0.1,
                        dt_areas=(dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1]),
                        gt_areas=(gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])))
    return out


def _mask_iou(img, dsel, gsel):
    """A mask IoU stand-in for the ``iou_fn`` hook: box IoU of the boxes
    shrunk by one pixel."""
    shrink = np.asarray([1, 1, -1, -1])
    return j_map._box_iou(img["dt_boxes"][dsel] + shrink, img["gt_boxes"][gsel] + shrink)


@pytest.mark.parametrize("seed,max_dets,empty_class,with_iou_fn", [
    (0, 100, None, False), (1, 3, None, False), (2, 100, 1, False), (3, 100, None, True)])
def test_evaluate_map_equal_jax(seed, max_dets, empty_class, with_iou_fn):
    per_image = detections(seed, empty_class=empty_class)
    fn = _mask_iou if with_iou_fn else None
    got = coco_map.evaluate_map(per_image, 3, iou_fn=fn, max_dets=max_dets)
    assert_same(got, j_map.evaluate_map(per_image, 3, iou_fn=fn, max_dets=max_dets))
    assert np.isfinite(got["mAP"])


@pytest.mark.parametrize("seed,areas,ignore_key", [
    (4, ((0.0, 1e10),), "gt_ignore"), (5, ((0.0, 1e10), (0.0, 64.0), (64.0, 1e10)), "gt_ignore"),
    (6, ((0.0, 100.0),), "none")])
def test_pr_curves_equal_jax(seed, areas, ignore_key):
    per_image = detections(seed)
    thrs = [0.1, 0.5, 0.75]
    got = coco_map.pr_curves(per_image, 3, thrs, areas, gt_ignore_key=ignore_key)
    want = j_map.pr_curves(per_image, 3, thrs, areas, gt_ignore_key=ignore_key)
    assert got.shape == (3, 101, 3, len(areas))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nums", [(1, 5, 20), (100, 300, 1000)])
def test_proposal_recall_equal_jax(nums):
    per_image = detections(7)
    assert_same(coco_map.proposal_recall(per_image, nums), j_map.proposal_recall(per_image, nums))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auroc_and_mcc_equal_jax(seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, 60)
    scores = np.round(rng.rand(60), 1)  # ties
    assert nucls.auroc(labels, scores) == j_nucls.auroc(labels, scores)
    assert np.isnan(nucls.auroc(np.ones(5), scores[:5]))
    yt, yp = rng.randint(0, 4, 80), rng.randint(0, 4, 80)
    yp[:40] = yt[:40]
    assert nucls.mcc(yt, yp, 4) == j_nucls.mcc(yt, yp, 4)
    assert nucls.mcc(np.zeros(5), np.zeros(5), 4) == j_nucls.mcc(np.zeros(5), np.zeros(5), 4)


@pytest.mark.parametrize("seed,radius", [(0, 12.0), (1, 3.0), (2, 0.0)])
def test_classification_metrics_equal_jax(seed, radius):
    rng = np.random.RandomState(seed)
    per_image = []
    for _ in range(3):
        ng = rng.randint(4, 15)
        gc = rng.uniform(0, 100, (ng, 2))
        dc = gc[rng.rand(ng) < 0.8] + rng.normal(0, 3, (1, 2))
        probs = rng.dirichlet(np.ones(4), len(dc))
        per_image.append(dict(gt_centroids=gc, gt_labels=rng.randint(0, 4, ng), dt_centroids=dc,
                              dt_labels=probs.argmax(1), dt_probs=probs))
    assert_same(nucls.classification_metrics(per_image, 4, radius),
                j_nucls.classification_metrics(per_image, 4, radius))


def rater_table(seed, n=40, raters=5, k=3, missing=0.2):
    rng = np.random.RandomState(seed)
    truth = rng.randint(0, k, n)
    responses = {}
    for e in range(n):
        responses[f"e{e}"] = {f"w{w}": int(truth[e] if rng.rand() < 0.6 + 0.08 * w
                                           else rng.randint(0, k))
                              for w in range(raters) if rng.rand() > missing}
    return responses


@pytest.mark.parametrize("seed,initquality", [(0, 0.7), (1, 0.9), (2, 0.5)])
def test_dawid_skene_equal_jax(seed, initquality):
    responses = rater_table(seed)
    got = interrater.DawidSkeneEM(responses, initquality=initquality).run(n_iter=30)
    want = j_ir.DawidSkeneEM(responses, initquality=initquality).run(n_iter=30)
    assert_same(got, want)
    assert_same(interrater.truth_from_posteriors(got[0], np.random.RandomState(3)),
                j_ir.truth_from_posteriors(want[0], np.random.RandomState(3)))


@pytest.mark.parametrize("level", ["nominal", "ordinal", "interval", "ratio"])
@pytest.mark.parametrize("seed", [0, 1])
def test_krippendorff_alpha_equal_jax(level, seed):
    rng = np.random.RandomState(seed)
    data = rng.randint(1, 6, (4, 30)).astype(float)
    data[:, :10] = data[0, :10]  # some agreement
    data[rng.rand(4, 30) < 0.15] = np.nan
    rows = [[None if np.isnan(v) else v for v in r] for r in data]
    got = interrater.krippendorff_alpha(rows, level)
    assert got == j_ir.krippendorff_alpha(rows, level) and np.isfinite(got)
    domain = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert (interrater.krippendorff_alpha(rows, level, value_domain=domain)
            == j_ir.krippendorff_alpha(rows, level, value_domain=domain))
    assert np.isnan(interrater.krippendorff_alpha([[1, None], [None, 2]], level))


@pytest.mark.parametrize("seed,thresh", [(0, 6.0), (1, 2.0), (2, 50.0)])
def test_constrained_clustering_equal_jax(seed, thresh):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 100, (8, 2))
    pts = np.concatenate([c + rng.normal(0, 1.5, (4, 2)) for c in centres])
    raters = np.tile(np.arange(4), 8)
    got = interrater.ConstrainedAgglomerativeClustering(pts, raters, thresh)
    want = j_ir.ConstrainedAgglomerativeClustering(pts, raters, thresh)
    clusters = got.run()
    assert clusters == want.run()
    assert all(len({raters[i] for i in c}) == len(c) for c in clusters)
    np.testing.assert_array_equal(got.medoids(clusters), want.medoids(clusters))
    assert interrater.ConstrainedAgglomerativeClustering(np.zeros((0, 2)), [], 1.0).run() == []
