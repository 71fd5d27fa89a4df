"""The analysis and dataset command lines of the port
(``nuhtc_tpu_torch.tools.analysis_tools``, ``tools.dataset.convert_format``)
against the JAX package's scripts, on the CPU. The JAX scripts run in this
process through their ``main`` with ``sys.argv`` patched.

- Inputs: a synthetic PanNuke release of four 256² tiles converted by the
  port's ``preprocess_pannuke``, a config over it, and a results pickle made
  from its ground truth (moved, grown, shrunk, relabelled, dropped and
  doubled nuclei, false positives); seeded PanNuke-layout ``.npy`` maps for
  the compute_stats suites; a ``.mat`` tree for consep and convert_format.
- Every port tool has the JAX script's positionals, options and defaults
  (``test_robustness`` adds ``--device``, which no other has).
- ``eval_metric``, ``confusion_matrix`` (both modes, with and without box
  NMS), ``coco_error_analysis`` (bbox and segm, ``--extraplots``),
  ``analyze_results``, ``interrater_analysis``, ``robustness_eval``,
  ``print_metric`` (one run and three folds), ``print_metric_all``, the
  PanNuke, CoNIC and CoNSeP suites in all their modes, the patch extractor
  and the six conversions of ``convert_format``: the same printed lines, the
  same file tree, ``.npy``/``.mat``/CSV files equal byte for byte or value
  for value, JSON key for key (1e-12 where the float order may differ);
  figures by existence and shape.
- ``viz_utils``: ``colorize`` = ``applyColorMap(…, COLORMAP_JET)``, the glyph
  table = a fresh rendering from cv2, ``put_text`` = ``cv2.putText``,
  ``gen_figure`` equal to the JAX one, ``visualize_instances_map`` at
  thickness 1 equal, the command line's overlay.
- Without matplotlib the figure functions raise ImportError naming it, after
  the numeric outputs are written.
"""

import argparse
import builtins
import csv
import filecmp
import json
import os
import pickle
import re
import shutil
import sys

import cv2
import numpy as np
import pytest
import scipy.io

from nuhtc_tpu_torch.data.coco import build_dataset
from nuhtc_tpu_torch.tools import preprocess_pannuke
from nuhtc_tpu_torch.tools.analysis_tools import (
    analyze_results, coco_error_analysis, confusion_matrix, eval_metric, interrater_analysis,
    print_metric, print_metric_all, robustness_eval, test_robustness, viz_utils)
from nuhtc_tpu_torch.tools.analysis_tools.conic import compute_stats as conic_stats
from nuhtc_tpu_torch.tools.analysis_tools.conic.misc import patch_extractor
from nuhtc_tpu_torch.tools.analysis_tools.consep import compute_stats as consep_stats
from nuhtc_tpu_torch.tools.analysis_tools.pannuke import compute_stats as pannuke_stats
from nuhtc_tpu_torch.tools.analysis_tools.pannuke import compute_stats_all
from nuhtc_tpu_torch.tools.dataset import convert_format
from nuhtc_tpu_torch.tools.synthetic import synthetic_pannuke
from nuhtc_tpu_torch.utils.imageio import read_image
from test_torch_dataset import shared_results
import torch_threads  # noqa: F401  (torch's threads: the host's cores over the workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_CFG = os.path.join(REPO, "configs", "nuhtc", "htc_lite_tiny_synthetic.py")

# port module ↔ JAX script
TOOLS = [
    (eval_metric, "analysis_tools/eval_metric.py"),
    (print_metric, "analysis_tools/print_metric.py"),
    (print_metric_all, "analysis_tools/print_metric_all.py"),
    (confusion_matrix, "analysis_tools/confusion_matrix.py"),
    (coco_error_analysis, "analysis_tools/coco_error_analysis.py"),
    (analyze_results, "analysis_tools/analyze_results.py"),
    (interrater_analysis, "analysis_tools/interrater_analysis.py"),
    (robustness_eval, "analysis_tools/robustness_eval.py"),
    (test_robustness, "analysis_tools/test_robustness.py"),
    (viz_utils, "analysis_tools/viz_utils.py"),
    (pannuke_stats, "analysis_tools/pannuke/compute_stats.py"),
    (compute_stats_all, "analysis_tools/pannuke/compute_stats_all.py"),
    (conic_stats, "analysis_tools/conic/compute_stats.py"),
    (consep_stats, "analysis_tools/consep/compute_stats.py"),
    (convert_format, "dataset/convert_format.py"),
]


def load_jax(script):
    import importlib.util

    name = "jax_" + re.sub(r"\W", "_", script[:-3])
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, capsys, script, argv):
    """The JAX script through its ``main``; returns what it printed."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools", os.path.dirname(script)))
    monkeypatch.delitem(sys.modules, "compute_stats", raising=False)
    monkeypatch.delitem(sys.modules, "viz_utils", raising=False)
    mod = load_jax(script)
    monkeypatch.setattr(sys, "argv", [script] + [str(a) for a in argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def run_port(capsys, module, argv):
    capsys.readouterr()
    assert module.main([str(a) for a in argv]) == 0
    return capsys.readouterr().out


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_json_close(got, want, atol=1e-12):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_json_close(got[k], want[k], atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_json_close(g, w, atol)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        assert got == want


def assert_same_files(got_root, want_root):
    """The same names; .npy and .mat equal, .json close, .csv/.txt equal
    bytes, images of the same shape."""
    names = tree(want_root)
    assert tree(got_root) == names and names
    for f in names:
        a, b = os.path.join(got_root, f), os.path.join(want_root, f)
        if f.endswith(".npy"):
            x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        elif f.endswith(".mat"):
            x, y = scipy.io.loadmat(a), scipy.io.loadmat(b)
            assert sorted(k for k in x if not k.startswith("__")) == sorted(
                k for k in y if not k.startswith("__"))
            for k in y:
                if not k.startswith("__"):
                    np.testing.assert_array_equal(x[k], y[k])
        elif f.endswith(".json"):
            assert_json_close(json.load(open(a)), json.load(open(b)))
        elif f.endswith(".png"):
            assert read_image(a).shape == cv2.imread(b).shape
        else:
            assert filecmp.cmp(a, b, shallow=False), f


# --- the options of every command line ---------------------------------------


class _Parsed(Exception):
    pass


def _parser_of(monkeypatch, main, argv):
    """The ArgumentParser a ``main`` builds, caught at its parse_args."""
    def catch(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as e:
        main(argv) if argv is not None else main()
    return e.value.args[0]


def _options(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        key = tuple(a.option_strings) or a.dest
        out[key] = (a.dest, a.default, a.nargs, a.type, a.required, a.choices,
                    type(a).__name__, a.const)
    return out


@pytest.mark.parametrize("module,script", TOOLS, ids=[s for _, s in TOOLS])
def test_command_line_options_equal_jax(monkeypatch, module, script):
    monkeypatch.setattr(sys, "argv", [script])
    want = _options(_parser_of(monkeypatch, load_jax(script).main, None))
    got = _options(_parser_of(monkeypatch, module.main, []))
    device = got.pop(("--device",), None)
    assert got == want
    if module is test_robustness:
        assert device == ("device", None, None, None, False, None, "_StoreAction", None)
    else:
        assert device is None


# --- the release, its config and a results pickle ----------------------------


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis")
    images, masks, types = synthetic_pannuke(np.random.RandomState(2), 4)
    for name, arr in (("images", images), ("masks", masks), ("types", types)):
        np.save(root / f"{name}.npy", arr)
    assert preprocess_pannuke.main([
        "--images", str(root / "images.npy"), "--masks", str(root / "masks.npy"),
        "--types", str(root / "types.npy"), "--fold", "3", "--out-dir", str(root / "datasets"),
        "--coco-dir", str(root / "coco")]) == 0
    test = dict(ann_file=str(root / "coco" / "PanNuke_annt_RLE_fold3.json"),
                img_prefix=str(root / "datasets" / "rgb"),
                seg_prefix=str(root / "datasets" / "rgb_seg"))
    cfg = root / "cfg.py"
    cfg.write_text(f"_base_ = {BASE_CFG!r}\ndata = dict(test={test!r})\n")
    dataset = build_dataset(dict(type="PanNukeCocoDataset", test_mode=True, **test))
    results = shared_results(dataset, seed=3)
    with open(root / "results.pkl", "wb") as f:
        pickle.dump(results, f)
    return dict(root=root, cfg=str(cfg), pkl=str(root / "results.pkl"), dataset=dataset,
                results=results, masks=masks, types=types)


def _both(monkeypatch, capsys, tmp_path, module, script, argv_of):
    """Runs both with ``argv_of(out_dir)``; returns {pkg: (stdout, out_dir)}."""
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        argv = argv_of(d)
        text = (run_jax(monkeypatch, capsys, script, argv) if pkg == "jax"
                else run_port(capsys, module, argv))
        out[pkg] = (text.replace(str(d), "<out>"), d)
    return out


@pytest.mark.parametrize("mode", ["eval", "format_only", "save_false"])
def test_eval_metric_equal_jax(monkeypatch, capsys, tmp_path, release, mode):
    """``save_false``: the JAX tool reads ``save=False`` as true (``bool`` of
    the text), and so does the port: both save."""
    def argv(d):
        extra = {"eval": ["--eval", "segm"],
                 "format_only": ["--format-only", "--eval-options", f"save_path={d}",
                                 "format=pannuke"],
                 "save_false": ["--eval", "segm", "--eval-options", "save=False",
                                f"save_path={d}", "format=conic"]}[mode]
        return [release["cfg"], release["pkl"], *extra]

    runs = _both(monkeypatch, capsys, tmp_path, eval_metric, "analysis_tools/eval_metric.py", argv)
    assert runs["port"][0] == runs["jax"][0]
    if mode == "eval":
        assert "pq: " in runs["port"][0] and "multi_pq: " in runs["port"][0]
    else:
        assert_same_files(runs["port"][1], runs["jax"][1])


@pytest.mark.parametrize("nms", [None, "0.3"])
def test_confusion_matrix_equal_jax(monkeypatch, capsys, tmp_path, release, nms):
    def argv(d):
        return [release["cfg"], release["pkl"], d, "--score-thr", "0.2"] + (
            ["--nms-iou-thr", nms] if nms else [])

    runs = _both(monkeypatch, capsys, tmp_path, confusion_matrix,
                 "analysis_tools/confusion_matrix.py", argv)
    assert runs["port"][0] == runs["jax"][0]
    assert_same_files(runs["port"][1], runs["jax"][1])
    cm = np.load(runs["port"][1] / "confusion_matrix.npy")
    assert cm.shape == (6, 6) and cm.sum() > 50


def test_confusion_matrix_legacy_mode_equal_jax(monkeypatch, capsys, tmp_path):
    metrics = tmp_path / "metrics.json"
    metrics.write_text(json.dumps({"pq": 0.5, "confusion_matrix": np.arange(36).reshape(
        6, 6).tolist()}))
    runs = _both(monkeypatch, capsys, tmp_path, confusion_matrix,
                 "analysis_tools/confusion_matrix.py",
                 lambda d: [metrics, "--classes", "a", "b", "c", "d", "e", "--out", d / "cm.png"])
    assert runs["port"][0] == runs["jax"][0]
    assert_same_files(runs["port"][1], runs["jax"][1])


def test_coco_error_analysis_equal_jax(monkeypatch, capsys, tmp_path, release):
    runs = _both(monkeypatch, capsys, tmp_path, coco_error_analysis,
                 "analysis_tools/coco_error_analysis.py",
                 lambda d: [release["cfg"], release["pkl"], "--out-dir", d, "--types", "bbox",
                            "segm", "--extraplots", "--areas", "100", "400", "10000000000"])
    assert runs["port"][0] == runs["jax"][0]
    assert_same_files(runs["port"][1], runs["jax"][1])
    aps = json.load(open(runs["port"][1] / "segm" / "segm_error_analysis.json"))
    assert list(aps)[-1] == "allclass" and 0 < aps["allclass"]["allarea"]["C50"] < 1


def test_analyze_results_equal_jax(monkeypatch, capsys, tmp_path, release):
    runs = _both(monkeypatch, capsys, tmp_path, analyze_results,
                 "analysis_tools/analyze_results.py",
                 lambda d: [release["cfg"], release["pkl"], d, "--topk", "2",
                            "--show-score-thr", "0.3"])
    assert runs["port"][0] == runs["jax"][0]
    assert_same_files(runs["port"][1], runs["jax"][1])
    assert len(tree(runs["port"][1])) == 4


def test_per_image_map_equal_jax(release):
    jax_mod = load_jax("analysis_tools/analyze_results.py")
    for i, (bboxes, _) in enumerate(release["results"]):
        ann = release["dataset"].get_ann_info(i)
        got = analyze_results.per_image_map(bboxes, ann["bboxes"], ann["labels"])
        assert got == jax_mod.per_image_map(bboxes, ann["bboxes"], ann["labels"]) and 0 < got < 1


@pytest.mark.parametrize("level", ["nominal", "interval"])
def test_interrater_analysis_equal_jax(monkeypatch, capsys, tmp_path, level):
    rng = np.random.RandomState(4)
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["example", "worker", "label"])
        for e in range(30):
            truth = rng.randint(4)
            for r in range(5):
                if rng.rand() < 0.8:
                    w.writerow([f"e{e}", f"w{r}", truth if rng.rand() < 0.7 else rng.randint(4)])
    runs = _both(monkeypatch, capsys, tmp_path, interrater_analysis,
                 "analysis_tools/interrater_analysis.py",
                 lambda d: [labels, "--level", level, "--out", d / "truth.csv"])
    assert json.loads(runs["port"][0]) == json.loads(runs["jax"][0])
    assert_same_files(runs["port"][1], runs["jax"][1])


def test_robustness_eval_equal_jax(monkeypatch, capsys, tmp_path):
    rng = np.random.RandomState(5)
    res = {k: {str(s): {m: float(rng.rand()) for m in ("pq", "aji", "dice")} for s in range(4)}
           for k in ("gaussian_noise", "fog")}
    path = tmp_path / "r.json"
    path.write_text(json.dumps(res))
    for argv in ([path], [path, "--metrics", "pq", "dice", "--prints", "rPC", "P"]):
        want = run_jax(monkeypatch, capsys, "analysis_tools/robustness_eval.py", argv)
        assert run_port(capsys, robustness_eval, argv) == want
        assert "Performance on Clean Data" in want or "rPC" in want


# --- the per-dataset suites ---------------------------------------------------


def _perturbed(masks, seed):
    """PanNuke-layout predictions from ground truth: instance maps rolled,
    some instances dropped or moved to another class, a blob added."""
    rng = np.random.RandomState(seed)
    pred = masks.copy()
    for i in range(len(pred)):
        for c in range(5):
            m = pred[i, :, :, c]
            for v in np.unique(m)[1:]:
                u = rng.rand()
                if u < 0.15:
                    m[m == v] = 0
                elif u < 0.25:
                    sel = m == v
                    m[sel] = 0
                    other = pred[i, :, :, (c + 1) % 5]
                    other[sel & (other == 0)] = 500 + v
            pred[i, :, :, c] = np.roll(m, rng.randint(-2, 3, 2), axis=(0, 1))
        yy, xx = np.mgrid[:masks.shape[1], :masks.shape[2]]
        blob = (yy - rng.randint(20, 100)) ** 2 + (xx - rng.randint(20, 100)) ** 2 < 30
        pred[i, :, :, 2][blob & (pred[i, :, :, :5].sum(-1) == 0)] = 999
        pred[i, :, :, 5] = (pred[i, :, :, :5].sum(-1) == 0).astype(pred.dtype)
    return pred


@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """Seeded PanNuke-layout ground truth (one class emptied in one tile, one
    tile without nuclei) and predictions, saved as .npy."""
    root = tmp_path_factory.mktemp("maps")
    _, masks, types = synthetic_pannuke(np.random.RandomState(6), 6, 128, nuclei=(6, 14))
    masks[1, :, :, 3] = 0
    masks[4, :, :, :5] = 0
    masks[..., 5] = (masks[..., :5].sum(-1) == 0)
    types[3] = types[0]
    pred = _perturbed(masks, 7)
    paths = {}
    for name, arr in (("true", masks), ("pred", pred), ("types", types)):
        paths[name + "_npy"] = root / f"{name}.npy"
        np.save(paths[name + "_npy"], arr)
    return dict(root=root, true=masks, pred=pred, types=types, **paths)


@pytest.mark.parametrize("with_types", [False, True])
def test_pannuke_compute_stats_equal_jax(monkeypatch, capsys, tmp_path, maps, with_types):
    runs = _both(monkeypatch, capsys, tmp_path, pannuke_stats,
                 "analysis_tools/pannuke/compute_stats.py",
                 lambda d: ["--true", maps["true_npy"], "--pred", maps["pred_npy"], "--out",
                            d / "s.json"] + (["--types", maps["types_npy"]] if with_types else []))
    assert runs["port"][0] == runs["jax"][0]
    assert_same_files(runs["port"][1], runs["jax"][1])
    assert 0 < json.load(open(runs["port"][1] / "s.json"))["bPQ"] < 1


@pytest.mark.parametrize("mode", ["coord", "iou"])
def test_pannuke_compute_stats_all_equal_jax(monkeypatch, capsys, tmp_path, maps, mode):
    runs = _both(monkeypatch, capsys, tmp_path, compute_stats_all,
                 "analysis_tools/pannuke/compute_stats_all.py",
                 lambda d: ["--true_path", maps["true_npy"], "--pred_path", maps["pred_npy"],
                            "--type_path", maps["types_npy"], "--save_path", d, "--mode", mode])
    assert runs["port"][0] == runs["jax"][0]
    assert_same_files(runs["port"][1], runs["jax"][1])
    assert len(tree(runs["port"][1])) == (11 if mode == "iou" else 9)


def _fold_tree(root, maps, capsys):
    """Three fold directories exp1..exp3 with the reference's tissue_stats.csv
    and class_stats.csv (compute_stats_all's iou tables of three prediction
    seeds) and a conic_stats.csv."""
    for fold in (1, 2, 3):
        d = root / f"exp{fold}"
        pred = root / f"pred{fold}.npy"
        np.save(pred, _perturbed(maps["true"], 20 + fold))
        run_port(capsys, compute_stats_all, [
            "--true_path", maps["true_npy"], "--pred_path", pred, "--type_path", maps["types_npy"],
            "--save_path", d, "--mode", "iou"])
        os.rename(d / "tissue_stats_PQ.csv", d / "tissue_stats.csv")
        os.rename(d / "class_stats_PQ.csv", d / "class_stats.csv")
        (d / "conic_stats.csv").write_text(f",aji,dice,pq\n0,{0.1 * fold + 1 / 3},0.7,0.5\n")


def test_print_metric_equal_jax(monkeypatch, capsys, tmp_path, maps):
    base = tmp_path / "base"
    base.mkdir()
    _fold_tree(base, maps, capsys)
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        shutil.copytree(base, d)
        for module, script, argv in (
                (print_metric, "analysis_tools/print_metric.py",
                 ["--path", d / "exp1", "--basedir", d, "--exp", "exp"]),
                (print_metric, "analysis_tools/print_metric.py", ["--path", d / "exp2/"]),
                (print_metric_all, "analysis_tools/print_metric_all.py", ["--path", d / "exp3"])):
            text = (run_jax(monkeypatch, capsys, script, argv) if pkg == "jax"
                    else run_port(capsys, module, argv))
            out.setdefault(pkg, []).append(text)
    assert out["port"] == out["jax"]
    assert "Tissue name" in out["port"][0] and "std" in out["port"][0]
    assert_same_files(tmp_path / "port", tmp_path / "jax")


def test_conic_compute_stats_equal_jax(monkeypatch, capsys, tmp_path, maps):
    true = convert_format.pannuke2conic(maps["true"].astype(np.int32))
    pred = convert_format.pannuke2conic(maps["pred"].astype(np.int32))
    np.save(tmp_path / "t.npy", true)
    np.save(tmp_path / "p.npy", pred)
    rng = np.random.RandomState(8)
    for name in ("t", "p"):
        with open(tmp_path / f"{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(conic_stats.CONIC_CLASSES)
            for _ in range(12):
                w.writerow(rng.randint(0, 40, 6))
    for i, argv in enumerate((
            ["--true", tmp_path / "t.npy", "--pred", tmp_path / "p.npy", "--num-classes", "5"],
            ["--mode", "regression", "--true", tmp_path / "t.csv", "--pred", tmp_path / "p.csv"])):
        (tmp_path / f"mode{i}").mkdir()
        runs = _both(monkeypatch, capsys, tmp_path / f"mode{i}", conic_stats,
                     "analysis_tools/conic/compute_stats.py",
                     lambda d, a=argv: a + ["--out", d / "c.json"])
        assert runs["port"][0] == runs["jax"][0]
        assert_same_files(runs["port"][1], runs["jax"][1])


@pytest.mark.parametrize("kind", ["valid", "mirror"])
def test_patch_extractor_equal_jax(kind):
    jax_mod = load_jax("analysis_tools/conic/misc/patch_extractor.py")
    rng = np.random.RandomState(9)
    for shape, win, step in (((100, 90, 3), 32, 20), ((20, 70, 2), 32, 16), ((64, 64), 64, 64)):
        x = rng.rand(*shape)
        got = patch_extractor.PatchExtractor(win, step).extract(x, kind)
        want = jax_mod.PatchExtractor(win, step).extract(x, kind)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(patch_extractor.cropping_center(x, (10, 20)),
                                  jax_mod.cropping_center(x, (10, 20)))


@pytest.fixture(scope="module")
def consep_tree(tmp_path_factory, maps):
    """True and predicted .mat trees: inst_map with type_map, or with the
    stored inst_centroid / inst_type, and one image without nuclei."""
    root = tmp_path_factory.mktemp("consep")
    conic_true = convert_format.pannuke2conic(maps["true"].astype(np.int32))
    conic_pred = convert_format.pannuke2conic(maps["pred"].astype(np.int32))
    for name, arr in (("true", conic_true), ("pred", conic_pred)):
        os.makedirs(root / name)
        for i, a in enumerate(arr):
            inst, tmap = a[..., 0], a[..., 1]
            doc = {"inst_map": inst, "type_map": tmap}
            if i % 2 and inst.max():
                ids = np.unique(inst)[1:]
                doc["inst_centroid"] = np.asarray(
                    [np.argwhere(inst == v).mean(0)[::-1] for v in ids])
                doc["inst_type"] = np.asarray([[np.bincount(tmap[inst == v]).argmax()]
                                               for v in ids])
            scipy.io.savemat(root / name / f"img_{i}.mat", doc)
    return root


@pytest.mark.parametrize("argv", [["--mode", "both"], ["--mode", "type", "--radius", "6"],
                                  ["--mode", "type", "--non-exhaustive"], ["--mode", "inst"]])
def test_consep_compute_stats_equal_jax(monkeypatch, capsys, consep_tree, argv):
    argv = argv + ["--true-dir", consep_tree / "true", "--pred-dir", consep_tree / "pred"]
    want = run_jax(monkeypatch, capsys, "analysis_tools/consep/compute_stats.py", argv)
    assert run_port(capsys, consep_stats, argv) == want and want.strip()


@pytest.mark.parametrize("pair", ["conic2pannuke", "pannuke2conic", "conic2consep",
                                  "pannuke2consep", "consep2conic", "consep2pannuke"])
def test_convert_format_equal_jax(monkeypatch, capsys, tmp_path, maps, pair):
    src, dst = pair.split("2")
    pannuke = maps["true"].astype(np.int32)
    data = {"pannuke": pannuke, "conic": convert_format.pannuke2conic(pannuke)}

    def argv(d):
        if src == "consep":
            path = d / "mats"
            path.mkdir()
            for i, a in enumerate(data["conic"][:3]):
                inst = a[..., 0]
                ids = np.unique(inst)[1:]
                types = np.asarray([[a[..., 1][inst == v][0]] for v in ids]).reshape(-1, 1)
                scipy.io.savemat(path / f"{i}.mat", {"inst_map": inst, "inst_type": types})
        else:
            path = d / f"preds_{src}.npy"
            np.save(path, data[src])
        return ["--data_path", path, "--format", src, "--to", dst, "--class_num", "5"]

    runs = _both(monkeypatch, capsys, tmp_path, convert_format, "dataset/convert_format.py", argv)
    assert runs["port"][0] == runs["jax"][0] == f"converted {pair}\n"
    assert_same_files(runs["port"][1], runs["jax"][1])
    assert len(tree(runs["port"][1])) > (3 if src == "consep" else 1)


def test_to_qupath_equal_jax(tmp_path):
    jax_mod = load_jax("dataset/convert_format.py")
    rng = np.random.RandomState(10)
    pos, types = rng.rand(20, 2) * 256, rng.randint(1, 4, 20)
    info = {1: ("a", (255, 0, 0)), 2: ("b", (0, 255, 10)), 3: ("c", (1, 2, 3))}
    convert_format.to_qupath(tmp_path / "p.tsv", pos, types, info)
    jax_mod.to_qupath(tmp_path / "j.tsv", pos, types, info)
    assert filecmp.cmp(tmp_path / "p.tsv", tmp_path / "j.tsv", shallow=False)


# --- viz_utils ---------------------------------------------------------------


def test_colorize_is_opencv_jet():
    g = np.random.RandomState(11).rand(30, 40) * 5 - 1
    jax_mod = load_jax("analysis_tools/viz_utils.py")
    np.testing.assert_array_equal(viz_utils.colorize(g), jax_mod.colorize(g))
    np.testing.assert_array_equal(viz_utils.colorize(g, 0, 2), jax_mod.colorize(g, 0, 2))
    np.testing.assert_array_equal(
        viz_utils.JET_U8, cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                                            cv2.COLORMAP_JET)[:, 0, ::-1])


def putText_glyphs():
    """The glyph table of ``viz_utils.put_text`` as cv2 renders it: per
    printable ASCII character its coverage on white (the box of the pixels it
    touches), the box's offset from the pen and the baseline, and its
    advance. ``python tests/test_torch_analysis_tools.py`` writes it."""
    x0, y0, font = 20, 30, cv2.FONT_HERSHEY_SIMPLEX
    width_a = cv2.getTextSize("A", font, 0.5, 1)[0][0]
    codes, meta, cover = [], [], []
    for code in range(32, 127):
        img = np.full((50, 80, 3), 255, np.uint8)
        cv2.putText(img, chr(code), (x0, y0), font, 0.5, (0, 0, 0), 1, cv2.LINE_AA)
        k = img[..., 0]
        ys, xs = np.nonzero(k != 255)
        if len(ys):
            box = k[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            dx, dy = xs.min() - x0, ys.min() - y0
        else:
            box, dx, dy = np.zeros((0, 0), np.uint8), 0, 0
        advance = cv2.getTextSize(chr(code) + "A", font, 0.5, 1)[0][0] - width_a
        codes.append(code)
        meta.append((dx, dy, advance) + box.shape)
        cover.append(box.ravel())
    return dict(codes=np.asarray(codes, np.int16), meta=np.asarray(meta, np.int16),
                coverage=np.concatenate(cover).astype(np.uint8))


def test_glyph_table_is_cv2s_rendering():
    shipped = np.load(viz_utils._GLYPHS)
    for k, v in putText_glyphs().items():
        np.testing.assert_array_equal(shipped[k], v)


def test_put_text_equal_cv2():
    rng = np.random.RandomState(12)
    chars = [chr(c) for c in range(32, 127)]
    for _ in range(60):
        text = "".join(rng.choice(chars, rng.randint(1, 25)))
        bg = rng.randint(0, 256, (40, rng.randint(20, 260), 3)).astype(np.uint8)
        org = (int(rng.randint(-5, 30)), int(rng.randint(5, 35)))
        want = bg.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1, cv2.LINE_AA)
        np.testing.assert_array_equal(viz_utils.put_text(bg.copy(), text, org), want)


def test_gen_figure_equal_jax(tmp_path):
    jax_mod = load_jax("analysis_tools/viz_utils.py")
    rng = np.random.RandomState(13)
    panels = [rng.randint(0, 256, (64, 80, 3)).astype(np.uint8), rng.rand(64, 50),
              rng.randint(0, 256, (32, 40, 3)).astype(np.uint8)]
    titles = ["image", "pq 0.512 (class 3)", "pred"]
    got = viz_utils.gen_figure(panels, titles, out_file=str(tmp_path / "p.png"))
    want = jax_mod.gen_figure(panels, titles, out_file=str(tmp_path / "j.png"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(str(tmp_path / "p.png")),
                                  cv2.imread(str(tmp_path / "j.png"))[..., ::-1])


def test_instance_drawing_equal_jax(release, tmp_path):
    jax_mod = load_jax("analysis_tools/viz_utils.py")
    img = release["dataset"].load_image(0)
    inst = release["masks"][0, :, :, :5].max(-1).astype(np.int32)
    tmap = release["masks"][0, :, :, :5].argmax(-1) + 1
    for dataset in ("pannuke", "conic", "consep", "nucls", "other"):
        np.testing.assert_array_equal(
            viz_utils.visualize_instances_map(img, inst, tmap, dataset, line_thickness=1),
            jax_mod.visualize_instances_map(img, inst, tmap, dataset, line_thickness=1))
    np.testing.assert_array_equal(viz_utils.visualize_instances_map(img, inst, None, "pannuke", 1),
                                  jax_mod.visualize_instances_map(img, inst, None, "pannuke", 1))
    for m in (inst == 3, np.zeros_like(inst, bool)):
        assert viz_utils.get_bounding_box(m) == jax_mod.get_bounding_box(m)
    assert viz_utils.random_colors(7, False, 3) == jax_mod.random_colors(7, False, 3)
    assert viz_utils.overlay_instances(img, inst).shape == jax_mod.overlay_instances(
        img, inst).shape
    np.save(tmp_path / "inst.npy", inst)
    np.save(tmp_path / "type.npy", tmap)
    png = os.path.join(release["dataset"].img_prefix, release["dataset"].img_info(0)["file_name"])
    assert viz_utils.main([png, "--inst", str(tmp_path / "inst.npy"), "--type",
                           str(tmp_path / "type.npy"), "--out", str(tmp_path / "o.png")]) == 0
    assert read_image(str(tmp_path / "o.png")).shape == img.shape


# --- without matplotlib ------------------------------------------------------


def test_figures_without_matplotlib_raise_after_the_numbers(monkeypatch, capsys, tmp_path,
                                                            release):
    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        confusion_matrix.main([release["cfg"], release["pkl"], str(tmp_path / "cm")])
    assert os.listdir(tmp_path / "cm") == ["confusion_matrix.npy"]
    with pytest.raises(ImportError, match="matplotlib"):
        coco_error_analysis.main([release["cfg"], release["pkl"], "--out-dir",
                                  str(tmp_path / "ea")])
    assert os.listdir(tmp_path / "ea" / "bbox") == ["bbox_error_analysis.json"]


if __name__ == "__main__":
    np.savez_compressed(viz_utils._GLYPHS, **putText_glyphs())
    print(f"wrote {viz_utils._GLYPHS}")
