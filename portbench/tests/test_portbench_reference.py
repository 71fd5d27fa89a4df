"""What the benchmark may load: nothing of JAX or the JAX package anywhere
under ``portbench/``, nothing of the port in the frozen reference, and no
read of the JAX package's benchmark (``bench.py``, ``BENCH_*.json``); the
same for the modules a CPU rehearsal of ``run.py``'s import path loads.
And the reference agrees with the port exactly at a small size in f32."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "nuhtc_tpu"}


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_import(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if os.sep + "reference" + os.sep in path:
        assert "nuhtc_tpu_torch" not in tops, f"the reference {path} imports the port"
    src = open(path).read()
    for word in ("bench.py", "BENCH_r"):
        assert word not in src or path.endswith("test_portbench_reference.py"), (path, word)


def test_rehearsed_import_path_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run as run\n"
        "from portbench.harness import common, slide, forward, program, trace, check, weights\n"
        "from nuhtc_tpu_torch.apis.inference import init_detector\n"
        "from nuhtc_tpu_torch.wsi.infer import infer_slide\n"
        "from nuhtc_tpu_torch.wsi.slide import ArraySlide\n"
        "b = common.benchmark()\n"
        "for m in b['per_layer']: common.metric_reader(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_forbidden_loaded_compares_whole_top_level_names(monkeypatch):
    from portbench.harness import common

    monkeypatch.setitem(sys.modules, "nuhtc_tpu_torch_lookalike", sys)
    assert "nuhtc_tpu" not in common.forbidden_loaded() or "nuhtc_tpu" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in common.forbidden_loaded()


@pytest.mark.parametrize("config", ["nuhtc-pannuke", "maskrcnn-nucls"])
def test_reference_equals_port_in_f32(config):
    """The frozen reference against the port on the CPU (plain paths, f32),
    the same weights and 96² tiles: the same detections and label maps."""
    import numpy as np
    import torch

    from portbench.harness import common, program, traffic, weights

    bench = common.benchmark()
    cfg = dict(common.config(bench, config), tile=96)
    state = weights.make(cfg, 5, torch.device("cpu"), torch.float32)
    eng = program.engine(cfg, state, 2, torch.device("cpu"))
    tiles = traffic.tiles(np.random.RandomState(3), 2, 96)
    got = eng.run_batch(tiles)
    want = program.reference_detect(program.reference(cfg, state, "cpu"), tiles, cfg, 2, "cpu")
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]) > 0
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["masks"], w["masks"])
