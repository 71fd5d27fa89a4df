"""``run.py`` as the driver runs it: without a card it exits 2 and prints
no result (also from a directory that holds only ``BENCHMARK.json`` and
``portbench/``); on a card (``-m cuda``) each cell's short run prints a
correct result line with every metric of its kind."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import common

ROOT = common.ROOT
CELLS = ["pannuke-slide-64", "maskrcnn-nucls-forward-b16", "pannuke-forward-b16"]


def _run(cwd, workload, trace=0, seconds=3, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", "2147484001",
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=900, env=env)


def test_no_card_exits_2_without_a_result():
    out = _run(ROOT, CELLS[1], env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == ""


def test_bare_benchmark_directory_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), CELLS[1])
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = _run(ROOT, workload, trace=trace)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    bench = common.benchmark()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in common.metrics_of(bench, workload, kind)}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
