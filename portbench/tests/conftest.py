"""Tests of the benchmark harness: ``python -m pytest portbench/tests`` from
the root of the repository (the CPU cases), and on a card
``python -m pytest portbench/tests -m cuda``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on an NVIDIA GPU; skipped without one")
