"""Torch's intra-op threads in the port's test processes: the host's cores
shared among pytest-xdist's workers (``PYTEST_XDIST_WORKER_COUNT``, 1
without xdist), so that N workers do not each run as many threads as the
host has cores. Every ``tests/test_torch_*.py`` imports this module; a test
that pins its own thread count sets and restores it around itself."""

import os

import torch


def intra_op_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


torch.set_num_threads(intra_op_threads())
