"""Start a process group on this host (what ``torchrun --standalone`` does,
from Python): ``run_ranks(fn, world)`` runs ``fn(rank, world, *args)`` in
``world`` new processes joined in a group on localhost.

Each process gets torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), joins the group through
``mesh.init_distributed`` on the backend and device the caller names, runs
``fn`` with ``torch.set_num_threads(threads)``, and leaves the group. ``fn``
must be a module-level function (the processes start with "spawn" and
import it). A rank that raises, or the time limit, ends every process and
raises here.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Callable, Optional, Sequence


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, backend: str,
               device: Optional[str], threads: int, args: Sequence) -> None:
    import torch

    from nuhtc_tpu_torch.parallel import mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    mesh.init_distributed(backend=backend, device=torch.device(device or "cpu"))
    try:
        fn(rank, world, *args)
    finally:
        mesh.destroy_distributed()


def run_ranks(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
              device: Optional[str] = None, threads: int = 1, timeout: float = 300.0) -> None:
    """Runs ``fn(rank, world, *args)`` on ranks 0 … world-1, each a process
    of its own in one process group (``backend`` on ``device``, the CPU by
    default), and waits for all of them; raises when one raises or when
    ``timeout`` seconds pass, after ending them all."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), backend, device,
                                               threads, tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"run_ranks: {world} ranks of {fn.__name__} still running "
                                   f"after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
