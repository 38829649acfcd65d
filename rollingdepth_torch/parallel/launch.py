"""Start ranks on one host with ``torch.multiprocessing`` and collect them.

``torchrun`` launches the port's ranks in production.  The tests, the card
smoke and ``tools/multihost_demo.py`` start them from Python instead:

    ranks = start_ranks(fn, 4, args=(...,), device="cpu", timeout=120)
    results = ranks.join()  # [fn(0, ...), ..., fn(3, ...)]

Each rank is a spawned process with torchrun's variables set (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and a free
``MASTER_PORT`` on localhost), joins the group through
``multihost.initialize_distributed`` with ``COLLECTIVE_TIMEOUT`` on every
collective, runs ``fn(rank, *args)`` (a module-level function) and saves
its result with ``torch.save``.  ``join`` waits at most ``timeout`` seconds
in all; a rank that fails, or the timeout, kills every rank and raises.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, port: int, device, threads: Optional[int], outs: Sequence[str],
               args: Sequence[Any]) -> None:
    import torch.distributed as dist

    from .multihost import initialize_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        initialize_distributed(device=device, timeout=COLLECTIVE_TIMEOUT)
        torch.save(fn(rank, *args), outs[rank] + ".tmp")
        os.replace(outs[rank] + ".tmp", outs[rank])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """Running ranks; ``join`` returns their results in rank order."""

    def __init__(self, context, outs: List[str], timeout: float, tmp):
        self.context, self.outs, self.timeout, self._tmp = context, outs, timeout, tmp
        self.deadline = time.monotonic() + timeout

    def kill(self) -> None:
        for p in self.context.processes:
            if p.is_alive():
                p.kill()
            p.join(5)

    def join(self) -> List[Any]:
        try:
            # returns once a rank ends; raises (and ends the others) when one failed
            while not self.context.join(max(0.0, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    codes = [p.exitcode for p in self.context.processes]
                    raise TimeoutError(f"ranks still running after {self.timeout:.0f} s: exit codes {codes}")
            return [torch.load(o, weights_only=False) for o in self.outs]
        finally:
            self.kill()
            self._tmp.cleanup()


def start_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *, device=None, threads: Optional[int] = None,
                timeout: float = 300.0) -> Ranks:
    """Spawn ``world`` ranks running ``fn(rank, *args)``; ``device`` as for
    ``initialize_distributed`` ("cpu" for gloo on the host; None: each
    rank's card).  ``threads`` sets each rank's ``torch.set_num_threads``."""
    tmp = tempfile.TemporaryDirectory(prefix="ranks-")
    outs = [os.path.join(tmp.name, f"rank{r}.pt") for r in range(world)]
    context = mp.start_processes(_rank_main, args=(fn, world, free_port(), device, threads, outs, tuple(args)),
                                 nprocs=world, join=False, daemon=True, start_method="spawn")
    return Ranks(context, outs, timeout, tmp)


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), **kwargs) -> List[Any]:
    """``start_ranks(...).join()``."""
    return start_ranks(fn, world, args, **kwargs).join()
