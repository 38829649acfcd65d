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
When a rank fails, the others that wait on it in a collective fail too;
``join`` raises the root cause, not whichever failure it saw first.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection as mp_connection
import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)
# seconds the other ranks get to end after one failed, before they are killed
FAILURE_GRACE = 10.0
# what a rank's collective raises when another rank has gone: not a root cause
COLLATERAL = ("Connection closed by peer", "Connection reset by peer", "Broken pipe", "DistBackendError",
              "NCCL communicator was aborted")


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
            failed = self._wait()
            if failed:
                self._raise_root_cause(failed)
            return [torch.load(o, weights_only=False) for o in self.outs]
        finally:
            self.kill()
            self._tmp.cleanup()

    def _wait(self) -> List[int]:
        """Wait until every rank ended or one failed; then give the others
        ``FAILURE_GRACE`` seconds to end (a rank waiting in a collective
        with the failed one usually fails too).  Returns the failed ranks."""
        procs = self.context.processes
        running = {p.sentinel: r for r, p in enumerate(procs)}
        while running:
            left = self.deadline - time.monotonic()
            if left <= 0:
                codes = [p.exitcode for p in procs]
                raise TimeoutError(f"ranks still running after {self.timeout:.0f} s: exit codes {codes}")
            for s in mp_connection.wait(list(running), timeout=left):
                procs[running.pop(s)].join()
            if any(p.exitcode not in (None, 0) for p in procs):
                grace = time.monotonic() + FAILURE_GRACE
                for p in procs:
                    p.join(max(0.0, grace - time.monotonic()))
                break
        return [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]

    def _raise_root_cause(self, failed: List[int]) -> None:
        """Raise the error of the rank that failed first on its own: a
        traceback that is not a collective's collateral failure
        (``COLLATERAL``), or else the earliest, by the error file's time
        stamp.  A failed rank without an error file ended by a signal or
        ``sys.exit``."""
        from torch.multiprocessing import ProcessExitedException, ProcessRaisedException

        procs, files = self.context.processes, self.context.error_files
        traces = []
        for r in failed:
            if os.access(files[r], os.R_OK):
                with open(files[r], "rb") as fh:
                    trace = pickle.load(fh)
                own = not any(c in trace for c in COLLATERAL)
                traces.append((own, -os.stat(files[r]).st_mtime, r, trace))
        if traces:
            _, _, r, trace = max(traces, key=lambda e: e[:2])
            raise ProcessRaisedException(f"\n\n-- Process {r} terminated with the following error:\n{trace}",
                                         r, procs[r].pid)
        r = failed[0]
        raise ProcessExitedException(f"process {r} terminated with exit code {procs[r].exitcode}",
                                     error_index=r, error_pid=procs[r].pid, exit_code=procs[r].exitcode)


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
