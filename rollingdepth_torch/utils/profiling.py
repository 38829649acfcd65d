"""Per-phase timers and opt-in ``torch.profiler`` traces.

Counterpart of ``rollingdepth_tpu/utils/profiling.py``.  The pipelines
time their phases with ``PhaseTimer`` (``last_timings``); every phase is a
``torch.profiler.record_function`` range named ``<prefix>.<phase>``, so a
profiler the caller runs (``tools/profile_fast_path.py``) sees it.  Set
``ROLLINGDEPTH_TRACE_DIR`` to have each phase write its own Chrome trace
(JSON, for ``chrome://tracing`` or Perfetto) there: ``<phase>.json``, then
``<phase>.1.json``, ... when a phase runs again.  A traced phase
synchronises the card before it ends, so that its trace holds its device
work, and its time includes the profiler's own cost.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)

TRACE_ENV = "ROLLINGDEPTH_TRACE_DIR"


class PhaseTimer:
    """Accumulates named phase durations (host clock) into ``timings``.
    On a CUDA ``device`` with ``verbose`` the card is synchronised at the end
    of each phase, so the time covers its device work."""

    def __init__(self, verbose: bool = False, prefix: str = "rollingdepth", device=None):
        self.timings: Dict[str, float] = {}
        self.verbose = verbose
        self.prefix = prefix
        self.device: Optional[torch.device] = None if device is None else torch.device(device)
        self._trace_dir = os.environ.get(TRACE_ENV)

    def _trace_path(self, name: str) -> str:
        """``<dir>/<name>.json``, or the first free ``<dir>/<name>.<k>.json``."""
        os.makedirs(self._trace_dir, exist_ok=True)
        path, k = os.path.join(self._trace_dir, f"{name}.json"), 0
        while os.path.exists(path):
            k += 1
            path = os.path.join(self._trace_dir, f"{name}.{k}.json")
        return path

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        on_card = self.device is not None and self.device.type == "cuda"
        prof = None
        if self._trace_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            with annotate(f"{self.prefix}.{name}"):
                yield
                if on_card and (self.verbose or prof is not None):
                    torch.cuda.synchronize(self.device)
        finally:
            dt = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(self._trace_path(name))
        self.timings[name] = self.timings.get(name, 0.0) + dt
        if self.verbose:
            logger.info("phase %s: %.2fs", name, dt)

    def summary(self) -> str:
        total = sum(self.timings.values())
        parts = [f"{k}={v:.2f}s" for k, v in self.timings.items()]
        return f"total={total:.2f}s ({', '.join(parts)})"


def annotate(name: str):
    """A named range in ``torch.profiler`` traces (JAX's ``TraceAnnotation``)."""
    return torch.profiler.record_function(name)
