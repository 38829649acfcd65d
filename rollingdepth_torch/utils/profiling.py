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

Below the phases, ``span`` opens a range at each layer boundary while a
profiler runs: ``rd.clip`` (a pipeline's ``forward``, ``clip_span``),
``rd.unet``, ``rd.vae.encode``, ``rd.vae.decode``, ``rd.solve`` and its
stages ``rd.solve.prepare``, ``.load``, ``.replay`` (the iterations: on
the card the kernel's one launch) and ``.merge``, and ``rd.phase_sync`` (a phase's card sync).  They share the
profiler's clock with the card's kernels and the runtime's calls, so a
trace can put each kernel, idle gap and host sync under the span that
caused it; those inside a phase appear in the phase's trace under
``ROLLINGDEPTH_TRACE_DIR``.  Without a profiler a span is one flag test:
``record_function`` is not entered.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import logging
import os
import time
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as autograd_profiler

logger = logging.getLogger(__name__)

TRACE_ENV = "ROLLINGDEPTH_TRACE_DIR"
CLIP_SPAN = "rd.clip"
PHASE_SYNC_SPAN = "rd.phase_sync"
_NO_SPAN = contextlib.nullcontext()


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
                    with span(PHASE_SYNC_SPAN):
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


def span(name: str, args=None):
    """A ``torch.profiler.record_function`` range ``name`` (``args``, if
    given, as its string) while a profiler runs; otherwise one shared no-op
    context.  Entering ``record_function`` costs microseconds even with no
    profiler; the test here, a module flag, costs a tenth of one."""
    if autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name, None if args is None else str(args))
    return _NO_SPAN


def annotate(name: str):
    """A named range in ``torch.profiler`` traces (JAX's ``TraceAnnotation``)."""
    return span(name)


def clip_span(forward):
    """A pipeline's ``forward`` inside an ``rd.clip`` span whose args, the
    pipeline's call number (``pipe.clip_calls``) and the clip's frame count
    (its first argument's length), are the clip's id for every span that
    nests in it."""
    frames_arg = list(inspect.signature(forward).parameters)[1]

    @functools.wraps(forward)
    def spanned(pipe, *args, **kwargs):
        pipe.clip_calls += 1
        frames = args[0] if args else kwargs[frames_arg]
        with span(CLIP_SPAN, {"call": pipe.clip_calls, "frames": len(frames)}):
            return forward(pipe, *args, **kwargs)

    return spanned
