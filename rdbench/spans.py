"""The device's time, its idle gaps and the host's syncs under the program's spans.

    python3 -m rdbench.spans --workload <cell> --seed <n> --seconds <s>

The port opens a ``torch.profiler`` range at each layer boundary while a
profiler runs (``rollingdepth_torch/utils/profiling.py`` ``span``:
``rd.clip``, ``rd.unet``, ``rd.vae.encode``/``.decode``, ``rd.solve`` and
its stages, ``rd.phase_sync``).  ``read_spans`` reads them from a finished
profile; the command above makes the harness's traced run of a cell
(``run.run_cell`` with ``--trace 1``), reads the spans from the same
profile, and prints a ``{"spans": ...}`` line, a ``{"readings": ...}`` line
(``readings``: the UNet's, the VAE's and the solve's device seconds a clip
and the host's syncs a clip) and the traced run's result line last.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import run, trace
from .trace import WINDOW_SPAN

SPAN_PREFIXES = ("rd.",)  # the program's spans below its phases
CLIP_SPAN = "rd.clip"  # one a pipeline call: a clip
PHASE_SYNC_SPAN = "rd.phase_sync"  # a phase's card sync, on only in a traced run
OUTSIDE = "outside_clips"  # what no span of the program was open for
RUNTIME_PREFIX = "cu"  # CUDA API calls: cudaLaunchKernel, cuLaunchKernel (ctypes), cudaGraphLaunch, ...
# the runtime calls that block the host until the card has caught up
# (PyTorch's copy from pageable memory ends in cudaStreamSynchronize)
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"})
# each reading's spans: the device busy under them and what nests in them
BUSY_SPANS = {"unet_busy_s": ("rd.unet",), "vae_busy_s": ("rd.vae.encode", "rd.vae.decode"),
              "coalign_busy_s": ("rd.solve",)}


def _thread(e) -> Tuple[int, int]:
    """A host event's thread.  The profiler numbers the threads of its own
    ranges (``start_thread_id``) but gives the runtime's calls of every
    thread the first thread's number; ``device_resource_id`` carries the
    system's thread id on both."""
    return e.start_thread_id(), e.device_resource_id()


class _Tree:
    """One thread's spans, nested by time: ``parent`` of each (-1 at the top)."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        spans.sort(key=lambda s: (s[0], -s[1]))
        self.start = np.array([s[0] for s in spans], np.int64)
        self.end = np.array([s[1] for s in spans], np.int64)
        self.name = [s[2] for s in spans]
        self.parent = np.full(len(spans), -1, np.int64)
        stack: List[int] = []
        for i, (a, _, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] <= a:
                stack.pop()
            if stack:
                self.parent[i] = stack[-1]
            stack.append(i)

    def innermost(self, t: np.ndarray) -> np.ndarray:
        """The innermost span open at each time of ``t`` (-1 where none is):
        the last to start before it, or the first of its ancestors still open."""
        i = np.searchsorted(self.start, t, side="right") - 1
        while True:
            closed = (i >= 0) & (self.end[np.maximum(i, 0)] < t)
            if not closed.any():
                return i
            i[closed] = self.parent[i[closed]]


def _union_ns(a: np.ndarray, b: np.ndarray) -> int:
    """The length of the union of the intervals [a, b)."""
    if a.size == 0:
        return 0
    order = np.argsort(a, kind="stable")
    a, reach = a[order], np.maximum.accumulate(b[order])
    first = np.ones(a.size, bool)
    first[1:] = a[1:] > reach[:-1]
    last = np.append(np.flatnonzero(first)[1:] - 1, a.size - 1)
    return int((reach[last] - a[first]).sum())


def read_spans(prof, prefixes: Sequence[str]) -> Dict:
    """From a finished ``torch.profiler.profile``, in one pass over its
    events: the window's length, its device busy and kernels as
    ``trace.read_events`` reads them, and ``by_span``: for each span name
    under ``prefixes`` (and ``OUTSIDE``), over the window (``WINDOW_SPAN``):
    - ``calls``; ``host_self_s``: its spans' time minus their child spans';
    - ``busy_s``: the device busy (union of intervals) with the kernels
      whose launch ran with it as the innermost span open on the launching
      thread; ``busy_incl_s``: the same for kernels launched inside it or
      any span nested in it.  A kernel joins its launch by correlation id:
      ``cudaLaunchKernel``, ``cuLaunchKernel`` (ctypes) and
      ``cudaGraphLaunch`` (every kernel of a replayed graph) alike;
    - ``idle_s``: the window's idle gaps, each under the innermost span open
      at its start on the thread that runs the clips;
    - ``syncs``, ``syncs_incl``: the synchronising runtime calls
      (``SYNC_CALLS``) with it innermost, and inside it.
    The innermost busy times sum to ``busy_s`` (less any overlap of two
    spans' kernels on two streams), the idle times to the rest of the
    window."""
    from torch.autograd import DeviceType

    prefixes = tuple(prefixes)
    cpu_names, device, window = set(), [], None
    spans: Dict[Tuple[int, int], List[Tuple[int, int, str]]] = {}
    launches: Dict[int, Tuple[Tuple[int, int], int]] = {}  # runtime call's correlation id -> (thread, start)
    syncs: List[Tuple[Tuple[int, int], int]] = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            cpu_names.add(name)
            if name.startswith(prefixes):
                spans.setdefault(_thread(e), []).append((e.start_ns(), e.end_ns(), name))
            elif name == WINDOW_SPAN:
                window = window or (e.start_ns(), e.end_ns())
            elif name.startswith(RUNTIME_PREFIX):
                launches[e.correlation_id()] = (_thread(e), e.start_ns())
                if name in SYNC_CALLS:
                    syncs.append((_thread(e), e.start_ns()))
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    kernels = [(max(a, w0), min(b, w1), c) for n, a, b, c in device if n not in cpu_names and b > w0 and a < w1]

    # every thread's spans, numbered in one list: node ids and their names
    trees, offset, names = {}, {}, []
    for th, ss in spans.items():
        trees[th] = tree = _Tree(ss)
        offset[th] = len(names)
        names += tree.name
    parent = np.concatenate([np.where(t.parent >= 0, t.parent + offset[th], -1) for th, t in trees.items()]
                            or [np.zeros(0, np.int64)])
    start = np.concatenate([t.start for t in trees.values()] or [np.zeros(0, np.int64)])
    end = np.concatenate([t.end for t in trees.values()] or [np.zeros(0, np.int64)])

    def nodes_at(points: List[Tuple[Tuple[int, int], int]]) -> np.ndarray:
        """The innermost span (its node id, -1 for none) open at each (thread, time)."""
        out = np.full(len(points), -1, np.int64)
        by_thread: Dict[Tuple[int, int], List[int]] = {}
        for k, (th, _) in enumerate(points):
            if th in trees:
                by_thread.setdefault(th, []).append(k)
        for th, ks in by_thread.items():
            t = np.array([points[k][1] for k in ks], np.int64)
            i = trees[th].innermost(t)
            out[ks] = np.where(i >= 0, i + offset[th], -1)
        return out

    # kernels: under the span their launch ran in
    corrs = sorted({c for _, _, c in kernels})
    at_corr = dict(zip(corrs, nodes_at([launches.get(c, (None, 0)) for c in corrs])))
    k_node = np.array([at_corr[c] for _, _, c in kernels], np.int64)
    k_a = np.array([a for a, _, _ in kernels], np.int64)
    k_b = np.array([b for _, b, _ in kernels], np.int64)

    # idle gaps: under the span open at their start on the clips' thread
    main = max(trees, key=lambda th: (trees[th].name.count(CLIP_SPAN), len(trees[th].name)), default=None)
    order = np.argsort(k_a, kind="stable")
    gap_a = np.concatenate([[w0], np.maximum.accumulate(k_b[order])]).astype(np.int64)
    gap_b = np.concatenate([k_a[order], [w1]]).astype(np.int64)
    idle = gap_b > gap_a
    gap_a, gap_b = gap_a[idle], gap_b[idle]
    g_node = nodes_at([(main, t) for t in gap_a.tolist()])
    s_node = nodes_at([(th, t) for th, t in syncs if w0 <= t <= w1])

    # by node id + 1 (0: no span); each node's chain: its name and its ancestors' (a name once)
    key = [OUTSIDE] + names
    chain: List[Tuple[str, ...]] = [(OUTSIDE,)]
    for i, n in enumerate(names):
        up = chain[parent[i] + 1] if parent[i] >= 0 else ()
        chain.append(up if n in up else (n,) + up)
    child_ns = np.zeros(len(names), np.int64)
    np.add.at(child_ns, parent[parent >= 0], (end - start)[parent >= 0])
    in_window = (end > w0) & (start < w1)
    calls = np.concatenate([[0], in_window])
    self_ns = np.concatenate([[0], np.where(in_window, end - start - child_ns, 0)])
    idle_ns = np.bincount(g_node + 1, weights=gap_b - gap_a, minlength=len(key))
    sync_n = np.bincount(s_node + 1, minlength=len(key))
    inner: Dict[str, List[int]] = {}
    incl: Dict[str, List[int]] = {}
    for i, n in enumerate(key):
        inner.setdefault(n, []).append(i)
        for m in chain[i]:
            incl.setdefault(m, []).append(i)

    def busy_s(ids: List[int]) -> float:
        mask = np.isin(k_node + 1, ids)
        return _union_ns(k_a[mask], k_b[mask]) / 1e9

    table = {n: {"calls": int(calls[ids].sum()), "host_self_s": float(self_ns[ids].sum()) / 1e9,
                 "busy_s": busy_s(ids), "busy_incl_s": busy_s(incl[n]), "idle_s": float(idle_ns[ids].sum()) / 1e9,
                 "syncs": int(sync_n[ids].sum()), "syncs_incl": int(sync_n[incl[n]].sum())}
             for n, ids in inner.items()}
    return {"window_s": (w1 - w0) / 1e9, "busy_s": _union_ns(k_a, k_b) / 1e9, "kernels": len(kernels),
            "by_span": table}


def busy_per_clip(spans: Dict, names: Sequence[str]) -> Optional[float]:
    """From ``read_spans``: the device busy under the spans ``names``, with
    what nests in them, over the window's clips (``CLIP_SPAN``).  None
    without clips or busy time: a program without the spans, or no card.
    The names' spans must not nest in one another."""
    by_span = spans["by_span"]
    clips = by_span.get(CLIP_SPAN, {}).get("calls", 0)
    busy = sum(by_span[n]["busy_incl_s"] for n in names if n in by_span)
    if clips == 0 or busy <= 0:
        return None
    return busy / clips


def host_syncs(spans: Dict) -> Optional[float]:
    """From ``read_spans``: the synchronising runtime calls made inside the
    ``rd.clip`` spans, less those inside ``rd.phase_sync``, over the clips.
    None without clips, or without the card (no runtime calls)."""
    by_span = spans["by_span"]
    clip = by_span.get(CLIP_SPAN)
    if not clip or clip["calls"] == 0 or spans["kernels"] == 0:
        return None
    return (clip["syncs_incl"] - by_span.get(PHASE_SYNC_SPAN, {}).get("syncs_incl", 0)) / clip["calls"]


def readings(spans: Dict) -> Dict[str, float]:
    """The UNet's, the VAE's and the solve's device seconds a clip
    (``BUSY_SPANS``) and the host's syncs a clip; a reading with nothing
    to read is left out."""
    out = {name: busy_per_clip(spans, names) for name, names in BUSY_SPANS.items()}
    out["host_syncs"] = host_syncs(spans)
    return {k: v for k, v in out.items() if v is not None}


def traced_run(name: str, seed: int, seconds: float, device: str = "cuda", bench_dir: str = run.HERE,
               benchmark: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    """The harness's traced run of cell ``name`` and ``read_spans`` of its
    profile: the spans are read where the run reads its events, from the
    same profile."""
    found: Dict = {}
    read_events = trace.read_events

    def read_both(prof, phase_prefixes):
        found.update(read_spans(prof, SPAN_PREFIXES + tuple(phase_prefixes)))
        return read_events(prof, phase_prefixes)

    trace.read_events = read_both
    try:
        result = run.run_cell(name, seed, seconds, True, device=device, bench_dir=bench_dir, benchmark=benchmark)
    finally:
        trace.read_events = read_events
    return result, found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("rdbench.spans: no CUDA device", file=sys.stderr)
        return 3
    result, spans = traced_run(args.workload, args.seed, args.seconds)
    print(json.dumps({"spans": spans}), flush=True)
    print(json.dumps({"readings": readings(spans)}), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
