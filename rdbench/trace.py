"""What a traced window's ``torch.profiler`` events say about the device.

The arithmetic of the program's ``tools/profile_fast_path.py``
(``device_shares``): kernels are the device events whose names no host
event carries; the device is busy over the union of their intervals.
Read from the raw kineto events, which a window of a few million kernels
(the solve's replayed graphs) keeps manageable.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

WINDOW_SPAN = "rdbench.window"
NAME_CHARS = 120  # kernel names are cut to this many characters in the breakdown


def read_events(prof, phase_prefixes: Sequence[str]) -> Dict:
    """From a finished ``torch.profiler.profile``: the window's length, the
    device's busy seconds in it, device seconds by kernel name, and idle
    seconds by the pipeline phase the host was in (``between_phases``
    outside every phase span)."""
    from torch.autograd import DeviceType

    cpu_names, spans, device = set(), [], []
    prefixes = tuple(phase_prefixes) + (WINDOW_SPAN,)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            cpu_names.add(name)
            if name.startswith(prefixes):
                spans.append((name, e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), e.end_ns()))
    windows = [(a, b) for n, a, b in spans if n == WINDOW_SPAN]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0]
    kernels = [(n, max(a, w0), min(b, w1)) for n, a, b in device if n not in cpu_names and b > w0 and a < w1]
    by_name: Dict[str, float] = {}
    for n, a, b in kernels:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    merged: List[List[int]] = []
    for a, b in sorted((a, b) for _, a, b in kernels):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_ns = sum(b - a for a, b in merged)
    phases = sorted((a, b, n) for n, a, b in spans if n != WINDOW_SPAN)
    starts = [a for a, _, _ in phases]
    idle: Dict[str, float] = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            i = bisect.bisect_right(starts, a) - 1
            where = phases[i][2] if i >= 0 and a < phases[i][1] else "between_phases"
            idle[where] = idle.get(where, 0.0) + (b - a) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9, "kernel_s": by_name, "idle_s": idle,
            "kernels": len(kernels)}


def top(table: Dict[str, float], k: int = 10) -> List[Tuple[str, float]]:
    return [[n[:NAME_CHARS], s] for n, s in sorted(table.items(), key=lambda kv: -kv[1])[:k]]
