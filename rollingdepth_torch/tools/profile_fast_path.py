"""Where a preset's time goes on the card: phases, device busy share, kernels.

    python -m rollingdepth_torch.tools.profile_fast_path [--preset fast|fast1024|full|paper | --relight]
        [--frames 60] [--height H --width W] [--out DIR]

Builds the full-width pipeline with seeded random weights
(``utils/synthetic.py``) in the preset's dtype and runs the preset (default
``fast``) three times on the same frames: once to warm up
(``warmup_wall_s``, first-use costs included), once timed without the
profiler (``wall_s``, the call's wall time), then once under
``torch.profiler`` with CPU and CUDA activities (``profiled_wall_s``).
Frames default to 16:9 at the preset's resolution (432x768, or 576x1024
for ``fast1024`` and ``full``), TF32 off.  For each phase
(the pipeline's ``rollingdepth.<phase>`` spans) it reports the host time,
the device time covered by kernels inside the span and the device's idle
share; then the kernels by total device time.  Prints JSON lines and writes
``profile_<preset>.json`` into ``--out`` (the profiler's own table is not
written: ``key_averages`` takes minutes on the relight call's 1.8M kernels).
The profiler slows the host: a phase bound by the host (the aligner's
loop) runs longer under it than in ``chip_smoke.py``, so its idle share
here is an upper bound.

In the profiled call every GroupNorm of the models runs with the silu after
it inside one span, ``NORM_SPAN`` (``norm_chain_spans``), and ``norm_chain``
reports per phase the device time of the kernels launched inside those
spans, their launches, and the chain's kernels by name.  The span wraps
``layers.group_norm`` and ``F.silu`` of a 4-D tensor, so it holds the same
chain whether the silu runs after the norm (op by op) or inside it (the
hand-written pair of ``ops/group_norm.py``); on an older checkout of the
package, copy this file over its own to measure it the same way.

``--relight`` runs the relight path instead (``random_relight_pipeline``,
bf16, ``RELIGHT_CALL``: t2i init, dilations [1, 25], 20 DPM++ SDE steps,
the three per-channel solves) on a synthetic fg/bg pair at 720x640 (the
``rollingimg.<phase>`` spans), warmed up on the first 6 frames, and
writes ``profile_relight.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from ..utils.device import card_name


def device_shares(events, prefixes=("rollingdepth.", "rollingimg.")):
    """From a ``torch.profiler`` run's ``events()``: for each pipeline phase
    span (``<prefix><phase>``) its host time, the device time covered by
    kernels inside it and the device's idle share; the same over the whole
    call (None without a span); and the kernel events."""
    from torch.autograd import DeviceType

    spans = {e.name: e.time_range for e in events if e.name.startswith(prefixes)}
    # device-side copies of CPU ranges (record_function spans, the
    # optimizer's step annotation) carry a CPU op's name; kernels do not
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in cpu_names]
    merged = []  # union of kernel intervals, in case streams overlap
    for lo, hi in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])

    def busy_us(a: float, b: float) -> float:
        return sum(max(0.0, min(hi, b) - max(lo, a)) for lo, hi in merged)

    phases = {}
    for span, r in spans.items():
        host_us = r.end - r.start
        dev_us = busy_us(r.start, r.end)
        phases[span.split(".", 1)[1]] = {"host_ms": host_us / 1e3, "device_busy_ms": dev_us / 1e3,
                                         "idle_share": 1.0 - dev_us / host_us if host_us > 0 else None}
    call = None
    if spans:
        a = min(r.start for r in spans.values())
        b = max(r.end for r in spans.values())
        call = {"host_ms": (b - a) / 1e3, "device_busy_ms": busy_us(a, b) / 1e3,
                "idle_share": 1.0 - busy_us(a, b) / (b - a)}
    return phases, call, kernels


NORM_SPAN = "rollingdepth_norm.group_norm_silu"


@contextlib.contextmanager
def norm_chain_spans():
    """Each ``layers.group_norm`` call, and each ``F.silu`` of a 4-D tensor
    (the silu after a norm: the time embedding's is 2-D), inside a profiler
    span ``NORM_SPAN``; a call inside an open span opens none."""
    import torch.nn.functional as F
    from torch.profiler import record_function

    from ..models import layers

    norm, silu = layers.group_norm, F.silu
    depth = [0]

    def spanned(fn, x, *args, **kwargs):
        if depth[0] or x.dim() != 4:
            return fn(x, *args, **kwargs)
        depth[0] += 1
        try:
            with record_function(NORM_SPAN):
                return fn(x, *args, **kwargs)
        finally:
            depth[0] -= 1

    layers.group_norm = lambda m, x, *a, **kw: spanned(lambda t, *b, **k: norm(m, t, *b, **k), x, *a, **kw)
    F.silu = lambda x, *a, **kw: spanned(silu, x, *a, **kw)
    try:
        yield
    finally:
        layers.group_norm, F.silu = norm, silu


def norm_chain(kineto_events, prefixes=("rollingdepth.", "rollingimg.")) -> dict:
    """Per pipeline phase, the GroupNorm chain of a run under
    ``norm_chain_spans``, from the profiler's raw events
    (``prof.profiler.kineto_results.events()``): the spans' calls, and the
    device time, launches and names of the kernels whose launch call (the
    ``cudaLaunchKernel`` or ``cuLaunchKernel`` event of the kernel's
    correlation id) ran on the host inside a span (one thread launches the
    pipeline's kernels); ``all`` sums the phases.  This join holds for
    kernels launched through ctypes as for PyTorch's own, where the
    profiler's op-to-kernel links (``FunctionEvent.kernels``) do not."""
    import bisect

    from torch.autograd import DeviceType

    cpu = [e for e in kineto_events if e.device_type() == DeviceType.CPU]
    cpu_names = {e.name() for e in cpu}  # device-side copies of CPU spans carry their names; kernels do not
    phases = [(e.name().split(".", 1)[1], e.start_ns(), e.end_ns()) for e in cpu if e.name().startswith(prefixes)]
    spans = sorted((e.start_ns(), e.end_ns()) for e in cpu if e.name() == NORM_SPAN)
    launches = {e.correlation_id(): e.start_ns() for e in cpu if e.name().startswith("cu")}

    def phase_of(t):
        return next((p for p, a, b in phases if a <= t <= b), "outside")

    out = {}

    def row(key):
        return out.setdefault(key, {"calls": 0, "device_ms": 0.0, "launches": 0, "by_kernel": {}})

    for a, _ in spans:
        for key in (phase_of(a), "all"):
            row(key)["calls"] += 1
    for k in kineto_events:
        if k.device_type() != DeviceType.CUDA or k.name() in cpu_names or k.correlation_id() not in launches:
            continue
        t = launches[k.correlation_id()]
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        if i < 0 or not spans[i][0] <= t <= spans[i][1]:
            continue
        ms = k.duration_ns() / 1e6
        for key in (phase_of(t), "all"):
            r = row(key)
            r["device_ms"] += ms
            r["launches"] += 1
            by = r["by_kernel"].setdefault(k.name()[:120], [0, 0.0])
            by[0] += 1
            by[1] += ms
    for r in out.values():
        r["by_kernel"] = [{"name": n, "count": c, "ms": ms}
                          for n, (c, ms) in sorted(r["by_kernel"].items(), key=lambda kv: -kv[1][1])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="fast", choices=["fast", "fast1024", "full", "paper"])
    ap.add_argument("--relight", action="store_true", help="the relight path at 720x640 instead of a depth preset")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_fast_path: no CUDA device", file=sys.stderr)
        return 2
    from ..io.pretrained import DTYPE_MAP
    from ..utils.presets import resolve_preset
    from ..utils.synthetic import RELIGHT_CALL, preset_kwargs, random_depth_pipeline, random_relight_pipeline

    settings = resolve_preset(args.preset)
    name = "relight" if args.relight else args.preset
    if args.relight:
        width, height = args.width or 720, args.height or 640
    else:
        width = args.width or settings.res
        height = args.height or width * 9 // 16
    smi = card_name()
    # fp32 in full fp32, as chip_smoke.py and chunk_times run it: TF32 off for matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    if args.relight:
        pipe, _ = random_relight_pipeline("cuda", torch.bfloat16, seed=0)
        fg, bg = (torch.rand((args.frames, 3, height, width), generator=gen, device="cuda") * 2 - 1
                  for _ in range(2))
        run = lambda n=None, **kw: pipe.forward(fg[:n], bg[:n], **RELIGHT_CALL, **kw)  # noqa: E731
        warm = 6  # the warm-up: the first 6 frames
    else:
        pipe, _ = random_depth_pipeline("cuda", DTYPE_MAP[settings.dtype], seed=0)
        frames = torch.randint(0, 256, (args.frames, 3, height, width), generator=gen,
                               device="cuda", dtype=torch.uint8)
        call = preset_kwargs(args.preset)
        run = lambda n=None, **kw: pipe(input_frames=frames[:n], **call, **kw)  # noqa: E731
        warm = None  # the warm-up: the same call
    walls = []  # the warm-up call (first-use costs included), then the call warm
    for n in (warm, None):
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    warmup_s, wall_s = walls

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, norm_chain_spans():
        t0 = time.perf_counter()
        run(verbose=True)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    events = prof.events()
    phases, call, kernels = device_shares(events)
    result = {"card": smi, "preset": name, "frames": args.frames, "res": [height, width], "wall_s": wall_s,
              "warmup_wall_s": warmup_s, "profiled_wall_s": profiled_s, "attention": os.environ.get("ROLLINGDEPTH_ATTN", "auto"),
              "device_kernels_seen": len(kernels), "phases": phases, "norm_chain": norm_chain(prof.profiler.kineto_results.events())}
    if call is not None:
        result["call"] = call
    by_name = {}
    for k in kernels:
        row = by_name.setdefault(k.name, [0, 0.0])
        row[0] += 1
        row[1] += k.time_range.end - k.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:30]
    result["kernels_by_device_ms"] = [{"name": n[:120], "count": c, "ms": us / 1e3} for n, (c, us) in top]
    for key in ("phases", "call", "norm_chain"):
        print(json.dumps({key: result.get(key), "card": smi}), flush=True)
    print(json.dumps({k: result[k] for k in ("wall_s", "warmup_wall_s", "profiled_wall_s", "attention", "preset",
                                             "frames", "res")}),
          flush=True)
    print(json.dumps({"kernels_by_device_ms": result["kernels_by_device_ms"][:15]}), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_{name}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
