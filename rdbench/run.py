"""One run of one cell of the port's benchmark.

    python3 -m rdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is sits in files found by name, so a later change adds
a cell, a configuration, a traffic mix or a per-layer metric by adding
files:
- ``rdbench/workloads/<cell>.json``: its configuration, traffic, call
  (the entry's arguments), chips, ``why`` and the limits of its check;
- ``rdbench/configs/<config>.json``: widths as published, the builder
  (``rdbench/builders/<builder>.py``) and the served dtype;
- ``rdbench/traffic/<traffic>.json``: what ``rdbench/traffic.py`` draws;
- ``rdbench/metrics/<metric>.py``: a ``read(ctx)`` for each per-layer
  metric ``BENCHMARK.json`` names for the cell.

A run: set-up (imports, the kernels from the build cache, seeded weights
on the card, the max-free gate, one warm-up clip at the cell's shapes, the
traffic's clips drawn on the host) is ``setup_s``.  Then clips run back to
back, one stream, as the CLI runs them: each clip's frames uploaded, run
through the entry and its output fetched to the host; a clip starts while
fewer than ``--seconds`` have passed, and ``frames_per_s`` is all the
frames over the window's wall time.  With ``--trace 1`` the window runs under
``torch.profiler`` with the phases' card syncs on, and the line carries
the per-layer metrics instead.  After the window the peak memory is read,
the program freed, and one clip of the window, drawn by the seed, is run
again by the fp32 reference and compared (``check.py``).  The last line of
standard output is the result; the numbers compared, with their limits,
are the last lines of standard error and the last key of the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here: the imports are part of it

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout: BENCHMARK.json and the program
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "rollingdepth_tpu")  # top-level module names no run may load
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # H100 SXM data sheet, dense, at 700 W
PEAK_BYTES_PER_S = 3.35e12


def set_cache_dirs() -> None:
    """The kernels' nvcc builds and any Triton cache live at fixed paths in the checkout."""
    os.environ["ROLLINGDEPTH_TORCH_BUILD"] = os.path.join(CACHE, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: str = HERE):
    """``rdbench/<kind>/<name>.py`` as a module (names may hold ``-`` and ``.``)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"rdbench.{kind}.{name.replace('-', '_').replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, bench_dir: str = HERE) -> Dict:
    """A cell with its configuration, traffic and builder module."""
    cell = load_json(bench_dir, "workloads", name + ".json")
    cfg = load_json(bench_dir, "configs", cell["config"] + ".json")
    traffic = load_json(bench_dir, "traffic", cell["traffic"] + ".json")
    return {"name": name, "cell": cell, "config": cfg, "traffic": traffic,
            "builder": load_module("builders", cfg["builder"], bench_dir)}


def per_layer_metrics(cell: str, benchmark: Dict) -> list:
    return [m for m in benchmark["per_layer"] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", bench_dir: str = HERE,
             benchmark: Optional[Dict] = None, t_start: float = T_START) -> Dict:
    """One run of cell ``name``; returns the result line's object."""
    import numpy as np
    import torch

    from . import check, traffic as gen
    from .trace import read_events, top

    spec = load_cell(name, bench_dir)
    cell, cfg, traffic, builder = spec["cell"], spec["config"], spec["traffic"], spec["builder"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    # ---- set-up
    t_build = time.perf_counter()
    program = builder.Program(cfg, cell, seed, dev)
    sync()
    t_warm = time.perf_counter()
    program.run(gen.make_clip(traffic, seed, gen.WARMUP_CLIP, builder))  # every shape, the solve's capture
    t_pool = time.perf_counter()
    pool = gen.pool(traffic, seed, builder)
    sync()
    setup_s = time.perf_counter() - t_start
    detail = program.setup_detail() if hasattr(program, "setup_detail") else {}
    print(json.dumps({"setup": {"setup_s": setup_s, "imports_s": t_build - t_start, "build_s": t_warm - t_build,
                                "warmup_clip_s": t_pool - t_warm, "pool_s": t_start + setup_s - t_pool, **detail}}),
          flush=True)

    # ---- the window
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function("rdbench.window")
        span.__enter__()
    outputs, clips = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        clip = pool[len(outputs) % len(pool)]
        c0 = time.perf_counter()
        outputs.append(program.run(clip, verbose=trace))
        clips.append({"frames": int(clip["frames"].shape[0]), "entry_s": time.perf_counter() - c0,
                      "timings": program.timings})
    sync()
    window_s = time.perf_counter() - t0
    if prof is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    print(json.dumps({"counters": program.counters(), "clips": len(clips), "window_s": window_s,
                      "clip_s": [c["entry_s"] for c in clips], "phases_s": [c["timings"] for c in clips]}), flush=True)

    result = {"attempted": len(clips),
              "failed": sum(not builder.sound(out, c["frames"], traffic) for out, c in zip(outputs, clips)),
              "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    frames = sum(c["frames"] for c in clips)
    if not trace:
        result["metrics"]["frames_per_s"] = {"value": frames / window_s, "unit": "frames/s"}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        events = read_events(prof, builder.PHASE_PREFIXES)
        del prof
        result["device"]["busy_s"] = events["busy_s"]
        result["device"]["window_s"] = events["window_s"]
        result["breakdown"] = {"device_ops": top(events["kernel_s"]), "idle_gaps": top(events["idle_s"])}
        counts, per_length = {}, {}
        for c in clips:
            if c["frames"] not in per_length:
                per_length[c["frames"]] = builder.clip_counts(cfg, cell, traffic, c["frames"])
            for k, v in per_length[c["frames"]].items():
                counts[k] = counts.get(k, 0.0) + v
        ctx = {"phases": builder.PHASES, "clips": clips, "window_s": window_s, "trace": events, "counts": counts,
               "peak_flops": PEAK_FLOPS[cfg["dtype"]], "peak_bytes_per_s": PEAK_BYTES_PER_S}
        bench = benchmark or load_json(ROOT, "BENCHMARK.json")
        for m in per_layer_metrics(name, bench):
            value = load_module("metrics", m["name"], bench_dir).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the check: one clip of the window, drawn by the seed, against the reference
    k = int(np.random.default_rng([seed, 7]).integers(len(outputs)))
    got, clip = outputs[k], pool[k % len(pool)]
    del outputs, pool
    program.close()
    del program
    c0 = time.perf_counter()
    numbers = builder.Reference(cfg, cell, seed, dev).numbers(clip, got, set(cell["limits"]))
    sync()
    print(json.dumps({"reference_clip": k, "reference_s": time.perf_counter() - c0}), flush=True)
    checks = check.verdict(numbers, cell["limits"])
    result["correct"] = result["failed"] == 0 and check.passed(checks)
    result["checks"] = checks
    return {key: result[key] for key in ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
            if key in result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    benchmark = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in benchmark["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"rdbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"rdbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 3
    print(json.dumps({"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda}), file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), benchmark=benchmark)
    found = forbidden_modules()
    if found:
        print(f"rdbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
