"""BENCHMARK.json keeps to its format, and a cell, a configuration, a
traffic mix, a builder or a per-layer metric is found by name once its file
is there."""

import filecmp
import json
import os
import re

import pytest

from rdbench import control, run
from rdbench.builders import depth as depth_builder

from .test_rdbench_harness import SEED, bench_for

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "-m", "rdbench.run"] and bench["paths"] == ["rdbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]] + [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in bench["end_to_end"] + bench["per_layer"]}) == len(bench["end_to_end"]) + len(
        bench["per_layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and LINE.match(c["source"]) and LINE.match(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and LINE.match(w["why"]) and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
    for w in bench["workloads"]:
        spec = run.load_cell(w["name"])
        cell = spec["cell"]
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (w["config"], w["traffic"],
                                                                                 w["chips"], w["why"])
        assert cell["limits"] and set(cell["limits"]) <= set(spec["builder"].NUMBERS)
        assert all(isinstance(v, float) and v > 0 for v in cell["limits"].values())
    for m in bench["per_layer"]:
        assert callable(run.load_module("metrics", m["name"]).read)


def test_a_dropped_in_metric_is_read(tiny_bench):
    with open(os.path.join(tiny_bench, "metrics", "clips_in_window.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx['clips']))\n")
    bench = bench_for(tiny_bench)
    bench["per_layer"].append({"name": "clips_in_window", "unit": "clips", "better": "higher",
                               "source": "program_counter", "layer": "pipelines", "moves": "frames_per_s",
                               "workloads": ["tiny-fast"]})
    res = run.run_cell("tiny-fast", SEED, 0.01, True, device="cpu", bench_dir=tiny_bench, benchmark=bench)
    assert res["metrics"]["clips_in_window"]["value"] == res["attempted"]
    assert "clips_in_window" not in [m["name"] for m in run.per_layer_metrics("tiny-full", bench)]


def test_traffic_repeats_by_seed_and_draws_lengths_in_range():
    from rdbench import traffic

    t = {"kind": "depth", "frames": 5, "height": 16, "width": 24}
    a, b, c = (traffic.make_clip(t, SEED, k, depth_builder) for k in (3, 3, 4))
    assert a["frames"].shape == (5, 3, 16, 24) and a["frames"].dtype.name == "uint8"
    assert a["noise"].shape == (4, 2, 3) and (a["frames"] == b["frames"]).all() and (a["noise"] == b["noise"]).all()
    assert not (a["frames"] == c["frames"]).all()
    mixed = {"kind": "depth", "frames_range": [3, 9], "height": 16, "width": 24}
    lengths = [traffic.clip_frames(mixed, SEED, k) for k in range(40)]
    assert min(lengths) >= 3 and max(lengths) <= 9 and len(set(lengths)) > 1
    assert lengths == [traffic.make_clip(mixed, SEED, k, depth_builder)["frames"].shape[0] for k in range(40)]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "set_cache_dirs", lambda: None)
    assert run.main(["--workload", "depth-fast-60f", "--seed", str(SEED), "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_pool_is_the_first_clips():
    from rdbench import traffic

    t = {"kind": "depth", "frames": 2, "height": 8, "width": 8, "pool": 3}
    pool = traffic.pool(t, SEED, depth_builder)
    assert len(pool) == 3 and all((c["frames"] == traffic.make_clip(t, SEED, k, depth_builder)["frames"]).all()
                                  for k, c in enumerate(pool))
    del t["pool"]
    assert len(traffic.pool(t, SEED, depth_builder)) == traffic.POOL


TOY_BUILDER = """
import time

import numpy as np
import torch

KINDS = ("pairs",)
PHASE_PREFIXES = ("toy.",)
PHASES = {"unet": ("blend",)}
NUMBERS = ("blend_err",)


def draw_clip(rng, n, traffic):
    shape = (n, traffic["height"], traffic["width"])
    return {"frames": rng.random(shape, dtype=np.float32), "background": rng.random(shape, dtype=np.float32)}


class Program:
    def __init__(self, cfg, cell, seed, device, quantize=None):
        self.alpha, self.device, self.timings = cell["call"]["alpha"], torch.device(device), {}

    def run(self, clip, verbose=False):
        t0 = time.perf_counter()
        with torch.profiler.record_function("toy.blend"):
            fg, bg = (torch.from_numpy(clip[k]).to(self.device) for k in ("frames", "background"))
            out = (self.alpha * fg + (1 - self.alpha) * bg).cpu().numpy()
        self.timings = {"blend": time.perf_counter() - t0}
        return {"out": out}

    def counters(self):
        return {}

    def close(self):
        pass


def sound(output, frames, traffic):
    return output["out"].shape[0] == frames and bool(np.isfinite(output["out"]).all())


def clip_counts(cfg, cell, traffic, frames):
    return {"flops": 3.0 * frames * traffic["height"] * traffic["width"]}


class Reference:
    def __init__(self, cfg, cell, seed, device):
        self.alpha = cell["call"]["alpha"]

    def numbers(self, clip, output, names):
        ref = self.alpha * clip["frames"].astype(np.float64) + (1 - self.alpha) * clip["background"]
        return {"blend_err": float(np.abs(output["out"] - ref).max())}


def readings(spec, seed, device, names):
    from rdbench import traffic

    clip = traffic.make_clip(spec["traffic"], seed, 0, spec["builder"])
    cell, cfg = spec["cell"], spec["config"]
    got = Program(cfg, cell, seed, device).run(clip)
    low = {"out": got["out"].astype(np.float16).astype(np.float32)}
    ref = Reference(cfg, cell, seed, device)
    return {"seed": seed, "program": ref.numbers(clip, got, names), "control": ref.numbers(clip, low, names)}
"""


def test_a_dropped_in_builder_and_traffic_kind_run(tiny_bench):
    """A configuration of another entry, with its own builder and traffic kind,
    added as files alone: the harness runs it, traced and not, and its control."""
    files = {"builders/toy.py": TOY_BUILDER,
             "configs/toy.json": json.dumps({"builder": "toy", "dtype": "fp32"}),
             "traffic/toy-pairs.json": json.dumps({"kind": "pairs", "frames": 3, "height": 4, "width": 5}),
             "workloads/toy-blend.json": json.dumps({"config": "toy", "traffic": "toy-pairs", "entry": "blend",
                                                     "chips": 1, "why": "a toy", "call": {"alpha": 0.25},
                                                     "limits": {"blend_err": 1e-6}})}
    for rel, text in files.items():
        with open(os.path.join(tiny_bench, rel), "w") as f:
            f.write(text)
    shared = filecmp.dircmp(run.HERE, tiny_bench, ignore=["__pycache__", ".cache", "tests"])

    def changed(d):
        return d.diff_files + [x for sub in d.subdirs.values() for x in changed(sub)]

    assert changed(shared) == []  # nothing of the harness was edited
    bench = bench_for(tiny_bench)
    for m in bench["per_layer"]:
        m["workloads"].append("toy-blend")
    res = run.run_cell("toy-blend", SEED, 0.01, False, device="cpu", bench_dir=tiny_bench, benchmark=bench)
    assert res["correct"] and res["checks"]["blend_err"]["value"] < 1e-6
    traced = run.run_cell("toy-blend", SEED, 0.01, True, device="cpu", bench_dir=tiny_bench, benchmark=bench)
    assert traced["correct"] and {"unet_s", "pipeline_host_s", "mfu_pct"} <= set(traced["metrics"])
    assert "vae_s" not in traced["metrics"] and "coalign_s" not in traced["metrics"]  # no such phases
    r = control.readings("toy-blend", SEED, device="cpu", bench_dir=tiny_bench)
    assert r["program"]["blend_err"] < 1e-6 < r["control"]["blend_err"]
