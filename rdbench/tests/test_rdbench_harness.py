"""A whole run of a tiny cell on the CPU, the look for a card skipped, and
the same run with the timed path broken underneath, which must come out
not correct."""

import json
import os

import numpy as np
import pytest
import torch

from rdbench import run

SEED = 2**31 + 12345  # more than 32 signed bits hold: seeds this large must work


def bench_for(bench_dir):
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + ["tiny-fast", "tiny-full"]
    return bench


def tiny_run(bench_dir, cell="tiny-fast", trace=False):
    return run.run_cell(cell, SEED, 0.01, trace, device="cpu", bench_dir=bench_dir, benchmark=bench_for(bench_dir))


@pytest.mark.parametrize("cell", ["tiny-fast", "tiny-full"])
def test_tiny_cell_runs_correct(tiny_bench, cell):
    res = tiny_run(tiny_bench, cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["metrics"]["frames_per_s"]["value"] > 0 and res["metrics"]["setup_s"]["value"] > 0


def test_tiny_traced_run_reads_spans(tiny_bench):
    res = tiny_run(tiny_bench, "tiny-full", trace=True)
    assert res["correct"]
    m = res["metrics"]
    # no device on the CPU: the trace's metrics find nothing to read and stay out
    assert {"pipeline_host_s", "unet_s", "vae_s", "coalign_s"} <= set(m)
    assert not {"attn_roofline_pct", "groupnorm_roofline_pct", "device_idle_pct"} & set(m)
    assert all(v["value"] > 0 for k, v in m.items() if k != "pipeline_host_s")
    assert "breakdown" in res and res["device"]["window_s"] > 0


def _frozen_step(self, model_output, timestep, sample, *args, **kwargs):
    return sample, sample


def _half_windows(original):
    def infer(self, rgb_latent, noise, index_matrix, *args, **kwargs):
        out = original(self, rgb_latent, noise, index_matrix, *args, **kwargs)
        half = out.shape[0] // 2
        return torch.cat([out[: out.shape[0] - half], out[: half]]) if half else out
    return infer


def _altered_frame(original):
    def forward(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        out.depth_pred = np.array(out.depth_pred)
        out.depth_pred[out.depth_pred.shape[0] // 2] *= 0.99
        return out
    return forward


@pytest.mark.parametrize("fault", ["state_unchanged", "half_windows_left_out", "answer_altered"])
def test_broken_path_is_not_correct(tiny_bench, monkeypatch, fault):
    from rollingdepth_torch.pipelines.rollingdepth import RollingDepthPipeline
    from rollingdepth_torch.schedulers.ddim import DDIMScheduler

    if fault == "state_unchanged":
        monkeypatch.setattr(DDIMScheduler, "step", _frozen_step)
    elif fault == "half_windows_left_out":
        monkeypatch.setattr(RollingDepthPipeline, "_infer_snippets", _half_windows(RollingDepthPipeline._infer_snippets))
    else:
        monkeypatch.setattr(RollingDepthPipeline, "forward", _altered_frame(RollingDepthPipeline.forward))
    res = tiny_run(tiny_bench)
    assert not res["correct"], res["checks"]
