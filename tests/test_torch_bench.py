"""``rollingdepth_torch/tools/bench.py`` on the CPU at a tiny size: one
parseable JSON line with the JAX bench's metric names (and ``_stride{N}``
for a stride run, which the JAX bench leaves out), and its FLOP model equal
to the JAX bench's."""

import importlib.util
import json
import pathlib

import pytest
import torch

from rollingdepth_torch.tools import bench as tbench

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["6", "1", "--device", "cpu", "--tiny", "--sb", "4", "--vb", "4"]


@pytest.mark.parametrize("extra, metric", [([], "depth_fps_768p_fast_1chip_tiny"),
                                           (["--quantize"], "depth_fps_768p_fast_1chip_w8a8_tiny"),
                                           (["--mode", "full", "--quantize", "w8a8", "--fp32"],
                                            "depth_fps_full_1chip_w8a8_fp32_tiny"),
                                           (["--stride", "2"], "depth_fps_768p_fast_1chip_stride2_tiny")])
def test_prints_one_json_line(capsys, extra, metric):
    torch.set_num_threads(2)
    assert tbench.main(TINY + extra) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == metric and result["unit"] == "frames/sec" and result["card"] == "cpu"
    assert result["value"] > 0 and result["vs_baseline"] > 0 and result["fps_upload_inclusive"] > 0
    assert result["stride"] == (int(extra[extra.index("--stride") + 1]) if "--stride" in extra else 1)


def test_flops_model_is_the_jax_benchs(monkeypatch, tmp_path):
    # bench.py sets JAX cache variables when imported; keep them out of this process
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    for kw in ({}, {"h": 1024, "w": 576, "dilation_count": 3, "refine_step": 10}):
        assert tbench.flops_per_frame(**kw) == jbench.flops_per_frame(**kw)
