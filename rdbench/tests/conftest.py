"""Shared set-up of the benchmark's own tests (``python -m pytest rdbench/tests``)."""

import json
import os
import shutil

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CONFIG = {
    "source": "https://huggingface.co/prs-eth/rollingdepth-v1-0",
    "builder": "depth",
    "dtype": "fp32",
    "unet": {"in_channels": 8, "out_channels": 4, "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "block_out_channels": [8, 16],
             "layers_per_block": 1, "cross_attention_dim": 8, "attention_head_dim": 2, "norm_num_groups": 4,
             "use_linear_projection": True},
    "vae": {"block_out_channels": [8, 8, 16, 16], "layers_per_block": 1, "norm_num_groups": 4},
    "text_encoder": {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2},
    "scheduler": {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                  "beta_schedule": "scaled_linear", "clip_sample": False, "set_alpha_to_one": False,
                  "steps_offset": 1, "prediction_type": "v_prediction", "timestep_spacing": "trailing"},
    "latent_solve": {"factor": 3, "border": 2, "lmda2": 0.1, "lmda3": 10.0, "lr": 0.001, "num_iterations": 0,
                     "depth_loss_weight": 0.0, "loss_scale": 1.0},
    "reduced": [],
}


# the tiny cells take at most one of the solve's steps: where windows nearly
# agree, a residual's sign is rounding noise and each step moves a window by
# lr, so fp32 and fp32 part by steps of lr (``depth_err`` starts from the
# windows, so ``tiny-full`` takes none); test_rdbench_reference holds the solve


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path)


def make_tiny_bench(tmp_path):
    """A copy of the benchmark's folder with a tiny configuration and two tiny
    cells (``tiny-fast``, ``tiny-full``) dropped in, as a later change adds them."""
    root = tmp_path / "rdbench"
    shutil.copytree(BENCH_DIR, root, ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    (root / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    one_step = dict(TINY_CONFIG, latent_solve=dict(TINY_CONFIG["latent_solve"], num_iterations=1))
    (root / "configs" / "tiny-one-step.json").write_text(json.dumps(one_step))
    (root / "traffic" / "tiny-clips.json").write_text(json.dumps({"kind": "depth", "frames": 12, "height": 64,
                                                                  "width": 96}))
    base = json.loads((root / "workloads" / "depth-fast-60f.json").read_text())
    # the tiny windows agree to rounding, so the solve's objective is rounding too
    # the one solve step's signs are rounding's too: the merges part by up to lr (0.002-0.007 read)
    fast_limits = {"window_err": 1e-3, "merge_err": 1e-3, "solve_merge_err": 0.015, "decode_err": 1e-3}
    for name, config, refine, limits in (("tiny-fast", "tiny-one-step", 0, fast_limits),
                                         ("tiny-full", "tiny", 2, {"window_err": 1e-3, "depth_err": 1e-3})):
        cell = dict(base, config=config, traffic="tiny-clips", limits=limits)
        cell["call"] = dict(base["call"], dilations=[1, 3], refine_step=refine, refine_start_dilation=3, max_vae_bs=5,
                            snippet_batch=3)
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return str(root)
