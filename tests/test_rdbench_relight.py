"""The relight cell of the port's benchmark (``rdbench/builders/relight.py``)
on the CPU: the port's ``RollingImgPipeline.forward`` against the plain
fp32 reference ``rdbench/ref/relight.py`` stage by stage, the reference's
keyed draws against the port's, and the cell's files and counts.

The tiny configuration keeps the published shapes' kinds: an SD1.5-shaped
UNet with 1x1 conv projections and heads by count (4-channel base,
12-channel merged copy), a 4-level VAE (8x down), a CLIP tower with
``quick_gelu`` and 77 positions, the relight scheduler, 6 frames.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from rdbench import check, run, traffic as gen
from rdbench.builders import relight as builder
from rdbench.ref import relight as ref_relight
from rollingdepth_torch.pipelines.rollingimg import SeededNoise

torch.set_num_threads(2)

SEED = 2**31 + 271828  # more than 32 signed bits hold
REAL = run.load_json(run.HERE, "configs", "iclight-fbc-sd15.json")
TINY_CONFIG = dict(
    copy.deepcopy(REAL), dtype="fp32",
    unet=dict(REAL["unet"], block_out_channels=[8, 16], layers_per_block=1, cross_attention_dim=8,
              attention_head_dim=2, norm_num_groups=4,
              down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
              up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"]),
    vae=dict(REAL["vae"], block_out_channels=[8, 8, 16, 16], layers_per_block=1, norm_num_groups=4),
    text_encoder=dict(REAL["text_encoder"], hidden_size=8, intermediate_size=16, num_hidden_layers=2,
                      num_attention_heads=2),
    solve=dict(REAL["solve"], factor=3, num_iterations=2),
)
# 6 frames cap every dilation to 1, so the tiny call names two uncapped ones
TINY_CALL = dict(run.load_json(run.HERE, "workloads", "relight-24f.json")["call"], dilations=[1, 2],
                 cap_dilation=False, num_inference_steps=6, snippet_batch=4)
TINY_TRAFFIC = {"kind": "relight", "frames": 6, "height": 64, "width": 72}
# fp32 against fp32 on the same weights and draws: what parts them is the
# order of sums (the blocked attention, the sampler's float32 scalars
# against float64 ones, one-hot frame sums against gathers).  Read on six
# seeds: t2i and windows 2.0e-7-2.8e-7 after 3 steps, the UNet's first step
# 2.5e-7-3.8e-7, decode 2.0e-6-2.6e-6 (one pass through 4 upsampling
# levels), R/G/B 4e-9-7.4e-7 after 2 solve steps whose L1 signs agree (a
# flip parts a channel by ~lr = 1e-3), the solved scales and shifts
# 2.8e-7-5.0e-7 of their moves from (1, 0); the encode is the same
# computation on both sides here and reads 0.  Each tolerance is 8x to 135x
# those (the encode's is the other one-pass numbers'); the controls one
# precision step below read 3.4e-4 (fp8 windows) to 0.33 (fp8 encode), the
# bf16 solve's scales and shifts 0.79-0.94, a solve left as it was 1.5e-3
# and more on R/G/B and exactly 1 on its scales and shifts
TOLERANCE = {"t2i_err": 1e-5, "encode_err": 1e-5, "unet_err": 1e-5, "window_err": 1e-5, "decode_err": 2e-5,
             "rgb_err": 1e-4, "solve_err": 5e-5}


def tiny_spec(limits=None):
    cell = {"config": "tiny-relight", "traffic": "tiny-fgbg", "entry": "relight", "chips": 1, "why": "tiny",
            "call": TINY_CALL, "limits": limits or TOLERANCE}
    return {"name": "tiny-relight", "cell": cell, "config": TINY_CONFIG, "traffic": TINY_TRAFFIC,
            "builder": builder}


@pytest.fixture(scope="module")
def served():
    """The program's output on a tiny clip, the clip, and the reference."""
    spec = tiny_spec()
    clip = gen.make_clip(TINY_TRAFFIC, SEED, 0, builder)
    program = builder.Program(TINY_CONFIG, spec["cell"], SEED, "cpu")
    out = program.run(clip)
    counters, chunks = dict(program.pipe.last_counters), dict(program.pipe.last_chunks)
    program.close()
    return {"clip": clip, "out": out, "counters": counters, "chunks": chunks,
            "ref": builder.Reference(TINY_CONFIG, spec["cell"], SEED, "cpu")}


@pytest.mark.parametrize("number", builder.NUMBERS)
def test_each_stage_matches_the_reference(served, number):
    """t2i init, the 12-channel UNet's first step, windows, decode and
    R/G/B: the port's forward against the plain reference, each stage from
    the port's own state."""
    got = served["ref"].numbers(served["clip"], served["out"], {number})
    assert got[number] < TOLERANCE[number], got


def test_the_sample_is_one_chunk_of_the_program():
    ref = builder.Reference(TINY_CONFIG, tiny_spec()["cell"], SEED, "cpu")
    frames, rows = ref.sample(6, 6)
    assert len(frames) == 4 or list(frames) == [4, 5]
    assert frames[0] % 4 == 0 and rows[0] % 4 == 0 and 0 < len(rows) <= 4


def test_the_program_serves_sound_rgb_and_counts_its_work(served):
    out, chunks, counters = served["out"], served["chunks"], served["counters"]
    assert builder.sound(out, 6, TINY_TRAFFIC)
    assert out["rgb"].min() == 0.0 and out["rgb"].max() == pytest.approx(1.0)
    t_start = 3  # 6 steps entered at strength 0.5
    assert counters == {"iclight_unet_calls": chunks["unet"], "base_unet_calls": chunks["t2i_unet"],
                        "sampler_steps": chunks["unet"] + chunks["t2i_unet"],
                        "noise_generators": 6 * (1 + t_start) + 6 * 3}
    assert out["windows"].shape == (6 * 3, 8, 9, 4) and out["decoded"].shape == (6 * 3, 64, 72, 3)


@pytest.mark.parametrize("kind", ["shared", "frames", "steps"])
def test_keyed_draws_equal_the_ports_bit_for_bit(kind):
    seed, shape = 2**40 + 7, (3, 5, 4)
    port, ref = SeededNoise(seed, "cpu"), ref_relight.KeyedNoise(seed, "cpu")
    if kind == "shared":
        assert torch.equal(port.shared(shape), ref.draw(shape, ref_relight.SHARED))
    elif kind == "frames":
        assert torch.equal(port.frames([0, 9], shape), torch.stack([ref.frame(0, shape), ref.frame(9, shape)]))
    else:
        assert torch.equal(port.steps([2, 31], 17, shape), torch.stack([ref.step(2, 17, shape), ref.step(31, 17, shape)]))
    assert port.generators == (1 if kind == "shared" else 2)


def test_the_reference_sampler_follows_the_ports():
    """The reference's DPM++ 2M SDE (its own float64 scalars) against the
    port's scheduler over the t2i steps and the window steps."""
    from rollingdepth_torch.io.pretrained_relight import RELIGHT_SCHEDULER_CONFIG
    from rollingdepth_torch.schedulers.dpmsolver import DPMSolverMultistepScheduler, DPMState

    ref, port = ref_relight.DPMSolverSDE(REAL["scheduler"]), DPMSolverMultistepScheduler(RELIGHT_SCHEDULER_CONFIG)
    (t_ref, s_ref), (t_port, s_port) = ref.schedule(40), port.schedule(40)
    assert list(t_ref) == list(t_port) and np.abs(s_ref - s_port).max() <= 1e-6 * s_port.max()
    gen_ = torch.Generator().manual_seed(0)
    for lo, hi in ((0, 20), (20, 40)):
        x = torch.randn((2, 6, 6, 4), generator=gen_)
        xr, xp, prev, state = x, x, None, DPMState.init()
        for i in range(lo, hi):
            noise = torch.randn(x.shape, generator=gen_)
            xr, prev = ref.step(torch.tanh(0.3 * xr), i, xr, s_ref, prev, noise)
            xp, state = port.step(torch.tanh(0.3 * xp), i, xp, s_port, 40, state, noise=noise)
        # float32 scalars against float64 ones: 1e-6 of the sample's size
        torch.testing.assert_close(xr, xp, rtol=0, atol=1e-6 * float(xp.abs().max()))


def test_controls_fail_where_the_program_passes():
    """One precision step below each stage reads far above the fp32 program
    (``readings``: the base UNet, the encode and the decode in fp8, the
    W8A8 IC-Light UNet, the solve in bf16; a solve that leaves its state as
    it was)."""
    r = builder.readings(tiny_spec(), SEED, "cpu", set(builder.NUMBERS))
    for k in builder.NUMBERS:
        assert r["program"][k] < TOLERANCE[k] < r["control"][k], (k, r)
    assert r["faults"]["rgb_err.state_unchanged"] > TOLERANCE["rgb_err"]
    assert r["faults"]["solve_err.state_unchanged"] == 1.0


def _frozen_step(self, model_output, step_index, sample, *args, **kwargs):
    return sample, args[2]


def test_a_frozen_sampler_is_not_correct(monkeypatch):
    """A sampler that leaves the latents as they were fails the t2i and window numbers."""
    from rollingdepth_torch.schedulers.dpmsolver import DPMSolverMultistepScheduler

    monkeypatch.setattr(DPMSolverMultistepScheduler, "step", _frozen_step)
    spec = tiny_spec()
    clip = gen.make_clip(TINY_TRAFFIC, SEED, 0, builder)
    program = builder.Program(TINY_CONFIG, spec["cell"], SEED, "cpu")
    got = builder.Reference(TINY_CONFIG, spec["cell"], SEED, "cpu").numbers(clip, program.run(clip),
                                                                             {"t2i_err", "window_err"})
    assert not check.passed(check.verdict(got, TOLERANCE))
    assert got["t2i_err"] > 0.1 and got["window_err"] > 0.1


def test_a_solve_that_leaves_its_state_is_not_correct(monkeypatch):
    """Solves that return at once, each window's scale 1 and shift 0, read
    exactly 1 on ``solve_err`` (which the cell's limit holds well below)
    and fail R/G/B too on the tiny clip."""
    from rollingdepth_torch import aligner

    monkeypatch.setattr(aligner, "solve", lambda p, kernel: None)
    spec = tiny_spec()
    clip = gen.make_clip(TINY_TRAFFIC, SEED, 0, builder)
    program = builder.Program(TINY_CONFIG, spec["cell"], SEED, "cpu")
    got = builder.Reference(TINY_CONFIG, spec["cell"], SEED, "cpu").numbers(clip, program.run(clip),
                                                                             {"rgb_err", "solve_err"})
    assert got["solve_err"] == pytest.approx(1.0, abs=1e-12)
    assert got["rgb_err"] > TOLERANCE["rgb_err"]
    assert got["solve_err"] > run.load_json(run.HERE, "workloads", "relight-24f.json")["limits"]["solve_err"]


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's folder with the tiny relight cell dropped in."""
    root = tmp_path / "rdbench"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    spec = tiny_spec()
    (root / "configs" / "tiny-relight.json").write_text(json.dumps(TINY_CONFIG))
    (root / "traffic" / "tiny-fgbg.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "workloads" / "tiny-relight.json").write_text(json.dumps(spec["cell"]))
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + ["tiny-relight"]
    return str(root), bench


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_relight_cell_runs_correct(tiny_bench, trace):
    root, bench = tiny_bench
    res = run.run_cell("tiny-relight", SEED, 0.01, trace, device="cpu", bench_dir=root, benchmark=bench)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(builder.NUMBERS) and res["failed"] == 0
    m = res["metrics"]
    if not trace:
        assert set(m) == {"frames_per_s", "setup_s"}
        return
    relight = {"relight_t2i_s", "relight_unet_s", "relight_vae_s", "relight_mfu_pct"}
    assert relight <= set(m) and all(m[k]["value"] > 0 for k in relight)
    # no device on the CPU: nothing for a kernel's roofline; the depth builder's phases are not relight's
    assert not {"relight_attn_roofline_pct", "unet_s", "vae_s", "coalign_s"} & set(m)


def test_relight_metrics_read_nothing_without_their_phases():
    """A pipeline that ran the denoise and the decode in one phase (the
    layout before the split) gives the UNet and VAE readers nothing."""
    from rdbench.metrics import relight_t2i_s, relight_unet_s, relight_vae_s

    clips = [{"timings": {"encode": 1.0, "init": 2.0, "snippet_infer_decode": 3.0, "coalign": 0.5}, "entry_s": 7.0}]
    ctx = {"phases": builder.PHASES, "clips": clips}
    assert relight_unet_s.read(ctx) is None and relight_vae_s.read(ctx) is None
    assert relight_t2i_s.read(ctx) == 2.0


def test_the_relight_cell_loads_and_counts_both_unets_at_their_head_widths():
    """``relight-24f`` through the harness's loader; its counts on the meta
    device hold the self-attention of both UNets at d = 40, 80 and 160 and
    the VAE's at 512, over the tokens of a window or a frame."""
    spec = run.load_cell("relight-24f")
    assert spec["builder"].__name__.endswith("relight") and spec["config"]["reduced"] == []
    cfg, cell, traffic = spec["config"], spec["cell"], spec["traffic"]
    counts = builder.clip_counts(cfg, cell, traffic, traffic["frames"])
    # levels: 80x90, 40x45, 20x23 and 10x12 latents; 8 heads of 320, 640, 1280 channels
    tokens = {40: 80 * 90, 80: 40 * 45, 160: 20 * 23}
    mid = 10 * 12

    def self_attn(n):  # one UNet call on n frames: 2 down, 3 up blocks at each of three levels, the mid block
        flops = sum(5 * 4.0 * 8 * (n * t) ** 2 * d for d, t in tokens.items())
        return flops + (4.0 * 8 * (n * mid) ** 2 * 160 if n * mid >= 256 else 0.0)

    windows, steps, t_start = 22 + 10, 20, 20
    vae = 4.0 * (80 * 90) ** 2 * 512  # the mid block's one head, in the encoder and in the decoder
    want = windows * steps * self_attn(3) + 24 * t_start * self_attn(1) + (2 * 24 + windows * 3) * vae
    assert counts["attn_flops"] == pytest.approx(want, rel=1e-12)
    base, iclight = builder.meta_models(cfg)[:2]
    ctx = torch.zeros((1, 154, 768), device="meta")
    one = {m: builder.module_counts(m, lambda m=m, c=c: m(torch.zeros((1, n, 80, 90, c), device="meta"), 999, ctx))
           for m, n, c in ((base, 1, 4), (iclight, 3, 12))}
    assert counts["flops"] > windows * steps * one[iclight]["flops"] + 24 * t_start * one[base]["flops"]
