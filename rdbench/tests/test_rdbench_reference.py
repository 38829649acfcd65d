"""The frozen reference against the program's tiny modules on the CPU, on
identical weights, and the reference's independence from the program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from rdbench import weights
from rdbench.builders import depth as builder
from rdbench.ref import depth as ref_depth

from .conftest import TINY_CONFIG


def _pair(seed=3):
    from rollingdepth_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig

    cfg = TINY_CONFIG
    sds = builder.draw(cfg, seed, "cpu")
    refs = builder.meta_models(cfg)
    ports = (UNet2DConditionModel(UNetConfig.from_dict(cfg["unet"]), device="meta"),
             AutoencoderKL(VAEConfig.from_dict(cfg["vae"]), device="meta"),
             CLIPTextModel(CLIPTextConfig.from_dict(cfg["text_encoder"]), device="meta"))
    for r, p, sd in zip(refs, ports, sds):
        r.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
        p.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    return refs, ports


def test_reference_modules_match_program_modules():
    (ru, rv, rt), (pu, pv, pt) = _pair()
    gen = torch.Generator().manual_seed(0)
    ids = torch.tensor([builder.EMPTY_PROMPT_IDS])
    with torch.no_grad():
        torch.testing.assert_close(rt(ids), pt(ids), rtol=1e-5, atol=1e-5)
        ctx = rt(ids)
        x = torch.randn((2, 3, 8, 12, 8), generator=gen)
        torch.testing.assert_close(ru(x, 999, ctx), pu(x, 999, ctx), rtol=1e-4, atol=1e-5)
        img = torch.rand((2, 64, 96, 3), generator=gen) * 2 - 1
        torch.testing.assert_close(rv.encode_mean(img), pv.encode_mean(img), rtol=1e-4, atol=1e-5)
        z = torch.randn((2, 8, 12, 4), generator=gen)
        torch.testing.assert_close(rv.decode(z), pv.decode(z), rtol=1e-4, atol=1e-5)


def test_reference_windows_match_program_windows():
    from rollingdepth_torch.pipelines import snippets

    for n_frames, n, d in ((60, 3, 25), (60, 3, 10), (24, 3, 25), (12, 3, 1)):
        dd = ref_depth.cap_dilation(n_frames, n, d)
        assert dd == snippets.cap_max_dilation(n_frames, n, d)
        np.testing.assert_array_equal(ref_depth.windows(n_frames, n, dd), snippets.snippet_index_matrix(n_frames, n, dd))
        for phase in range(4):
            np.testing.assert_array_equal(ref_depth.partition_windows(n_frames, n, dd, phase),
                                          snippets.partition_index_matrix(n_frames, n, dd, phase=phase))
    for i in range(10):
        assert ref_depth.refine_gap(i, 10, 6) == snippets.current_gap(i, 10, 6, 1)


def test_reference_solve_matches_program_solve():
    from rollingdepth_torch.aligner import AlignerConfig, DepthAligner

    gen = torch.Generator().manual_seed(1)
    idx = [ref_depth.windows(12, 3, 1), ref_depth.windows(12, 3, 3)]
    groups = [torch.randn((m.shape[0], 3, 8, 12, 4), generator=gen) for m in idx]
    solve = dict(TINY_CONFIG["latent_solve"], num_iterations=3)
    got = DepthAligner(AlignerConfig(**solve)).run(groups, [1, 3], restore_shift=True, channels_last=True,
                                                   index_mats=idx, seq_len=12)
    # a few steps on windows that disagree: once a residual near 0 rounds to
    # the other sign, a step moves a window by lr, so longer solves part by steps of lr
    merged, loss = ref_depth.solve_and_merge(groups, idx, 12, solve)
    torch.testing.assert_close(merged, got[0], rtol=1e-5, atol=5e-5)
    assert loss == pytest.approx(float(got[3][-1, 0]), rel=1e-4)
    assert ref_depth.merge_residual(groups, idx, merged) < 1e-5
    assert ref_depth.merge_residual(groups, idx, merged + 0.01 * torch.randn(merged.shape, generator=gen)) > 1e-3


def _disagreeing_windows(seed):
    """Windows of 12 frames that disagree by a scale and shift a window, and by noise."""
    gen = torch.Generator().manual_seed(seed)
    idx = [ref_depth.windows(12, 3, 1), ref_depth.windows(12, 3, 3)]
    base = torch.randn((12, 16, 24, 4), generator=gen)
    groups = []
    for m in idx:
        s = 1 + 0.3 * torch.rand((m.shape[0], 1, 1, 1, 1), generator=gen)
        t = 0.2 * torch.randn((m.shape[0], 1, 1, 1, 1), generator=gen)
        groups.append(base[torch.as_tensor(m)] * s + t + 0.05 * torch.randn((m.shape[0], 3, 16, 24, 4), generator=gen))
    return groups, idx


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_merge_err_reads_the_solve_a_merge_used(seed):
    solve = dict(TINY_CONFIG["latent_solve"], num_iterations=2000)
    groups, idx = _disagreeing_windows(seed)
    problem = ref_depth.SolveProblem(groups, idx, 12, solve)
    merged = problem.merge(*ref_depth.solve(problem)[:2])
    names = {"solve_merge_err"}
    ref = builder.Reference(dict(TINY_CONFIG, latent_solve=solve), {"call": {"merge_in_latent": True, "strides": [1],
                            "snippet_lengths": [3], "dilations": [1, 3], "cap_dilation": False}}, 0, "cpu")

    def err(m):
        return ref.numbers({"frames": np.zeros((12,))}, {"windows": groups, "merged": m}, names)["solve_merge_err"]

    assert err(merged) == 0.0
    assert err(merged.bfloat16()) < 0.004  # the program hands its merge on in bf16
    s, t = ref_depth.solve(problem)[:2]
    assert err(problem.merge([torch.ones_like(x) for x in s], [torch.zeros_like(x) for x in t])) > 0.02
    other = ref_depth.SolveProblem(_disagreeing_windows(seed + 10)[0], idx, 12, solve)
    assert err(problem.merge(*ref_depth.solve(other)[:2])) > 0.02  # another clip's scales


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, rdbench.ref.depth, rdbench.ref.models, rdbench.counts, rdbench.weights, rdbench.check, "
            "rdbench.traffic, rdbench.trace; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'rollingdepth_torch', 'rollingdepth_tpu', 'jax', "
            "'jaxlib', 'flax'}); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("mods,found", [(["jax.numpy"], ["jax"]), (["rollingdepth_tpu.ops"], ["rollingdepth_tpu"]),
                                        (["rollingdepth_torch.ops", "jaxtyping"], [])])
def test_guard_compares_whole_top_level_names(monkeypatch, mods, found):
    from rdbench import run

    for m in mods:
        monkeypatch.setitem(sys.modules, m, object())
    assert [f for f in run.forbidden_modules() if f in {m.split(".")[0] for m in mods}] == found


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    a, b, c = (builder.draw(TINY_CONFIG, s, "cpu") for s in (5, 5, 6))
    for x, y, z in zip(a, b, c):
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert any(not torch.equal(x[k], z[k]) for k in x)
    leaves = a[0]
    assert torch.all(leaves["conv_in.bias"] == 0) and torch.all(leaves["conv_norm_out.weight"] == 1)
    std = float(leaves["conv_in.weight"].float().std())
    assert abs(std - weights.STDDEV) < 0.3 * weights.STDDEV
