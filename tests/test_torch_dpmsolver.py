"""The port's DPM-Solver(++) and Euler-Ancestral schedulers against the JAX ones.

The schedules are the same float64 numpy math: held exactly equal.  The
steps run a whole schedule on both sides from the same fp32 sample, with a
fixed model (a near-ideal denoiser of one fixed clean target) and the
same injected SDE noise: within 1e-6 of the sample's scale (max |x|) of
JAX at every step.  Both run in fp32 with per-step scalars in fp32; the
residue is XLA's own exp and log, an ulp from numpy's, which late steps
carry into samples that are differences of terms of the scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.schedulers.dpmsolver import DPMSolverConfig, DPMSolverMultistepScheduler, DPMState
from rollingdepth_torch.schedulers.euler_ancestral import EulerAncestralConfig, EulerAncestralScheduler
from rollingdepth_tpu.schedulers import dpmsolver as jdpm
from rollingdepth_tpu.schedulers import euler_ancestral as jea

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (2, 3, 5, 4)


def assert_close_to_scale(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=err_msg)

SCHEDULES = [
    dict(algorithm_type="sde-dpmsolver++", use_karras_sigmas=True, steps_offset=1),  # the relight config
    dict(algorithm_type="dpmsolver++", use_karras_sigmas=False),
    dict(algorithm_type="dpmsolver++", timestep_spacing="leading", steps_offset=1),
    dict(algorithm_type="dpmsolver++", timestep_spacing="trailing", final_sigmas_type="sigma_min"),
    dict(algorithm_type="sde-dpmsolver", final_sigmas_type="sigma_min", beta_schedule="scaled_linear"),
    dict(algorithm_type="dpmsolver++", rescale_betas_zero_snr=True, timestep_spacing="trailing"),
]


@pytest.mark.parametrize("kw", SCHEDULES)
@pytest.mark.parametrize("steps", [4, 20, 40])
def test_schedule_exactly_equal(kw, steps):
    got_t, got_s = DPMSolverMultistepScheduler(DPMSolverConfig(**kw)).schedule(steps)
    want_t, want_s = jdpm.DPMSolverMultistepScheduler(jdpm.DPMSolverConfig(**kw)).schedule(steps)
    assert got_t.dtype == want_t.dtype and got_s.dtype == want_s.dtype
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_s, want_s)


def _model(rng, vp=True):
    """The noise of x around a fixed clean target x0 at sigma, plus a small
    fixed error: x = alpha x0 + sigma alpha eps (variance preserving), or
    x = x0 + sigma eps (Euler)."""
    x0, err = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))

    def eps(x, sigma):
        sigma = np.float32(sigma)
        alpha = np.float32(1.0) / np.sqrt(sigma * sigma + 1) if vp else np.float32(1.0)
        return ((x - alpha * x0) / (sigma * alpha) + 0.1 * err).astype(np.float32)

    return eps


def _run_both(kw, steps, begin=0, seed=0):
    """Both schedulers over the schedule from ``begin``; per step (port, JAX) samples."""
    rng = np.random.default_rng(seed)
    model = _model(rng)
    tsched = DPMSolverMultistepScheduler(DPMSolverConfig(**kw))
    jsched = jdpm.DPMSolverMultistepScheduler(jdpm.DPMSolverConfig(**kw))
    _, sigmas = tsched.schedule(steps)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    xt, xj = torch.from_numpy(x0), jnp.asarray(x0)
    st, sj = DPMState.init(), jdpm.DPMState.init(SHAPE)
    out = []
    for i in range(begin, steps):
        noise = rng.standard_normal(SHAPE).astype(np.float32)
        xt, st = tsched.step(torch.from_numpy(model(xt.numpy(), sigmas[i])), i, xt, sigmas, steps, st,
                             noise=torch.from_numpy(noise))
        xj, sj = jsched.step(jnp.asarray(model(np.array(xj), sigmas[i])), i, xj, sigmas, steps, sj,
                             noise=jnp.asarray(noise))
        out.append((xt.numpy(), np.asarray(xj), st, sj))
    return out


@pytest.mark.parametrize("algo", ["dpmsolver++", "sde-dpmsolver++"])
@pytest.mark.parametrize("karras", [True, False])
@pytest.mark.parametrize("steps, begin", [(40, 20), (10, 0), (20, 0)])
def test_step_whole_run_matches_jax(algo, karras, steps, begin):
    """Every step of a run, with the warm-up (first order), second order,
    and the first-order final step (zero final sigma, and < 15 steps)."""
    kw = dict(algorithm_type=algo, use_karras_sigmas=karras, steps_offset=1)
    for i, (got, want, st, sj) in enumerate(_run_both(kw, steps, begin)):
        assert_close_to_scale(got, want, err_msg=f"step {begin + i}")
        assert st.lower_order_nums == int(sj.lower_order_nums) == min(i + 1, 2)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("kw", [
    dict(algorithm_type="sde-dpmsolver", final_sigmas_type="sigma_min"),
    dict(algorithm_type="dpmsolver", final_sigmas_type="sigma_min", solver_type="heun"),
    dict(algorithm_type="dpmsolver++", solver_type="heun", prediction_type="v_prediction"),
    dict(algorithm_type="sde-dpmsolver++", solver_type="heun", prediction_type="sample"),
    dict(algorithm_type="dpmsolver++", solver_order=1),
    dict(algorithm_type="dpmsolver++", euler_at_final=True, final_sigmas_type="sigma_min"),
    dict(algorithm_type="dpmsolver++", lower_order_final=False, final_sigmas_type="sigma_min"),
])
def test_step_variants_match_jax(kw):
    for i, (got, want, _, _) in enumerate(_run_both(kw, 12, seed=3)):
        assert_close_to_scale(got, want, err_msg=f"step {i}")


def test_warm_up_and_final_steps_are_first_order():
    """The first step uses no memory (any prev_converted gives the same
    result), and so does the last at a zero final sigma."""
    sched = DPMSolverMultistepScheduler(DPMSolverConfig(algorithm_type="sde-dpmsolver++", use_karras_sigmas=True))
    _, sigmas = sched.schedule(10)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    eps, noise = 0.5 * x, torch.ones(SHAPE)
    a, s1 = sched.step(eps, 0, x, sigmas, 10, DPMState.init(), noise=noise)
    b, _ = sched.step(eps, 0, x, sigmas, 10, DPMState(torch.full(SHAPE, 7.0), 0), noise=noise)
    assert torch.equal(a, b) and s1.lower_order_nums == 1
    c, _ = sched.step(eps, 9, x, sigmas, 10, DPMState(torch.zeros(SHAPE), 2), noise=noise)
    d, _ = sched.step(eps, 9, x, sigmas, 10, DPMState(torch.full(SHAPE, 7.0), 2), noise=noise)
    assert torch.equal(c, d)
    e, _ = sched.step(eps, 5, x, sigmas, 10, DPMState(torch.zeros(SHAPE), 2), noise=noise)
    f, _ = sched.step(eps, 5, x, sigmas, 10, DPMState(torch.full(SHAPE, 7.0), 2), noise=noise)
    assert not torch.equal(e, f)  # mid-run: second order reads the memory
    with pytest.raises(ValueError, match="noise"):
        sched.step(eps, 0, x, sigmas, 10, DPMState.init())


def test_non_pp_rejects_zero_final_sigma():
    for algo in ("dpmsolver", "sde-dpmsolver"):
        with pytest.raises(ValueError, match="sigma_min"):
            DPMSolverMultistepScheduler(DPMSolverConfig(algorithm_type=algo, final_sigmas_type="zero"))


@pytest.mark.parametrize("sigma", [0.0, 0.03, 1.7, 14.6])
def test_add_noise_matches_jax(sigma):
    rng = np.random.default_rng(1)
    x, n = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    got = DPMSolverMultistepScheduler().add_noise(torch.from_numpy(x), torch.from_numpy(n), np.float32(sigma))
    want = jdpm.DPMSolverMultistepScheduler().add_noise(jnp.asarray(x), jnp.asarray(n), jnp.float32(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bf = DPMSolverMultistepScheduler().add_noise(torch.from_numpy(x).bfloat16(), torch.from_numpy(n), sigma)
    assert bf.dtype == torch.bfloat16


# ---- Euler ancestral: the JAX step's own draw (normal of its key) passed in


@pytest.mark.parametrize("kw", [dict(), dict(prediction_type="v_prediction", timestep_spacing="trailing"),
                                dict(timestep_spacing="leading", steps_offset=1, beta_schedule="scaled_linear"),
                                dict(rescale_betas_zero_snr=True, timestep_spacing="trailing")])
def test_euler_ancestral_matches_jax(kw):
    steps = 8
    tsched, jsched = EulerAncestralScheduler(EulerAncestralConfig(**kw)), jea.EulerAncestralScheduler(
        jea.EulerAncestralConfig(**kw))
    t_ts, t_sig = tsched.schedule(steps)
    j_ts, j_sig = jsched.schedule(steps)
    np.testing.assert_array_equal(t_ts, j_ts)
    np.testing.assert_array_equal(t_sig, j_sig)
    assert np.isfinite(t_sig).all()

    rng = np.random.default_rng(2)
    model = _model(rng, vp=False)
    x0 = rng.standard_normal(SHAPE).astype(np.float32) * float(t_sig[0])
    xt, xj = torch.from_numpy(x0), jnp.asarray(x0)
    np.testing.assert_allclose(tsched.scale_model_input(xt, t_sig[0]).numpy(),
                               np.asarray(jsched.scale_model_input(xj, jnp.float32(j_sig[0]))), **TOL)
    for i in range(steps):
        key = jax.random.PRNGKey(i)
        noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
        xt, pt = tsched.step(torch.from_numpy(model(xt.numpy(), t_sig[i])), i, xt, t_sig, noise=torch.from_numpy(noise))
        xj, pj = jsched.step(jnp.asarray(model(np.array(xj), t_sig[i])), i, xj, j_sig, key)
        assert_close_to_scale(xt.numpy(), np.asarray(xj), err_msg=f"step {i}")
        assert_close_to_scale(pt.numpy(), np.asarray(pj))
    got = tsched.add_noise(torch.from_numpy(x0), torch.ones(SHAPE), t_sig[3])
    want = jsched.add_noise(jnp.asarray(x0), jnp.ones(SHAPE), jnp.float32(j_sig[3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
