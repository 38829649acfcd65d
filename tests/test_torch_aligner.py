"""``rollingdepth_torch.aligner`` against ``rollingdepth_tpu.aligner``.

Same snippet groups, fp32.  The solve is L1 with Adam: its gradient is a
sign, so once the windows agree the iterates oscillate, and fp32 sum-order
differences (the port's ascending slot order against XLA's one-hot matmuls)
then flip signs and the two solves part by O(lr) per step.  Up to 100
iterations they agree to 1e-5; the full 2000 are held to 2e-2 of the latent
scale.  The port's frame sums run in one fixed order (the solve's gather and
reduction over the slots, ``frame_sum`` in the merge; no atomic add): the
merged output is bit-equal at 1 and 4 CPU threads, and no scatter-add is
reached.  The Adam step (``adam_update_``) is optax's ``adam`` bit for bit
when optax runs op by op; under ``jax.jit`` XLA's fused CPU code rounds
some of its products differently, by up to one fp32 ulp of a parameter a
step."""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rollingdepth_torch import aligner as port_aligner
from rollingdepth_torch.aligner import AlignerConfig, DepthAligner, adam_update_
from rollingdepth_torch.pipelines.snippets import snippet_index_matrix
from rollingdepth_tpu.aligner import AlignerConfig as JAlignerConfig
from rollingdepth_tpu.aligner import DepthAligner as JDepthAligner
from tests.test_torch_framesum import refuse_scatter_adds

torch.set_num_threads(2)


def _groups(n_frames=10, dilations=(1, 3), channels_last=True, positive=False, seed=0):
    rng = np.random.default_rng(seed)
    idx = [snippet_index_matrix(n_frames, 3, d) for d in dilations]
    base = rng.standard_normal((n_frames, 16, 16, 4)).astype(np.float32)
    groups = []
    for k, m in enumerate(idx):
        scale = 1.0 + 0.2 * rng.standard_normal((m.shape[0], 1, 1, 1, 1))
        g = base[m] * scale + 0.3 * rng.standard_normal(m.shape + (16, 16, 4)) + 0.1 * k
        if positive:
            g = np.abs(g) + 0.5
        if not channels_last:
            g = g.transpose(0, 1, 4, 2, 3)
        groups.append(g.astype(np.float32))
    return idx, groups


def _run_both(kw, idx, groups, n_frames, **run_kw):
    a = JDepthAligner(JAlignerConfig(**kw)).run(
        [jnp.asarray(g) for g in groups], [1, 3], index_mats=idx, seq_len=n_frames, **run_kw)
    b = DepthAligner(AlignerConfig(**kw)).run(
        [torch.from_numpy(g) for g in groups], [1, 3], index_mats=idx, seq_len=n_frames, **run_kw)
    return a, b


@pytest.mark.parametrize("iters", [1, 30, 100])
def test_latent_path_matches_jax(iters):
    """The pipeline's latent-path settings: factor 3, no inverse term,
    restore_shift, channels_last."""
    idx, groups = _groups()
    kw = dict(factor=3, depth_loss_weight=0.0, num_iterations=iters)
    a, b = _run_both(kw, idx, groups, 10, restore_shift=True, channels_last=True)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-5, atol=1e-5)
    for sa, sb in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_allclose(sb.numpy(), np.asarray(sa), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b[3].numpy(), np.asarray(a[3]), rtol=1e-5, atol=1e-5)


def test_latent_path_full_solve_close_to_jax():
    idx, groups = _groups(seed=1)
    a, b = _run_both(dict(factor=3, depth_loss_weight=0.0), idx, groups, 10,
                     restore_shift=True, channels_last=True)
    ref = np.asarray(a[0])
    np.testing.assert_allclose(b[0].numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    assert np.corrcoef(b[0].numpy().ravel(), ref.ravel())[0, 1] > 0.9999


def test_depth_path_with_inverse_term_matches_jax():
    """Depth-space settings (factor 4, inverse-depth term on, [S, w, C, H, W]
    groups, positive depths), default stride-1 windows."""
    idx, groups = _groups(positive=True, channels_last=False, seed=2)
    kw = dict(factor=4, num_iterations=50)
    a = JDepthAligner(JAlignerConfig(**kw)).run([jnp.asarray(g) for g in groups], [1, 3])
    b = DepthAligner(AlignerConfig(**kw)).run([torch.from_numpy(g) for g in groups], [1, 3])
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b[3].numpy(), np.asarray(a[3]), rtol=1e-5, atol=1e-5)


def test_windows_of_two_lengths_match_jax():
    """Groups of windows of 3 and of 2 frames: the solve pads the shorter
    group's views to 3 frames, rows that no target or loss reads."""
    rng = np.random.default_rng(4)
    idx = [snippet_index_matrix(10, 3, 1), snippet_index_matrix(10, 2, 3)]
    base = rng.standard_normal((10, 16, 16, 4)).astype(np.float32)
    groups = [(base[m] * (1.0 + 0.2 * rng.standard_normal((m.shape[0], 1, 1, 1, 1)))
               + 0.3 * rng.standard_normal(m.shape + (16, 16, 4))).astype(np.float32) for m in idx]
    a, b = _run_both(dict(factor=3, depth_loss_weight=0.0, num_iterations=30), idx, groups, 10,
                     restore_shift=True, channels_last=True)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-5, atol=1e-5)
    for sa, sb in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_allclose(sb.numpy(), np.asarray(sa), rtol=1e-5, atol=1e-5)


def test_mismatched_index_matrix_raises():
    idx, groups = _groups()
    with pytest.raises(ValueError):
        DepthAligner(AlignerConfig(num_iterations=1)).run(
            [torch.from_numpy(g) for g in groups], [1, 3], index_mats=idx[::-1], seq_len=10)


def _run_port(groups, idx, n_frames, **kw):
    cfg = AlignerConfig(**kw)
    return DepthAligner(cfg).run([torch.from_numpy(g) for g in groups], [1, 3], index_mats=idx, seq_len=n_frames,
                                 channels_last=True, restore_shift=True)


def test_merged_output_is_the_same_at_1_and_4_threads():
    """Frames of 64x64x4: the merge's gathers and adds run on several
    threads; the solve's view (factor 10) stays small."""
    rng = np.random.default_rng(3)
    idx = [snippet_index_matrix(12, 3, d) for d in (1, 3)]
    base = rng.standard_normal((12, 64, 64, 4)).astype(np.float32)
    groups = [(base[m] + 0.3 * rng.standard_normal(m.shape + (64, 64, 4))).astype(np.float32) for m in idx]
    threads = torch.get_num_threads()
    try:
        runs = []
        for n in (1, 4):
            torch.set_num_threads(n)
            runs.append(_run_port(groups, idx, 12, factor=10, depth_loss_weight=0.0, num_iterations=30))
    finally:
        torch.set_num_threads(threads)
    flat = [[merged, *scales, *shifts, history] for merged, scales, shifts, history in runs]
    assert all(torch.equal(a, b) for a, b in zip(*flat))


@pytest.mark.parametrize("depth_loss_weight", [0.0, 1.0])
def test_no_scatter_add_is_reached(monkeypatch, depth_loss_weight):
    refuse_scatter_adds(monkeypatch)
    idx, groups = _groups(positive=True)
    merged = _run_port(groups, idx, 10, factor=3, depth_loss_weight=depth_loss_weight, num_iterations=3)[0]
    assert merged.shape == (10, 16, 16, 4) and torch.isfinite(merged).all()


@pytest.mark.parametrize("mode", ["eager", "jit"])
@pytest.mark.parametrize("steps", [1, 2, 5, 10])
def test_adam_update_matches_optax(mode, steps):
    """The same parameters and gradients (magnitudes 1e-6 to 10) through
    ``optax.adam(1e-3, b1=0.5, b2=0.9, eps=1e-8)`` and ``adam_update_``:
    op by op bit for bit (parameters, moments, count); jitted within 1e-6,
    a thousandth of lr (XLA's fused products; 1.2e-7 seen at 10 steps)."""
    rng = np.random.default_rng(steps)
    p0 = rng.standard_normal((2, 300)).astype(np.float32)
    grads = [(rng.standard_normal((2, 300)) * 10.0 ** rng.uniform(-6, 1, (2, 300))).astype(np.float32)
             for _ in range(steps)]
    opt = optax.adam(1e-3, b1=0.5, b2=0.9, eps=1e-8)

    def update(p, state, g):
        u, state = opt.update(g, state, p)
        return optax.apply_updates(p, u), state

    update = jax.jit(update) if mode == "jit" else update
    p, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy())
    mu, nu, count = torch.zeros_like(tp), torch.zeros_like(tp), torch.zeros(1, dtype=torch.long)
    for g in grads:
        p, state = update(p, state, jnp.asarray(g))
        adam_update_(tp, torch.from_numpy(g), mu, nu, count, 1e-3)
    adam_state = state[0]
    assert int(count) == int(adam_state.count) == steps
    if mode == "eager":
        np.testing.assert_array_equal(tp.numpy(), np.asarray(p))
        np.testing.assert_array_equal(mu.numpy(), np.asarray(adam_state.mu))
        np.testing.assert_array_equal(nu.numpy(), np.asarray(adam_state.nu))
    else:
        np.testing.assert_allclose(tp.numpy(), np.asarray(p), rtol=0, atol=1e-6)


def test_zero_iterations_give_the_plain_average():
    """No step: s = 1, t = 0, an empty history, and the merge is each
    frame's mean over the windows that cover it."""
    idx, groups = _groups()
    merged, scales, shifts, history = _run_port(groups, idx, 10, factor=3, depth_loss_weight=0.0, num_iterations=0)
    assert history.shape == (0, 3)
    assert all(torch.equal(s, torch.ones_like(s)) for s in scales)
    assert all(torch.equal(t, torch.zeros_like(t)) for t in shifts)
    total, count = np.zeros((10, 16, 16, 4)), np.zeros(10)
    for m, g in zip(idx, groups):
        for w, frame in np.ndenumerate(m):
            total[frame] += g[w]
            count[frame] += 1
    np.testing.assert_allclose(merged.numpy(), total / count[:, None, None, None], rtol=1e-6, atol=1e-6)


def test_step_reads_nothing_from_the_host(monkeypatch):
    """The plain steps make no tensor from the host and read no value back:
    they read only the device tensors that the call built before them."""
    def refuse(*args, **kwargs):
        raise AssertionError("the step reached the host")

    solve = port_aligner.solve

    def guarded(p, kernel):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "nonzero", "numpy", "__bool__"):
                m.setattr(torch.Tensor, name, refuse)
            for name in ("from_numpy", "as_tensor", "tensor", "nonzero"):
                m.setattr(torch, name, refuse)
            solve(p, kernel)

    monkeypatch.setattr(port_aligner, "solve", guarded)
    idx, groups = _groups(positive=True)
    for weight in (0.0, 1.0):
        merged = _run_port(groups, idx, 10, factor=3, depth_loss_weight=weight, num_iterations=3)[0]
        assert torch.isfinite(merged).all()


def _module_state(module) -> dict:
    """Each global of ``module``: its object, and its length if it holds others."""
    return {k: (id(v), len(v) if isinstance(v, (dict, list, set)) else None)
            for k, v in vars(module).items() if not k.startswith("__")}


@pytest.mark.parametrize("lengths", [(10, 13), (13, 10)])
@pytest.mark.parametrize("path", ["latent", "inverse"])
def test_solves_of_different_lengths_share_nothing(monkeypatch, path, lengths):
    """A solve after another of a different clip length gives the bits it
    gives alone, and each call drops its solve: the aligner module holds
    nothing more after either, and no ``Problem`` outlives its call."""
    kw = dict(factor=3, num_iterations=20, depth_loss_weight=0.0 if path == "latent" else 1.0)
    run_kw = dict(restore_shift=True, channels_last=True) if path == "latent" else {}
    clips = {n: _groups(n_frames=n, positive=path == "inverse", channels_last=path == "latent", seed=n)
             for n in lengths}
    problems, solve = [], port_aligner.solve

    def recording(p, kernel):
        problems.append(weakref.ref(p))
        solve(p, kernel)

    monkeypatch.setattr(port_aligner, "solve", recording)

    def run(n):
        idx, groups = clips[n]
        merged, scales, shifts, history = DepthAligner(AlignerConfig(**kw)).run(
            [torch.from_numpy(g) for g in groups], [1, 3], index_mats=idx, seq_len=n, **run_kw)
        return [merged, *scales, *shifts, history]

    first, second = lengths
    state = _module_state(port_aligner)
    alone = run(second)
    runs = [run(first), run(second)]
    assert _module_state(port_aligner) == state
    assert len(problems) == 3 and all(ref() is None for ref in problems)
    assert all(torch.equal(a, b) for a, b in zip(alone, runs[1]))
    assert runs[0][0].shape[0] == first and runs[1][0].shape[0] == second
