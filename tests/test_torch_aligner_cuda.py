"""The solve and the frame sums on the card (``-m cuda``; every test skips without one).

- the co-alignment solve at the ``fast`` path's sizes (60 frames, windows of
  3 at dilations 1 and 25, latents of 54x96x4, factor 3, 2000 steps, the
  latent merge) and in depth space (the inverse term on, windows of
  1x432x768, factor 10): two runs give the same merged output, scales,
  shifts and loss history, bit for bit;
- the kernel's solve (``ops/coalign.py``, one launch) against the plain
  version, the same step run eagerly (``_optimize(kernel=False)``) on the
  CPU, at both sizes: at 1 and 10 steps the scales, shifts, history and
  merged output within rtol/atol 1e-5 (the tolerance
  ``tests/test_torch_aligner.py`` holds the plain version to JAX at); at
  2000 steps the merged output within 2e-2 of its largest value, or, where
  the plain version on the card already parts from it by more, within
  twice that parting.  The reference is the CPU's run: at the ``fast``
  size the plain version on the card parts from it by 4.4e-4 at 10 steps
  and the kernel by 1.9e-6 (PyTorch's reduction on the card sums each
  frame's slots in another order, and the L1 solve turns such roundings
  into signs); at 2000 steps in depth space the plain version on the card
  and on the CPU part by 3.7e-2 of the largest value;
- the same at 10 steps for windows of two lengths (a masked table), more
  frames than the card has SMs (a block owns several frames) and rows too
  large for shared memory (read from L2 at each pass);
- three channel solves of one shape (as relight runs them) and a second
  call: a launch each, each within the tolerance of its eager solve, the
  second call's the first's bits;
- a solve while another thread copies device tensors to the host (as the
  CLI's save pool does): the same bits as without the copies;
- ``_refine`` on 60 frames (refinement annealed from dilation 25), over
  partition and over stride-1 windows, with the tiny UNet on latents of
  18x32x4: two runs give the same latents, bit for bit.  (The tiny UNet's
  heads take the plain attention path, whose [L, L] scores at the fast
  path's 54x96 latents, L = 15,552, do not fit the card.)

The card's machine has no JAX: ``python -m pytest tests/test_torch_aligner_cuda.py -m cuda --noconftest``.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from rollingdepth_torch.aligner import AlignerConfig, DepthAligner
from rollingdepth_torch.ops import coalign as co
from rollingdepth_torch.pipelines.snippets import snippet_index_matrix

N_FRAMES, DILATIONS = 60, (1, 25)
TOL = dict(rtol=1e-5, atol=1e-5)  # the eager step against JAX (tests/test_torch_aligner.py)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _windows(frame_shape, positive: bool, n_frames: int = N_FRAMES, lengths=(3, 3)):
    """Windows of ``lengths`` frames at each dilation: the frames, scaled per window, plus noise."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randn((n_frames,) + frame_shape, generator=gen, device="cuda")
    idx = [snippet_index_matrix(n_frames, w, d) for w, d in zip(lengths, DILATIONS)]
    groups = []
    for m in idx:
        scale = 1.0 + 0.2 * torch.randn((m.shape[0], 1) + (1,) * len(frame_shape), generator=gen, device="cuda")
        g = base[torch.as_tensor(m, device="cuda")] * scale
        g = g + 0.3 * torch.randn(g.shape, generator=gen, device="cuda")
        groups.append(g.abs() + 0.5 if positive else g)
    return idx, groups


def _space(space: str):
    """The ``fast`` path's latent solve, or a depth-space solve."""
    if space == "latent":
        idx, groups = _windows((54, 96, 4), positive=False)
        return idx, groups, AlignerConfig(factor=3, depth_loss_weight=0.0), dict(restore_shift=True, channels_last=True)
    idx, groups = _windows((1, 432, 768), positive=True)
    return idx, groups, AlignerConfig(), {}


def _solve(cfg, groups, idx, n_frames: int = N_FRAMES, **kw) -> list:
    merged, scales, shifts, history = DepthAligner(cfg).run(groups, DILATIONS, index_mats=idx, seq_len=n_frames, **kw)
    return [merged, *scales, *shifts, history]


def _eager(monkeypatch, cfg, groups, idx, n_frames: int = N_FRAMES, device: str = "cpu", **kw) -> list:
    """The same solve with the step run eagerly (``_optimize(kernel=False)``),
    on the CPU (copies of the windows) or on the card."""
    optimize = DepthAligner._optimize
    with monkeypatch.context() as m:
        m.setattr(DepthAligner, "_optimize", lambda self, *a, **k: optimize(self, *a, kernel=False, **k))
        return [x.cpu() for x in _solve(cfg, [g.to(device) for g in groups], idx, n_frames, **kw)]


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _close(got: list, want: list, **tol) -> None:
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), **tol)


def _kernel(cfg, groups, idx, n_frames: int = N_FRAMES, **kw) -> list:
    """The solve through the kernel: one launch."""
    before = co.coalign.launches
    got = _solve(cfg, groups, idx, n_frames, **kw)
    assert co.coalign.launches == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["latent", "depth"])
def test_solve_repeats_bit_for_bit(space):
    _cuda()
    idx, groups, cfg, kw = _space(space)
    assert _equal(*(_solve(cfg, groups, idx, **kw) for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 10])
@pytest.mark.parametrize("space", ["latent", "depth"])
def test_kernel_solve_matches_eager_steps(monkeypatch, space, iters):
    _cuda()
    idx, groups, cfg, kw = _space(space)
    cfg = dataclasses.replace(cfg, num_iterations=iters)
    got = _kernel(cfg, groups, idx, **kw)
    assert got[-1].shape == (iters, 3)
    _close(got, _eager(monkeypatch, cfg, groups, idx, **kw), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["latent", "depth"])
def test_kernel_full_solve_close_to_eager_steps(monkeypatch, space):
    """2000 steps: the merged output within 2e-2 of its largest value, as
    ``test_latent_path_full_solve_close_to_jax`` holds the plain version,
    or within twice the parting of the plain version on the card and on
    the CPU where that is larger."""
    _cuda()
    idx, groups, cfg, kw = _space(space)
    got = _kernel(cfg, groups, idx, **kw)[0].cpu()
    want = _eager(monkeypatch, cfg, groups, idx, **kw)[0]
    card = _eager(monkeypatch, cfg, groups, idx, device="cuda", **kw)[0]
    bound = max(2e-2 * float(want.abs().max()), 2 * float((card - want).abs().max()))
    assert float((got - want).abs().max()) <= bound


def _case(case: str):
    """(frames, windows, config, run kwargs, what the plan must show)."""
    cfg = AlignerConfig(factor=3, depth_loss_weight=0.0, num_iterations=10)
    kw = dict(restore_shift=True, channels_last=True)
    if case == "two_lengths":  # windows of 3 and of 2: a masked table, padded views
        n = N_FRAMES
        idx, groups = _windows((18, 32, 4), positive=False, lengths=(3, 2))
    elif case == "frames_per_block":  # more frames than SMs: each block owns several
        n = 2 * torch.cuda.get_device_properties(0).multi_processor_count + 7
        idx, groups = _windows((54, 96, 4), positive=False, n_frames=n)
    else:  # rows too large for shared memory: read from L2 at each pass (P = 366^2, K = 6)
        n = N_FRAMES
        idx, groups = _windows((1, 1100, 1100), positive=True)
        cfg, kw = AlignerConfig(factor=3, num_iterations=10), {}
    return n, idx, groups, cfg, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["two_lengths", "frames_per_block", "rows_from_l2"])
def test_kernel_cases_match_eager_steps(monkeypatch, case):
    _cuda()
    n, idx, groups, cfg, kw = _case(case)
    plans = []
    plan = co.launch_plan
    monkeypatch.setattr(co, "launch_plan", lambda *a, **k: plans.append(plan(*a, **k)) or plans[-1])
    got = _kernel(cfg, groups, idx, n, **kw)
    monkeypatch.setattr(co, "launch_plan", plan)
    (p,) = plans
    assert {"two_lengths": p.resident, "frames_per_block": p.frames_per_block > 1,
            "rows_from_l2": not p.resident}[case], p
    _close(got, _eager(monkeypatch, cfg, groups, idx, n, **kw), **TOL)


@pytest.mark.cuda
def test_three_channel_solves_of_one_shape(monkeypatch):
    """Relight's three channel solves, then a second call of one of them:
    a launch each, each within the tolerance of its eager solve, and the
    second call the first's bits."""
    _cuda()
    idx, groups = _windows((3, 64, 96), positive=True)
    cfg = AlignerConfig(num_iterations=10)
    channels = [[g[:, :, ch : ch + 1] for g in groups] for ch in range(3)]
    got = [_kernel(cfg, c, idx) for c in channels] + [_kernel(cfg, channels[1], idx)]
    for a, c in zip(got, channels):
        _close(a, _eager(monkeypatch, cfg, c, idx), **TOL)
    assert _equal(got[1], got[3]) and not _equal(got[0], got[1])


@pytest.mark.cuda
def test_solve_while_another_thread_copies_to_the_host():
    _cuda()
    idx, groups, cfg, kw = _space("latent")
    want = _kernel(cfg, groups, idx, **kw)
    big = torch.randn((16, 1024, 1024), device="cuda")
    stop, copies, errors, window = threading.Event(), [], [], []

    def copier():
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                big.cpu()
                copies.append((t0, time.perf_counter()))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    thread = threading.Thread(target=copier, daemon=True)
    thread.start()
    try:
        while not copies:
            time.sleep(0.001)
        t0 = time.perf_counter()
        got = _kernel(cfg, groups, idx, **kw)
        torch.cuda.synchronize()
        window.append((t0, time.perf_counter()))
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    (lo, hi), = window
    assert any(a < hi and b > lo for a, b in copies), "no copy overlapped the solve"
    assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("partition", [True, False])
def test_refine_repeats_bit_for_bit(partition):
    from rollingdepth_torch.tools.multihost_demo import build_pipeline

    _cuda()
    pipe = build_pipeline("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rgb, depth = (torch.randn((N_FRAMES, 18, 32, 4), generator=gen, device="cuda") for _ in range(2))
    noise = torch.randn((18, 32, 4), generator=gen, device="cuda")
    runs = [pipe._refine(rgb, depth, noise, refine_step=2, snippet_len=3, start_dilation=25, partition=partition,
                         chunks={}) for _ in range(2)]
    assert torch.equal(*runs)
