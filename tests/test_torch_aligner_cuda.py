"""The solve and the frame sums on the card (``-m cuda``; every test skips without one).

- the co-alignment solve at the ``fast`` path's sizes (60 frames, windows of
  3 at dilations 1 and 25, latents of 54x96x4, factor 3, 2000 steps, the
  latent merge) and in depth space (the inverse term on, windows of
  1x432x768, factor 10): two runs give the same merged output, scales,
  shifts and loss history, bit for bit; and the captured CUDA graph's
  solve gives the same bits as the same step run eagerly;
- one capture serves every solve of one shape: three channel solves (as
  relight runs them) and a second call replay it, each bit for bit against
  its eager solve;
- a capture while another thread copies device tensors to the host (as
  the CLI's save pool does) succeeds and gives the eager solve's bits;
- ``_refine`` on 60 frames (refinement annealed from dilation 25), over
  partition and over stride-1 windows, with the tiny UNet on latents of
  18x32x4: two runs give the same latents, bit for bit.  (The tiny UNet's
  heads take the plain attention path, whose [L, L] scores at the fast
  path's 54x96 latents, L = 15,552, do not fit the card.)

The card's machine has no JAX: ``python -m pytest tests/test_torch_aligner_cuda.py -m cuda --noconftest``.
"""
import threading
import time

import pytest
import torch

from rollingdepth_torch import aligner as port_aligner
from rollingdepth_torch.aligner import AlignerConfig, DepthAligner
from rollingdepth_torch.pipelines.snippets import snippet_index_matrix

N_FRAMES, DILATIONS = 60, (1, 25)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _windows(frame_shape, positive: bool):
    """Windows of 3 frames at each dilation: the frames, scaled per window, plus noise."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = torch.randn((N_FRAMES,) + frame_shape, generator=gen, device="cuda")
    idx = [snippet_index_matrix(N_FRAMES, 3, d) for d in DILATIONS]
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


def _solve(cfg, groups, idx, **kw) -> list:
    merged, scales, shifts, history = DepthAligner(cfg).run(groups, DILATIONS, index_mats=idx, seq_len=N_FRAMES, **kw)
    return [merged, *scales, *shifts, history]


def _eager(monkeypatch, cfg, groups, idx, **kw) -> list:
    """The same solve with the step run eagerly (``_optimize(graph=False)``)."""
    optimize = DepthAligner._optimize
    with monkeypatch.context() as m:
        m.setattr(DepthAligner, "_optimize", lambda self, *a, **k: optimize(self, *a, graph=False, **k))
        return _solve(cfg, groups, idx, **kw)


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["latent", "depth"])
def test_solve_repeats_bit_for_bit(space):
    _cuda()
    idx, groups, cfg, kw = _space(space)
    assert _equal(*(_solve(cfg, groups, idx, **kw) for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["latent", "depth"])
def test_graph_solve_equals_eager_steps(monkeypatch, space):
    _cuda()
    idx, groups, cfg, kw = _space(space)
    graph = _solve(cfg, groups, idx, **kw)
    assert _equal(graph, _eager(monkeypatch, cfg, groups, idx, **kw))
    assert graph[-1].shape == (cfg.num_iterations, 3)


@pytest.mark.cuda
def test_one_capture_serves_every_solve_of_a_shape(monkeypatch):
    """Relight's three channel solves, then a second call: one capture,
    and each solve the eager one's bits (the replays read each call's
    inputs)."""
    _cuda()
    port_aligner._SOLVES.clear()
    idx, groups = _windows((3, 64, 96), positive=True)
    cfg = AlignerConfig(num_iterations=200)
    channels = [[g[:, :, ch : ch + 1] for g in groups] for ch in range(3)]
    got = [_solve(cfg, c, idx) for c in channels] + [_solve(cfg, channels[1], idx)]
    assert len(port_aligner._SOLVES) == 1
    assert next(iter(port_aligner._SOLVES.values())).captures == 1
    want = [_eager(monkeypatch, cfg, c, idx) for c in channels]
    assert all(_equal(a, b) for a, b in zip(got, want + want[1:2]))
    assert not _equal(got[0], got[1])


@pytest.mark.cuda
def test_capture_while_another_thread_copies_to_the_host(monkeypatch):
    _cuda()
    port_aligner._SOLVES.clear()
    idx, groups, cfg, kw = _space("latent")
    cfg = AlignerConfig(factor=3, depth_loss_weight=0.0, num_iterations=100)
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

    capture = port_aligner._Solve._capture

    def timed_capture(self):
        t0 = time.perf_counter()
        capture(self)
        window.append((t0, time.perf_counter()))

    monkeypatch.setattr(port_aligner._Solve, "_capture", timed_capture)
    thread = threading.Thread(target=copier, daemon=True)
    thread.start()
    try:
        while not copies:
            time.sleep(0.001)
        got = _solve(cfg, groups, idx, **kw)
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    (lo, hi), = window
    assert any(a < hi and b > lo for a, b in copies), "no copy overlapped the capture"
    assert _equal(got, _eager(monkeypatch, cfg, groups, idx, **kw))


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
