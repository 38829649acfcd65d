"""The frame sums on the card repeat bit for bit (``-m cuda``; every test skips without one).

- the co-alignment solve at the ``fast`` path's sizes (60 frames, windows of
  3 at dilations 1 and 25, latents of 54x96x4, factor 3, 2000 steps, the
  latent merge) and in depth space (the inverse term on, windows of
  1x432x768, factor 10): two runs give the same merged output, scales,
  shifts and loss history, bit for bit;
- ``_refine`` on 60 frames (refinement annealed from dilation 25), over
  partition and over stride-1 windows, with the tiny UNet on latents of
  18x32x4: two runs give the same latents, bit for bit.  (The tiny UNet's
  heads take the plain attention path, whose [L, L] scores at the fast
  path's 54x96 latents, L = 15,552, do not fit the card.)

The card's machine has no JAX: ``python -m pytest tests/test_torch_aligner_cuda.py -m cuda --noconftest``.
"""

import pytest
import torch

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


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["latent", "depth"])
def test_solve_repeats_bit_for_bit(space):
    _cuda()
    if space == "latent":
        idx, groups = _windows((54, 96, 4), positive=False)
        cfg, kw = AlignerConfig(factor=3, depth_loss_weight=0.0), dict(restore_shift=True, channels_last=True)
    else:
        idx, groups = _windows((1, 432, 768), positive=True)
        cfg, kw = AlignerConfig(), {}
    runs = [DepthAligner(cfg).run(groups, DILATIONS, index_mats=idx, seq_len=N_FRAMES, **kw) for _ in range(2)]
    flat = [[merged, *scales, *shifts, history] for merged, scales, shifts, history in runs]
    assert all(torch.equal(a, b) for a, b in zip(*flat))


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
