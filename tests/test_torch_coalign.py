"""``rollingdepth_torch.ops.coalign`` on the CPU: the kernel's launch plan, its
index tables, and the wrapper's refusals.

The kernel itself runs only on a card (``tests/test_torch_aligner_cuda.py``).
Here ``emulate`` walks the solve as the kernel does, block by block, reading
only what ``tables`` gives it (each block's windows, each row's window in
that list, each window's rows, the owner of each window), and is held to the
plain step (``aligner.plain_step``) at the JAX tolerances; so a table that
points one block at another's window, drops a row or misorders a window's
rows fails here, before any card run."""

import numpy as np
import pytest
import torch

from rollingdepth_torch import aligner
from rollingdepth_torch.aligner import ADAM_B1, ADAM_B2, ADAM_EPS, AlignerConfig, DepthAligner
from rollingdepth_torch.ops import coalign as co
from rollingdepth_torch.pipelines.snippets import snippet_index_matrix

H100_SMS = 132


@pytest.mark.parametrize("name, n_frames, k, p, want", [
    ("fast", 60, 6, 17 * 31 * 4, (60, 1, True)),  # 54x96 latents, crop 2, ::3; dilations [1, 19]
    ("full", 60, 9, 23 * 42 * 4, (60, 1, True)),  # 72x128 latents; dilations [1, 10, 19]
    ("paper", 51, 9, 43 * 77, (51, 1, True)),  # depth 432x768, factor 10; dilations [1, 10, 25]
    ("relight", 24, 3, 72 * 64, (24, 1, True)),  # a channel at 720x640, factor 10; dilation 1
    ("fast_12f", 12, 6, 17 * 31 * 4, (12, 1, True)),
    ("fast_120f", 120, 6, 17 * 31 * 4, (120, 1, True)),
    ("fast_300f", 300, 6, 17 * 31 * 4, (100, 3, True)),  # more frames than SMs: 3 a block still fit
    ("fast_1000f", 1000, 6, 17 * 31 * 4, (125, 8, False)),  # 8 frames' rows (405 KB) read from L2
    ("wide_rows", 60, 6, 10_000, (60, 1, False)),  # one frame's rows (240 KB) exceed shared memory
])
def test_launch_plan(name, n_frames, k, p, want):
    plan = co.launch_plan(n_frames, k, p, H100_SMS)
    assert (plan.blocks, plan.frames_per_block, plan.resident) == want
    assert plan.blocks <= H100_SMS and plan.blocks * plan.frames_per_block >= n_frames
    assert (plan.blocks - 1) * plan.frames_per_block < n_frames
    assert co.smem_bytes(plan.frames_per_block, k, p, plan.resident) <= co.SMEM_MAX
    assert co.smem_bytes(plan.frames_per_block, k, p, True) > co.SMEM_MAX or plan.resident


def test_launch_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError):
        co.launch_plan(0, 6, 100, H100_SMS)
    with pytest.raises(ValueError):  # 4,000 frames a block: their slots alone overflow shared memory
        co.launch_plan(4000, 9, 100, 1)


def test_tables_layout():
    """Two groups on 4 frames, windows of 2 (dilation 1: 3 windows) and of 1
    (4 windows), w_max 2, two blocks of 2 frames."""
    idx = [snippet_index_matrix(4, 2, 1), snippet_index_matrix(4, 1, 1)]
    table, _ = aligner.frame_table(idx, 4)
    place = np.concatenate([(np.arange(3)[:, None] * 2 + np.arange(2)).ravel(), (3 + np.arange(4)) * 2])
    slots = np.append(place, -1)[table]
    plan = co.Plan(2, 2, True)
    meta = co.tables(slots, 2, [3, 4], plan)
    n = slots.size
    np.testing.assert_array_equal(meta[:n].reshape(4, 3), slots)
    # frame 0: rows (window 0, j 0), (window 3, j 0); frame 1: (0, 1), (1, 0), (4, 0)
    np.testing.assert_array_equal(slots, [[0, 6, -1], [1, 2, 8], [3, 4, 10], [5, 12, -1]])
    blk_win = meta[-2 - 2 * 6 : -2].reshape(2, 6)
    np.testing.assert_array_equal(blk_win, [[0, 1, 3, 4, -1, -1], [1, 2, 5, 6, -1, -1]])
    np.testing.assert_array_equal(meta[-2:], [4, 4])
    np.testing.assert_array_equal(meta[n : 2 * n].reshape(4, 3), [[0, 2, -1], [0, 1, 3], [0, 1, 2], [1, 3, -1]])
    win_rows = meta[2 * n : 2 * n + 14].reshape(7, 2)
    np.testing.assert_array_equal(win_rows, [[0, 3], [4, 6], [7, 9], [1, -1], [5, -1], [8, -1], [10, -1]])
    np.testing.assert_array_equal(meta[2 * n + 14 : 2 * n + 21], [3, 3, 3, 4, 4, 4, 4])


def emulate(views: torch.Tensor, slots: np.ndarray, sizes, iters: int, cfg: AlignerConfig, denom: float, n_sm: int):
    """The kernel's solve in fp32 PyTorch on the CPU, from its tables: every
    block's frames, then the barrier, then each block's Adam on its own copy
    of its windows.  Returns (params [2, n], history [iters, 3])."""
    n_frames, k = slots.shape
    n_all, w_max, p = views.shape
    plan = co.launch_plan(n_frames, k, p, n_sm)
    meta = co.tables(slots, w_max, sizes, plan)
    width, cut = plan.frames_per_block * k, np.cumsum([0, n_frames * k, n_frames * k, n_all * w_max, n_all])
    slot_place, slot_local, win_rows, win_size = (meta[a:b] for a, b in zip(cut[:-1], cut[1:]))
    slot_place, slot_local = slot_place.reshape(n_frames, k), slot_local.reshape(n_frames, k)
    win_rows = win_rows.reshape(n_all, w_max)
    blk_win = meta[cut[-1] : cut[-1] + plan.blocks * width].reshape(plan.blocks, width)
    blk_nwin = meta[cut[-1] + plan.blocks * width :]
    v, f32 = views.reshape(-1, p), (lambda x: torch.tensor(x, dtype=torch.float32))  # noqa: E731
    inv = cfg.depth_loss_weight != 0.0
    state = [{"id": blk_win[b, : blk_nwin[b]], "p": torch.stack([torch.ones(blk_nwin[b]), torch.zeros(blk_nwin[b])]),
              "m": torch.zeros(2, blk_nwin[b]), "v": torch.zeros(2, blk_nwin[b])} for b in range(plan.blocks)]
    history = torch.zeros(iters, 3)
    for n in range(iters):
        part, stats = torch.zeros(n_frames * k, 2), []
        for b, st in enumerate(state):
            lm = li = soft = f32(0.0)
            lo, hi = np.inf, -np.inf
            for f in range(b * plan.frames_per_block, min(n_frames, (b + 1) * plan.frames_per_block)):
                ks = [s for s in range(k) if slot_local[f, s] >= 0]
                if not ks:
                    continue
                a = {s: v[slot_place[f, s]] * st["p"][0, slot_local[f, s]] + st["p"][1, slot_local[f, s]] for s in ks}
                tg = sum(a[s] for s in ks) / len(ks)
                sc = (tg.abs().sum() / p).clamp(min=1e-12)
                if inv:
                    ti = sum(1.0 / a[s].clamp(min=1e-3) for s in ks) / len(ks)
                    sci = (ti.abs().sum() / p).clamp(min=1e-12)
                lo, hi = min(lo, float(tg.min())), max(hi, float(tg.max()))
                for s in ks:
                    row = v[slot_place[f, s]]
                    sg = torch.sign(a[s] - tg)
                    gs, gt = (sg * row).sum() / sc, sg.sum() / sc
                    lm = lm + (a[s] - tg).abs().sum() / sc
                    if inv:
                        c = a[s].clamp(min=1e-3)
                        gi = torch.sign(1.0 / c - ti) * torch.where(a[s] >= 1e-3, -1.0 / (c * c), 0.0)
                        gs = gs + cfg.depth_loss_weight * ((gi * row).sum() / sci)
                        gt = gt + cfg.depth_loss_weight * (gi.sum() / sci)
                        li = li + (1.0 / c - ti).abs().sum() / sci
                    part[f * k + s] = torch.stack([gs, gt])
            for j, i in enumerate(st["id"]):
                if (win_rows[i, 0] // k) // plan.frames_per_block == b:  # the window's owner adds its soft term
                    r, t = torch.relu(1.0 - st["p"][0, j]), st["p"][1, j]
                    soft = soft + cfg.lmda2 * r * r / win_size[i] + cfg.lmda3 * t * t / win_size[i]
            stats.append((lm, li, soft, lo, hi))
        lm, li, soft = (sum(s[q] for s in stats) for q in range(3))
        loss = lm / denom + cfg.depth_loss_weight * (li / denom)
        history[n] = torch.stack([cfg.loss_scale * loss + soft, f32(min(s[3] for s in stats)),
                                  f32(max(s[4] for s in stats))])
        for st in state:  # every block, its own copy
            rows = win_rows[st["id"]]
            g = torch.stack([torch.stack([part[r[r >= 0], q].sum() for r in rows]) for q in range(2)])
            g = g * (cfg.loss_scale / denom)
            sizes_b = f32(win_size[st["id"]])
            g[0] = g[0] - 2.0 * (cfg.lmda2 / sizes_b) * torch.relu(1.0 - st["p"][0])
            g[1] = g[1] + 2.0 * (cfg.lmda3 / sizes_b) * st["p"][1]
            aligner.adam_update_(st["p"], g, st["m"], st["v"], torch.tensor([n]), cfg.lr, ADAM_B1, ADAM_B2, ADAM_EPS)
    params = torch.zeros(2, n_all)
    for st in state:
        params[:, st["id"]] = st["p"]
    return params, history


def _eager_solve(monkeypatch, groups, idx, n_frames, cfg, **kw):
    """The eager solve on the CPU, and the ``Problem`` it ran on."""
    problems, solve = [], aligner.solve

    def recording(p, kernel):
        problems.append(p)
        solve(p, kernel)

    monkeypatch.setattr(aligner, "solve", recording)
    DepthAligner(cfg).run([torch.from_numpy(g) for g in groups], [1] * len(groups), index_mats=idx,
                          seq_len=n_frames, **kw)
    return problems[0]


@pytest.mark.parametrize("case", ["latent", "inverse", "two_lengths", "frames_per_block"])
@pytest.mark.parametrize("iters", [1, 10])
def test_emulated_kernel_matches_the_eager_steps(monkeypatch, case, iters):
    rng = np.random.default_rng(iters)
    n_frames = 10
    lengths = (3, 2) if case == "two_lengths" else (3, 3)
    idx = [snippet_index_matrix(n_frames, w, d) for w, d in zip(lengths, (1, 3))]
    base = rng.standard_normal((n_frames, 12, 12, 4)).astype(np.float32)
    groups = [(base[m] * (1.0 + 0.2 * rng.standard_normal((m.shape[0], 1, 1, 1, 1)))
               + 0.3 * rng.standard_normal(m.shape + (12, 12, 4))).astype(np.float32) for m in idx]
    if case == "inverse":
        groups = [np.abs(g) + 0.5 for g in groups]
    cfg = AlignerConfig(factor=3, depth_loss_weight=1.0 if case == "inverse" else 0.0, num_iterations=iters)
    solve = _eager_solve(monkeypatch, groups, idx, n_frames, cfg, channels_last=True, restore_shift=True)
    assert (solve.slots < 0).any() and len(set(solve.widths)) == len(set(lengths))  # edge frames: empty slots
    n_sm = 4 if case == "frames_per_block" else H100_SMS  # 3 frames a block, the last block 1
    params, history = emulate(solve.views, solve.slots, solve.sizes, iters, cfg, solve.denom, n_sm)
    np.testing.assert_allclose(params.numpy(), solve.params.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(history.numpy(), solve.history.numpy(), rtol=1e-5, atol=1e-5)


def _args(views, n=4, iters=3):
    return dict(views=views, place=np.zeros((n, 2), np.int64), sizes=[views.shape[0]],
                params=torch.zeros(2, views.shape[0]), mu=torch.zeros(2, views.shape[0]),
                nu=torch.zeros(2, views.shape[0]), history=torch.zeros(iters, 3))


HYPER = dict(lr=1e-3, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS, lmda2=0.1, lmda3=10.0, loss_scale=1.0,
             depth_loss_weight=0.0, denom=1.0)


@pytest.mark.parametrize("fault, why", [
    ("cpu", "CUDA tensors"),
    ("bf16", "fp32"),
    ("strided", "contiguous"),
])
def test_wrapper_refuses(fault, why):
    views = torch.zeros(4, 2, 16)
    if fault == "bf16":
        views = views.bfloat16()
    elif fault == "strided":
        views = torch.zeros(4, 2, 32)[..., ::2]
    before = co.coalign.launches
    with pytest.raises(ValueError, match=why):
        co.coalign(**_args(views), **HYPER)
    assert co.coalign.launches == before
