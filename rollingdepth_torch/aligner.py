"""Snippet co-alignment solver (a scale and a shift per snippet window).

Counterpart of ``rollingdepth_tpu/aligner.py``.  Each window gets a scalar
scale s (init 1) and shift t (init 0), optimised with Adam (lr 1e-3, betas
(0.5, 0.9), eps 1e-8, 2000 iterations) so that all windows covering a
frame agree: an L1 loss against the detached per-frame mean, each frame
normalised by the mean |target|, plus an optional inverse-depth term and
soft constraints lmda2*relu(1-s)^2 + lmda3*t^2 per group.  The solve sees a
border-cropped, ::factor-subsampled view; the solved (s, t) are applied at
full resolution and overlapping windows averaged per frame.

Groups (one per dilation) are ``[S_g, w_g, C, H, W]``, or
``[S_g, w_g, H, W, C]`` with ``channels_last=True`` (the latent path).
Every sum of windows into frames runs in an order fixed on the host
(``frame_table``), as the JAX package's one-hot sums do: no atomic add, so
a call gives the same bits on every run.  The solve sums each target with
one [T, K, P] gather and a reduction over the K slots; the merge and
refinement, at full resolution, slot by slot (``frame_sum``).  The loop
does no host sync: the loss history is written into a preallocated device
tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .pipelines.snippets import snippet_index_matrix


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    factor: int = 10  # spatial subsample stride of the solve
    lmda: float = 1e-1  # unused by the objective; kept for API parity
    lmda2: float = 1e-1  # soft constraint weight on (1 - s)
    lmda3: float = 1e1  # soft constraint weight on t
    lr: float = 1e-3
    num_iterations: int = 2000
    border: int = 2
    depth_loss_weight: float = 1.0
    loss_scale: float = 1.0


def frame_table(index_mats: Sequence[np.ndarray], seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """The order of every frame sum, built on the host.

    The window rows are the index matrices flattened row-major and
    concatenated in order (R rows in all).  Returns ``table`` [seq_len, K]:
    row t lists, in ascending order, the window rows that cover frame t; K
    is the largest coverage, and an empty slot holds R, the row that
    ``frame_sum`` expects to be zero; and ``counts`` [seq_len], each frame's
    coverage."""
    flat = np.concatenate([np.asarray(m, np.int64).reshape(-1) for m in index_mats])
    counts = np.bincount(flat, minlength=seq_len)
    if counts.shape[0] != seq_len:
        raise ValueError(f"a window covers frame {flat.max()} of a {seq_len}-frame clip")
    order = np.argsort(flat, kind="stable")  # by frame, and by row within a frame
    slot = np.arange(flat.size) - np.repeat(np.cumsum(counts) - counts, counts)
    table = np.full((seq_len, counts.max(initial=0)), flat.size, np.int64)
    table[flat[order], slot] = order
    return table, counts


def frame_sum(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum window rows into frames in the table's order.

    ``rows`` [R + 1, ...] with row R zero; ``table`` [T, K] from
    ``frame_table``, on ``rows``' device.  Frame t's sum is
    ``((rows[table[t, 0]] + rows[table[t, 1]]) + rows[table[t, 2]]) + ...``,
    slot by slot from the left: K ordered gathers and adds into one [T, ...]
    accumulator, with no atomic add, so the same bits on every run and at
    every thread count."""
    if table.shape[1] == 0:
        return rows.new_zeros((table.shape[0],) + tuple(rows.shape[1:]))
    acc = rows[table[:, 0]]
    for k in range(1, table.shape[1]):
        acc = acc + rows[table[:, k]]
    return acc


class DepthAligner:
    def __init__(self, config: AlignerConfig = AlignerConfig()):
        self.config = config

    def run(
        self,
        snippet_ls: Sequence[torch.Tensor],
        dilations: Sequence[int],
        restore_shift: bool = False,
        channels_last: bool = False,
        index_mats: Optional[Sequence[np.ndarray]] = None,
        seq_len: Optional[int] = None,
    ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
        """Returns (merged [N, ...frame], scales, translations, loss_history).

        ``loss_history`` is [iters, 3]: loss, min and max of the per-frame
        mean target.  ``restore_shift`` adds the solver's global min shift
        back, so the merge lives in the input's value space (the latent
        path needs real latents back).  Without ``index_mats`` the windows
        are the stride-1 windows of each (group size, dilation)."""
        cfg = self.config
        if index_mats is None:
            w0, gap0 = snippet_ls[0].shape[1], dilations[0] - 1
            seq_len = snippet_ls[0].shape[0] + (w0 - 1) * gap0 + (w0 - 1)
            index_mats = [snippet_index_matrix(seq_len, s.shape[1], d) for s, d in zip(snippet_ls, dilations)]
        elif seq_len is None:
            raise ValueError("explicit index_mats need seq_len")
        for m, s in zip(index_mats, snippet_ls):
            if tuple(m.shape) != tuple(s.shape[:2]):
                raise ValueError(f"index matrix {m.shape} does not match group {tuple(s.shape)}")
        dev = snippet_ls[0].device
        idx = [torch.as_tensor(np.asarray(m).reshape(-1), device=dev, dtype=torch.long) for m in index_mats]
        table, counts = frame_table(index_mats, seq_len)
        counts = torch.as_tensor(counts, device=dev, dtype=torch.float32)

        b, f = cfg.border, cfg.factor
        mn = torch.stack([g.float().amin() for g in snippet_ls]).amin()
        views = []
        for g in snippet_ls:
            v = g[:, :, b:-b:f, b:-b:f, :] if channels_last else g[:, :, :, b:-b:f, b:-b:f]
            views.append((v.float() - mn).reshape(g.shape[0], g.shape[1], -1))

        scales, shifts, history = self._optimize(views, idx, table, counts, seq_len)
        merged = self._merge(snippet_ls, torch.as_tensor(table, device=dev), counts, scales, shifts, mn,
                             restore_shift, seq_len)
        return merged, scales, shifts, history

    @torch.enable_grad()  # callers may run under no_grad (the pipeline does)
    def _optimize(self, views, idx, table: np.ndarray, counts, seq_len: int):
        """The views go into one [n_windows, w_max, P] tensor before the loop
        (a shorter group's missing frames are zero rows that nothing reads),
        so each step applies (s, t) once.  Each target is ``a[rows].sum(1)``
        over the table's [T, K] rows: one gather, then one reduction over K
        (PyTorch's, with no atomic add: its order is fixed by the shape and
        the device), with an empty slot's row masked to zero."""
        cfg = self.config
        dev = views[0].device
        sizes = [v.shape[0] for v in views]
        widths = [v.shape[1] for v in views]
        p_dim = views[0].shape[-1]
        n_all, w_max = sum(sizes), max(widths)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        v_all = torch.zeros((n_all, w_max, p_dim), device=dev)
        for v, lo, hi in zip(views, bounds[:-1], bounds[1:]):
            v_all[lo:hi, : v.shape[1]] = v
        # each window row of the table (groups flattened row-major, in order) at its place in v_all
        place = np.concatenate([((lo + np.arange(v.shape[0]))[:, None] * w_max + np.arange(v.shape[1])).reshape(-1)
                                for v, lo in zip(views, bounds[:-1])])
        empty = table == place.size
        rows = torch.as_tensor(np.append(place, 0)[table], device=dev)
        keep = torch.as_tensor(~empty, device=dev, dtype=torch.float32)[..., None] if empty.any() else None

        s_all = torch.ones(n_all, device=dev, requires_grad=True)
        t_all = torch.zeros(n_all, device=dev, requires_grad=True)
        opt = torch.optim.Adam([s_all, t_all], lr=cfg.lr, betas=(0.5, 0.9), eps=1e-8)
        history = torch.empty((cfg.num_iterations, 3), device=dev)
        use_inv = cfg.depth_loss_weight != 0.0
        denom = float(sum(v.shape[1] for v in views) * seq_len * p_dim)
        cnt = counts.clamp(min=1.0)[:, None]
        covered = (counts > 0)[:, None]

        def frame_mean(a):
            g = a.reshape(-1, p_dim)[rows]
            return (g if keep is None else g * keep).sum(1) / cnt

        for it in range(cfg.num_iterations):
            opt.zero_grad(set_to_none=True)
            s_list = [s_all[bounds[i] : bounds[i + 1]] for i in range(len(views))]
            t_list = [t_all[bounds[i] : bounds[i + 1]] for i in range(len(views))]
            a_all = v_all * s_all[:, None, None] + t_all[:, None, None]
            inv_all = a_all.clamp(min=1e-3) ** -1 if use_inv else None
            a_list = [a_all[bounds[i] : bounds[i + 1], :w] for i, w in enumerate(widths)]
            inv_list = [inv_all[bounds[i] : bounds[i + 1], :w] for i, w in enumerate(widths)] if use_inv else []
            with torch.no_grad():  # the per-frame targets are detached
                target = frame_mean(a_all)
                scale = target.abs().mean(-1, keepdim=True)
                if use_inv:
                    target_inv = frame_mean(inv_all)
                    scale_inv = target_inv.abs().mean(-1, keepdim=True)
            loss_m = 0.0
            loss_inv = 0.0
            for gi, (a, i) in enumerate(zip(a_list, idx)):
                shape = a.shape
                tgt = target[i].reshape(shape)
                sc = scale[i].reshape(shape[:2] + (1,)).clamp(min=1e-12)
                loss_m = loss_m + ((a - tgt) / sc).abs().sum()
                if use_inv:
                    tgt_inv = target_inv[i].reshape(shape)
                    sc_inv = scale_inv[i].reshape(shape[:2] + (1,)).clamp(min=1e-12)
                    loss_inv = loss_inv + ((inv_list[gi] - tgt_inv) / sc_inv).abs().sum()
            loss = loss_m / denom + cfg.depth_loss_weight * (loss_inv / denom)
            soft = 0.0
            for s, t in zip(s_list, t_list):
                soft = soft + cfg.lmda2 * torch.relu(1.0 - s).pow(2).sum() / s.shape[0]
                soft = soft + cfg.lmda3 * t.pow(2).sum() / t.shape[0]
            total = cfg.loss_scale * loss + soft
            total.backward()
            opt.step()
            with torch.no_grad():
                history[it, 0] = total.detach()
                history[it, 1] = torch.where(covered, target, torch.inf).amin()
                history[it, 2] = torch.where(covered, target, -torch.inf).amax()

        s_out = s_all.detach()
        t_out = t_all.detach()
        return ([s_out[bounds[i] : bounds[i + 1]] for i in range(len(views))],
                [t_out[bounds[i] : bounds[i + 1]] for i in range(len(views))], history)

    @torch.no_grad()
    def _merge(self, snippet_ls, table, counts, scales, shifts, mn, restore_shift: bool, seq_len: int):
        """Apply (s, t) at full resolution; average covering windows per frame.
        The solver's (s, t) live in min-shifted space: s*(x - mn) + t is
        applied as s*x + (t - s*mn).  The aligned windows are written once
        into one [R + 1, C*H*W] buffer (row R zero), which ``frame_sum``
        reads slot by slot."""
        frame_shape = tuple(snippet_ls[0].shape[2:])
        chw = int(np.prod(frame_shape))
        n_rows = sum(g.shape[0] * g.shape[1] for g in snippet_ls)
        rows = torch.empty((n_rows + 1, chw), device=snippet_ls[0].device)
        r0 = 0
        for g, s, t in zip(snippet_ls, scales, shifts):
            sg, w = g.shape[0], g.shape[1]
            a = rows[r0 : r0 + sg * w].view(sg, w * chw)
            torch.mul(g.reshape(sg, w * chw), s[:, None], out=a)
            a += (t - mn * s)[:, None]
            r0 += sg * w
        rows[n_rows] = 0.0
        out = frame_sum(rows, table) / counts.clamp(min=1.0)[:, None]
        if restore_shift:
            out = out + mn
        return out.reshape((seq_len,) + frame_shape)
