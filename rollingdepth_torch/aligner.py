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
refinement, at full resolution, slot by slot (``frame_sum``).

On the card the whole solve, every Adam step, is one launch of a
hand-written kernel (``ops/coalign.py``, ``csrc/coalign.cu``), as the JAX
package runs it as one jitted ``lax.scan``.  Each call builds its solve's
tensors (``Problem``) and drops them when it returns: nothing outlives a
call.  On the CPU the plain version runs: the same step op by op with
autograd (``plain_step``), optax's ``adam`` written out in tensor ops
(``adam_update_``), reading only device tensors built before the solve, the
step count and the loss history included.  ``solve`` runs either.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.coalign import coalign
from .pipelines.snippets import snippet_index_matrix
from .utils.profiling import span


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


ADAM_B1, ADAM_B2, ADAM_EPS = 0.5, 0.9, 1e-8  # the JAX package's optax.adam(lr, b1=0.5, b2=0.9, eps=1e-8)


def adam_update_(params: torch.Tensor, grads: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                 count: torch.Tensor, lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
                 eps: float = ADAM_EPS) -> None:
    """``optax.adam(lr, b1, b2, eps)``'s update of ``params`` in place, in
    ``optax.scale_by_adam``'s order and from device tensors only (the kernel
    rounds in the same order): ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2
    + b2 nu``, ``count += 1`` (a one-element integer tensor), the bias
    corrections ``1 - b**count`` in the parameters' dtype from the device
    count, then ``params -= lr * mu_hat / (sqrt(nu_hat) + eps)``."""
    mu.mul_(b1).add_(grads * (1 - b1))
    nu.mul_(b2).add_(grads * grads * (1 - b2))
    count.add_(1)
    c = count.to(params.dtype)
    update = (mu / (1 - b1**c)) / ((nu / (1 - b2**c)).sqrt() + eps)
    params.sub_(update * lr)


@dataclasses.dataclass
class Problem:
    """One solve's tensors, built by ``build`` for one call on the views'
    device and dropped when the call returns.

    ``views`` [n_windows, w_max, P] holds the groups' windows in order (a
    shorter group's missing frames are zero rows that nothing reads);
    ``slots`` [T, K] each (frame, slot)'s row of the flattened views, -1
    for an empty slot; ``sizes`` and ``widths`` each group's window count
    and width.  The steps write ``params`` (every window's s, then its t;
    1 and 0 at first), the moments and the [iters, 3] history.  For the
    plain steps ``build`` also makes, from the host, every table they read:
    each slot's row of the views (``rows``), the empty slots' mask
    (``keep``, None when there is none), each group's frame indices
    (``idx``), each frame's coverage (``cnt``, at least 1) and whether it is
    covered, and the step count; so a step reads only device tensors."""

    cfg: AlignerConfig
    views: torch.Tensor
    slots: np.ndarray
    sizes: List[int]
    widths: List[int]
    params: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    history: torch.Tensor
    rows: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None
    idx: Sequence[torch.Tensor] = ()
    cnt: Optional[torch.Tensor] = None
    covered: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None

    @classmethod
    def build(cls, cfg: AlignerConfig, views, table: np.ndarray, idx, counts: torch.Tensor,
              plain: bool) -> "Problem":
        """The problem of ``views`` (each group's [S_g, w_g, P]) and the
        frame table ``table`` [T, K] from ``frame_table``."""
        dev = views[0].device
        sizes, widths = [v.shape[0] for v in views], [v.shape[1] for v in views]
        n_all, w_max, bounds = sum(sizes), max(widths), np.concatenate([[0], np.cumsum(sizes)])
        padded = torch.zeros((n_all, w_max, views[0].shape[-1]), device=dev)
        for v, lo in zip(views, bounds[:-1]):
            padded[lo : lo + v.shape[0], : v.shape[1]] = v
        # each window row of the table (groups flattened row-major, in order) at its place in the padded views
        place = np.concatenate([((lo + np.arange(v.shape[0]))[:, None] * w_max + np.arange(v.shape[1])).reshape(-1)
                                for v, lo in zip(views, bounds[:-1])])
        slots = np.append(place, -1)[table]  # an empty slot (row R) is -1
        params = torch.zeros((2, n_all), device=dev)
        params[0] = 1.0
        p = cls(cfg, padded, slots, sizes, widths, params, torch.zeros_like(params), torch.zeros_like(params),
                torch.zeros((cfg.num_iterations, 3), device=dev))
        if plain:
            p.rows = torch.as_tensor(np.maximum(slots, 0), device=dev)
            if (slots < 0).any():
                p.keep = torch.as_tensor((slots >= 0)[..., None], dtype=torch.float32, device=dev)
            p.idx = idx
            p.cnt = counts.clamp(min=1.0)[:, None]
            p.covered = (counts > 0)[:, None]
            p.count = torch.zeros(1, dtype=torch.long, device=dev)
        return p

    @property
    def bounds(self) -> np.ndarray:
        """Each group's first window, and the window count at the end."""
        return np.concatenate([[0], np.cumsum(self.sizes)])

    @property
    def denom(self) -> float:
        """What the loss's sums are divided by: every window row's values."""
        return float(sum(self.widths) * self.slots.shape[0] * self.views.shape[-1])


def solve(p: Problem, kernel: bool) -> None:
    """``num_iterations`` Adam steps from s = 1, t = 0 into ``p``'s
    parameters, moments and history: one launch of the kernel, or the plain
    version's steps."""
    cfg = p.cfg
    with span("rd.solve.replay"):
        if kernel:
            coalign(p.views, p.slots, p.sizes, p.params, p.mu, p.nu, p.history, lr=cfg.lr, b1=ADAM_B1, b2=ADAM_B2,
                    eps=ADAM_EPS, lmda2=cfg.lmda2, lmda3=cfg.lmda3, loss_scale=cfg.loss_scale,
                    depth_loss_weight=cfg.depth_loss_weight, denom=p.denom)
            return
        for _ in range(cfg.num_iterations):
            plain_step(p)


@torch.enable_grad()  # callers may run under no_grad (the pipelines do)
def plain_step(p: Problem) -> None:
    """One Adam step of the plain version, on ``p``'s device tensors only."""
    cfg, bounds, widths, p_dim = p.cfg, p.bounds, p.widths, p.views.shape[-1]
    use_inv = cfg.depth_loss_weight != 0.0
    params = p.params.detach().requires_grad_()
    s_all, t_all = params[0], params[1]

    def frame_mean(a):
        g = a.reshape(-1, p_dim)[p.rows]
        return (g if p.keep is None else g * p.keep).sum(1) / p.cnt

    s_list = [s_all[bounds[i] : bounds[i + 1]] for i in range(len(widths))]
    t_list = [t_all[bounds[i] : bounds[i + 1]] for i in range(len(widths))]
    a_all = p.views * s_all[:, None, None] + t_all[:, None, None]
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
    for gi, (a, i) in enumerate(zip(a_list, p.idx)):
        shape = a.shape
        tgt = target[i].reshape(shape)
        sc = scale[i].reshape(shape[:2] + (1,)).clamp(min=1e-12)
        loss_m = loss_m + ((a - tgt) / sc).abs().sum()
        if use_inv:
            tgt_inv = target_inv[i].reshape(shape)
            sc_inv = scale_inv[i].reshape(shape[:2] + (1,)).clamp(min=1e-12)
            loss_inv = loss_inv + ((inv_list[gi] - tgt_inv) / sc_inv).abs().sum()
    loss = loss_m / p.denom + cfg.depth_loss_weight * (loss_inv / p.denom)
    soft = 0.0
    for s, t in zip(s_list, t_list):
        soft = soft + cfg.lmda2 * torch.relu(1.0 - s).pow(2).sum() / s.shape[0]
        soft = soft + cfg.lmda3 * t.pow(2).sum() / t.shape[0]
    total = cfg.loss_scale * loss + soft
    (grads,) = torch.autograd.grad(total, params)
    with torch.no_grad():
        row = torch.stack([total.detach(), torch.where(p.covered, target, torch.inf).amin(),
                           torch.where(p.covered, target, -torch.inf).amax()])
        p.history.index_copy_(0, p.count, row[None])  # at the device's step count
        adam_update_(p.params, grads, p.mu, p.nu, p.count, cfg.lr)


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
        with span("rd.solve", {"windows": sum(s.shape[0] for s in snippet_ls), "frames": seq_len}):
            with span("rd.solve.prepare"):
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

            scales, shifts, history = self._optimize(views, idx, table, counts)
            with span("rd.solve.merge"):
                merged = self._merge(snippet_ls, torch.as_tensor(table, device=dev), counts, scales, shifts, mn,
                                     restore_shift, seq_len)
            return merged, scales, shifts, history

    def _optimize(self, views, idx, table: np.ndarray, counts, kernel: bool = True):
        """The views go into one [n_windows, w_max, P] tensor (a shorter
        group's missing frames are zero rows that nothing reads), so each
        step applies (s, t) once.  Each target sums the table's [T, K] rows,
        with an empty slot's row masked to zero: in the kernel slot by slot
        from the left, in the plain step as one gather and one reduction
        over K (PyTorch's, with no atomic add: its order is fixed by the
        shape and the device).

        The call builds what its solve needs (``Problem``) and drops it when
        it returns.  On the card the whole solve is one launch of the kernel
        (``ops/coalign.py``), the counterpart of the JAX package's one
        jitted ``lax.scan``; ``kernel=False`` runs the plain version's steps
        instead (the card's tests and ``chip_smoke.py`` hold the two to the
        JAX tolerances).  On the CPU the plain steps always run."""
        cfg = self.config
        kernel = kernel and views[0].device.type == "cuda" and cfg.num_iterations > 0
        with span("rd.solve.load"):
            p = Problem.build(cfg, views, table, idx, counts, plain=not kernel)
        solve(p, kernel)
        (s_out, t_out), bounds = p.params, p.bounds
        return ([s_out[bounds[i] : bounds[i + 1]] for i in range(len(views))],
                [t_out[bounds[i] : bounds[i + 1]] for i in range(len(views))], p.history)

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
