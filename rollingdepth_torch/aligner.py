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
package runs it as one jitted ``lax.scan``; its static tensors are cached
per shape (``_SOLVES``), as JAX caches its scans.  On the CPU the plain
version runs: the same step op by op with autograd (``_Solve.step``), optax's
``adam`` written out in tensor ops (``adam_update_``), reading only device
tensors built before the solve, the step count and the loss history included.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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

# The kernel's solves' static tensors, shared by every DepthAligner as the
# JAX package's _SOLVE_CACHE shares its jitted scans (each caller builds a
# new aligner): solve_key -> _Solve.  Unbounded, as JAX's is.
_SOLVES: Dict[tuple, "_Solve"] = {}


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


def solve_key(view_shapes, table_shape, masked: bool, cfg: AlignerConfig, device) -> tuple:
    """What a solve's static tensors are specific to: the views' shapes, the
    frame table's shape and whether it has empty slots, the inverse term,
    the config (the iterations included) and the device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return (tuple(tuple(s) for s in view_shapes), tuple(table_shape), masked, cfg.depth_loss_weight != 0.0, cfg,
            device)


class _Solve:
    """One solve's static tensors, for one ``solve_key``: the padded views,
    the parameters (every window's s, then its t), the moments and the
    history, which the kernel writes; and the eager step's tables and step
    count.  ``load`` writes a call's views (and, for the eager step, its
    tables); ``run`` solves from s = 1, t = 0; ``step`` runs one Adam step
    of the plain version and reads only these tensors (no host sync, no
    tensor made from the host)."""

    def __init__(self, key: tuple):
        view_shapes, (n_frames, k), masked, self.use_inv, self.cfg, self.device = key
        self.sizes = [s[0] for s in view_shapes]
        self.widths = [s[1] for s in view_shapes]
        self.p_dim = view_shapes[0][-1]
        self.bounds = np.concatenate([[0], np.cumsum(self.sizes)])
        self.denom = float(sum(self.widths) * n_frames * self.p_dim)
        dev, n_all = self.device, sum(self.sizes)
        self.v_all = torch.zeros((n_all, max(self.widths), self.p_dim), device=dev)
        self.slots = np.zeros((n_frames, k), np.int64)  # each (frame, slot)'s row of v_all, -1 empty
        self.rows = torch.zeros((n_frames, k), dtype=torch.long, device=dev)
        self.keep = torch.ones((n_frames, k, 1), device=dev) if masked else None
        self.idx = [torch.zeros(s * w, dtype=torch.long, device=dev) for s, w in zip(self.sizes, self.widths)]
        self.cnt = torch.ones((n_frames, 1), device=dev)
        self.covered = torch.ones((n_frames, 1), dtype=torch.bool, device=dev)
        self.params = torch.zeros((2, n_all), device=dev)  # every window's s, then its t
        self.mu, self.nu = torch.zeros_like(self.params), torch.zeros_like(self.params)
        self.count = torch.zeros(1, dtype=torch.long, device=dev)
        self.history = torch.zeros((self.cfg.num_iterations, 3), device=dev)

    def load(self, views, slots: np.ndarray, idx, counts: torch.Tensor, kernel: bool) -> None:
        self.v_all.zero_()
        for v, lo in zip(views, self.bounds[:-1]):
            self.v_all[lo : lo + v.shape[0], : v.shape[1]] = v
        self.slots = slots
        if kernel:  # the kernel reads the views and the host's table only
            return
        self.rows.copy_(torch.from_numpy(np.maximum(slots, 0)))
        if self.keep is not None:
            self.keep.copy_(torch.from_numpy(slots >= 0)[..., None])
        for dst, src in zip(self.idx, idx):
            dst.copy_(src)
        self.cnt.copy_(counts.clamp(min=1.0)[:, None])
        self.covered.copy_((counts > 0)[:, None])

    def reset(self) -> None:
        """s = 1, t = 0, the moments, the step count and the history 0."""
        self.params[0] = 1.0
        self.params[1] = 0.0
        for x in (self.mu, self.nu, self.count, self.history):
            x.zero_()

    def run(self, kernel: bool) -> None:
        """``num_iterations`` steps from the reset state: one launch of the
        kernel, or the eager steps."""
        cfg = self.cfg
        with span("rd.solve.replay"):
            if kernel:
                coalign(self.v_all, self.slots, self.sizes, self.params, self.mu, self.nu, self.history, lr=cfg.lr,
                        b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS, lmda2=cfg.lmda2, lmda3=cfg.lmda3,
                        loss_scale=cfg.loss_scale, depth_loss_weight=cfg.depth_loss_weight, denom=self.denom)
                return
            self.reset()
            for _ in range(cfg.num_iterations):
                self.step()

    @torch.enable_grad()  # callers may run under no_grad (the pipelines do)
    def step(self) -> None:
        """One Adam step of the solve on the static tensors."""
        cfg, bounds, widths, p_dim, use_inv = self.cfg, self.bounds, self.widths, self.p_dim, self.use_inv
        params = self.params.detach().requires_grad_()
        s_all, t_all = params[0], params[1]

        def frame_mean(a):
            g = a.reshape(-1, p_dim)[self.rows]
            return (g if self.keep is None else g * self.keep).sum(1) / self.cnt

        s_list = [s_all[bounds[i] : bounds[i + 1]] for i in range(len(widths))]
        t_list = [t_all[bounds[i] : bounds[i + 1]] for i in range(len(widths))]
        a_all = self.v_all * s_all[:, None, None] + t_all[:, None, None]
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
        for gi, (a, i) in enumerate(zip(a_list, self.idx)):
            shape = a.shape
            tgt = target[i].reshape(shape)
            sc = scale[i].reshape(shape[:2] + (1,)).clamp(min=1e-12)
            loss_m = loss_m + ((a - tgt) / sc).abs().sum()
            if use_inv:
                tgt_inv = target_inv[i].reshape(shape)
                sc_inv = scale_inv[i].reshape(shape[:2] + (1,)).clamp(min=1e-12)
                loss_inv = loss_inv + ((inv_list[gi] - tgt_inv) / sc_inv).abs().sum()
        loss = loss_m / self.denom + cfg.depth_loss_weight * (loss_inv / self.denom)
        soft = 0.0
        for s, t in zip(s_list, t_list):
            soft = soft + cfg.lmda2 * torch.relu(1.0 - s).pow(2).sum() / s.shape[0]
            soft = soft + cfg.lmda3 * t.pow(2).sum() / t.shape[0]
        total = cfg.loss_scale * loss + soft
        (grads,) = torch.autograd.grad(total, params)
        with torch.no_grad():
            row = torch.stack([total.detach(), torch.where(self.covered, target, torch.inf).amin(),
                               torch.where(self.covered, target, -torch.inf).amax()])
            self.history.index_copy_(0, self.count, row[None])  # at the device's step count
            adam_update_(self.params, grads, self.mu, self.nu, self.count, cfg.lr)


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
        from the left, in the eager step as one gather and one reduction
        over K (PyTorch's, with no atomic add: its order is fixed by the
        shape and the device).

        Everything that reads the host (the row table, its mask, the frame
        indices) is built here.  On the card the whole solve is one launch
        of the kernel (``ops/coalign.py``), the counterpart of the JAX
        package's one jitted ``lax.scan``, on static tensors cached per
        ``solve_key``; ``kernel=False`` runs the plain version's steps
        eagerly instead (the card's tests and ``chip_smoke.py`` hold the two
        to the JAX tolerances).  On the CPU the steps always run eagerly."""
        cfg = self.config
        dev = views[0].device
        sizes = [v.shape[0] for v in views]
        w_max = max(v.shape[1] for v in views)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        # each window row of the table (groups flattened row-major, in order) at its place in v_all
        place = np.concatenate([((lo + np.arange(v.shape[0]))[:, None] * w_max + np.arange(v.shape[1])).reshape(-1)
                                for v, lo in zip(views, bounds[:-1])])
        slots = np.append(place, -1)[table]  # an empty slot (row R) is -1
        key = solve_key([tuple(v.shape) for v in views], table.shape, bool((slots < 0).any()), cfg, dev)
        kernel = kernel and dev.type == "cuda" and cfg.num_iterations > 0
        solve = _SOLVES.get(key) if kernel else None
        if solve is None:
            solve = _Solve(key)
            if kernel:
                _SOLVES[key] = solve
        with span("rd.solve.load"):
            solve.load(views, slots, idx, counts, kernel)
        solve.run(kernel)
        # copies: a later solve of the same key overwrites the static tensors
        s_out, t_out = solve.params.clone()
        return ([s_out[bounds[i] : bounds[i + 1]] for i in range(len(views))],
                [t_out[bounds[i] : bounds[i + 1]] for i in range(len(views))], solve.history.clone())

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
