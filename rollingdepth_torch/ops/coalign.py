"""The co-alignment solve as one hand-written persistent CUDA kernel.

| wrapper | CUDA (csrc/coalign.cu)                          | replaces (no Pallas kernel: a jitted scan)        |
| ------- | ----------------------------------------------- | ------------------------------------------------- |
| ``coalign`` | ``rd_coalign_solve``: ``coalign_solve``, every | ``rollingdepth_tpu/aligner.py``                   |
|         | Adam step of the solve in one cooperative launch | ``DepthAligner._optimize``'s ``lax.scan``         |

The JAX package runs the whole solve as one ``lax.scan`` that XLA compiles
whole.  The kernel does the same on the card: one launch runs every step,
each block keeping its frames' window rows in shared memory and the windows
it needs in its own copy of the Adam state, with one grid barrier a step
(``csrc/coalign.cu`` says how).  Its plain version is
``aligner.plain_step``, the same step op by op with autograd, which the CPU
runs.

``coalign(views, place, sizes, params, mu, nu, history, ...)`` takes the
padded views ``[n_windows, w_max, P]`` fp32 and the frame table ``place``
``[T, K]`` (each (frame, slot)'s row of the views, flattened, -1 for an
empty slot) and writes the solved ``params`` (s, then t), the moments and
the ``[iters, 3]`` history.  It takes CUDA tensors only, launches the kernel
(building it at first use, ``ops/_build.py``) or raises: there is no
fallback.  ``launch_plan`` chooses the partition from the shapes and the
card alone, and ``tables`` builds the kernel's index tables on the host.
The wrapper counts its launches in ``coalign.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

# the kernel's constants (csrc/coalign.cu)
THREADS = 512
WARPS = THREADS // 32
RED = 64  # floats a warp in the reduction scratch
STATS = 8  # floats a block in the per-step statistics
SMEM_MAX = 232448  # shared memory a block may opt into on the H100 (227 KB)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float] * 11 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's partition: ``blocks`` blocks of ``frames_per_block``
    whole frames each (the last one may hold fewer), and whether each block
    keeps its frames' rows in shared memory (``resident``) or reads them from
    global memory at each pass."""

    blocks: int
    frames_per_block: int
    resident: bool


def smem_bytes(frames_per_block: int, k: int, p: int, resident: bool) -> int:
    """A block's shared memory (csrc/coalign.cu ``smem_bytes``): 13 floats a
    (frame, slot) (a window's state, its slots and loss parts), 3 a frame,
    the reduction scratch, and the rows themselves when resident."""
    slots = frames_per_block * k
    floats = 13 * slots + 3 * frames_per_block + WARPS * 4 + WARPS * RED + RED + (slots * p if resident else 0)
    return 4 * floats


def launch_plan(n_frames: int, k: int, p: int, n_sm: int, smem_max: int = SMEM_MAX) -> Plan:
    """The partition for T = ``n_frames`` frames of K slots of P values on a
    card of ``n_sm`` SMs: one block a SM at most (the kernel's occupancy:
    its 512 threads hold up to 128 registers each), as few frames a block as
    that allows, the blocks as few as those frames need; the rows resident
    when a block's share of them fits beside its fixed shared memory."""
    if min(n_frames, k, p, n_sm) < 1:
        raise ValueError(f"coalign: no solve for T={n_frames}, K={k}, P={p} on {n_sm} SMs")
    fpb = -(-n_frames // n_sm)
    blocks = -(-n_frames // fpb)
    resident = smem_bytes(fpb, k, p, True) <= smem_max
    if smem_bytes(fpb, k, p, False) > smem_max:
        raise ValueError(f"coalign: {fpb} frames a block of {k} slots need {smem_bytes(fpb, k, p, False)} bytes "
                         f"of shared memory, more than {smem_max}")
    return Plan(blocks, fpb, resident)


def tables(place: np.ndarray, w_max: int, sizes: Sequence[int], plan: Plan) -> np.ndarray:
    """The kernel's int32 index tables, one array: for each (frame, slot) its
    row of the views (``place``, -1 empty) and its window's index in the list
    of the frame's block; for each window the (frame * K + slot) of its rows
    in order (-1 past its width) and its group's size; for each block its
    windows, ascending (-1 past their count), and their count.  A window is
    ``row // w_max``; ``sizes`` are the groups' window counts, in order."""
    place = np.asarray(place, np.int64)
    n_frames, k = place.shape
    n_all, fpb, width = int(sum(sizes)), plan.frames_per_block, plan.frames_per_block * place.shape[1]
    valid = place >= 0
    win = np.where(valid, place // w_max, -1)
    f, s = np.nonzero(valid)
    win_rows = np.full((n_all, w_max), -1, np.int64)
    win_rows[win[f, s], place[f, s] % w_max] = f * k + s
    if (win_rows[:, 0] < 0).any():
        raise ValueError("coalign: a window covers no frame of the table")
    local = np.full((n_frames, k), -1, np.int64)
    blk_win = np.full((plan.blocks, width), -1, np.int64)
    blk_nwin = np.zeros(plan.blocks, np.int64)
    for b in range(plan.blocks):
        rows = slice(b * fpb, min(n_frames, (b + 1) * fpb))
        mine = np.unique(win[rows][valid[rows]])
        blk_win[b, : mine.size] = mine
        blk_nwin[b] = mine.size
        local[rows] = np.where(valid[rows], np.searchsorted(mine, win[rows]), -1)
    size = np.repeat(np.asarray(sizes, np.int64), sizes)
    return np.concatenate([np.where(valid, place, -1).ravel(), local.ravel(), win_rows.ravel(), size,
                           blk_win.ravel(), blk_nwin]).astype(np.int32)


def _check(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"coalign: {name} must be fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"coalign: {name} must be contiguous, got strides {x.stride()}")
    if x.device.type != "cuda":
        raise ValueError(f"coalign: the kernel runs on CUDA tensors (the CPU runs the eager step), "
                         f"got {name} on {x.device}")
    if tuple(x.shape) != shape or x.device != device:
        raise ValueError(f"coalign: {name} must be {list(shape)} on {device}, got {list(x.shape)} on {x.device}")


def coalign(views: torch.Tensor, place: np.ndarray, sizes: Sequence[int], params: torch.Tensor, mu: torch.Tensor,
            nu: torch.Tensor, history: torch.Tensor, *, lr: float, b1: float, b2: float, eps: float, lmda2: float,
            lmda3: float, loss_scale: float, depth_loss_weight: float, denom: float) -> None:
    """``history.shape[0]`` Adam steps of the solve from s = 1, t = 0 on the
    card, in one launch: writes ``params``, ``mu``, ``nu`` ([2, n_windows])
    and ``history`` ([iters, 3]).  ``views`` [n_windows, w_max, P] fp32, the
    groups' windows in order (``sizes``); ``place`` [T, K] from
    ``aligner.frame_table``, each slot's row of the flattened views (-1 empty)."""
    if views.ndim != 3:
        raise ValueError(f"coalign: views must be [windows, w_max, P], got {list(views.shape)}")
    n_all, w_max, p = views.shape
    _check("views", views, (n_all, w_max, p), views.device)
    for name, x in (("params", params), ("mu", mu), ("nu", nu)):
        _check(name, x, (2, n_all), views.device)
    iters = history.shape[0] if history.ndim == 2 else 0
    _check("history", history, (iters, 3), views.device)
    place = np.asarray(place)
    if place.ndim != 2 or iters < 1 or sum(sizes) != n_all:
        raise ValueError(f"coalign: needs a [T, K] table, a step and {n_all} windows in the groups, got "
                         f"table {place.shape}, {iters} steps, groups {list(sizes)}")
    n_frames, k = place.shape
    plan = launch_plan(n_frames, k, p, torch.cuda.get_device_properties(views.device).multi_processor_count)
    meta = torch.from_numpy(tables(place, w_max, sizes, plan)).to(views.device)
    part = torch.empty(2 * n_frames * k * 2, dtype=torch.float32, device=views.device)
    stats = torch.empty(2 * plan.blocks * STATS + 1, dtype=torch.float32, device=views.device)
    from ._build import load

    fn = load("coalign").rd_coalign_solve
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(views.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(views.data_ptr(), meta.data_ptr(), params.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                 history.data_ptr(), part.data_ptr(), stats.data_ptr(), stats[-1:].data_ptr(), n_frames, k, p, n_all,
                 w_max, plan.blocks, plan.frames_per_block, int(plan.resident), iters, int(depth_loss_weight != 0.0),
                 lr, b1, b2, 1.0 - b1, 1.0 - b2, eps, lmda2, lmda3, loss_scale, depth_loss_weight, denom, stream)
    if err != 0:
        why = {-1: "unsupported shape", -2: "the grid does not fit on the card at once"}.get(err, f"CUDA error {err}")
        raise RuntimeError(f"coalign failed: {why} at views {list(views.shape)}, table {list(place.shape)}, "
                           f"plan {plan}")
    coalign.launches += 1


coalign.launches = 0
