"""bf16 GroupNorm (+ silu): a hand-written CUDA pair and its plain version.

| wrapper        | CUDA (csrc/group_norm.cu)                      | replaces (no Pallas kernel: XLA fusions)       |
| -------------- | ---------------------------------------------- | ---------------------------------------------- |
| ``group_norm`` | ``rd_group_norm``: ``gn_stats`` (one read of x, | ``rollingdepth_tpu/models/layers.py:126``       |
|                | per-chunk partials), ``gn_merge`` (fixed-order | ``group_norm``'s bf16 branch and the ``silu``   |
|                | merge), ``gn_apply`` (one fused pass)          | after it: reduction fusions, one loop fusion   |

The JAX package has no Pallas kernel here: XLA runs the norm's bf16 branch,
with the ``silu`` that follows it in every ResNet block, as a few reduction
fusions and one loop fusion that reads x once, writes bf16 once and rounds
to bf16 after every op.  The pair does the same on the card: fp32
statistics in one read of x with a fixed-order merge (no atomics: every run
gives the same bits), then one pass that rounds where XLA and PyTorch's
bf16 ops round (``group_norm_reference``), so only the bf16 roundings of
the mean and of ``inv`` can differ from the plain version, where the fp32
statistics differ in their last bits.

``group_norm(x, weight, bias, groups, eps, silu=False)`` takes x
``[N, C, H, W]``.  An fp32 x, on any device, and any CPU tensor take
``group_norm_reference`` (fp32: ``F.group_norm``, one native kernel; this
is where the dtype is chosen).  Any other CUDA tensor launches the pair
(building it at first use, ``ops/_build.py``) or raises: x must be bf16 in
``channels_last`` memory (how the models keep activations on the card;
nothing is copied), C a multiple of 8 up to 4096, and no autograd may be
recording (the pair has no backward; training runs fp32).  There is no
fallback.  The wrapper counts its launches in ``group_norm.launches`` and,
by input, in ``group_norm.inputs`` (``(N, C, H, W, groups, eps, silu)``:
launches), so a caller can hold the pair at every input a run gave it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

VEC = 8  # bf16 channels in a 16-byte vector: a thread's share of a pixel's channel row
THREADS = 256  # the kernels' block: max(1, THREADS // (C / VEC)) rows of C / VEC threads
MAX_C = 4096
STATS_BLOCKS = 132 * 8  # the statistics kernel aims at 8 blocks on each of the H100's SMs

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                         silu: bool = False) -> torch.Tensor:
    """The JAX package's ``layers.group_norm`` in PyTorch, op by op, then
    ``F.silu`` when ``silu``.  fp32: ``F.group_norm``.  Other dtypes: fp32
    mean and variance (correction 0) over each group, ``inv = rsqrt(var +
    eps)``, then ``apply_reference``."""
    if x.dtype == torch.float32:
        out = F.group_norm(x, groups, weight, bias, eps)
        return F.silu(out) if silu else out
    n, c, h, w = x.shape
    xg = x.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)  # a view in channels_last
    var, mean = torch.var_mean(xg.float(), dim=(1, 3), correction=0)
    return apply_reference(x, mean, torch.rsqrt(var + eps), weight, bias, silu)


def apply_reference(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, silu: bool = False) -> torch.Tensor:
    """The plain version's pass over x ``[N, C, H, W]`` with fp32 statistics
    ``mean``, ``inv`` ``[N, G]``: in x's dtype, rounding after each op,
    ``(x - mean) * inv``, times the weight, plus the bias (statistics,
    weight and bias cast to x's dtype), then ``F.silu`` when ``silu``."""
    n, c, h, w = x.shape
    groups = mean.shape[1]
    xg = x.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)
    m, i = mean.to(x.dtype)[:, None, :, None], inv.to(x.dtype)[:, None, :, None]
    out = ((xg - m) * i).reshape(n, h, w, c).permute(0, 3, 1, 2)
    out = out * weight.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]
    return F.silu(out) if silu else out


def block_rows(c: int) -> int:
    """Pixel rows of the kernels' block for C channels (C / VEC threads a row)."""
    vecs = c // VEC
    return THREADS // vecs if vecs < THREADS else 1


def stats_plan(n: int, hw: int, c: int) -> tuple:
    """(pixels a chunk, chunks an image) of the statistics kernel: about
    STATS_BLOCKS blocks over the call, a chunk a multiple of the block's rows."""
    rows = block_rows(c)
    chunks = max(1, min(-(-STATS_BLOCKS // n), -(-hw // rows)))
    per_chunk = -(-(-(-hw // chunks)) // rows) * rows
    return per_chunk, -(-hw // per_chunk)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    if x.ndim != 4 or weight is None or bias is None or weight.shape != (x.shape[1],) or bias.shape != weight.shape:
        raise ValueError(f"group_norm: needs x [N, C, H, W] and weight, bias [C], got x{tuple(x.shape)}")
    if groups < 1 or x.shape[1] % groups:
        raise ValueError(f"group_norm: {x.shape[1]} channels do not split into {groups} groups")
    if not (x.device == weight.device == bias.device):
        raise ValueError("group_norm: x, weight and bias on different devices")


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, silu: bool):
    """The pair on the card: (y, mean, inv), mean and inv fp32 [N, G].
    Raises, before touching the library, on what the kernels do not take."""
    n, c, h, w = x.shape
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"group_norm: the CUDA kernels read x in channels_last memory, got strides {x.stride()}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        raise RuntimeError("group_norm: the CUDA kernels have no backward; call under torch.no_grad() "
                           "(training runs fp32, on F.group_norm)")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"group_norm: the CUDA kernels take bf16 (fp32 runs F.group_norm), got {x.dtype}")
    if c % VEC or c > MAX_C or n > 65535:
        raise ValueError(f"group_norm: needs C a multiple of {VEC} up to {MAX_C} and N <= 65535, got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: the kernels run on CUDA tensors (CPU tensors take the plain version), "
                         f"got {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("group_norm: x must be 16-byte aligned")
    from ._build import load

    fn = load("group_norm").rd_group_norm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    per_chunk, chunks = stats_plan(n, h * w, c)
    work = torch.empty((n * chunks * groups * 2 + 2 * n * groups,), dtype=torch.float32, device=x.device)
    mean, inv = work[: 2 * n * groups].view(2, n, groups)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    wb, bb = weight.to(torch.bfloat16).contiguous(), bias.to(torch.bfloat16).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), wb.data_ptr(), bb.data_ptr(), y.data_ptr(),
                 work[2 * n * groups :].data_ptr(), mean.data_ptr(), inv.data_ptr(), n, h * w, c, groups, eps,
                 int(silu), per_chunk, chunks, stream)
    if err != 0:
        why = {-1: "unsupported shape"}.get(err, f"CUDA error {err}")
        raise RuntimeError(f"group_norm failed: {why} at x{tuple(x.shape)} groups={groups}")
    return y, mean, inv


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm of x ``[N, C, H, W]`` (then silu when ``silu``): the plain
    version on a CPU tensor and on fp32, the CUDA pair on other CUDA tensors."""
    _check(x, weight, bias, groups)
    if x.device.type == "cpu" or x.dtype == torch.float32:
        return group_norm_reference(x, weight, bias, groups, eps, silu)
    y, _, _ = _launch(x, weight, bias, groups, eps, silu)
    group_norm.launches += 1
    key = (*x.shape, groups, eps, silu)
    group_norm.inputs[key] = group_norm.inputs.get(key, 0) + 1
    return y


group_norm.launches = 0
group_norm.inputs = {}

KERNELS = (group_norm,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.inputs = {}
