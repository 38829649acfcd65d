"""Megatron tensor parallelism of the UNet, and the block split over dp.

Counterpart of ``rollingdepth_tpu/parallel/sharding.py``.  The JAX package
annotates parameters with ``PartitionSpec``s and lets GSPMD place the
collectives; the port slices each rank's shard in place and makes the
collectives itself, with the two operators of Megatron-LM:
- ``copy_to_tp`` (f): identity forward, all-reduce over tp backward, on the
  input of every column-parallel group (q/k/v, the GEGLU projection);
- ``reduce_from_tp`` (g): all-reduce over tp forward, identity backward, on
  the output of every row-parallel linear (``to_out``, the feed-forward's
  out projection), before its bias, which is then added once.
``torch.distributed.nn.functional.all_reduce`` would not do for g: its
backward all-reduces the gradient, which is already the same on every tp
rank, and so multiplies it by tp.

Column-parallel layers split their output features (``weight`` [out, in]
on dim 0, and the bias), row-parallel ones their input features (dim 1;
the bias stays whole).  Convolutions, norms, ``proj_in``/``proj_out`` and
the time embedding stay replicated: GroupNorm between convs needs full
channels.  The port keeps diffusers' fused GEGLU projection
``ff.net.0.proj`` [2 * inner, dim], which the JAX package holds as two
column-parallel halves (``proj_h``, ``proj_gate``): rank r takes rows
r * inner / tp ... (r + 1) * inner / tp of BOTH halves, so ``GEGLU``'s
``chunk(2)`` still pairs each value with its gate.

W8A8 layers (``ops/quant.py``) split the same way, as the JAX package
splits ``kernel_q``/``w_scale``: a column-parallel ``weight_q``, its
``w_scale`` and bias on the output features; a row-parallel ``weight_q``
on the input features with ``w_scale`` and the bias whole, and that
``QuantLinear`` gets the tp group, over which it takes its activation's
abs-max and sums its int32 partials.

Where tp does not divide a block's heads, that block's q/k/v/out stay
replicated (its feed-forward is still split): with SD2's heads (5, 10, 20,
20) that is level 0 at tp = 2 and levels 0-1 at tp = 4.  GSPMD splits those
columns across heads and reshards instead; the numbers are the same, only
the memory differs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops.quant import QuantLinear
from .mesh import axis

# "proj_h"/"proj_gate" are the GEGLU value/gate halves; the ff "out" linear
# is the matching row-parallel projection (the JAX package's lists)
COLUMN_PARALLEL = (
    "to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "fc1",
    "proj_h", "proj_gate",
)
ROW_PARALLEL = ("to_out", "out_proj", "fc2", "out")

_GEGLU = ("ff", "net", "0", "proj")


# ---------------------------------------------------------------------------
# the Megatron operators
# ---------------------------------------------------------------------------


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """f: the input of a column-parallel group; its gradient is summed over tp."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """g: sums a row-parallel linear's partial output over tp, in place
    (``x`` must be a contiguous tensor the caller owns)."""
    return _ReduceFromTP.apply(x, group)


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------


def _role(name: str) -> Tuple[Optional[str], str, int]:
    """(the JAX parent name of a diffusers parameter, its leaf, how many
    trailing segments of its name lead up to its Attention or FeedForward)."""
    parts = name.split(".")
    leaf, path = parts[-1], parts[:-1]
    if tuple(path[-4:]) == _GEGLU:
        return "proj_h", leaf, 4  # owner: ...ff
    if path[-3:] == ["ff", "net", "2"]:
        return "out", leaf, 3
    if path[-2:] == ["to_out", "0"]:
        return "to_out", leaf, 3
    return (path[-1] if path else None), leaf, 2


def _shardable(owner: nn.Module, tp: int) -> bool:
    from ..models.layers import Attention, FeedForward

    if getattr(owner, "tp_group", None) is not None:
        return True  # already sharded
    if isinstance(owner, Attention):
        return owner.heads % tp == 0
    if isinstance(owner, FeedForward):
        return (owner.net[0].proj.out_features // 2) % tp == 0
    return False


def param_split_dims(unet: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """``unet_param_sharding`` for a tp size."""
    out: Dict[str, Optional[int]] = {}
    for name, _ in unet.named_parameters():
        parent, leaf, up = _role(name)
        dim = None
        if tp > 1 and parent in COLUMN_PARALLEL + ROW_PARALLEL:
            owner = unet.get_submodule(".".join(name.split(".")[:-up]))
            if _shardable(owner, tp):
                if parent in COLUMN_PARALLEL:
                    dim = 0  # weight(_q) [out, in], w_scale and bias: the output features
                elif leaf in ("weight", "weight_q"):
                    dim = 1  # row-parallel: the input features; w_scale and the bias stay whole
        out[name] = dim
    return out


def unet_param_sharding(unet: nn.Module, mesh) -> Dict[str, Optional[int]]:
    """For each diffusers parameter name of ``unet``, the dimension its tp
    shard splits (None: replicated).  Works on a UNet before or after
    ``shard_unet_``."""
    return param_split_dims(unet, axis(mesh, "tp")[0])


def is_geglu(name: str) -> bool:
    return tuple(name.split(".")[-5:-1]) == _GEGLU


def shard_tensor(name: str, full: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s shard of parameter ``name`` (or of its optimizer
    moments), split on ``dim``; the GEGLU projection by halves."""
    if is_geglu(name):
        return torch.cat([h.chunk(tp, dim)[rank] for h in full.chunk(2, dim)], dim).contiguous()
    return full.chunk(tp, dim)[rank].contiguous()


def unshard_tensor(name: str, local: torch.Tensor, dim: int, group, tp: int) -> torch.Tensor:
    """The whole parameter from every tp rank's ``local`` shard (a collective
    over ``group``)."""
    parts = [torch.empty_like(local) for _ in range(tp)]
    dist.all_gather(parts, local.contiguous(), group=group)
    if is_geglu(name):
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim)
    return torch.cat(parts, dim)


@torch.no_grad()
def shard_unet_(unet: nn.Module, mesh) -> nn.Module:
    """Slice every rank's full UNet weights to its tp shard, in place (the
    counterpart of ``shard_params``): column- and row-parallel weights per
    ``unet_param_sharding``, ``Attention.heads`` set to the local head count
    and each sharded ``Attention`` and ``FeedForward`` given the tp group.
    Blocks whose heads tp does not divide keep their attention whole.  A
    no-op at tp = 1."""
    from ..models.layers import Attention, FeedForward

    tp, rank, group = axis(mesh, "tp")
    if tp == 1:
        return unet
    split = param_split_dims(unet, tp)
    for name, p in unet.named_parameters():
        if split[name] is not None:
            p.data = shard_tensor(name, p.data, split[name], rank, tp)
    def is_split(weight: str) -> bool:  # a float or a W8A8 weight
        return split.get(weight) is not None or split.get(weight + "_q") is not None

    for name, m in unet.named_modules():
        if isinstance(m, Attention) and is_split(f"{name}.to_q.weight"):
            m.heads //= tp
            m.tp_group = group
        elif isinstance(m, FeedForward) and is_split(f"{name}.net.0.proj.weight"):
            m.tp_group = group
    for name, m in unet.named_modules():
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape
        elif isinstance(m, QuantLinear):
            m.out_features, m.in_features = m.weight_q.shape
            if split.get(f"{name}.weight_q") == 1:  # a row-parallel W8A8 shard
                m.tp_group = group
    return unet


# ---------------------------------------------------------------------------
# rows over dp
# ---------------------------------------------------------------------------


def row_block(n: int, mesh) -> Tuple[int, int]:
    """[start, stop) of this dp rank's block of ``n`` rows: blocks of
    ceil(n / dp), the last ones short or empty."""
    dp, r, _ = axis(mesh, "dp")
    per = -(-n // dp)
    return min(r * per, n), min((r + 1) * per, n)


def shard_rows(x, mesh, pad: bool = False):
    """This dp rank's block of ``x``'s leading axis (a tensor or an array),
    the counterpart of ``data_sharding``.  ``pad``: blocks of ceil(n / dp)
    for every rank, the rows past n repeating the last row, so that
    ``gather_rows`` can all-gather equal blocks.  Without ``pad`` a rank's
    block may be short or empty."""
    dp, r, _ = axis(mesh, "dp")
    n = x.shape[0]
    if dp == 1:
        return x
    if not pad:
        start, stop = row_block(n, mesh)
        return x[start:stop]
    per = -(-n // dp)
    rows = [min(i, n - 1) for i in range(r * per, (r + 1) * per)]
    return x[rows]


def gather_rows(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """Every dp rank's padded block (``shard_rows(..., pad=True)``), in rank
    order, the padding dropped: the first ``n`` rows."""
    dp, _, group = axis(mesh, "dp")
    if dp == 1:
        return x[:n]
    parts = [torch.empty_like(x) for _ in range(dp)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)[:n]
