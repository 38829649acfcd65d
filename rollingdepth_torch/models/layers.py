"""Building blocks of the SD model family, as ``nn.Module``s with diffusers names.

Counterpart of ``rollingdepth_tpu/models/layers.py``.  Modules run in
NCHW (on CUDA the models keep activations in ``channels_last`` memory
format, which cuDNN prefers); the models convert at their public NHWC
boundary.  Norms keep the JAX package's precision:
- ``group_norm``: ``ops/group_norm.py``, fp32 statistics; fp32 inputs
  normalise in fp32 (``F.group_norm``), bf16 inputs normalise in bf16 (as
  ``layers.group_norm`` does): on the card its hand-written pair, which
  also takes the silu after the norm (``silu=True``), as XLA fuses it;
- ``layer_norm``: computed in fp32, cast back.
Self-attention goes through ``ops.attention.dot_product_attention``.
``Attention`` and ``FeedForward`` also run as Megatron tp shards
(``parallel/sharding.py`` ``shard_unet_`` sets their ``tp_group``); with
no group they make no collective and no extra copy.  Their linears and the
resnets' convs may be the W8A8 ``QuantLinear``/``QuantConv2d`` of
``ops/quant.py`` (``quantize_unet_``); a quantized row-parallel shard sums
its own int32 partials.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import group_norm as gn
from ..ops.attention import dot_product_attention
from ..ops.quant import QuantLinear
from ..parallel.sharding import copy_to_tp, reduce_from_tp


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, eps: Optional[float] = None, silu: bool = False) -> torch.Tensor:
    """GroupNorm over an NCHW tensor with ``norm``'s groups, weight and bias,
    then ``F.silu`` when ``silu`` (``ops/group_norm.group_norm``)."""
    return gn.group_norm(x, norm.weight, norm.bias, norm.num_groups, norm.eps if eps is None else eps, silu=silu)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(),
                        norm.eps).to(x.dtype)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal embedding in fp32 (diffusers ``get_timestep_embedding``)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    emb = torch.exp(exponent / (half - downscale_freq_shift))
    emb = timesteps.float()[:, None] * emb[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class Attention(nn.Module):
    """diffusers ``Attention``: q/k/v projections, multi-head attention, out
    projection (``to_out.0``).  The caller owns the token layout.  As a tp
    shard (``tp_group`` set) it holds ``heads`` of the block's heads: q/k/v
    column-parallel, ``to_out.0`` row-parallel, its bias added after the
    all-reduce."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, cross_dim: Optional[int] = None,
                 qkv_bias: bool = False, norm_groups: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_dim if cross_dim is not None else query_dim
        self.heads = heads
        self.tp_group = None
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])
        if norm_groups is not None:
            self.group_norm = nn.GroupNorm(norm_groups, query_dim, eps=1e-6)

    def forward(self, hidden: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        tp = self.tp_group
        if tp is not None:
            hidden = copy_to_tp(hidden, tp)
            context = None if context is None else copy_to_tp(context, tp)
        ctx = hidden if context is None else context
        b, lq, _ = hidden.shape
        q = self.to_q(hidden)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        inner = q.shape[-1]
        d = inner // self.heads
        out = dot_product_attention(
            q.reshape(b, lq, self.heads, d),
            k.reshape(b, ctx.shape[1], self.heads, d),
            v.reshape(b, ctx.shape[1], self.heads, d),
        )
        out = out.reshape(b, lq, inner)
        proj = self.to_out[0]
        if tp is None or isinstance(proj, QuantLinear):  # a W8A8 shard makes its own sum
            return proj(out)
        return reduce_from_tp(F.linear(out, proj.weight), tp) + proj.bias


class ResnetBlock2D(nn.Module):
    """norm-silu-conv twice, with an additive time bias and a 1x1 shortcut
    when the channel count changes."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int], groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch is not None:
            self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(group_norm(self.norm1, x, silu=True))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None].to(h.dtype)
        h = self.conv2(group_norm(self.norm2, h, silu=True))
        skip = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return skip + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv.  The VAE encoder pads (0,1,0,1) by hand
    (``asymmetric_pad``); the UNet pads 1 on every side."""

    def __init__(self, ch: int, asymmetric_pad: bool):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest upsample (2x, or to ``output_size`` for odd skip shapes) + 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor, output_size: Optional[Sequence[int]] = None) -> torch.Tensor:
        if output_size is None:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        else:
            x = F.interpolate(x, size=tuple(output_size), mode="nearest")
        return self.conv(x)


class GEGLU(nn.Module):
    """diffusers' fused GEGLU projection: value and gate halves of one linear."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU projection, then the out linear (``net.2``).  As a tp shard
    (``tp_group`` set) the projection is column-parallel over both GEGLU
    halves and ``net.2`` row-parallel."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.tp_group = None
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp, out = self.tp_group, self.net[2]
        if tp is None:
            return out(self.net[0](x))
        if isinstance(out, QuantLinear):  # a W8A8 shard makes its own sum
            return out(self.net[0](copy_to_tp(x, tp)))
        return reduce_from_tp(F.linear(self.net[0](copy_to_tp(x, tp)), out.weight), tp) + out.bias


class BasicTransformerBlock(nn.Module):
    """self-attention -> cross-attention -> GEGLU feed-forward, pre-LN.
    Self-attention is cross-frame because the caller passes L = n*h*w."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, cross_dim=cross_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, dim * 4)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(layer_norm(self.norm1, x))
        x = x + self.attn2(layer_norm(self.norm2, x), context)
        return x + self.ff(layer_norm(self.norm3, x))


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, with the JAX package's init scales: linear and
    conv weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), norms at
    identity, embeddings N(0, 0.02^2).  Draws on each parameter's device."""

    def uniform_(t: torch.Tensor, bound: float) -> None:
        r = torch.rand(t.shape, generator=generator, device=t.device, dtype=torch.float32)
        t.copy_((r * 2 - 1) * bound)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, nn.Embedding):
            r = torch.randn(m.weight.shape, generator=generator, device=m.weight.device)
            m.weight.copy_(r * 0.02)
    return module
