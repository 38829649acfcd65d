"""W8A8 dynamic quantization of the UNet, the opt-in serving mode.

Counterpart of ``rollingdepth_tpu/ops/quant.py`` and of the W8A8 branch of
its ``layers.linear``/``layers.conv2d``.  The scheme, kept bit for bit:
- weights: per-OUTPUT-channel symmetric int8 (``quantize_weight``), once,
  at load (``quantize_unet_``);
- activations: per-TENSOR symmetric int8 with a dynamic abs-max scale
  (``quantize_activation``): ``round`` half to even, clipped to +-127;
- the product accumulates in int32, then ``acc.float() * (sx * w_scale)``
  in that order, cast back to the activation's dtype, then the bias.

The JAX package leaves the int8 products to XLA (``dot_general`` and
``conv_general_dilated`` with ``preferred_element_type=int32``); no Pallas
kernel is involved.  Here the GEMM is ``torch._int_mm`` (cuBLASLt's int8
GEMM on the card), and since PyTorch has no int8 convolution on CUDA, a
convolution is im2col (its taps side by side, in int8) followed by one
``_int_mm``.  int32 sums are exact, so neither route changes the result.
``_int_mm`` on the card wants more than 16 rows and K and N multiples of
8: ``int8_matmul`` pads with zeros, which is exact.

What is quantized is JAX's list: resnet ``conv1``/``conv2``/
``conv_shortcut``, the down- and upsampler convs, the transformers'
``proj_in``/``proj_out`` (linear for SD2, 1x1 conv for SD1.5), ``to_q``/
``to_k``/``to_v``/``to_out.0`` of both attentions and the feed-forward's
two linears.  ``conv_in``, ``conv_out``, the time embedding, every
resnet's ``time_emb_proj`` and the norms keep their float weights, and
attention itself stays in the activation dtype.

Under tp (``parallel/sharding.py``) a row-parallel layer holds a slice of
the input features: its abs-max is all-reduced (MAX) over the tp group,
as GSPMD takes it over the whole tensor, and its int32 accumulators are
summed over the group before the dequantisation, as XLA sums the int32
``dot_general`` partials; the result equals the unsharded layer's.  dp
needs nothing: the JAX pipelines run each dp shard's windows under
``shard_map`` (manual over dp), so the scale is per shard there too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# symmetric int8 range; 127 (not 128) keeps the grid symmetric, so -x
# quantizes to -q(x)
_QMAX = 127.0
# bytes of int8 im2col a convolution builds at once
IM2COL_BYTES = 1 << 28


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (dim 0) symmetric int8: (q, fp32 scale [out])."""
    w32 = weight.float()
    absmax = w32.abs().amax(dim=tuple(range(1, w32.ndim)))
    scale = absmax.clamp_min(1e-12) / _QMAX
    q = torch.clamp(torch.round(w32 / scale.view((-1,) + (1,) * (w32.ndim - 1))), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def quantize_activation(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: (q, fp32 scalar scale).  With a
    process ``group`` the abs-max is the max over its ranks."""
    lo, hi = torch.aminmax(x)
    absmax = torch.maximum(-lo, hi).float()
    if group is not None:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = absmax.clamp_min(1e-12) / _QMAX
    q = torch.div(x.float(), scale).round_().clamp_(-_QMAX, _QMAX)
    return q.to(torch.int8), scale


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [M, K] times int8 ``w`` [N, K] transposed -> int32 [M, N],
    through ``torch._int_mm``; zero padding (exact) meets its shape rules."""
    m, k = a.shape
    n = w.shape[0]
    pk, pn, pm = -k % 8, -n % 8, max(0, 32 - m)
    if pk:
        a, w = F.pad(a, (0, pk)), F.pad(w, (0, pk))
    if pn:
        w = F.pad(w, (0, 0, 0, pn))
    if pm:
        a = F.pad(a, (0, 0, 0, pm))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (pm or pn) else out


def dequantize(acc: torch.Tensor, sx: torch.Tensor, w_scale: torch.Tensor, dtype) -> torch.Tensor:
    """JAX's order: ``(acc.float() * (sx * w_scale)).astype(x.dtype)``."""
    return (acc.float() * (sx * w_scale)).to(dtype)


class QuantLinear(nn.Module):
    """W8A8 ``nn.Linear``: ``weight_q`` int8 [out, in], ``w_scale`` fp32
    [out] and the float bias.  ``tp_group`` (set by ``shard_unet_`` on a
    row-parallel shard): the abs-max and the int32 sums span the group,
    and the bias is added once, after the sum."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.tp_group = None
        self.weight_q = nn.Parameter(torch.zeros((out_features, in_features), dtype=torch.int8, device=device),
                                     requires_grad=False)
        self.w_scale = nn.Parameter(torch.ones(out_features, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device), requires_grad=False) if bias else None

    @classmethod
    @torch.no_grad()
    def from_float(cls, linear: nn.Linear) -> "QuantLinear":
        q = cls(linear.in_features, linear.out_features, linear.bias is not None, device=linear.weight.device)
        q.weight_q.data, q.w_scale.data = quantize_weight(linear.weight)
        if linear.bias is not None:
            q.bias.data = linear.bias.detach().clone()
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, sx = quantize_activation(x, self.tp_group)
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), self.weight_q)
        if self.tp_group is not None:
            dist.all_reduce(acc, group=self.tp_group)
        y = dequantize(acc, sx, self.w_scale, x.dtype).reshape(x.shape[:-1] + (self.out_features,))
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QuantConv2d(nn.Module):
    """W8A8 ``nn.Conv2d`` over NCHW: ``weight_q`` int8 [out, in, kh, kw],
    ``w_scale`` fp32 [out] and the float bias.  The int8 product is im2col
    and one ``int8_matmul``, ``IM2COL_BYTES`` of im2col at a time; the
    output is NCHW in channels_last memory."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        k = kernel_size
        self.weight_q = nn.Parameter(torch.zeros((out_channels, in_channels, k, k), dtype=torch.int8, device=device),
                                     requires_grad=False)
        self.w_scale = nn.Parameter(torch.ones(out_channels, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device), requires_grad=False) if bias else None

    @classmethod
    @torch.no_grad()
    def from_float(cls, conv: nn.Conv2d) -> "QuantConv2d":
        kh, kw = conv.kernel_size
        if kh != kw or conv.stride[0] != conv.stride[1] or not isinstance(conv.padding, tuple) \
                or conv.padding[0] != conv.padding[1] or conv.groups != 1 or conv.dilation != (1, 1):
            raise ValueError(f"QuantConv2d takes square, ungrouped, undilated convs, not {conv}")
        q = cls(conv.in_channels, conv.out_channels, kh, conv.stride[0], conv.padding[0], conv.bias is not None,
                device=conv.weight.device)
        q.weight_q.data, q.w_scale.data = quantize_weight(conv.weight)
        if conv.bias is not None:
            q.bias.data = conv.bias.detach().clone()
        return q

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, sx = quantize_activation(x)
        k, s, p = self.kernel_size, self.stride, self.padding
        n, _, h, w = x.shape
        ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        out = torch.empty((n, ho, wo, self.out_channels), dtype=x.dtype, device=x.device)
        for b, acc in int8_conv_chunks(xq.permute(0, 2, 3, 1), self.weight_q, s, p):
            out[b : b + acc.shape[0]] = dequantize(acc, sx, self.w_scale, x.dtype)
        y = out.permute(0, 3, 1, 2)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


def int8_conv_chunks(xq: torch.Tensor, weight_q: torch.Tensor, stride: int, padding: int):
    """The int8 convolution of NHWC ``xq`` with OIHW ``weight_q``, in blocks
    of images: yields (first image, int32 [images, Ho, Wo, O]).  im2col lays
    the k*k taps side by side in int8 (columns ordered (i, j, c)), at most
    ``IM2COL_BYTES`` at once, and one ``int8_matmul`` takes each block."""
    out_ch, c, k, _ = weight_q.shape
    n, h, w, _ = xq.shape
    s, p = stride, padding
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    xq = xq.contiguous()
    if p:
        xq = F.pad(xq, (0, 0, p, p, p, p))
    wmat = weight_q.permute(0, 2, 3, 1).reshape(out_ch, k * k * c)
    per = max(1, IM2COL_BYTES // max(1, ho * wo * k * k * c))
    for b in range(0, n, per):
        xb = xq[b : b + per]
        if k == 1 and s == 1:
            cols = xb.reshape(-1, c)
        else:
            taps = [xb[:, i : i + s * (ho - 1) + 1 : s, j : j + s * (wo - 1) + 1 : s] for i in range(k) for j in range(k)]
            cols = torch.cat(taps, dim=-1).reshape(-1, k * k * c)
        yield b, int8_matmul(cols, wmat).reshape(-1, ho, wo, out_ch)


def _swap(parent: nn.Module, name: str) -> None:
    """Replace the float ``nn.Linear``/``nn.Conv2d`` child ``name`` (a
    ``ModuleList`` index too) by its W8A8 counterpart; a missing or
    already quantized child stays."""
    child = getattr(parent, name, None)
    if isinstance(child, nn.Linear):
        setattr(parent, name, QuantLinear.from_float(child))
    elif isinstance(child, nn.Conv2d):
        setattr(parent, name, QuantConv2d.from_float(child))


def _quantize_transformer2d_(t2d: nn.Module) -> None:
    _swap(t2d, "proj_in")
    _swap(t2d, "proj_out")
    for block in t2d.transformer_blocks:
        for attn in (block.attn1, block.attn2):
            for name in ("to_q", "to_k", "to_v"):
                _swap(attn, name)
            _swap(attn.to_out, "0")
        # the port keeps diffusers' fused GEGLU projection [2 * inner, dim],
        # where JAX holds proj_h and proj_gate: with per-out-channel weight
        # scales and one per-tensor input scale, the fused int8 linear is
        # exactly JAX's two
        _swap(block.ff.net[0], "proj")
        _swap(block.ff.net, "2")


def _quantize_resnet_(resnet: nn.Module) -> None:
    for name in ("conv1", "conv2", "conv_shortcut"):
        _swap(resnet, name)


@torch.no_grad()
def quantize_unet_(unet: nn.Module) -> nn.Module:
    """Swap the UNet's quantized layers for ``QuantLinear``/``QuantConv2d``
    in place (``quantize_unet_params``).  Call it on the whole UNet, before
    ``shard_unet_``: the weight scales are per output channel of the whole
    layer."""
    for block in list(unet.down_blocks) + [unet.mid_block] + list(unet.up_blocks):
        for resnet in block.resnets:
            _quantize_resnet_(resnet)
        for t2d in block.attentions:
            _quantize_transformer2d_(t2d)
        for name in ("downsamplers", "upsamplers"):
            for sampler in getattr(block, name, ()):
                _swap(sampler, "conv")
    return unet


def is_quantized(module: nn.Module) -> bool:
    """Whether ``module`` holds a W8A8 layer."""
    return any(isinstance(m, (QuantLinear, QuantConv2d)) for m in module.modules())


def apply_quantize(unet: nn.Module, quantize: Optional[str]) -> nn.Module:
    """The load-time transform of ``--quantize``: None/"none" or "w8a8"."""
    if quantize in (None, "none"):
        return unet
    if quantize == "w8a8":
        return quantize_unet_(unet)
    raise ValueError(f"unknown quantize mode {quantize!r} (expected 'w8a8')")


@torch.no_grad()
def to_compute_dtype_(module: nn.Module, device, dtype) -> nn.Module:
    """``module.to(device, dtype)`` that leaves the W8A8 weights as they
    are: int8 stays int8 and ``w_scale`` fp32 (JAX's ``_cast_leaf``)."""
    module.to(device=device)
    tensors = list(module.named_parameters()) + list(module.named_buffers())
    for name, t in tensors:
        if t.is_floating_point() and t.dtype != dtype and name.rsplit(".", 1)[-1] != "w_scale":
            t.data = t.data.to(dtype)
    return module
