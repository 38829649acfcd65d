"""The reference one precision step below bf16: fp8 (e4m3) products.

The control of a stage the program runs in bf16 and has no int8 path for
(the VAE, the solve's merge, refinement's UNet): every convolution's and
linear layer's weight rounded once to e4m3 with a scale per output
channel, and its input rounded to e4m3 with one scale per call, the
product then taken in fp32.  A sound limit has to fail this.
"""

from __future__ import annotations

import torch
from torch import nn

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` through e4m3 and back, scaled so its abs-max (over ``dim``, or
    the whole tensor) maps to the format's largest value."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@torch.no_grad()
def fp8_(module: nn.Module) -> nn.Module:
    """Round ``module``'s convolution and linear weights, and their inputs on
    every call, to e4m3."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.copy_(fp8_round(m.weight, dim=tuple(range(1, m.weight.ndim))))
            m.register_forward_pre_hook(lambda _m, args: (fp8_round(args[0]),) + tuple(args[1:]))
    return module
