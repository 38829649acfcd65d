"""Random parameters drawn on the module's device, for throughput benches.

Counterpart of ``rollingdepth_tpu/utils/bench_init.py``.  Throughput does
not depend on the weights, so a bench fills the parameters in place where
they live, with no host upload: biases 0, norm weights 1, every other
floating parameter ``stddev * N(0, 1)``, which keeps activations bounded
through the GroupNorm and softmax stacks.  The draws come from one explicit
``torch.Generator`` on the module's device, one parameter after another in
``named_parameters`` order, so a seed gives the same weights on every run.
Fill a UNet before ``ops.quant.quantize_unet_``: int8 parameters are left
as they are.
"""

from __future__ import annotations

import torch
from torch import nn

_NORMS = (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)


def leaf_kind(module: nn.Module, name: str) -> str:
    """"zeros", "ones" or "normal" for the parameter ``name`` of ``module``."""
    owner_name, _, leaf = name.rpartition(".")
    if leaf == "bias":
        return "zeros"
    if leaf == "weight" and isinstance(module.get_submodule(owner_name), _NORMS):
        return "ones"
    return "normal"


@torch.no_grad()
def device_random_params(module: nn.Module, generator: torch.Generator, dtype=torch.bfloat16,
                         stddev: float = 0.02) -> nn.Module:
    """Cast ``module`` to ``dtype`` and fill its parameters in place on their
    device from ``generator`` (which must live on that device)."""
    module.to(dtype=dtype)
    for name, p in module.named_parameters():
        if not p.is_floating_point():
            continue
        kind = leaf_kind(module, name)
        if kind == "zeros":
            p.zero_()
        elif kind == "ones":
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32).mul_(stddev))
    return module
