"""Seeded weights, drawn on the device in a few large calls.

The benchmark's own recipe (that of ``utils/bench_init.py`` in the
program, drawn in bulk): biases 0, norm weights 1, every other floating
parameter ``stddev * N(0, 1)``, which keeps activations bounded through
the GroupNorm and softmax stacks.  The names and shapes come from the
reference modules (diffusers' names), built on the meta device; one
``torch.randn`` a model, in the dtype the model is served in, is cut into
the parameters in ``named_parameters`` order.  The same seed gives the
same state dicts, which load into the program's modules and, cast to
fp32, into the reference's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

NORMS = (nn.GroupNorm, nn.LayerNorm)
STDDEV = 0.02


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))


def _kind(module: nn.Module, name: str) -> str:
    owner, _, leaf = name.rpartition(".")
    if leaf == "bias":
        return "zeros"
    if leaf == "weight" and isinstance(module.get_submodule(owner), NORMS):
        return "ones"
    return "normal"


@torch.no_grad()
def draw_state_dict(meta_module: nn.Module, gen: torch.Generator, dtype: torch.dtype,
                    stddev: float = STDDEV) -> Dict[str, torch.Tensor]:
    """Every parameter of ``meta_module`` drawn on ``gen``'s device in ``dtype``."""
    dev = gen.device
    params = [(n, p.shape, _kind(meta_module, n)) for n, p in meta_module.named_parameters()]
    total = sum(s.numel() for _, s, k in params if k == "normal")
    flat = torch.randn(total, generator=gen, device=dev, dtype=dtype).mul_(stddev)
    out, off = {}, 0
    for name, shape, kind in params:
        if kind == "normal":
            out[name] = flat[off : off + shape.numel()].view(shape)
            off += shape.numel()
        else:
            out[name] = (torch.zeros if kind == "zeros" else torch.ones)(shape, device=dev, dtype=dtype)
    return out


def draw_models(meta_modules: Sequence[nn.Module], dtypes: Sequence[torch.dtype], seed: int, device):
    """State dicts of ``meta_modules``, one after another from one generator."""
    gen = generator(seed, device)
    return [draw_state_dict(m, gen, dt) for m, dt in zip(meta_modules, dtypes)]
