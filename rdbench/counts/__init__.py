"""Operations and bytes of a clip, counted from shapes, not from launches.

``module_counts`` runs one call of a reference module (``rdbench/ref``) on
the meta device under ``torch.utils.flop_counter.FlopCounterMode`` and
hooks every attention and GroupNorm module on the way:
- ``flops``: every matmul, convolution and attention product the call
  needs (2 a multiply-add), the numerator of ``mfu_pct``;
- ``attn_flops``: QK^T and PV of the self-attention over at least
  ``LONG_ATTENTION`` tokens, at the true head width (4 B H L_q L_k d), the
  work the program's flash kernels do; the cross-attention to the prompt's
  few tokens and the shorter self-attention are matmuls, counted in
  ``flops`` only;
- ``gn_bytes``: each GroupNorm's input read once and output written once,
  and its weight and bias, in the served dtype (the bf16 GroupNorm pair's
  bound).
The counts are the same whatever implements the work, so a kernel's
roofline reads its share of the same work on every commit.  A builder
multiplies the counts of one call by the calls a clip makes
(``scaled``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..ref.models import Attention

LONG_ATTENTION = 256  # tokens: the shortest self-attention counted as a kernel's


def module_counts(module: nn.Module, call: Callable[[], object], itemsize: int = 2) -> Dict[str, float]:
    """Counts of ``call()``, which runs ``module`` (on the meta device)."""
    tally = {"attn_flops": 0.0, "gn_bytes": 0.0}

    def on_attention(m, args, _out):
        x = args[0]
        ctx = args[1] if len(args) > 1 and args[1] is not None else None
        lq = x.shape[1]
        if ctx is None and lq >= LONG_ATTENTION:
            d = m.to_q.out_features // m.heads
            tally["attn_flops"] += 4.0 * x.shape[0] * m.heads * lq * lq * d

    def on_norm(m, args, _out):
        tally["gn_bytes"] += (2 * args[0].numel() + 2 * m.num_channels) * itemsize

    hooks = []
    for m in module.modules():
        if isinstance(m, Attention):
            hooks.append(m.register_forward_hook(on_attention))
        elif isinstance(m, nn.GroupNorm):
            hooks.append(m.register_forward_hook(on_norm))
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            call()
    finally:
        for h in hooks:
            h.remove()
    return {"flops": float(counter.get_total_flops()), **tally}


def scaled(counts: Dict[str, float], times: float) -> Dict[str, float]:
    return {k: v * times for k, v in counts.items()}


def total(*parts: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0.0) + v
    return out
