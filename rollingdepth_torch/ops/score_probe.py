"""Load-time attention score calibration for the max-free flash kernel.

Counterpart of ``rollingdepth_tpu/ops/score_probe.py``.  The max-free
kernel computes ``p = exp2(s)`` with no running max, which needs the
log2-domain scores inside fp32 exp2 range (|s| < ~120).  That is a contract
on the weights, so the loader measures it: small UNet forwards at early,
mid and late timesteps, with ``ops.attention`` recording the |score| max of
every attention call, and the gate closes when the bound times a margin
exceeds ``NOMAX_SCORE_LIMIT``.  The dispatch then routes narrow heads to
the running-max kernel.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from . import attention as attn_mod
from .attention import NOMAX_SCORE_LIMIT, set_nomax_allowed

logger = logging.getLogger(__name__)

# latent edge of the probe input: scores are per-pair dot products and do
# not grow with sequence length, so a small size measures the same scale
_PROBE_HW = 16


@torch.no_grad()
def probe_unet_score_bound(
    unet,
    context: Optional[torch.Tensor] = None,
    n: int = 3,
    timesteps=(1, 500, 999),
    seed: int = 0,
) -> float:
    """Max log2-domain |score| over every attention call of small UNet
    forwards on N(0,1) latents, in the UNet's own device and dtype."""
    cfg = unet.config
    p = next(unet.parameters())
    gen = torch.Generator(device=p.device).manual_seed(seed)
    x = torch.randn((1, n, _PROBE_HW, _PROBE_HW, cfg.in_channels), generator=gen, device=p.device)
    if context is None:
        context = torch.randn((1, 2, cfg.cross_attention_dim), generator=gen, device=p.device)
    elif context.ndim == 2:
        context = context[None]
    x, context = x.to(p.dtype), context.to(device=p.device, dtype=p.dtype)

    recorder: list = []
    old = attn_mod._SCORE_RECORDER
    attn_mod._SCORE_RECORDER = recorder
    try:
        for t in timesteps:
            unet(x, torch.tensor([t], device=p.device), context)
    finally:
        attn_mod._SCORE_RECORDER = old
    if not recorder:
        raise RuntimeError("score probe recorded no attention calls: recorder hook broken")
    return float(torch.stack(recorder).amax())


def calibrate_nomax(unet, context=None, margin: float = 2.0, group=None, **kwargs) -> float:
    """Probe the UNet and set the global max-free gate; returns the bound.
    With a process ``group`` the bound is the max over its ranks, so every
    rank takes the same kernel (a rank on K2 beside one on K1 would part
    their results); probe the whole UNet, before ``shard_unet_``."""
    bound = probe_unet_score_bound(unet, context=context, **kwargs)
    if group is not None:
        import torch.distributed as dist

        t = torch.tensor([bound], dtype=torch.float32, device=next(unet.parameters()).device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        bound = float(t.item())
    ok = bound * margin < NOMAX_SCORE_LIMIT
    set_nomax_allowed(ok)
    if ok:
        logger.info("attention score bound %.1f (log2 domain, limit %.0f/margin %.1fx): "
                    "max-free flash kernel enabled", bound, NOMAX_SCORE_LIMIT, margin)
    else:
        logger.warning("attention score bound %.1f exceeds %.0f/%.1fx: routing attention to the "
                       "running-max kernel", bound, NOMAX_SCORE_LIMIT, margin)
    return bound
