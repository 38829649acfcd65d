"""Attention dispatch: the CUDA flash kernels on the card, plain PyTorch elsewhere.

Counterpart of ``rollingdepth_tpu/ops/attention.py``.  Callers pass
``[B, L, H, D]`` tensors; the RollingDepth cross-frame self-attention passes
``L = n*h*w`` (the snippet axis is part of the token axis).

Routing, for a call that takes a kernel:
- d > 256: the wide kernel (K3);
- d < 128: the max-free kernel (K1) while the score gate is open, else the
  running-max kernel (K2);
- 128 <= d <= 256: the wide kernel.
Auto-select takes a kernel on CUDA tensors with L_q >= 256, L_k >= 256 and
32 <= d <= 512, d a multiple of 8.  ``ROLLINGDEPTH_ATTN=xla`` or ``=flash`` overrides that for
every call (the names are the JAX package's: ``xla`` means the plain path).

Under autograd (grad mode on and q, k or v requiring grad) a kernel call
goes through ``flash_attention.FlashAttention``, whose backward recomputes
plain attention per query block; the plain path is differentiated by
autograd directly.  With grad mode off the bare kernel wrapper is called.

The plain path is ``matmul`` + fp32 softmax + ``matmul``.  It serves the
cross-attention to the text tokens, the UNet mid-block (L = 252 at
768x432), the score probe and every CPU call.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from . import flash_attention as fa

# ---- max-free kernel safety gate ------------------------------------------
# The max-free kernel needs bounded log2-domain scores (|q.k|*scale*log2e <
# ~120, else fp32 exp2 overflows).  Loaders measure the bound on the loaded
# weights (ops/score_probe.py) and close this gate when it is too large;
# the dispatch then routes narrow heads to the running-max kernel.
_NOMAX_ALLOWED = True
NOMAX_SCORE_LIMIT = 96.0  # log2 units; fp32 exp2 overflows at 128

LOG2E = fa.LOG2E

# When a list, every dot_product_attention call appends its log2-domain
# |score| max (a 0-d device tensor) and answers by the plain path: the
# recording mechanism of the load-time score probe.
_SCORE_RECORDER: Optional[List[torch.Tensor]] = None

# Above this many scores per call the plain path loops over query chunks.
_PLAIN_CHUNK_SCORES = 8_388_608
_PLAIN_BLOCK_Q = 2048


def set_nomax_allowed(ok: bool) -> None:
    global _NOMAX_ALLOWED
    _NOMAX_ALLOWED = bool(ok)


def nomax_allowed() -> bool:
    return _NOMAX_ALLOWED


def _plain_block(q, k, v, scale: float) -> torch.Tensor:
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def auto_selects_kernel(on_cuda: bool, l_q: int, l_k: int, d: int) -> bool:
    """The auto rule: a kernel for long sequences on the card, at head
    dims 32..512 (tiny test heads run faster on the plain path) that are
    multiples of 8 (the bf16 kernels load 16-byte vectors)."""
    return on_cuda and l_q >= 256 and l_k >= 256 and 32 <= d <= 512 and d % 8 == 0


def plain_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention: fp32 scores and softmax, P in v's dtype.  Long
    sequences loop over query chunks to bound the live score matrix."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    lq, lk = q.shape[1], k.shape[1]
    if lq * lk <= _PLAIN_CHUNK_SCORES or lq <= 4096:
        return _plain_block(q, k, v, scale)
    return torch.cat(
        [_plain_block(q[:, i : i + _PLAIN_BLOCK_Q], k, v, scale) for i in range(0, lq, _PLAIN_BLOCK_Q)],
        dim=1,
    )


def dot_product_attention(q, k, v, scale: Optional[float] = None, use_flash: Optional[bool] = None):
    """Multi-head attention over ``[B, L, H, D]`` tensors (see module doc)."""
    if _SCORE_RECORDER is not None:
        d = q.shape[-1]
        sc = (d**-0.5 if scale is None else scale) * LOG2E
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        _SCORE_RECORDER.append(logits.abs().amax() * sc)
        return plain_attention(q, k, v, scale)
    if use_flash is None:
        env = os.environ.get("ROLLINGDEPTH_ATTN", "auto").lower()
        if env == "xla":
            use_flash = False
        elif env == "flash":
            use_flash = True
    d = q.shape[-1]
    if use_flash is None:
        use_flash = auto_selects_kernel(q.is_cuda, q.shape[1], k.shape[1], d)
    if not use_flash:
        return plain_attention(q, k, v, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if d < 128:
        kernel = fa.flash_attention_nomax if _NOMAX_ALLOWED else fa.flash_attention_max
    else:
        kernel = fa.flash_attention_wide
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return fa.FlashAttention.apply(kernel, q, k, v, scale)
    return kernel(q, k, v, scale)
