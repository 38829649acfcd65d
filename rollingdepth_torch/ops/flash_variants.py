"""Flash-attention sweep variants: the counterparts of the five kernels of
``scripts/bench_flash_variants.py``.

| wrapper                         | CUDA entry point (csrc/flash_attn.cu) | replaces (scripts/bench_flash_variants.py) |
| ------------------------------- | ------------------------------------- | ------------------------------------------ |
| ``flash_exp2``                  | ``rd_flash_exp2``                     | ``_kernel_exp2`` (K6)                      |
| ``flash_fused``                 | ``rd_flash_max``, K2's kernel         | ``_kernel_fused`` (K7)                     |
| ``flash_bf16``                  | ``rd_flash_bf16``                     | ``_kernel_bf16`` (K8)                      |
| ``flash_nomax``                 | ``rd_flash_nomax``, K1's kernel       | ``_kernel_nomax`` (K9)                     |
| ``flash_nomax(bf16_exp=True)``  | ``rd_flash_nomax_bf16exp``            | ``_kernel_nomax(bf16_exp=True)`` (K9)      |
| ``flash_nomask``                | ``rd_flash_nomask``                   | ``_kernel_nomask`` (K10)                   |

Each takes ``[B, L, H, D]`` tensors with the script's names; the TPU
block sizes have no counterpart (the CUDA tile shapes are constants).  The
scale is ``D**-0.5``.  On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs ``attention_exp2_reference`` with the
variant's roundings.  Each wrapper counts its launches in ``.launches``;
``flash_nomax(bf16_exp=True)`` counts in ``flash_nomax_bf16_exp.launches``.
bf16 heads must be narrow (d < 128, d % 8 == 0); fp32 takes the 3xTF32
kernels (d % 8 == 0, d <= 512), except ``flash_bf16`` and the ``bf16_exp`` kernel, which take
bf16 only.
"""

from __future__ import annotations

import torch

from .flash_attention import _check, _launch, attention_exp2_reference


# Each wrapper's rounding flags for ``attention_exp2_reference``.
PLAIN = {
    "flash_exp2": dict(no_max=False, sum_rounded=False),
    "flash_fused": dict(no_max=False, sum_rounded=True),
    "flash_bf16": dict(no_max=False, sum_rounded=True, prescale_q=True, bf16_scores=True),
    "flash_nomax": dict(no_max=True, sum_rounded=True),
    "flash_nomax_bf16_exp": dict(no_max=True, sum_rounded=True, bf16_scores=True),
    "flash_nomask": dict(no_max=True, sum_rounded=True, prescale_q=True),
}
BF16_ONLY = ("flash_bf16", "flash_nomax_bf16_exp")


def reference(name: str, q, k, v) -> torch.Tensor:
    """The plain version of the wrapper called ``name``, on any device."""
    return attention_exp2_reference(q, k, v, **PLAIN[name])


def _run(wrapper, symbol: str, q, k, v) -> torch.Tensor:
    name = wrapper.__name__
    _check(q, k, v, name)
    if q.device.type == "cpu":
        return reference(name, q, k, v)
    if q.dtype == torch.bfloat16 and q.shape[-1] >= 128:
        raise ValueError(f"{name}: bf16 head dim must be < 128, got {q.shape[-1]}")
    if name in BF16_ONLY and q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 only, got {q.dtype}")
    out = _launch(symbol, q, k, v, None)
    wrapper.launches += 1
    return out


def flash_exp2(q, k, v) -> torch.Tensor:
    """K6: running max, scale on the fp32 score, normaliser = sum of fp32 P."""
    return _run(flash_exp2, "rd_flash_exp2", q, k, v)


def flash_fused(q, k, v) -> torch.Tensor:
    """K7: running max, normaliser = sum of P rounded to v's dtype (the TPU
    kernel's ones column).  The function of K2; launches ``rd_flash_max``."""
    return _run(flash_fused, "rd_flash_max", q, k, v)


def flash_bf16(q, k, v) -> torch.Tensor:
    """K8: q pre-scaled by d^-1/2 * log2(e) and rounded to bf16; scores,
    ``s - max`` and P in bf16; running max and sums in fp32.  bf16 only."""
    return _run(flash_bf16, "rd_flash_bf16", q, k, v)


def flash_nomax(q, k, v, bf16_exp: bool = False) -> torch.Tensor:
    """K9: no running max, ``p = exp2(s)``.  Without ``bf16_exp`` the
    function of K1 (launches ``rd_flash_nomax``); with it, s is rounded to
    bf16 before exp2 (``flash_nomax_bf16_exp``, bf16 only)."""
    if bf16_exp:
        return flash_nomax_bf16_exp(q, k, v)
    return _run(flash_nomax, "rd_flash_nomax", q, k, v)


def flash_nomax_bf16_exp(q, k, v) -> torch.Tensor:
    """K9 with ``bf16_exp=True``: ``p = exp2(bf16(s))`` in bf16."""
    return _run(flash_nomax_bf16_exp, "rd_flash_nomax_bf16exp", q, k, v)


def flash_nomask(q, k, v) -> torch.Tensor:
    """K10: q pre-scaled and rounded to its dtype, no running max; padded
    keys contribute 0 to the numerator and the normaliser."""
    return _run(flash_nomask, "rd_flash_nomask", q, k, v)


KERNELS = (flash_exp2, flash_fused, flash_bf16, flash_nomax, flash_nomax_bf16_exp, flash_nomask)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
