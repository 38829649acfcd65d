"""Time the flash-attention variants on the card at the UNet's attention shape.

    python -m rollingdepth_torch.tools.bench_flash_variants

The counterpart of ``scripts/bench_flash_variants.py``'s ``main``: at
[2, 15552, 5, 64] and [8, 15552, 5, 64] (self-attention, L_q = L_k, bf16,
seeded random q, k, v) it runs every variant of ``ops/flash_variants.py``
and prints its time per call (CUDA events after 2 warm-up calls), its
rate in TFLOP/s of QK^T and PV (4·B·H·L²·D operations), and its max abs
error against ``flash_fused``, as the script does against its reference.  The TPU
script's block-size sweep has no counterpart: the CUDA tile shapes are
constants.  Prints the card's name and power limit first and a JSON line
of all rows last.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from typing import List

import torch

from ..ops import flash_variants as fv
from ..utils.device import card_name

VARIANTS = (
    ("exp2", fv.flash_exp2),
    ("fused", fv.flash_fused),
    ("bf16", fv.flash_bf16),
    ("nomax", fv.flash_nomax),
    ("nomax_bf16_exp", fv.flash_nomax_bf16_exp),
    ("nomask", fv.flash_nomask),
)
SHAPES = ((2, 15552, 5, 64), (8, 15552, 5, 64))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep(iters: int = 10, verbose: bool = True) -> List[dict]:
    """Every variant at every shape of ``SHAPES``; one row per (shape, variant)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash_variants: needs a CUDA card")
    rows = []
    for b, l, h, d in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, l, h, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        ref = fv.flash_fused(q, k, v).float()
        flops = 4.0 * b * h * l * l * d
        for name, fn in VARIANTS:
            err = (fn(q, k, v).float() - ref).abs().max().item()
            ms = cuda_ms(lambda: fn(q, k, v), iters)
            row = {"variant": name, "shape": [b, l, h, d], "ms": ms, "tflops": flops / ms / 1e9,
                   "max_abs_err_vs_fused": err}
            rows.append(row)
            if verbose:
                print(f"{name:>15} {[b, l, h, d]}: {ms:8.3f} ms  {row['tflops']:6.1f} TF/s  err {err:.2e}",
                      flush=True)
        del q, k, v, ref
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_flash_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = card_name()
    print(smi, flush=True)
    rows = sweep()
    print(json.dumps({"card": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
