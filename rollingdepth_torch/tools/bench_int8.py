"""Probe: the int8 product and convolution of the W8A8 mode against bf16 on the card.

    python -m rollingdepth_torch.tools.bench_int8 [--full] [--iters 10]

Counterpart of ``scripts/bench_int8.py``.  Times bare operations at the
SD2 UNet's trunk shapes at 768x432 (96x54 latents, 16 windows of 3 frames:
48 images): a 3x3 convolution at 320 channels on 96x54 and at 1280 on
24x14, and a 16k x 4k x 4k product.  ``--full`` adds the 640-channel conv
on 48x27, the VAE's last up-block conv (128 channels on 768x432, 16
frames), the level-0 q/k/v and the level-1 GEGLU projections as products,
and the whole W8A8 layers (``QuantConv2d``/``QuantLinear``: the dynamic
quantisation of a bf16 input, the int8 product and the dequantisation).

The bf16 rows are cuDNN's convolution (channels_last) and cuBLAS's GEMM;
the int8 rows are what ``ops/quant.py`` runs: ``torch._int_mm`` (cuBLASLt)
for a product, im2col plus ``_int_mm`` for a convolution
(``int8_conv_chunks``).  Each row gives the time per call (CUDA events
after two warm-up calls), the rate in TOP/s of 2·M·N·K operations, and
``bound_ms``: the larger of the bytes (each input read once, the output
written once) at 3.35 TB/s and the operations at the H100's dense peak,
989 TFLOP/s in bf16 and 1979 TOP/s in int8.  Prints the card's name and
power limit first and a JSON line of every row last.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List

from ..utils.device import card_name

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
CONVS = [  # name, (images, H, W, channels)
    ("unet l0 320@96x54", (48, 96, 54, 320)),
    ("unet l1 640@48x27", (48, 48, 27, 640)),
    ("unet l2 1280@24x14", (48, 24, 14, 1280)),
    ("vae up3 128@768x432", (16, 768, 432, 128)),
]
DOTS = [  # name, (M, K, N)
    ("attn qkv l0", (48 * 96 * 54, 320, 320)),
    ("ff geglu l1", (48 * 48 * 27, 640, 5120)),
    ("big", (16384, 4096, 4096)),
]
SLIM = {"unet l0 320@96x54", "unet l2 1280@24x14", "big"}


def cuda_ms(fn: Callable, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def row(kind: str, name: str, dtype: str, ms: float, ops: float, nbytes: float) -> dict:
    """``dtype``: "bf16", "int8", or "int8 w8a8" (the whole layer, at the int8 peak)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype.split()[0]]
    return {"kind": kind, "name": name, "dtype": dtype, "ms": ms, "tops": ops / ms / 1e9,
            "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def sweep(full: bool = False, iters: int = 10, verbose: bool = True) -> List[dict]:
    """Every row of the probe (the slim set unless ``full``)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from ..ops.quant import QuantConv2d, QuantLinear, int8_conv_chunks, int8_matmul

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    rows: List[dict] = []

    def emit(r):
        rows.append(r)
        if verbose:
            print(f"{r['kind']:4s} {r['name']:20s} {r['dtype']:9s} {r['ms']:8.3f} ms {r['tops']:7.1f} TOP/s "
                  f"(bound {r['bound_ms']:.3f} ms, {r['bound_by']})", flush=True)

    def int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def bf16(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    for name, (n, h, w, c) in CONVS:
        if not full and name not in SLIM:
            continue
        ops = 2 * n * h * w * c * c * 9
        xb = bf16((n, c, h, w)).contiguous(memory_format=torch.channels_last)
        wb = bf16((c, c, 3, 3), 0.02).contiguous(memory_format=torch.channels_last)
        emit(row("conv", name, "bf16", cuda_ms(lambda: F.conv2d(xb, wb, padding=1), iters), ops,
                 2 * (xb.numel() + wb.numel() + xb.numel())))
        del xb
        xi, wi = int8((n, h, w, c)), int8((c, c, 3, 3))
        emit(row("conv", name, "int8", cuda_ms(lambda: [a for _, a in int8_conv_chunks(xi, wi, 1, 1)], iters), ops,
                 xi.numel() + wi.numel() + 4 * xi.numel()))
        del xi
        if full:
            conv = nn.Conv2d(c, c, 3, padding=1, device=dev, dtype=torch.bfloat16)
            qconv = QuantConv2d.from_float(conv)
            xb = bf16((n, c, h, w)).contiguous(memory_format=torch.channels_last)
            emit(row("conv", name, "int8 w8a8", cuda_ms(lambda: qconv(xb), iters), ops,
                     2 * xb.numel() + wi.numel() + 2 * xb.numel()))
            del xb
        torch.cuda.empty_cache()

    for name, (m, k, n) in DOTS:
        if not full and name not in SLIM:
            continue
        ops = 2 * m * k * n
        ab, bb = bf16((m, k)), bf16((k, n), 0.02)
        emit(row("dot", name, "bf16", cuda_ms(lambda: torch.mm(ab, bb), iters), ops, 2 * (m * k + k * n + m * n)))
        ai, wi = int8((m, k)), int8((n, k))
        emit(row("dot", name, "int8", cuda_ms(lambda: int8_matmul(ai, wi), iters), ops, m * k + k * n + 4 * m * n))
        if full:
            lin = QuantLinear.from_float(nn.Linear(k, n, device=dev, dtype=torch.bfloat16))
            emit(row("dot", name, "int8 w8a8", cuda_ms(lambda: lin(ab), iters), ops, 2 * m * k + k * n + 2 * m * n))
        del ab, bb, ai, wi
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="every shape, and the whole W8A8 layers")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_int8: no CUDA device", file=sys.stderr)
        return 2
    smi = card_name()
    print(smi, flush=True)
    rows = sweep(args.full, args.iters)
    print(json.dumps({"card": smi, "torch": torch.__version__, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
