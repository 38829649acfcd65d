"""Where the persistent conv kernel (K5, ``rd_conv3x3_db``) spends its cycles.

    python -m rollingdepth_torch.tools.conv_breakdown

Builds ``csrc/conv3x3.cu`` a second time with ``-DRD_CONV_TRACE`` (its own
library beside the plain one in the build directory), runs
``rd_conv3x3_db`` at the VAE decoder's three widths (bf16, seeded random
x, w and bias) and reads the kernel's cycle trace: for each CTA's tiles,
the wait for its first halo and weight tiles, the main loop (9 taps x
Cin / 64 chunks of 256 x 128 x 64 products), the cycles consumer thread 0
waited inside the loop for halo tiles and for weight tiles, and the
epilogue.  A step at the tensor cores' dense bf16 rate takes
``PEAK_CYCLES_PER_STEP`` cycles.  Prints the card's name and power limit
first, then one JSON line per width.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import conv3x3 as conv
from ..utils.device import card_name

SHAPES = ((4, 432, 768, 128, 128), (4, 216, 384, 256, 256), (4, 108, 192, 512, 512))
TRACE_CTAS, TRACE_TILES, TRACE_FIELDS = 1024, 64, 6  # csrc/conv3x3.cu's trace layout
# A step's operations over 4096 dense bf16 operations a cycle on one SM
# (989 TFLOP/s over 132 SMs at 1.83 GHz, data sheet)
PEAK_CYCLES_PER_STEP = (2 * conv.TILE_ROWS["conv3x3_same_db"] * conv.TILE_COLS * conv.TILE_COUT * conv.TILE_CIN
                        // 4096)


def build_traced() -> ctypes.CDLL:
    """``csrc/conv3x3.cu`` built with the cycle trace, once per source."""
    from ..ops import _build

    path = _build._lib_path("conv3x3").replace("libconv3x3-", "libconv3x3_trace-")
    if not os.path.exists(path):
        os.makedirs(_build.build_dir(), exist_ok=True)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DRD_CONV_TRACE", "-o", path,
               os.path.join(_build._CSRC, "conv3x3.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the traced conv3x3.cu:\n{(proc.stdout + proc.stderr)[-8000:]}")
    return ctypes.CDLL(path)


def summarize(trace: np.ndarray, n_tiles: int, grid: int, steps: int) -> dict:
    """Mean cycles per tile from ``trace`` [TRACE_CTAS, TRACE_TILES,
    TRACE_FIELDS] (start, first tiles landed, loop done, epilogue done,
    halo waits, weight waits) over the tiles every one of the ``grid``
    CTAs ran, at most TRACE_TILES."""
    tiles = min(n_tiles // grid, TRACE_TILES)
    if tiles < 2:
        raise ValueError(f"{n_tiles} tiles on {grid} CTAs: fewer than 2 tiles per CTA to average")
    t = trace[:grid, :tiles].astype(np.float64)
    start, landed, loop, end, wait_a, wait_b = (t[..., i] for i in range(TRACE_FIELDS))
    per_tile = float(((end[:, -1] - start[:, 0]) / tiles).mean())
    main_loop = float((loop - landed).mean())
    return {"tiles_per_cta": tiles, "steps_per_tile": steps, "cycles_per_tile": per_tile,
            "first_tiles_wait": float((landed - start).mean()), "main_loop": main_loop,
            "halo_wait_in_loop": float(wait_a.mean()), "weight_wait_in_loop": float(wait_b.mean()),
            "epilogue": float((end - loop).mean()), "between_tiles": float((start[:, 1:] - end[:, :-1]).mean()),
            "main_loop_per_step": main_loop / steps, "peak_cycles_per_step": PEAK_CYCLES_PER_STEP,
            "main_loop_share_of_tile": main_loop / per_tile}


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from .bench_flash_variants import cuda_ms

    smi = card_name()
    print(smi, flush=True)
    lib = build_traced()
    fn, read = lib.rd_conv3x3_db, lib.rd_conv3x3_trace
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, h, w, cin, cout in SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(torch.bfloat16)
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") * (9 * cin) ** -0.5).to(torch.bfloat16)
        b = torch.randn((cout,), generator=gen, device="cuda").to(torch.bfloat16)
        o = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = fn(0, x.data_ptr(), wt.data_ptr(), b.data_ptr(), o.data_ptr(), n, h, w, cin, cout, stream)
            if err != 0:
                raise RuntimeError(f"rd_conv3x3_db (traced) failed with {err}")

        ms = cuda_ms(launch, 1, warmup=3)  # the trace holds this last launch
        trace = np.zeros((TRACE_CTAS, TRACE_TILES, TRACE_FIELDS), dtype=np.int64)
        if read(trace.ctypes.data) != 0:
            raise RuntimeError("reading the conv trace failed")
        n_tiles = conv.bf16_tiles(conv.conv3x3_same_db, n, h, w, cout)
        grid = min(n_tiles, sms)
        row = summarize(trace, n_tiles, grid, 9 * -(-cin // conv.TILE_CIN))
        cycles = row["cycles_per_tile"] * n_tiles / grid
        print(json.dumps({"shape": [n, h, w, cin, cout], "ms": ms, "grid": grid,
                          "sm_clock_ghz": cycles / (ms * 1e6), **row, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
