"""3x3 stride-1 SAME convolution: two hand-written CUDA kernels and their plain version.

| wrapper             | CUDA kernel (csrc/conv3x3.cu)             | replaces (rollingdepth_tpu/ops/conv3x3.py) |
| ------------------- | ----------------------------------------- | ------------------------------------------ |
| ``conv3x3_same``    | ``rd_conv3x3``: one stage: load, wait,    | ``_conv_kernel`` (K4)                      |
|                     | multiply                                  |                                            |
| ``conv3x3_same_db`` | ``rd_conv3x3_db``: persistent, a producer | ``_conv_kernel_db`` (K5)                   |
|                     | warpgroup, a ring of 2 halo tiles and 4   |                                            |
|                     | weight tiles                              |                                            |

Both take x ``[N, H, W, Cin]`` (NHWC), w ``[3, 3, Cin, Cout]`` (HWIO) and an
optional bias ``[Cout]``, as the JAX functions do, and return
``[N, H, W, Cout]`` in x's dtype.  The JAX functions' ``block_rows`` and
``interpret`` are TPU tiling knobs and have no counterpart.  On a CUDA
tensor a wrapper launches its kernel (building it at first use,
``ops/_build.py``) or raises; on a CPU tensor it runs ``conv3x3_reference``.
Each wrapper counts its launches in ``.launches``.  The bf16 kernels read x
and w through TMA tensor maps, whose strides must be multiples of 16
bytes, so bf16 channel counts must be multiples of 8; fp32 takes any.
There is no fallback: a shape a kernel does not take, or a tensor map the
CUDA driver refuses, raises.

Like the JAX package, the port's models do not call these: the VAE and
UNet convolutions stay ``F.conv2d``.  What bounds the kernels and what
their design does about it is noted at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# The bf16 kernels' tiles (csrc/conv3x3.cu): an output tile is TILE_ROWS
# image rows x TILE_COLS columns x TILE_COUT output channels, and each step
# of its loop takes one tap of a TILE_CIN-channel chunk.
TILE_ROWS = {"conv3x3_same": 2, "conv3x3_same_db": 4}
TILE_COLS, TILE_COUT, TILE_CIN = 64, 128, 64


def bf16_tiles(wrapper, n: int, h: int, w: int, cout: int) -> int:
    """Output tiles of one bf16 call of ``wrapper``."""
    return n * -(-h // TILE_ROWS[wrapper.__name__]) * -(-w // TILE_COLS) * -(-cout // TILE_COUT)


def bf16_tma_bytes(wrapper, n: int, h: int, w: int, cin: int, cout: int) -> int:
    """Bytes one bf16 call of ``wrapper`` loads through TMA, all from L2:
    per output tile and input-channel chunk, one haloed (rows + 2) x
    (columns + 2) tile of x and nine TILE_CIN x TILE_COUT weight tiles."""
    halo = TILE_CIN * (TILE_COLS + 2) * (TILE_ROWS[wrapper.__name__] + 2) * 2
    return bf16_tiles(wrapper, n, h, w, cout) * -(-cin // TILE_CIN) * (halo + 9 * TILE_CIN * TILE_COUT * 2)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: nine shifted fp32 matmuls
    over a zero-padded copy of x, summed tap by tap, rounded to x's dtype;
    then the bias rounded to x's dtype is added in x's dtype."""
    n, h, wd, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # [N, H+2, W+2, Cin]
    wf = w.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = torch.matmul(xp[:, dy : dy + h, dx : dx + wd], wf[dy, dx])
            acc = t if acc is None else acc.add_(t)
    out = acc.to(x.dtype)
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def _check(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], name: str) -> None:
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: needs x [N, H, W, Cin] and w [3, 3, Cin, Cout] (NHWC, HWIO), "
                         f"got x{tuple(x.shape)} w{tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"{name}: bias shape {tuple(b.shape)} != ({w.shape[3]},)")
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: needs x and w both bf16 or both fp32, got {x.dtype}/{w.dtype}")
    if x.device != w.device or (b is not None and b.device != x.device):
        raise ValueError(f"{name}: x, w and b on different devices")
    if x.numel() == 0 or w.shape[3] == 0:
        raise ValueError(f"{name}: empty input x{tuple(x.shape)} w{tuple(w.shape)}")


def _launch(symbol: str, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if x.dtype == torch.bfloat16 and (cin % 8 or cout % 8):
        raise ValueError(f"{symbol}: bf16 channel counts must be multiples of 8, got Cin={cin} Cout={cout}")
    if x.device.type != "cuda":
        raise ValueError(f"{symbol}: runs on CUDA tensors (CPU tensors take the plain version), got {x.device}")
    if n * h * wd >= 2**31:
        raise ValueError(f"{symbol}: N*H*W = {n * h * wd} pixels does not fit the kernel's int index")
    for t in (x, w):
        if not t.is_contiguous():
            raise ValueError(f"{symbol}: x and w must be contiguous NHWC / HWIO")
        if t.data_ptr() % 16:
            raise ValueError(f"{symbol}: x and w must be 16-byte aligned")
    bias = None if b is None else b.to(x.dtype).contiguous()
    from ._build import load

    fn = getattr(load("conv3x3"), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(0 if x.dtype == torch.bfloat16 else 1, x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, stream)
    if err != 0:
        why = {-1: "unsupported shape", -2: "the CUDA driver refused a TMA tensor map"}.get(
            err, f"CUDA error {err}")
        raise RuntimeError(f"{symbol} failed: {why} at x{tuple(x.shape)} w{tuple(w.shape)} {x.dtype}")
    return out


def _conv(wrapper, symbol: str, x, w, b) -> torch.Tensor:
    _check(x, w, b, wrapper.__name__)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b)
    out = _launch(symbol, x, w, b)
    wrapper.launches += 1
    return out


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's counterpart: each step's halo and weight tiles loaded only after
    the previous step's products are done (bf16), or each (tap, channel
    chunk) tile loaded synchronously (fp32)."""
    return _conv(conv3x3_same, "rd_conv3x3", x, w, b)


def conv3x3_same_db(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's counterpart: the next halo and weight tiles load while the current
    ones are multiplied (bf16: a TMA ring fed by a producer warpgroup; fp32:
    a 2-stage cp.async ring)."""
    return _conv(conv3x3_same_db, "rd_conv3x3_db", x, w, b)


conv3x3_same.launches = 0
conv3x3_same_db.launches = 0

KERNELS = (conv3x3_same, conv3x3_same_db)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
