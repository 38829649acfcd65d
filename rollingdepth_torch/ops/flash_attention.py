"""Flash attention: three hand-written CUDA kernels and their plain versions.

| wrapper                    | CUDA kernel (csrc/flash_attn.cu) | replaces (rollingdepth_tpu/ops/flash_attention.py) |
| -------------------------- | -------------------------------- | -------------------------------------------------- |
| ``flash_attention_nomax``  | ``rd_flash_nomax``               | ``_flash_kernel_packed_nomax`` (K1)                |
| ``flash_attention_max``    | ``rd_flash_max``                 | ``_flash_kernel_packed`` (K2)                      |
| ``flash_attention_wide``   | ``rd_flash_wide``                | ``_flash_kernel_wide`` (K3)                        |

Each wrapper takes ``[B, L, H, D]`` tensors.  On a CUDA tensor it launches
its kernel (building it at first use, ``ops/_build.py``) or raises; on a
CPU tensor it runs ``attention_exp2_reference``, the plain PyTorch version
of the same arithmetic.  Each wrapper counts its launches in ``.launches``;
K1 and K2 count in ``.cut_launches`` those whose products ran narrower than
the head's padding to 64 or 128 columns (``product_widths``).

``FlashAttention`` makes a wrapper differentiable, as the JAX package's
``flash_attention`` ``custom_vjp`` does: the wrapper runs forward and only
q, k and v are saved; the backward recomputes the attention of each
512-row query block in plain PyTorch and differentiates it
(``blocked_attention_vjp``).  No kernel of ours runs in the backward.

What bounds the kernels and what their design does about it is noted at the
top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

LOG2E = 1.4426950408889634

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def attention_exp2_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    no_max: bool = False,
    sum_rounded: bool = True,
    block_q: int = 1024,
    prescale_q: bool = False,
    bf16_scores: bool = False,
) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch, looped over query chunks.

    Scores in fp32 in the log2 domain, ``s = (q.k) * scale * log2(e)``;
    ``p = exp2(s)`` with no max when ``no_max``, else ``exp2(s - rowmax)``;
    P rounded to v's dtype before P.V with fp32 sums; the normaliser sums the
    rounded P when ``sum_rounded`` (narrow kernels) or the fp32 P (wide).

    The sweep variants' roundings (``ops/flash_variants.py``):
    ``prescale_q`` rounds ``q * scale * log2(e)`` to q's dtype and uses the
    score unscaled; ``bf16_scores`` rounds s, and ``s - rowmax``, to bf16,
    and P to bf16."""
    b, lq, h, d = q.shape
    sc = (d**-0.5 if scale is None else scale) * LOG2E
    kf = k.permute(0, 2, 3, 1).float()  # [B, H, D, Lk]
    vf = v.permute(0, 2, 1, 3)  # [B, H, Lk, D]
    out = torch.empty_like(q)
    for i in range(0, lq, block_q):
        qc = q[:, i : i + block_q].permute(0, 2, 1, 3).float()  # [B, H, bq, D]
        if prescale_q:
            qc = (qc * sc).to(q.dtype).float()
        s = torch.matmul(qc, kf)
        if not prescale_q:
            s = s * sc
        if bf16_scores:
            s = s.bfloat16().float()
        if not no_max:
            s = s - s.amax(dim=-1, keepdim=True)
            if bf16_scores:
                s = s.bfloat16().float()
        p32 = torch.exp2(s)
        p = p32.to(torch.bfloat16 if bf16_scores else v.dtype)
        denom = (p.float() if sum_rounded else p32).sum(dim=-1, keepdim=True)
        o = torch.matmul(p.float(), vf.float()) / denom
        out[:, i : i + block_q] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def padded_width(d: int) -> int:
    """Columns a narrow bf16 head takes in the kernels' tiles: 64 or 128."""
    return 64 if d <= 64 else 128


def product_widths(d: int) -> tuple:
    """``(qk_depth, pv_width)``: the widths at which K1 and K2 run their two
    products for a bf16 head of ``d`` columns (``csrc/flash_attn.cu``,
    ``narrow_qk_depth`` and ``narrow_pv_width``).  d = 64 as padded; any other
    d (``max(d, 32)``) contracts Q K^T over d rounded up to 16 and runs P V
    at N = d + 8, column d being the ones that sum the normaliser."""
    d = max(d, 32)
    if d == 64:
        return 64, 64
    return -(-d // 16) * 16, d + 8


def _is_cut(q: torch.Tensor) -> bool:
    d = q.shape[-1]
    return q.dtype == torch.bfloat16 and max(product_widths(d)) < padded_width(d)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: needs q, k, v all bf16 or all fp32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} are not [B, L, H, D]")


def _launch(symbol: str, q, k, v, scale: Optional[float]) -> torch.Tensor:
    from ._build import load

    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{symbol}: inputs must be contiguous [B, L, H, D]")
        if t.data_ptr() % 16:
            raise ValueError(f"{symbol}: inputs must be 16-byte aligned")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d % 8 or d > 512:
        raise ValueError(f"{symbol}: head dim must be a multiple of 8 up to 512, got {d}")
    if b * h > 65535 or lq == 0 or lk == 0:
        raise ValueError(f"{symbol}: unsupported shape {tuple(q.shape)} / L_k={lk}")
    lib = load("flash_attn")
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    # the fp32 kernels' split operands (q, k and v^T as tf32 big and small
    # parts), or a narrow bf16 head's k and v padded to 64 or 128 columns
    lib.rd_flash_scratch_bytes.argtypes = [ctypes.c_int] * 7
    lib.rd_flash_scratch_bytes.restype = ctypes.c_longlong
    dtype = 0 if q.dtype == torch.bfloat16 else 1
    nbytes = lib.rd_flash_scratch_bytes(dtype, int(symbol != "rd_flash_wide"), b, h, lq, lk, d)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    sl = (d**-0.5 if scale is None else scale) * LOG2E
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), b, h, lq, lk, d, sl, stream)
    if err != 0:
        why = {-1: "unsupported shape", -2: "the driver refused a TMA tensor map"}.get(err, f"CUDA error {err}")
        raise RuntimeError(f"{symbol} failed: {why} at q{tuple(q.shape)} L_k={lk} {q.dtype}")
    return o


def flash_attention_nomax(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """K1, max-free: ``p = exp2(s)``.  Contract: |s| < ~120 in the log2
    domain (fp32 exp2 overflows at 128), enforced by ``ops/score_probe.py``.
    The CUDA kernel takes d % 8 == 0 and d < 128 (bf16) or d <= 512 (fp32)."""
    _check(q, k, v, "flash_attention_nomax")
    if q.device.type == "cpu":
        return attention_exp2_reference(q, k, v, scale, no_max=True, sum_rounded=True)
    if q.dtype == torch.bfloat16 and q.shape[-1] >= 128:
        raise ValueError("flash_attention_nomax: bf16 head dim must be < 128; use flash_attention_wide")
    out = _launch("rd_flash_nomax", q, k, v, scale)
    flash_attention_nomax.launches += 1
    flash_attention_nomax.cut_launches += _is_cut(q)
    return out


def flash_attention_max(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """K2, online softmax with a running max, narrow heads (d < 128 bf16)."""
    _check(q, k, v, "flash_attention_max")
    if q.device.type == "cpu":
        return attention_exp2_reference(q, k, v, scale, no_max=False, sum_rounded=True)
    if q.dtype == torch.bfloat16 and q.shape[-1] >= 128:
        raise ValueError("flash_attention_max: bf16 head dim must be < 128; use flash_attention_wide")
    out = _launch("rd_flash_max", q, k, v, scale)
    flash_attention_max.launches += 1
    flash_attention_max.cut_launches += _is_cut(q)
    return out


def flash_attention_wide(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """K3, online softmax with a running max and an fp32 normaliser, for
    wide heads (d <= 512; the VAE mid-block's single d=512 head)."""
    _check(q, k, v, "flash_attention_wide")
    if q.device.type == "cpu":
        return attention_exp2_reference(q, k, v, scale, no_max=False, sum_rounded=False)
    if q.shape[-1] > 512:
        raise ValueError("flash_attention_wide: head dim must be <= 512")
    out = _launch("rd_flash_wide", q, k, v, scale)
    flash_attention_wide.launches += 1
    return out


BWD_BLOCK_Q = 512  # the query block of the JAX package's training dispatch


def blocked_attention_vjp(q, k, v, scale: Optional[float], grad_out: torch.Tensor, block_q: int = BWD_BLOCK_Q):
    """dq, dk, dv of plain attention at ``grad_out``, one query block at a
    time: the VJP of ``_attention_remat_reference`` in
    ``rollingdepth_tpu/ops/flash_attention.py``.  Each block recomputes its
    fp32 scores and softmax, so at most one ``[B, H, block_q, L_k]`` score
    block is live; dk and dv sum over the blocks in fp32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    k, v = k.detach().requires_grad_(), v.detach().requires_grad_()
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        for i in range(0, q.shape[1], block_q):
            qc = q[:, i : i + block_q].detach().requires_grad_()
            logits = torch.einsum("bqhd,bkhd->bhqk", qc.float(), k.float())
            probs = torch.softmax(logits * scale, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
            gq, gk, gv = torch.autograd.grad(out, (qc, k, v), grad_out[:, i : i + block_q])
            dq[:, i : i + block_q] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(wrapper, q, k, v, scale)``: ``wrapper``'s
    output (its kernel on the card) with the blocked plain backward."""

    @staticmethod
    def forward(ctx, wrapper, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return wrapper(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = blocked_attention_vjp(q, k, v, ctx.scale, grad_out)
        return None, dq, dk, dv, None


flash_attention_nomax.launches = 0
flash_attention_max.launches = 0
flash_attention_wide.launches = 0
flash_attention_nomax.cut_launches = 0
flash_attention_max.cut_launches = 0

KERNELS = (flash_attention_nomax, flash_attention_max, flash_attention_wide)
NARROW = (flash_attention_nomax, flash_attention_max)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in NARROW:
        fn.cut_launches = 0
