"""The operand split of the fp32 attention kernels (3xTF32), emulated in
plain PyTorch on the CPU.

The kernels (``rollingdepth_torch/csrc/flash_attn.cu``) split each fp32
operand x into big = x with its low 13 mantissa bits cleared (a tf32 value)
and small = x - big, and take each product as big.big + big.small +
small.big on the tensor cores, which read only the top 19 bits of an
operand (so small is cut to tf32 too).  This emulation does the same with
bit masks on the int32 view, for Q K^T and for P V, and holds the result
against ``attention_exp2_reference`` in fp32 at a K1-like (d = 64) and a
K3-like (d = 512) shape: 3xTF32 stays within 1e-4 of the output's scale,
the bound the card-side tests and ``chip_smoke.py`` hold the kernels to,
with a margin of 10x; one tf32 product (1xTF32) does not."""

import numpy as np
import pytest
import torch

from rollingdepth_torch.ops.flash_attention import LOG2E, attention_exp2_reference

torch.set_num_threads(2)
BOUND = 1e-4  # of the output's scale
MARGIN = 10.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x with the low 13 mantissa bits cleared (0xFFFFE000 as int32 is -8192)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the tensor cores see it: 3 terms of the split, or 1 of tf32."""
    ab, bb = tf32(a), tf32(b)
    if terms == 1:
        return ab @ bb
    return tf32(a - ab) @ bb + ab @ tf32(b - bb) + ab @ bb


def attention_tf32(q, k, v, no_max: bool, terms: int) -> torch.Tensor:
    """The exp2 attention of the kernels with both products on tf32 parts."""
    d = q.shape[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, L, D]
    s = product(qh, kh.transpose(-1, -2), terms) * (d**-0.5 * LOG2E)
    if not no_max:
        s = s - s.amax(-1, keepdim=True)
    p = torch.exp2(s)
    o = product(p, vh, terms) / p.sum(-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


@pytest.mark.parametrize("no_max", [True, False], ids=["nomax", "max"])
@pytest.mark.parametrize("shape,lk", [((1, 256, 2, 64), 1000), ((1, 200, 1, 512), 300)], ids=["K1_d64", "K3_d512"])
def test_three_terms_meet_the_fp32_bound_and_one_does_not(shape, lk, no_max):
    rng = np.random.default_rng(shape[-1] + lk)
    b, lq, h, d = shape
    q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, lk, h, d)).astype(np.float32)) for _ in range(2))
    ref = attention_exp2_reference(q, k, v, no_max=no_max, sum_rounded=False)
    bound = BOUND * ref.abs().max().item()
    err3 = (attention_tf32(q, k, v, no_max, 3) - ref).abs().max().item()
    err1 = (attention_tf32(q, k, v, no_max, 1) - ref).abs().max().item()
    assert err3 <= bound / MARGIN, (err3, bound)
    assert err1 > bound, (err1, bound)


def test_split_is_exact():
    """big + small == x bit for bit, big is a tf32 value, |small| < 2^-10 |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32) * 1e3)
    big = tf32(x)
    small = x - big
    assert torch.equal(big + small, x)
    assert torch.equal(tf32(big), big)
    assert (small.abs() < x.abs() * 2.0**-10).all()
