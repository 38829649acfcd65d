"""The W8A8 products on the card (``-m cuda``; every test skips without one).

``torch._int_mm`` on CUDA (cuBLASLt) wants more than 16 rows and K and N
multiples of 8, which the CPU's does not; ``ops/quant.py`` pads with zeros.
Each case holds the card's int32 product, and a whole ``QuantLinear``/
``QuantConv2d`` in bf16, bit for bit against the CPU on the same operands:
int32 sums are exact and the dequantisation is the same IEEE arithmetic.

The card's machine has no JAX: ``python -m pytest tests/test_torch_quant_cuda.py -m cuda --noconftest``.
"""

import pytest
import torch
from torch import nn

from rollingdepth_torch.ops.quant import QuantConv2d, QuantLinear, int8_conv_chunks, int8_matmul


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(5, 16, 24), (40, 45, 24), (3 * 54 * 96, 320, 2560), (154, 1024, 322)],
                         ids=["few_rows", "k_45", "geglu_l0", "n_322"])
def test_cuda_int8_matmul_is_exact(m, k, n):
    _card()
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    got = int8_matmul(a.cuda(), w.cuda()).cpu()
    assert got.dtype == torch.int32 and torch.equal(got.long(), a.long() @ w.long().t())


@pytest.mark.cuda
@pytest.mark.parametrize("ci, co, k, stride, pad, hw", [(320, 320, 3, 1, 1, (54, 96)), (5, 12, 3, 2, 1, (9, 8)),
                                                         (8, 16, 1, 1, 0, (3, 4))], ids=["l0", "stride2", "1x1"])
def test_cuda_quantized_layers_equal_the_cpus(ci, co, k, stride, pad, hw):
    _card()
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (2,) + hw + (ci,), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (co, ci, k, k), generator=gen, dtype=torch.int8)
    card = torch.cat([a for _, a in int8_conv_chunks(x.cuda(), wq.cuda(), stride, pad)]).cpu()
    host = torch.cat([a for _, a in int8_conv_chunks(x, wq, stride, pad)])
    assert torch.equal(card, host)

    conv = QuantConv2d.from_float(nn.Conv2d(ci, co, k, stride=stride, padding=pad).to(torch.bfloat16))
    lin = QuantLinear.from_float(nn.Linear(ci, co).to(torch.bfloat16))
    xf = torch.randn((2, ci) + hw, generator=gen).to(torch.bfloat16)
    tokens = torch.randn((2, 7, ci), generator=gen).to(torch.bfloat16)
    assert torch.equal(conv.cuda()(xf.cuda().contiguous(memory_format=torch.channels_last)).cpu(),
                       conv.cpu()(xf))
    assert torch.equal(lin.cuda()(tokens.cuda()).cpu(), lin.cpu()(tokens))
