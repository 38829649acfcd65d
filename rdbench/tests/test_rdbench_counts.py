"""The counting functions against hand-worked numbers at small shapes."""

import pytest
import torch
from torch import nn

from rdbench.counts import module_counts, scaled, total
from rdbench.ref.models import Attention


def meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("tokens,long", [(300, True), (100, False)])
def test_one_attention_call(tokens, long):
    with torch.device("meta"):
        attn = Attention(64, heads=2, dim_head=32)
    c = module_counts(attn, lambda: attn(meta(1, tokens, 64)))
    products = 4 * 1 * 2 * tokens * tokens * 32  # QK^T and PV, 2 operations a multiply-add
    projections = 4 * 2 * tokens * 64 * 64  # q, k, v and out
    assert c["flops"] == products + projections
    assert c["attn_flops"] == (products if long else 0)
    assert c["gn_bytes"] == 0


def test_cross_attention_is_not_a_kernel_call():
    with torch.device("meta"):
        attn = Attention(64, heads=2, dim_head=32, cross_dim=16)
    c = module_counts(attn, lambda: attn(meta(1, 512, 64), meta(1, 2, 16)))
    assert c["attn_flops"] == 0
    assert c["flops"] == 4 * 2 * 512 * 2 * 32 + 2 * 2 * 512 * 64 * 64 + 2 * 2 * 2 * 16 * 64


def test_one_norm_input():
    with torch.device("meta"):
        norm = nn.GroupNorm(4, 16)
    x = meta(2, 16, 8, 8)
    assert module_counts(norm, lambda: norm(x))["gn_bytes"] == (2 * x.numel() + 2 * 16) * 2
    assert module_counts(norm, lambda: norm(x), itemsize=4)["gn_bytes"] == (2 * x.numel() + 2 * 16) * 4


def test_one_conv():
    with torch.device("meta"):
        conv = nn.Conv2d(8, 16, 3, padding=1)
    c = module_counts(conv, lambda: conv(meta(1, 8, 10, 10)))
    assert c == {"flops": 2 * 16 * 10 * 10 * 8 * 9, "attn_flops": 0.0, "gn_bytes": 0.0}


def test_scaled_and_total():
    a, b = {"flops": 2.0, "gn_bytes": 1.0}, {"flops": 3.0, "attn_flops": 1.0}
    assert total(scaled(a, 3), b) == {"flops": 9.0, "gn_bytes": 3.0, "attn_flops": 1.0}
