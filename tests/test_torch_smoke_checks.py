"""CPU tests of chip_smoke.py's bf16 check of a kernel against its plain version.

The mean bound must pass bf16 rounding noise and fail an output that lacks
one tile of work: a key tile of attention, which the max bound alone can
pass at long key lengths, or a (tap, 64-channel chunk) of the conv."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
from rollingdepth_torch.ops import conv3x3 as pc
from rollingdepth_torch.ops import flash_attention as fa

SHAPES = [(2, 999, 1, 64), (1, 300, 2, 40)]  # [B, L, H, D]


def _case(shape, no_max):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16() for _ in range(3))
    plain = lambda kk, vv: fa.attention_exp2_reference(q, kk, vv, no_max=no_max)  # noqa: E731
    return q, k, v, plain


@pytest.mark.parametrize("no_max", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_rounding_noise_passes(shape, no_max):
    q, k, v, plain = _case(shape, no_max)
    ref = plain(k, v)
    # the same attention in fp32, rounded once: a kernel with other roundings
    got = fa.attention_exp2_reference(q.float(), k.float(), v.float(), no_max=no_max).bfloat16()
    errs = cs.held_to_plain("noise", got, ref, True, lambda: plain(*cs.drop_key_tile(torch, k, v)))
    assert errs["mean_abs_err"] <= errs["mean_tol"] < errs["dropped_tile_shift"]


@pytest.mark.parametrize("shape", SHAPES)
def test_dropped_key_tile_fails(shape):
    q, k, v, plain = _case(shape, True)
    ref = plain(k, v)
    dropped = plain(*cs.drop_key_tile(torch, k, v))
    assert cs.drop_key_tile(torch, k, v)[0].shape[1] == shape[1] - cs.DROPPED_KEYS
    with pytest.raises(AssertionError):
        cs.held_to_plain("dropped", dropped, ref, True, lambda: dropped)


# ---- the conv kernels (K4, K5): the control drops one (tap, 64-channel chunk)

CONV_SHAPES = [(1, 5, 65, 72, 136), (2, 9, 13, 128, 64)]  # [N, H, W, Cin, Cout]


def _conv_case(shape):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), dtype=np.float32)).bfloat16()
    wt = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * (9 * cin) ** -0.5).bfloat16()
    b = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32)).bfloat16()
    return x, wt, b


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_rounding_noise_passes(shape):
    x, wt, b = _conv_case(shape)
    ref = pc.conv3x3_reference(x, wt, b)
    # the same conv in fp32 with the bias, rounded once: a kernel with other roundings
    got = pc.conv3x3_reference(x.float(), wt.float(), b.float()).bfloat16()
    errs = cs.held_to_plain("noise", got, ref, True, lambda: pc.conv3x3_reference(x, cs.drop_tap_chunk(torch, wt), b))
    assert errs["mean_abs_err"] <= errs["mean_tol"] < errs["dropped_tile_shift"]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_dropped_tap_chunk_fails(shape):
    x, wt, b = _conv_case(shape)
    ref = pc.conv3x3_reference(x, wt, b)
    w_dropped = cs.drop_tap_chunk(torch, wt)
    c0 = (shape[3] - 1) // 64 * 64
    assert not w_dropped[0, 0, c0:].any() and torch.equal(w_dropped[0, 0, :c0], wt[0, 0, :c0])
    assert torch.equal(w_dropped[1:], wt[1:]) and torch.equal(w_dropped[0, 1:], wt[0, 1:])
    dropped = pc.conv3x3_reference(x, w_dropped, b)
    with pytest.raises(AssertionError):
        cs.held_to_plain("dropped", dropped, ref, True, lambda: dropped)
