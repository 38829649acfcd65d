"""CPU tests of chip_smoke.py's bf16 check of a kernel against its plain version.

The mean bound must pass bf16 rounding noise and fail an output that lacks
one key tile, which the max bound alone can pass at long key lengths."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as cs
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
