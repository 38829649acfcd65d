"""The sharded UNet on the card (``-m cuda``; every test skips without one).

Two ranks of a (1, 2) mesh share the one card over gloo (NCCL refuses two
ranks on one device, ``parallel/multihost.py``): a UNet whose
self-attention takes K1 (d = 64) as a tp shard against the same UNet
whole, within 2e-2 (bf16) or 1e-4 (fp32, TF32 off) of the output's max
|value|, with the same kernel launches (each rank runs its local heads).

The card's machine has no JAX: ``python -m pytest tests/test_torch_parallel_cuda.py -m cuda --noconftest``.
"""

import pytest
import torch

import torch_parallel_ranks as R
from rollingdepth_torch.parallel.launch import run_ranks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [("bfloat16", 2e-2), ("float32", 1e-4)])
def test_cuda_tp_unet_matches_whole(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ranks = run_ranks(R.cuda_tp_rank, 2, args=(dtype,), timeout=300)
    for r in ranks:
        assert r["backend"] == ("gloo" if torch.cuda.device_count() < 2 else "nccl")
        err = (r["shard"] - r["whole"]).abs().max().item()
        assert err <= tol * r["whole"].abs().max().item(), err
        assert r["shard_launches"] == r["whole_launches"]
        assert r["whole_launches"]["flash_attention_nomax"] > 0
