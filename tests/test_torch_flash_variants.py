"""The port's flash-attention sweep variants (``rollingdepth_torch.ops.flash_variants``).

On the CPU each wrapper runs ``attention_exp2_reference`` with its
variant's roundings.  Each plain version is held against its own Pallas
kernel from ``scripts/bench_flash_variants.py`` (imported by file path),
run under ``pltpu.force_tpu_interpret_mode()`` with the script's default
blocks.  fp32 at ragged (L_q, L_k): tolerance 3e-5, as
``tests/test_torch_flash_attention.py``.  bf16 for the two kernels that
round scores to bf16 (K8, K9 with ``bf16_exp``): 2e-2 of the output scale,
since a score that lands on the other side of a bf16 rounding moves its P
by 2^-8, and the output is rounded to bf16 (measured: up to 1.3e-2).

The ``cuda`` tests hold each CUDA kernel against its plain version on the
card and skip without one.  JAX is imported inside the tests that use it:
``python -m pytest tests/test_torch_flash_variants.py -m cuda --noconftest``."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from rollingdepth_torch.ops import flash_attention as fa
from rollingdepth_torch.ops import flash_variants as fv

torch.set_num_threads(2)
TOL = dict(rtol=3e-5, atol=3e-5)
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "bench_flash_variants.py")

# port wrapper -> (the script's function, its keyword arguments)
PALLAS = {
    "exp2": (fv.flash_exp2, "flash_exp2", {}),                      # K6
    "fused": (fv.flash_fused, "flash_fused", {}),                   # K7
    "bf16": (fv.flash_bf16, "flash_bf16", {}),                      # K8
    "nomax": (fv.flash_nomax, "flash_nomax", {}),                   # K9
    "nomax_bf16_exp": (fv.flash_nomax_bf16_exp, "flash_nomax", {"bf16_exp": True}),  # K9, bf16_exp
    "nomask": (fv.flash_nomask, "flash_nomask", {}),                # K10
}
ENTRY_POINTS = {
    "exp2": "rd_flash_exp2",
    "fused": "rd_flash_max",     # K2's kernel
    "bf16": "rd_flash_bf16",
    "nomax": "rd_flash_nomax",   # K1's kernel
    "nomax_bf16_exp": "rd_flash_nomax_bf16exp",
    "nomask": "rd_flash_nomask",
}


@functools.lru_cache(maxsize=None)
def _script():
    spec = importlib.util.spec_from_file_location("bench_flash_variants_tpu", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(lq, lk, seed, b=1, h=2, d=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32))


def _pallas(name, q, k, v, bf16):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    _, fn_name, kw = PALLAS[name]
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        out = getattr(_script(), fn_name)(*(jnp.asarray(t).astype(dtype) for t in (q, k, v)), **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("name", ["exp2", "fused", "nomax", "nomask"])
@pytest.mark.parametrize("lq,lk", [(300, 1537), (1025, 1025)])
def test_plain_matches_pallas_fp32(name, lq, lk):
    q, k, v = _qkv(lq, lk, seed=lq + lk)
    ref = _pallas(name, q, k, v, bf16=False)
    got = PALLAS[name][0](*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["bf16", "nomax_bf16_exp"])
@pytest.mark.parametrize("lq,lk", [(300, 1537), (1025, 1025)])
def test_plain_matches_pallas_bf16(name, lq, lk):
    q, k, v = _qkv(lq, lk, seed=lq + lk)
    ref = _pallas(name, q, k, v, bf16=True)
    got = PALLAS[name][0](*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_nomax_bf16_exp_keyword_is_the_bf16_exp_kernel():
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(40, 70, seed=4))
    assert torch.equal(fv.flash_nomax(q, k, v, bf16_exp=True), fv.flash_nomax_bf16_exp(q, k, v))
    assert not torch.equal(fv.flash_nomax(q, k, v), fv.flash_nomax_bf16_exp(q, k, v))


@pytest.mark.parametrize("variant,kernel", [
    (fv.flash_fused, fa.flash_attention_max),   # K7 computes what K2 computes
    (fv.flash_nomax, fa.flash_attention_nomax),  # K9 without bf16_exp, K1
], ids=["K7_is_K2", "K9_is_K1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_kernels_compute_the_same_function(variant, kernel, dtype):
    q, k, v = (torch.from_numpy(t).to(dtype) for t in _qkv(70, 130, seed=6))
    assert torch.equal(variant(q, k, v), kernel(q, k, v))


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_wrappers_launch_their_entry_points(name, monkeypatch):
    """A meta tensor stands for the card's: the wrapper takes its kernel
    path, which here records the C entry point instead of launching it.
    flash_fused and flash_nomax launch K2's and K1's kernels."""
    calls = []

    def fake_launch(symbol, q, k, v, scale):
        calls.append(symbol)
        return torch.empty_like(q)

    monkeypatch.setattr(fv, "_launch", fake_launch)
    wrapper = PALLAS[name][0]
    monkeypatch.setattr(wrapper, "launches", 0)
    q = torch.empty((1, 16, 2, 64), dtype=torch.bfloat16, device="meta")
    out = wrapper(q, q, q)
    assert calls == [ENTRY_POINTS[name]] and out.shape == q.shape
    assert wrapper.launches == 1


def test_cpu_wrappers_do_not_count_launches():
    q, k, v = (torch.from_numpy(t) for t in _qkv(32, 48, seed=1))
    fv.reset_launch_counts()
    for fn in fv.KERNELS:
        fn(q.bfloat16(), k.bfloat16(), v.bfloat16())
    fv.flash_nomax(q, k, v, bf16_exp=True)
    assert [fn.launches for fn in fv.KERNELS] == [0] * len(fv.KERNELS)


@pytest.mark.parametrize("name", ["bf16", "nomax_bf16_exp"])
def test_bf16_only_kernels_reject_fp32_off_the_cpu(name, monkeypatch):
    monkeypatch.setattr(fv, "_launch", lambda *a: pytest.fail("launched"))
    q = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="bf16 only"):
        PALLAS[name][0](q, q, q)
    with pytest.raises(ValueError, match="< 128"):
        PALLAS[name][0](*(torch.empty((1, 16, 1, 128), dtype=torch.bfloat16, device="meta"),) * 3)


# ---- on the card ---------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,lq,lk,d", [
    (2, 300, 1537, 64), (2, 1024, 1000, 64), (2, 513, 257, 40), (2, 200, 333, 120),
    # the edges of the tiles: 128 query rows (192 for K8 and K9 with
    # bf16_exp) x 128 keys (64 for d > 64); L at 1, BK - 1, BK + 1, 2 * BQ + 1
    (2, 1, 129, 64), (2, 127, 1, 64), (2, 129, 127, 64), (2, 257, 65, 80), (2, 385, 63, 120),
    # three batches with ragged L: a TMA box must not cross into the next batch
    (3, 1001, 999, 64),
])
def test_cuda_kernel_matches_plain(name, dtype, b, lq, lk, d):
    """bf16: 2e-2 of the output scale (P, scores and the output rounded to
    bf16, exp2 by the SFU's approximation); fp32: 1e-4."""
    dev = _cuda()
    wrapper = PALLAS[name][0]
    q, k, v = (torch.from_numpy(x).to(dev, getattr(torch, dtype)) for x in _qkv(lq, lk, seed=5, b=b, h=3, d=d))
    if dtype == "float32" and name in ("bf16", "nomax_bf16_exp"):
        with pytest.raises(ValueError, match="bf16 only"):
            wrapper(q, k, v)
        return
    before = wrapper.launches
    got = wrapper(q, k, v)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    plain = wrapper(q.cpu(), k.cpu(), v.cpu())
    err = (got.float().cpu() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    assert err <= (2e-2 if dtype == "bfloat16" else 1e-4) * scale, (err, scale)
