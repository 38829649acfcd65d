"""The port's three flash-attention kernels (``rollingdepth_torch.ops.flash_attention``).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX Pallas kernels run in interpret mode, at the cases of
``tests/test_attention.py`` (ragged L_q and L_k, max-free and running-max,
d = 64 and d = 512).  fp32 on both sides; tolerance 3e-5, the one
``tests/test_attention.py`` holds the Pallas kernels to against XLA.

The ``cuda`` tests hold each CUDA kernel against its plain version on the
card and skip without one.  JAX is imported inside the tests that use it,
so that on the card (which has no JAX) this file runs its ``cuda`` tests:
``python -m pytest tests/test_torch_flash_attention.py -m cuda --noconftest``."""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rollingdepth_torch.ops import flash_attention as fa

torch.set_num_threads(2)
TOL = dict(rtol=3e-5, atol=3e-5)


def _qkv(b, lq, lk, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32))


@pytest.mark.parametrize("no_max", [True, False], ids=["K1_nomax", "K2_max"])
@pytest.mark.parametrize("lq,lk", [(300, 1537), (1025, 1025), (1024, 4096)])
def test_narrow_plain_matches_pallas_interpret(no_max, lq, lk):
    import jax.numpy as jnp
    from rollingdepth_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(1, lq, lk, 2, 64, seed=lq + lk)
    # the UNet dispatch's Pallas configuration: blocks 512/4096
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 512, 4096, True, no_max)
    wrapper = fa.flash_attention_nomax if no_max else fa.flash_attention_max
    got = wrapper(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("lq,lk,d", [(300, 300, 512), (257, 513, 128)])
def test_wide_plain_matches_pallas_interpret(lq, lk, d):
    import jax.numpy as jnp
    from rollingdepth_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(1, lq, lk, 1, d, seed=d)
    # the VAE dispatch's Pallas configuration: blocks 512/512
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 512, 512, True)
    got = fa.flash_attention_wide(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_wrappers_do_not_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 64, 1, 64, seed=1))
    fa.reset_launch_counts()
    fa.flash_attention_nomax(q, k, v)
    fa.flash_attention_wide(q, k, v)
    assert [fn.launches for fn in fa.KERNELS] == [0, 0, 0]


def test_cpu_wrappers_count_no_cut_launches():
    """A d = 40 bf16 head on the CPU runs the plain version: no launch and no
    cut launch; reset_launch_counts clears the cut counts too."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(1, 64, 64, 2, 40, seed=1))
    fa.flash_attention_nomax.cut_launches = fa.flash_attention_max.cut_launches = 3
    fa.reset_launch_counts()
    fa.flash_attention_nomax(q, k, v)
    fa.flash_attention_max(q, k, v)
    assert [fn.cut_launches for fn in fa.NARROW] == [0, 0]
    assert [fn.launches for fn in fa.NARROW] == [0, 0]


@pytest.mark.parametrize("d", range(32, 128, 8))
def test_product_widths(d):
    """The narrow kernels' product widths for every d the dispatch sends
    them (32 <= d < 128, d % 8 == 0): Q K^T in whole k16 steps, P V one
    8-column block wider than d (its ones column), neither below d nor
    above the padding; d = 64 as padded, and SD1.5's 40 and 80 cut."""
    qk, pv = fa.product_widths(d)
    pad = fa.padded_width(d)
    assert d <= qk <= pad and qk % 16 == 0 and qk - d < 16
    assert d < pv <= pad or d == pv == 64
    cut = max(qk, pv) < pad
    assert cut == (d not in (56, 64, 120))
    assert fa.product_widths(64) == (64, 64)
    assert fa.product_widths(40) == (48, 48) and fa.product_widths(80) == (80, 88)
    assert fa.padded_width(d) == (64 if d <= 64 else 128)


def test_plain_sums_rounded_p_in_bf16():
    """Narrow kernels normalise by the sum of P rounded to v's dtype (the
    TPU kernel's ones column); the wide kernel by the fp32 P."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 32, 64, 1, 64, seed=2))
    a = fa.attention_exp2_reference(q, k, v, sum_rounded=True)
    b = fa.attention_exp2_reference(q, k, v, sum_rounded=False)
    assert a.dtype == torch.bfloat16
    assert (a.float() - b.float()).abs().max() < 2e-2


def test_wrappers_reject_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 16, 16, 1, 64, seed=3))
    with pytest.raises(ValueError):
        fa.flash_attention_nomax(q, k[:, :, :, :32], v)
    with pytest.raises(ValueError):
        fa.flash_attention_wide(q.double(), k.double(), v.double())


# ---- on the card ---------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_on_card(name, q, k, v):
    """One launch of the kernel, within its bound of the plain version:
    bf16 2e-2 of the output scale (P and the output rounded to bf16, exp2
    by the SFU's approximation); fp32 1e-4 (the 3xTF32 kernels against the
    plain version with TF32 off)."""
    wrapper = getattr(fa, f"flash_attention_{name}")
    before = wrapper.launches
    got = wrapper(q, k, v)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    plain = fa.attention_exp2_reference(q, k, v, no_max=name == "nomax", sum_rounded=name != "wide")
    err = (got.float() - plain.float()).abs().max().item()
    scale = plain.float().abs().max().item()
    assert err <= (2e-2 if q.dtype == torch.bfloat16 else 1e-4) * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name,d", [
    ("nomax", 64), ("max", 64), ("wide", 512),  # the main path's heads
    # every other head dim the dispatch can send to a kernel (multiples of
    # 8 in 32..512; SD1.5 uses 40, 80 and 160)
    ("nomax", 32), ("nomax", 40), ("max", 80), ("nomax", 120),
    ("wide", 128), ("wide", 160), ("wide", 256), ("wide", 320),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,lq,lk", [
    (2, 300, 1537), (2, 1024, 1000),
    # the edges of the bf16 tiles: narrow 128 query rows x 128 keys (64
    # for d > 64), wide 64 x 32; L at 1, BK - 1, BK + 1 and 2 * BQ + 1
    (2, 1, 129), (2, 127, 1), (2, 129, 127), (2, 257, 65), (2, 385, 63),
    (2, 1, 33), (2, 31, 1), (2, 33, 31), (2, 129, 33),
    # ragged L (chip_smoke.py's wide case), and three batches: a TMA box
    # must not cross into the next batch
    (2, 1001, 999), (3, 1001, 999),
])
def test_cuda_kernel_matches_plain(name, d, dtype, b, lq, lk):
    dev = _cuda()
    h = 1 if name == "wide" else 4
    q, k, v = (torch.from_numpy(x).to(dev, getattr(torch, dtype)) for x in _qkv(b, lq, lk, h, d, seed=5))
    _check_on_card(name, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["nomax", "max"])
@pytest.mark.parametrize("d", [32, 40, 48, 56, 72, 80, 96, 120])
@pytest.mark.parametrize("lq,lk", [(1380, 5400), (5400, 1380)])
def test_cuda_narrow_at_the_heads_width(name, d, lq, lk):
    """K1 and K2 at the head's width against the same wrapper on q, k and v
    zero-padded to 64 columns (d < 64) or 120 (d > 64; the bf16 narrow
    kernels take d < 128, and 120 runs the 128-column tiles) with the same
    explicit scale.  The scores are equal (the zero columns add exactly 0).
    The outputs differ by one bf16 ulp in about 1e-4 of the elements,
    largest 4.9e-4 (one ulp at 0.06-0.12): the normaliser is the ones
    column of P V, summed by the tensor core in its order, where the padded
    d = 64 run sums it in the threads (the kernel without the ones column
    was bit-equal to the padded run at every d and both lengths).  So: at
    most one ulp apart, on at most 1e-3 of the elements, and within the
    file's bound of the plain version.  A cut launch counts in
    ``cut_launches``."""
    dev = _cuda()
    wrapper = getattr(fa, f"flash_attention_{name}")
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in _qkv(2, lq, lk, 3, d, seed=d + lq))
    scale = d**-0.5
    wide = 64 if d < 64 else 120
    pad = lambda t: torch.nn.functional.pad(t, (0, wide - d)).contiguous()  # noqa: E731
    before, cut_before = wrapper.launches, wrapper.cut_launches
    got = wrapper(q, k, v, scale)
    padded = wrapper(pad(q), pad(k), pad(v), scale)[..., :d]
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert wrapper.cut_launches == cut_before + (max(fa.product_widths(d)) < fa.padded_width(d))
    ulps = (got.view(torch.int16).int() - padded.view(torch.int16).int()).abs()
    assert torch.equal(got.sign(), padded.sign()) and ulps.max().item() <= 1
    assert (ulps > 0).float().mean().item() <= 1e-3
    plain = fa.attention_exp2_reference(q, k, v, scale, no_max=name == "nomax")
    err, ref_scale = (got.float() - plain.float()).abs().max().item(), plain.float().abs().max().item()
    assert err <= 2e-2 * ref_scale, (err, ref_scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d,keys", [(40, 128), (80, 64)])
def test_cuda_exp2_half_runs_under_the_pv(d, keys):
    """K1's steady-state turn at SD1.5's widths, in the built library's SASS:
    every ex2 of a tile (one a score a thread, keys / 2) issues after the
    wait for Q K^T and before the wait for the previous tile's P V, and no
    conversion of the pack comes between them.  Unpinned, ptxas hoists that
    wait above all but one ex2 and the exp2 no longer runs under the P V
    (``schedule_fence``, ``narrow_fenced`` in ``csrc/flash_attn.cu``)."""
    _cuda()
    from rollingdepth_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    _build.load("flash_attn")
    sass = subprocess.run([cuobjdump, "-sass", _build._lib_path("flash_attn")], capture_output=True, text=True,
                          check=True).stdout
    name = f"flash_fwd_narrowILi{d}ELb1ELb1ELb0ELb0E"  # K1: NO_MAX, SUM_ROUNDED
    (block,) = [b for b in sass.split("Function : ") if name in b.split("\n")[0]]
    ops = []
    for line in block.splitlines():
        m = re.search(r"\*/\s+(?:@!?U?P\d\s+)?(MUFU\.EX2|F2FP\S*|WARPGROUP\.DEPBAR\.LE gsb0, 0x[01])", line)
        if m:
            ops.append(m.group(1)[-1] if m.group(1).startswith("WARPGROUP") else m.group(1).split(".")[0])
    waits = [i for i, op in enumerate(ops) if op == "1"]
    assert waits
    for i in waits:
        end = ops.index("0", i)
        assert ops[i + 1:end].count("MUFU") == keys // 2 and "F2FP" not in ops[i + 1:end], ops[i:end + 2]


@pytest.mark.cuda
@pytest.mark.parametrize("name,d", [("nomax", 64), ("max", 40), ("wide", 512), ("wide", 160), ("max", 120)])
@pytest.mark.parametrize("lq,lk", [
    # the fp32 tiles: d <= 64 takes 128 query rows x 64 keys, wider heads
    # 64 x 32; L at 1, BK - 1, BK, BK + 1 and 2 * BQ + 1 of both
    (1, 1), (1, 63), (1, 65), (128, 64), (257, 63), (257, 65),
    (1, 31), (1, 33), (64, 32), (129, 31), (129, 33), (65, 1),
])
def test_cuda_fp32_tile_edges(name, d, lq, lk):
    """The 3xTF32 kernels at the edges of their tiles."""
    dev = _cuda()
    h = 1 if name == "wide" else 3
    q, k, v = (torch.from_numpy(x).to(dev) for x in _qkv(2, lq, lk, h, d, seed=lq * 7 + lk))
    _check_on_card(name, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,lk", [
    ("nomax", (1, 256, 2, 64), 16384), ("max", (1, 256, 2, 64), 16384),
    ("wide", (1, 128, 1, 512), 9216), ("nomax", (1, 130, 1, 512), 9000),
])
def test_cuda_fp32_long_keys(name, shape, lk):
    """fp32 over many key tiles (the paper preset's K1 has 15,552 keys, its
    K3 at res 1024 9,216): the sums of P V stay within 1e-4 of the output
    scale, which one tensor-core accumulator over every key tile does not."""
    dev = _cuda()
    b, lq, h, d = shape
    q, k, v = (torch.from_numpy(x).to(dev) for x in _qkv(b, lq, lk, h, d, seed=lk))
    _check_on_card(name, q, k, v)
