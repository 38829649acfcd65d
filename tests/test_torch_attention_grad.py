"""Gradients through attention: ``flash_attention.FlashAttention`` and the
dispatch's routing under autograd, against the JAX package.

On the CPU each kernel wrapper runs its plain version forward; the
Function's backward is the blocked recompute on every device.  JAX's
``flash_attention`` (a ``custom_vjp``: the Pallas kernel in interpret mode
forward, the VJP of its rematerialized blocked reference backward) is the
reference, at the shape and tolerance of ``tests/test_attention.py``'s
gradient test (atol and rtol 2e-4), plus a multi-block, a ragged and a
wide-head case.  The plain path's gradients are held to ``_xla_attention``'s
and ``_chunked_attention``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.ops import attention as attn
from rollingdepth_torch.ops import flash_attention as fa
from rollingdepth_tpu.ops.attention import _chunked_attention, _xla_attention
from rollingdepth_tpu.ops.flash_attention import flash_attention

torch.set_num_threads(2)

WRAPPERS = {"nomax": fa.flash_attention_nomax, "max": fa.flash_attention_max, "wide": fa.flash_attention_wide}


def _inputs(shape, lk=None, seed=5):
    b, lq, h, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape).astype(np.float32)
    k, v = (rng.standard_normal((b, lk or lq, h, d)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, cot


def _torch_grads(fn, q, k, v, cot):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(cot))
    return out, [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_grads(fn, q, k, v, cot):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * cot), argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("name, shape, lk", [
    ("nomax", (1, 384, 2, 8), None),  # tests/test_attention.py's gradient test
    ("max", (1, 384, 2, 8), None),
    ("wide", (1, 384, 2, 8), None),
    ("nomax", (2, 1100, 2, 8), 700),  # three backward blocks of 512, the last ragged
    ("max", (1, 600, 1, 64), 300),
    ("wide", (1, 520, 1, 256), 300),  # a wide head, two backward blocks
])
def test_function_grads_match_jax_flash(name, shape, lk):
    q, k, v, cot = _inputs(shape, lk)
    out, got = _torch_grads(lambda a, b, c: fa.FlashAttention.apply(WRAPPERS[name], a, b, c, None), q, k, v, cot)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    want = _jax_grads(lambda a, b, c: flash_attention(a, b, c, None, 128, 128, True, name == "nomax"), q, k, v, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_blocked_vjp_is_the_plain_gradient(bf16):
    """``blocked_attention_vjp`` at any block size equals autograd through
    ``plain_attention`` (fp32: to rounding; bf16: within bf16's 2e-2 of
    each gradient's max)."""
    q, k, v, cot = (torch.from_numpy(x) for x in _inputs((2, 700, 3, 16), 650, seed=3))
    if bf16:
        q, k, v, cot = (t.bfloat16() for t in (q, k, v, cot))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    attn.plain_attention(tq, tk, tv).backward(cot)
    for block_q in (128, 512, 1024):
        got = fa.blocked_attention_vjp(q, k, v, None, cot, block_q=block_q)
        for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
            assert g.dtype == w.dtype and g.shape == w.shape
            tol = (2e-2 if bf16 else 1e-5) * w.float().abs().max().item()
            assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.parametrize("shape, lk, chunked", [
    ((1, 384, 2, 8), None, False),
    ((2, 300, 3, 16), 77, False),  # cross-attention-like: few keys
    ((1, 4200, 1, 8), 2100, True),  # past the plain path's 8.4M-score bound: query chunks
])
def test_plain_path_grads_match_jax(shape, lk, chunked):
    q, k, v, cot = _inputs(shape, lk, seed=7)
    assert (shape[1] * (lk or shape[1]) > attn._PLAIN_CHUNK_SCORES and shape[1] > 4096) == chunked
    _, got = _torch_grads(lambda a, b, c: attn.dot_product_attention(a, b, c, use_flash=False), q, k, v, cot)
    ref = _chunked_attention if chunked else _xla_attention
    want = _jax_grads(ref, q, k, v, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=2e-5)


@pytest.fixture
def spies(monkeypatch):
    """Each kernel wrapper replaced by a spy that records its calls and
    answers with the wrapper (the plain version on the CPU)."""
    calls = []
    for name, fn in WRAPPERS.items():
        def spy(q, k, v, scale=None, _fn=fn, _name=name):
            calls.append((_name, torch.is_grad_enabled()))
            return _fn(q, k, v, scale)

        monkeypatch.setattr(fa, f"flash_attention_{name}", spy)
    return calls


@pytest.mark.parametrize("d, gate_open, kernel", [(8, True, "nomax"), (8, False, "max"), (256, True, "wide")])
def test_dispatch_routes_grad_through_the_function(monkeypatch, spies, d, gate_open, kernel):
    """``ROLLINGDEPTH_ATTN=flash``: under autograd the kernel the dispatch
    picks runs inside the Function (grad mode off inside it), and the
    output's ``grad_fn`` is the Function's; with grad mode off, or with
    nothing requiring grad, the bare wrapper answers with no ``grad_fn``."""
    monkeypatch.setenv("ROLLINGDEPTH_ATTN", "flash")
    monkeypatch.setattr(attn, "_NOMAX_ALLOWED", gate_open)
    q, k, v, cot = (torch.from_numpy(x) for x in _inputs((1, 300, 2, d), seed=1))
    tq = q.clone().requires_grad_()
    out = attn.dot_product_attention(tq, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert spies == [(kernel, False)]
    out.backward(cot)
    assert spies == [(kernel, False)]  # the backward calls no wrapper
    ref = q.clone().requires_grad_()
    attn.plain_attention(ref, k, v).backward(cot)
    torch.testing.assert_close(tq.grad, ref.grad, rtol=1e-5, atol=1e-5)

    with torch.no_grad():
        assert attn.dot_product_attention(tq, k, v).grad_fn is None
    assert attn.dot_product_attention(q, k, v).grad_fn is None
    assert spies == [(kernel, False), (kernel, False), (kernel, True)]  # bare calls: grad mode as the caller's
    monkeypatch.setenv("ROLLINGDEPTH_ATTN", "xla")
    assert type(attn.dot_product_attention(tq, k, v).grad_fn).__name__ != "FlashAttentionBackward"
    assert len(spies) == 3


def test_unet_grads_through_the_function_match_the_plain_path(monkeypatch):
    """A small UNet's loss gradients with every self-attention forced onto
    the kernel route (the Function) equal those of the plain path; every
    self-attention projection gets a nonzero gradient."""
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig

    torch.manual_seed(0)
    unet = UNet2DConditionModel(UNetConfig.tiny(in_channels=8), device="cpu")
    x = torch.randn(2, 3, 8, 8, 8)
    ctx = torch.randn(1, 2, 8)
    grads = {}
    for mode in ("flash", "xla"):
        monkeypatch.setenv("ROLLINGDEPTH_ATTN", mode)
        unet.zero_grad(set_to_none=True)
        out = unet(x, torch.tensor([10, 700]), ctx)
        (out ** 2).mean().backward()
        grads[mode] = {n: p.grad.clone() for n, p in unet.named_parameters()}
    for name, g in grads["flash"].items():
        w = grads["xla"][name]
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item() + 1e-12, name
        if ".attn1.to_" in name:
            assert g.abs().max().item() > 0, name
    assert sum(".attn1.to_" in n for n in grads["flash"]) >= 9
