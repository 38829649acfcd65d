"""``rollingdepth_torch/ops/quant.py`` (the W8A8 serving mode) against
``rollingdepth_tpu/ops/quant.py`` and the W8A8 branch of its layers, on the CPU.

Tolerances:
- ``QuantLinear``/``QuantConv2d`` against JAX's W8A8 ``linear``/``conv2d``:
  bit for bit, from the same int8 operands and from the same float inputs
  (fp32 and bf16).  The quantisation is elementwise IEEE arithmetic (a max,
  one division, round half to even), the product is exact in int32, and
  the dequantisation multiplies in JAX's order;
- the weight bridge against the port's own ``quantize_unet_`` of the same
  float weights: every int8 weight within 1 LSB and at most 0.1% of them
  off by one (none is, on these fixtures); the scales equal;
- the quantized tiny UNet (SD2's linear and SD1.5's 1x1-conv projections)
  against JAX's quantized UNet: 2e-5 of the output scale, the float UNet
  test's bound (fp32 sums in another order).  A rounding of x / scale that
  flips between the two costs one int8 step, ~1% of that activation's
  range, and would show far above it; none does here;
- the quantized depth pipeline (``tests/test_quant.py``'s setup) against
  JAX's W8A8 pipeline: JAX's own bounds for a quantized UNet on the
  windows (correlation above 0.99, rms difference below 0.1 of the spread)
  and a depth correlation above 0.999 after one co-alignment iteration,
  since a rounding flip between the two cascades (the test says how far);
  and JAX's drift bound against the float pipeline, correlation above 0.95.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rollingdepth_torch.io.weights import quant_state_dict_from_jax, state_dict_from_jax
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
from rollingdepth_torch.ops.quant import (
    QuantConv2d,
    QuantLinear,
    apply_quantize,
    dequantize,
    int8_matmul,
    quantize_activation,
    quantize_unet_,
    quantize_weight,
    to_compute_dtype_,
)
from rollingdepth_torch.pipelines.rollingdepth import RollingDepthPipeline, unet_chunks
from rollingdepth_torch.pipelines.snippets import snippet_index_matrix
from rollingdepth_torch.schedulers.ddim import DDIMConfig, DDIMScheduler
from rollingdepth_tpu.models import layers as JL
from rollingdepth_tpu.models.unet import UNet2DCondition
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig
from rollingdepth_tpu.ops import quant as jq
from rollingdepth_tpu.pipelines.rollingdepth import RollingDepthPipeline as JRollingDepthPipeline
from rollingdepth_tpu.schedulers.ddim import DDIMConfig as JDDIMConfig
from rollingdepth_tpu.schedulers.ddim import DDIMScheduler as JDDIMScheduler

torch.set_num_threads(2)
DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- the layers


@pytest.mark.parametrize("jdt, tdt", DTYPES, ids=["fp32", "bf16"])
def test_linear_matches_jax_bit_for_bit(jdt, tdt):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((24, 16)) * 0.3).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((4, 7, 16)).astype(np.float32)
    qp = jq.quantize_linear_params({"kernel": jnp.asarray(w.T, jdt), "bias": jnp.asarray(b, jdt)})
    jx = jnp.asarray(x, jdt)
    lin = nn.Linear(16, 24)
    lin.weight.data, lin.bias.data = torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt)
    ql = QuantLinear.from_float(lin)
    assert ql.weight_q.dtype == torch.int8 and ql.w_scale.dtype == torch.float32
    np.testing.assert_array_equal(ql.weight_q.numpy().T, np.asarray(qp["kernel_q"]))
    np.testing.assert_array_equal(ql.w_scale.numpy(), np.asarray(qp["w_scale"]))

    # the same int8 operands: the int32 product and the dequantisation
    xq, sx = jq.quantize_activation(jx)
    acc = int8_matmul(torch.from_numpy(np.array(xq).reshape(-1, 16)), ql.weight_q)
    got = dequantize(acc, torch.tensor(np.asarray(sx)), ql.w_scale, tdt) + ql.bias.to(tdt)
    np.testing.assert_array_equal(got.float().numpy().reshape(4, 7, 24), _np(JL.linear(qp, jx)))
    # the same float input: the activation's quantisation too
    tq, tsx = quantize_activation(torch.from_numpy(x).to(tdt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(xq))
    assert tsx.item() == float(sx)
    np.testing.assert_array_equal(ql(torch.from_numpy(x).to(tdt)).float().numpy(), _np(JL.linear(qp, jx)))


@pytest.mark.parametrize("jdt, tdt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("ci, co, k, stride, pad, hw", [
    (8, 12, 3, 1, 1, (9, 9)),  # a resnet conv
    (5, 12, 3, 2, 1, (9, 8)),  # a downsampler; K = 45 pads to a multiple of 8
    (8, 16, 1, 1, 0, (3, 4)),  # a shortcut or SD1.5 projection; 24 rows pad past 16
    (16, 8, 3, 1, 1, (2, 3)),
], ids=["3x3", "stride2", "1x1", "few_rows"])
def test_conv_matches_jax_bit_for_bit(jdt, tdt, ci, co, k, stride, pad, hw):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((co, ci, k, k)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, ci) + hw).astype(np.float32)
    qp = jq.quantize_conv_params({"kernel": jnp.asarray(w.transpose(2, 3, 1, 0), jdt), "bias": jnp.asarray(b, jdt)})
    ref = _np(JL.conv2d(qp, jnp.asarray(x.transpose(0, 2, 3, 1), jdt), stride=stride, padding=pad))
    conv = nn.Conv2d(ci, co, k, stride=stride, padding=pad)
    conv.weight.data, conv.bias.data = torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt)
    qc = QuantConv2d.from_float(conv)
    np.testing.assert_array_equal(qc.weight_q.numpy().transpose(2, 3, 1, 0), np.asarray(qp["kernel_q"]))
    got = qc(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy().transpose(0, 2, 3, 1), ref)


def test_im2col_chunks_give_the_same_result(monkeypatch):
    """A conv whose im2col is built a few images at a time equals the one-shot product."""
    from rollingdepth_torch.ops import quant

    conv = QuantConv2d.from_float(nn.Conv2d(8, 8, 3, padding=1))
    x = torch.randn(5, 8, 6, 7, generator=torch.Generator().manual_seed(0))
    whole = conv(x)
    monkeypatch.setattr(quant, "IM2COL_BYTES", 2 * 6 * 7 * 9 * 8)  # two images a chunk
    torch.testing.assert_close(conv(x), whole, rtol=0, atol=0)


def test_quantisation_grid():
    """Symmetric: -x quantizes to -q(x); weights per output channel, clipped to +-127."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(2))
    q, s = quantize_activation(x)
    nq, ns = quantize_activation(-x)
    assert torch.equal(nq, -q) and s == ns and q.abs().max() == 127
    wq, ws = quantize_weight(torch.randn(4, 3, 3, 3))
    assert wq.dtype == torch.int8 and ws.shape == (4,) and (wq.reshape(4, -1).abs().amax(1) == 127).all()


# ---- the UNet


def _unet_pair(**overrides):
    jcfg = dataclasses.replace(JUNetConfig.tiny(), **overrides)
    params = UNet2DCondition(jcfg).init(jax.random.PRNGKey(0))
    unet = UNet2DConditionModel(dataclasses.replace(UNetConfig.tiny(), **overrides), device="cpu")
    unet.load_state_dict(state_dict_from_jax(params))
    return UNet2DCondition(jcfg), params, unet.eval()


@pytest.mark.parametrize("overrides, hw", [
    ({}, (8, 8)),
    ({}, (7, 9)),  # odd latent: the upsampler materialises nearest to the skip's size
    ({"use_linear_projection": False}, (6, 10)),  # SD1.5: 1x1-conv projections
], ids=["sd2", "sd2_odd", "sd15"])
def test_quantized_unet_matches_jax(overrides, hw):
    junet, params, unet = _unet_pair(**overrides)
    qparams = jq.quantize_unet_params(params)
    quantize_unet_(unet)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3) + hw + (8,)).astype(np.float32)
    ctx = rng.standard_normal((1, 2, 8)).astype(np.float32)
    t = np.array([1, 999])
    ref = np.asarray(junet.apply(qparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    # W8A8 is not the float UNet: the drift is the quantisation's, far above the bound
    fp = np.asarray(junet.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    assert np.abs(fp - ref).max() > 100 * 2e-5 * np.abs(ref).max()


@pytest.mark.parametrize("overrides", [{}, {"use_linear_projection": False}], ids=["sd2", "sd15"])
def test_weight_bridge_matches_quantize_unet(overrides):
    """``quant_state_dict_from_jax`` of JAX's W8A8 tree against the port's
    own ``quantize_unet_`` of the same float weights: the same parameter
    names, dtypes and shapes; int8 within 1 LSB (at most 0.1% off by one)."""
    _, params, unet = _unet_pair(**overrides)
    bridged = quant_state_dict_from_jax(jq.quantize_unet_params(params))
    own = quantize_unet_(unet).state_dict()
    assert set(bridged) == set(own)
    off = total = 0
    for name, t in own.items():
        b = bridged[name]
        assert (b.dtype, b.shape) == (t.dtype, t.shape), name
        if t.dtype == torch.int8:
            d = (b.int() - t.int()).abs()
            assert d.max() <= 1, name
            off, total = off + int((d > 0).sum()), total + d.numel()
        else:
            torch.testing.assert_close(b, t, rtol=0, atol=0, msg=name)
    assert off <= 1e-3 * total
    # and it loads into a quantized UNet
    fresh = quantize_unet_(UNet2DConditionModel(dataclasses.replace(UNetConfig.tiny(), **overrides), device="cpu"))
    fresh.load_state_dict(bridged)
    with pytest.raises(ValueError, match="kernel_q"):
        quant_state_dict_from_jax(params)


def test_untouched_layers_keep_float_weights():
    """conv_in, conv_out, the time embedding, every ``time_emb_proj`` and the
    norms stay float, as JAX leaves them; what is quantized is JAX's list."""
    _, params, unet = _unet_pair()
    quantize_unet_(unet)
    for name, m in unet.named_modules():
        if name in ("conv_in", "conv_out") or name.startswith("time_embedding.") or name.endswith("time_emb_proj"):
            assert type(m) in (nn.Conv2d, nn.Linear), name
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            assert m.weight.dtype == torch.float32
    jax_quantized = {k[: -len(".weight_q")] for k in quant_state_dict_from_jax(jq.quantize_unet_params(params))
                     if k.endswith(".weight_q")}
    port_quantized = {n for n, m in unet.named_modules() if isinstance(m, (QuantLinear, QuantConv2d))}
    assert port_quantized == jax_quantized
    assert apply_quantize(unet, "none") is unet
    with pytest.raises(ValueError, match="int4"):
        apply_quantize(unet, "int4")


def test_compute_dtype_cast_keeps_int8_and_fp32_scales():
    _, _, unet = _unet_pair()
    to_compute_dtype_(quantize_unet_(unet), "cpu", torch.bfloat16)
    for name, p in unet.named_parameters():
        if name.endswith("weight_q"):
            assert p.dtype == torch.int8, name
        elif name.endswith("w_scale"):
            assert p.dtype == torch.float32, name
        else:
            assert p.dtype == torch.bfloat16, name


# ---- the pipeline


def test_unet_chunks_follow_jax():
    """A W8A8 UNet's windows are grouped as the JAX pipelines group them:
    chunks of ``snippet_batch``, a remainder of at most 8 in chunks of 4
    when the chunk is larger than 4, one chunk under ``snippet_batch``
    windows.  A float UNet's take the fewest calls."""
    assert unet_chunks(68, 8, True) == [(i, i + 8) for i in range(0, 64, 8)] + [(64, 68)]  # fast, 60 frames
    assert unet_chunks(14, 8, True) == [(0, 8), (8, 12), (12, 14)]
    assert unet_chunks(25, 8, True) == [(0, 8), (8, 16), (16, 24), (24, 25)]
    assert unet_chunks(6, 8, True) == [(0, 6)] and unet_chunks(7, 4, True) == [(0, 4), (4, 7)]
    # relight splits the tail only where that saves padded windows, and up to 128 windows
    assert unet_chunks(21, 16, True, relight=True) == [(0, 16), (16, 20), (20, 21)]
    assert unet_chunks(14, 8, True, relight=True) == [(0, 8), (8, 14)]  # no window saved: uniform
    assert unet_chunks(133, 16, True, relight=True)[-1] == (128, 133)
    for relight in (False, True):
        assert unet_chunks(14, 8, relight=relight) == [(0, 8), (8, 14)]
        assert unet_chunks(25, 8, relight=relight) == [(0, 8), (8, 16), (16, 24), (24, 25)]
        assert unet_chunks(6, 8, relight=relight) == [(0, 6)]


def _pipelines(snippet_batch):
    """``tests/test_quant.py``'s pipeline setup on both sides, W8A8."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jcfg = JUNetConfig.tiny(in_channels=8)
    params = UNet2DCondition(jcfg).init(k1)
    vae_params = JAutoencoderKL(JVAEConfig.tiny()).init(k2)
    text = np.asarray(jax.random.normal(k3, (1, 2, 8), dtype=jnp.float32))
    sched = dict(beta_schedule="scaled_linear", timestep_spacing="trailing", prediction_type="epsilon")
    jpipes = [JRollingDepthPipeline(UNet2DCondition(jcfg), p, JAutoencoderKL(JVAEConfig.tiny()), vae_params,
                                    JDDIMScheduler(JDDIMConfig(**sched)), jnp.asarray(text), dtype=jnp.float32,
                                    snippet_batch=snippet_batch)
              for p in (params, jq.quantize_unet_params(params))]
    tpipes = []
    for quantize in (None, "w8a8"):
        unet = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
        unet.load_state_dict(state_dict_from_jax(params))
        vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
        vae.load_state_dict(state_dict_from_jax(vae_params))
        tpipes.append(RollingDepthPipeline(apply_quantize(unet, quantize), vae, DDIMScheduler(DDIMConfig(**sched)),
                                           torch.from_numpy(text.copy()), dtype=torch.float32,
                                           snippet_batch=snippet_batch, device="cpu"))
    return jpipes, tpipes


def _drift(got, ref):
    """(correlation, rms of the difference over the reference's std): the
    drift measures of ``tests/test_quant.py``."""
    got, ref = np.asarray(got).ravel(), np.asarray(ref).ravel()
    return np.corrcoef(got, ref)[0, 1], np.sqrt(((got - ref) ** 2).mean()) / (ref.std() + 1e-12)


@pytest.mark.parametrize("n_frames, snippet_batch", [(8, 4), (16, 8)], ids=["test_quant_setup", "mixed_tail"])
def test_quantized_pipeline_matches_jax(n_frames, snippet_batch):
    """8 frames (6 windows, chunks 4 + 2) and 16 frames at snippet_batch 8
    (14 windows: JAX's chunks 8 + 4 + 2, which the port takes, so that each
    call's activation scales span the same windows).

    The UNet alone agrees with JAX's to 2e-5 (above), but a pipeline's UNet
    sees inputs that differ from JAX's by fp32 sum order (1e-7), and one
    rounding of x / scale that flips between the two moves an activation by
    one int8 step, which flips more roundings downstream.  So the windows
    are held to JAX's bounds for
    a quantized UNet (``tests/test_quant.py``: correlation above 0.99, rms
    difference below 0.1 of the reference's spread), and the depth after one
    co-alignment iteration to a correlation above 0.999 and 0.05 absolute
    on [-1, 1]; then JAX's pipeline bound, the W8A8 depth's correlation with
    the float pipeline's above 0.95."""
    (_, jw8), (tfp, tw8) = _pipelines(snippet_batch)
    rng = np.random.RandomState(0)
    frames = rng.rand(n_frames, 3, 32, 32).astype(np.float32) * 2 - 1
    noise = np.random.default_rng(1).standard_normal((4, 16, 16)).astype(np.float32)
    qp = tw8.unet.down_blocks[0].resnets[0].conv1
    assert qp.weight_q.dtype == torch.int8 and qp.w_scale.dtype == torch.float32
    kw = dict(dilations=[1], init_noise=noise, coalign_kwargs={"num_iterations": 1})
    ref = jw8.forward(frames, **kw).depth_pred
    got = tw8.forward(frames, **kw).depth_pred
    assert got.shape == ref.shape == (n_frames, 1, 32, 32) and np.isfinite(got).all()
    assert tw8.last_chunks["unet"] == len(unet_chunks(n_frames - 2, snippet_batch, True))
    corr, _ = _drift(got, ref)
    assert corr > 0.999 and np.abs(got - ref).max() < 0.05
    # the windows: JAX's snippet denoise on the port's frame latents
    windows = torch.cat(tw8.last_window_latents).numpy()
    with torch.no_grad():
        lat = tw8._encode(torch.from_numpy(frames).permute(0, 2, 3, 1), 4, {})
    idx = snippet_index_matrix(n_frames, 3, 1)
    jwin = np.asarray(jw8._infer_snippets(jnp.asarray(lat.numpy()), jnp.asarray(noise.transpose(1, 2, 0)), idx, 1))
    corr, rel_rms = _drift(windows, jwin)
    assert corr > 0.99 and rel_rms < 0.1, (corr, rel_rms)
    fp = tfp.forward(frames, dilations=[1], init_noise=noise).depth_pred
    w8 = tw8.forward(frames, dilations=[1], init_noise=noise).depth_pred
    assert _drift(w8, fp)[0] > 0.95
