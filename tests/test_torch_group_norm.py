"""``rollingdepth_torch.ops.group_norm`` on the CPU: the plain version against
JAX, the dispatch, the kernels' statistics arithmetic, and the launch formula.

- (a) ``group_norm_reference`` against ``rollingdepth_tpu.models.layers.group_norm``
  (with and without ``layers.silu``) on the same numpy inputs, bf16 and fp32,
  at the SD widths with 32 groups, with x in NCHW and in channels_last
  memory.  Tolerances: fp32 2e-5 (``tests/test_torch_layers.py``: fp32 sums
  in another order); bf16 rtol 2e-2, atol 5e-2 (the bf16 bound of
  ``tests/test_torch_layers.py::test_group_norm``: one bf16 ulp per rounding
  step on values of order 3), and one bf16 ulp (2^-7) more rtol after the
  silu: JAX's silu rounds after each of its ops, PyTorch's once.
- (b) On the CPU ``layers.group_norm`` gives ``group_norm_reference``'s bits,
  which are the bits of the op-by-op code the port ran before the CUDA pair
  (kept here as ``_before``), so every other port test keeps its numbers.
- (c) The refusals of the CUDA path (x not in channels_last memory, autograd
  recording, a dtype or width the kernels do not take) come from the
  wrapper's own checks, before the library is touched, so they show on CPU
  tensors; a CPU call launches nothing and counts nothing; a call off the
  CPU counts its launch and records its input (``group_norm.inputs``); fp32
  takes ``F.group_norm`` on any device.
- (d) The module imports, and runs on the CPU, where there is no nvcc.
- (e) The GroupNorms of one call of the tiny UNet and VAE, and of a tiny
  bf16 pipeline call, equal ``chip_smoke.py``'s formula for the card's launches.
- The statistics kernel's arithmetic (``csrc/group_norm.cu`` ``gn_stats``,
  ``gn_merge``: per-chunk sums shifted by the chunk's first pixel, channels
  merged into groups, chunks and lanes merged by Chan's formula in a fixed
  order) emulated in fp32: within 1e-5 of float64 statistics, also where
  the mean is 100 standard deviations from 0 (an unshifted sum of squares
  is not); the fused pass with those statistics gives the plain version's
  bits but where a mean or inv rounds to another bf16.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import chip_smoke as cs
import rollingdepth_tpu.models.layers as JL
from rollingdepth_torch.models import layers as TL
from rollingdepth_torch.ops import group_norm as gn

torch.set_num_threads(1)
TOL32 = dict(rtol=2e-5, atol=2e-5)
TOL16 = dict(rtol=2e-2, atol=5e-2)
ULP16 = 2.0**-7
GROUPS = 32


def _inputs(c, hw=(5, 7), n=2, seed=0):
    """x [N, H, W, C] with a per-channel offset and scale, weight and bias [C]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + hw + (c,)).astype(np.float32)
    x = x * (1 + 2 * rng.random(c, dtype=np.float32)) + rng.standard_normal(c).astype(np.float32)
    return x, rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(np.float32)


def _torch_x(x, dtype, channels_last):
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if channels_last else t


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _before(norm, x):
    """``models/layers.py::group_norm`` as the port ran it before the CUDA pair."""
    if x.dtype == torch.float32:
        return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)
    n, c, h, w = x.shape
    g = norm.num_groups
    xg = x.permute(0, 2, 3, 1).reshape(n, h * w, g, c // g)
    var, mean = torch.var_mean(xg.float(), dim=(1, 3), keepdim=True, correction=0)
    inv = torch.rsqrt(var + norm.eps)
    out = ((xg - mean.to(x.dtype)) * inv.to(x.dtype)).reshape(n, h, w, c).permute(0, 3, 1, 2)
    return out * norm.weight.to(x.dtype)[:, None, None] + norm.bias.to(x.dtype)[:, None, None]


# ---- (a) the plain version against JAX


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm_silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 320, 512, 640, 1280])
def test_reference_matches_jax(c, dtype, silu, channels_last):
    x, scale, bias = _inputs(c, seed=c)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    ref = JL.group_norm({"scale": jnp.asarray(scale, jd), "bias": jnp.asarray(bias, jd)}, jnp.asarray(x, jd),
                        num_groups=GROUPS, eps=1e-6)
    if silu:
        ref = JL.silu(ref)
    got = gn.group_norm_reference(_torch_x(x, td, channels_last), torch.from_numpy(scale).to(td),
                                  torch.from_numpy(bias).to(td), GROUPS, 1e-6, silu=silu)
    assert got.dtype == td and got.shape == (x.shape[0], c) + x.shape[1:3]
    if dtype == "float32":
        tol = TOL32
    else:
        tol = dict(TOL16, rtol=TOL16["rtol"] + (ULP16 if silu else 0.0))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref.astype(jnp.float32)), **tol)


# ---- (b) the CPU dispatch keeps its bits


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm_silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_dispatch_is_the_reference_bit_for_bit(dtype, silu, channels_last):
    x, scale, bias = _inputs(320, (6, 9), seed=4)
    td = getattr(torch, dtype)
    norm = nn.GroupNorm(GROUPS, 320, eps=1e-5)
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    norm = norm.to(td)
    xt = _torch_x(x, td, channels_last)
    with torch.no_grad():
        got = TL.group_norm(norm, xt, silu=silu)
        ref = gn.group_norm_reference(xt, norm.weight, norm.bias, GROUPS, 1e-5, silu=silu)
        before = _before(norm, xt)
    assert torch.equal(got, ref)
    assert torch.equal(got, F.silu(before) if silu else before)


def test_resnet_block_silu_moves_into_the_norm(monkeypatch):
    """The ResNet block's norms carry ``silu=True``; its output keeps the bits
    of norm, then ``F.silu``, then conv (the block before this change)."""
    calls = []
    norm = gn.group_norm
    monkeypatch.setattr(gn, "group_norm", lambda *a, **kw: calls.append(kw.get("silu")) or norm(*a, **kw))
    block = TL.init_random_(TL.ResnetBlock2D(16, 32, 8, 4, 1e-5), torch.Generator().manual_seed(0)).to(torch.bfloat16)
    x = torch.randn((2, 16, 5, 6), generator=torch.Generator().manual_seed(1)).bfloat16()
    temb = torch.randn((2, 8), generator=torch.Generator().manual_seed(2)).bfloat16()
    with torch.no_grad():
        got = block(x, temb)
        h = block.conv1(F.silu(_before(block.norm1, x)))
        h = h + block.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = block.conv2(F.silu(_before(block.norm2, h)))
        want = block.conv_shortcut(x) + h
    assert calls == [True, True]
    assert torch.equal(got, want)


# ---- (c) the CUDA path's refusals, by the wrapper's own checks


def _cl(x):
    return x.contiguous(memory_format=torch.channels_last)


def _args(c=64, dtype=torch.bfloat16, grad=False):
    x = torch.randn((2, c, 4, 5)).to(dtype)
    w, b = nn.Parameter(torch.ones(c, dtype=dtype), requires_grad=grad), torch.zeros(c, dtype=dtype)
    return x, w, b


def test_card_path_refuses_nchw_memory():
    x, w, b = _args()
    with torch.no_grad(), pytest.raises(ValueError, match="channels_last"):
        gn._launch(x, w, b, 8, 1e-6, silu=True)


@pytest.mark.parametrize("which", ["x", "weight"])
def test_card_path_refuses_autograd(which):
    x, w, b = _args(grad=which == "weight")
    x = _cl(x).requires_grad_(which == "x")
    with pytest.raises(RuntimeError, match="no backward"):
        gn._launch(x, w, b, 8, 1e-6, silu=False)


def test_card_path_checks_pass_under_no_grad_until_the_device():
    """Under no_grad a channels_last bf16 x passes every check; the first
    refusal is the device (a CPU tensor never reaches the library)."""
    x, w, b = _args(grad=True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        gn._launch(_cl(x), w, b, 8, 1e-6, silu=True)


@pytest.mark.parametrize("case", ["fp32", "fp16", "width"])
def test_card_path_refuses_what_the_kernels_do_not_take(case):
    dtype = {"fp32": torch.float32, "fp16": torch.float16}.get(case, torch.bfloat16)
    x, w, b = _args(c=36 if case == "width" else 64, dtype=dtype)
    with torch.no_grad(), pytest.raises(ValueError, match="bf16" if case != "width" else "multiple of 8"):
        gn._launch(_cl(x), w, b, 4, 1e-6, silu=False)


def test_cpu_call_launches_nothing(monkeypatch):
    monkeypatch.setattr(gn, "_launch", lambda *a, **kw: pytest.fail("a CPU tensor reached the launch"))
    gn.reset_launch_counts()
    x, w, b = _args()
    got = gn.group_norm(x, w, b, 8, 1e-6, silu=True)
    assert gn.group_norm.launches == 0
    assert torch.equal(got, gn.group_norm_reference(x, w, b, 8, 1e-6, silu=True))


def test_card_call_counts_its_launches_by_input(monkeypatch):
    """Off the CPU (a ``meta`` tensor stands in for the card, ``_launch``
    stubbed) each call counts one launch and records its input."""
    monkeypatch.setattr(gn, "_launch", lambda x, *a: (torch.empty_like(x), None, None))
    gn.reset_launch_counts()
    x, w, b = (t.to("meta") for t in _args())
    for silu in (True, False, True):
        assert gn.group_norm(x, w, b, 8, 1e-6, silu=silu).shape == x.shape
    assert gn.group_norm.launches == 3
    assert gn.group_norm.inputs == {(2, 64, 4, 5, 8, 1e-6, True): 2, (2, 64, 4, 5, 8, 1e-6, False): 1}
    gn.reset_launch_counts()
    assert gn.group_norm.launches == 0 and gn.group_norm.inputs == {}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_fp32_takes_f_group_norm_on_any_device(monkeypatch, device):
    """fp32 never reaches the kernels: ``F.group_norm`` (then ``F.silu``)
    on the card as on the CPU, with autograd (training runs fp32)."""
    monkeypatch.setattr(gn, "_launch", lambda *a, **kw: pytest.fail("fp32 reached the launch"))
    gn.reset_launch_counts()
    x, w, b = (t.to(device) for t in _args(dtype=torch.float32))
    w = nn.Parameter(w)
    y = gn.group_norm(x, w, b, 8, 1e-6, silu=True)
    assert y.requires_grad and gn.group_norm.launches == 0
    if device == "cpu":
        assert torch.equal(y, F.silu(F.group_norm(x, 8, w, b, 1e-6)))


@pytest.mark.parametrize("bad", ["shape", "groups"])
def test_wrapper_checks_its_arguments(bad):
    x, w, b = _args()
    if bad == "shape":
        w = w[:-1]
    with pytest.raises(ValueError):
        gn.group_norm(x, w, b, 8 if bad == "shape" else 7, 1e-6)


# ---- (d) no nvcc here


def test_module_imports_and_runs_without_nvcc(tmp_path):
    code = ("import torch; from rollingdepth_torch.ops import group_norm as gn, _build; "
            "x = torch.randn(1, 16, 3, 3).bfloat16(); w = torch.ones(16); "
            "y = gn.group_norm(x, w, w * 0, 4, 1e-6, silu=True); "
            "assert 'group_norm' in _build.SOURCES and _build._lib_path('group_norm').endswith('.so'); "
            "print(y.dtype, gn.group_norm.launches)")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               ROLLINGDEPTH_TORCH_BUILD=str(tmp_path / "build"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["torch.bfloat16", "0"]
    assert not (tmp_path / "build").exists()


# ---- (e) calls per model call and per pipeline call: chip_smoke.py's formula


@pytest.fixture
def counted(monkeypatch):
    calls = []
    norm = gn.group_norm

    def counting(x, *a, **kw):
        calls.append(tuple(x.shape))
        return norm(x, *a, **kw)

    monkeypatch.setattr(gn, "group_norm", counting)
    return calls


def test_tiny_unet_and_vae_norm_calls_match_the_formula(counted):
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig

    gen = torch.Generator().manual_seed(0)
    unet = TL.init_random_(UNet2DConditionModel(UNetConfig.tiny(), device="cpu"), gen).to(torch.bfloat16)
    vae = TL.init_random_(AutoencoderKL(VAEConfig.tiny(), device="cpu"), gen).to(torch.bfloat16)
    with torch.no_grad():
        unet(torch.randn((2, 3, 8, 8, 8)).bfloat16(), 10, torch.randn((1, 2, 8)).bfloat16())
        n_unet = len(counted)
        vae.encode_mean(torch.rand((2, 16, 16, 3)).bfloat16())
        n_enc = len(counted) - n_unet
        vae.decode(torch.randn((2, 8, 8, 4)).bfloat16())
        n_dec = len(counted) - n_unet - n_enc
    assert n_unet == cs.unet_norm_calls(unet.config)
    assert n_enc == cs.vae_norm_calls(vae.config, "encode")
    assert n_dec == cs.vae_norm_calls(vae.config, "decode")


def test_full_width_formula():
    """SD2 and SD1.5 UNets (61 a call) and SD's VAE (22 an encode, 30 a decode)."""
    from rollingdepth_torch.models.unet import UNetConfig
    from rollingdepth_torch.models.vae import VAEConfig

    assert cs.unet_norm_calls(UNetConfig.sd21()) == cs.unet_norm_calls(UNetConfig.sd15(12)) == 61
    assert (cs.vae_norm_calls(VAEConfig(), "encode"), cs.vae_norm_calls(VAEConfig(), "decode")) == (22, 30)


@pytest.mark.parametrize("refine", [0, 1])
def test_tiny_bf16_pipeline_norm_calls_match_the_formula(counted, refine):
    from rollingdepth_torch.tools.multihost_demo import build_pipeline

    pipe = build_pipeline("cpu")
    pipe = type(pipe)(pipe.unet, pipe.vae, pipe.scheduler, pipe.empty_text_embed, dtype=torch.bfloat16,
                      snippet_batch=2, device="cpu")
    frames = (np.random.RandomState(0).rand(8, 3, 32, 48) * 255).astype(np.uint8)
    pipe(input_frames=frames, dilations=[1, 2], cap_dilation=True, refine_step=refine, seed=0, max_vae_bs=4,
         merge_in_latent=True, latent_coalign_kwargs={"num_iterations": 3}, coalign_kwargs={"num_iterations": 3})
    chunks = pipe.last_chunks
    assert chunks["unet"] > 0 and chunks["encode"] > 0 and chunks["decode"] > 0
    assert ("refine_unet" in chunks) == bool(refine)
    assert len(counted) == cs.norm_kernel_launches(pipe, chunks)


# ---- the statistics kernel's arithmetic, emulated


def _chan(a, b):
    """Chan's merge of (count, mean, M2) b into a, elementwise; count 0 is empty."""
    na, ma, qa = a
    nb, mb, qb = b
    n = na + nb
    safe = torch.where(n > 0, n, torch.ones_like(n))
    d = mb - ma
    m = torch.where(nb == 0, ma, torch.where(na == 0, mb, ma + d * (nb / safe)))
    q = torch.where(nb == 0, qa, torch.where(na == 0, qb, qa + qb + d * d * (na * nb / safe)))
    return n, m, q


def _kernel_stats(x, groups, eps):
    """mean and inv [N, G] as gn_stats and gn_merge compute them, in fp32."""
    n, c, h, w = x.shape
    hw, cg = h * w, c // groups
    xs = x.permute(0, 2, 3, 1).reshape(n, hw, c).float()
    per_chunk, chunks = gn.stats_plan(n, hw, c)
    parts = []
    for k in range(chunks):
        seg = xs[:, k * per_chunk : (k + 1) * per_chunk]
        count = seg.shape[1]
        d = seg - seg[:, :1]
        s1, s2 = d.sum(1), (d * d).sum(1)  # [N, C]
        mean_c = seg[:, 0] + s1 / count
        m2_c = torch.clamp(s2 - s1 * (s1 / count), min=0).reshape(n, groups, cg)
        mean_c = mean_c.reshape(n, groups, cg)
        mean_g = mean_c.sum(-1) / cg
        m2_g = m2_c.sum(-1) + count * ((mean_c - mean_g[..., None]) ** 2).sum(-1)
        parts.append((torch.full_like(mean_g, float(count * cg)), mean_g, m2_g))
    empty = (torch.zeros(n, groups), torch.zeros(n, groups), torch.zeros(n, groups))
    lanes = []
    for lane in range(32):
        acc = empty
        for k in range(lane, chunks, 32):
            acc = _chan(acc, parts[k])
        lanes.append(acc)
    off = 16
    while off:
        lanes = [_chan(lanes[i], lanes[i + off]) if i < off else lanes[i] for i in range(32)]
        off //= 2
    cnt, mean, m2 = lanes[0]
    return mean, torch.rsqrt(m2 / cnt + eps)


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("shape", [(2, 128, 27, 48), (3, 320, 9, 16), (1, 960, 7, 12), (4, 80, 13, 1)])
def test_kernel_statistics_arithmetic(shape, offset):
    n, c, h, w = shape
    groups = GROUPS if c % GROUPS == 0 else 8
    gen = torch.Generator().manual_seed(c)
    x = (torch.randn(shape, generator=gen) * (1 + torch.rand((1, c, 1, 1), generator=gen)) + offset).bfloat16()
    mean, inv = _kernel_stats(x, groups, 1e-6)
    x64 = x.double().permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)
    var64, mean64 = torch.var_mean(x64, dim=(1, 3), correction=0)
    std64 = var64.sqrt()
    assert ((mean.double() - mean64).abs() / std64).max() < 1e-5
    assert (inv.double() / torch.rsqrt(var64 + 1e-6) - 1).abs().max() < 1e-5
    if offset:  # an unshifted fp32 sum of squares loses the variance here
        xf = x.float().permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)
        naive = (xf * xf).mean(dim=(1, 3)) - xf.mean(dim=(1, 3)) ** 2
        assert ((naive.double() / var64) - 1).abs().max() > 1e-5


@pytest.mark.parametrize("shape", [(2, 320, 9, 16), (3, 960, 5, 7)])
def test_fused_pass_with_kernel_statistics_gives_the_plain_bits(shape):
    """The pass's rounding chain, fed gn_stats' statistics: the plain version's
    bits wherever the bf16 mean and inv agree with the plain version's."""
    n, c, h, w = shape
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).bfloat16()
    wt, bs = torch.randn(c, generator=gen).bfloat16(), torch.randn(c, generator=gen).bfloat16()
    mean, inv = _kernel_stats(x, GROUPS, 1e-6)
    g = torch.arange(c) // (c // GROUPS)
    m = mean.bfloat16()[:, g][:, :, None, None]
    i = inv.bfloat16()[:, g][:, :, None, None]
    got = ((x - m) * i) * wt[:, None, None] + bs[:, None, None]
    assert torch.equal(gn.apply_reference(x, mean, inv, wt, bs), got)  # chip_smoke.held_norm's exact rule
    ref = gn.group_norm_reference(x, wt, bs, GROUPS, 1e-6)
    xg = x.permute(0, 2, 3, 1).reshape(n, h * w, GROUPS, c // GROUPS)
    var_p, mean_p = torch.var_mean(xg.float(), dim=(1, 3), correction=0)
    same = (mean_p.bfloat16() == mean.bfloat16()) & (torch.rsqrt(var_p + 1e-6).bfloat16() == inv.bfloat16())
    assert same.float().mean() > 0.9
    keep = same[:, g][:, :, None, None].expand_as(x)
    assert torch.equal(got[keep], ref[keep])


@pytest.mark.parametrize("n, hw, c", [(4, 432 * 768, 128), (24, 54 * 96, 320), (24, 7 * 12, 1280), (1, 1, 8),
                                      (3, 37 * 53, 960), (8, 80 * 90, 2560)])
def test_stats_plan_covers_every_pixel_once(n, hw, c):
    rows = gn.block_rows(c)
    per_chunk, chunks = gn.stats_plan(n, hw, c)
    assert per_chunk % rows == 0 and chunks * per_chunk >= hw > (chunks - 1) * per_chunk
    assert n * chunks < gn.STATS_BLOCKS + n
    assert rows * (c // gn.VEC) <= gn.MAX_C // gn.VEC


# ---- tools/profile_fast_path.py: one span a norm chain


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_profile_spans_hold_each_norm_chain_once(dtype):
    """Under ``norm_chain_spans`` each norm of a tiny UNet call, with the silu
    inside it or after it, is one span, counted in the phase it ran in."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.tools import profile_fast_path as pf

    td = getattr(torch, dtype)
    unet = TL.init_random_(UNet2DConditionModel(UNetConfig.tiny(), device="cpu"), torch.Generator().manual_seed(0))
    unet = unet.to(td)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof, pf.norm_chain_spans():
        with record_function("rollingdepth.snippet_infer"):
            unet(torch.randn((1, 3, 8, 8, 8)).to(td), 10, torch.randn((1, 2, 8)).to(td))
        F.silu(torch.randn(2, 3, 4, 4))  # outside every phase
    chain = pf.norm_chain(prof.profiler.kineto_results.events())
    assert chain["snippet_infer"]["calls"] == cs.unet_norm_calls(unet.config)
    assert chain["outside"]["calls"] == 1 and chain["all"]["calls"] == cs.unet_norm_calls(unet.config) + 1
    assert TL.group_norm.__name__ == "group_norm" and F.silu.__name__ == "silu"
