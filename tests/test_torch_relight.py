"""The port's relight stack against the JAX package's: the SD1.5-style UNet,
the prompt encoding, the IC-Light weight transforms, and
``RollingImgPipeline.forward`` with each init mode (``turbo``, ``strides``,
gen-3, gen-2 and SD t2i/i2i: ``test_torch_relight_modes.py``).

Both pipelines are tiny (a 12-channel SD1.5-style UNet with conv
projections and integer heads, its 4-channel base, the tiny VAE, a tiny
CLIP), carry the same weights (``state_dict_from_jax``), run in fp32 on 6
frames of 16x16, and draw the same noise: the port takes a provider
(``JaxNoise``) that computes the JAX pipeline's own PRNG draws, keyed as
it keys them.  A 4-step schedule at strength 0.5 (2 steps executed, 2 t2i
init steps) keeps the JAX compiles short.

Tolerances: the windows before alignment (``snippet_ls``) within 1e-4 of
their scale; R/G/B after 0 solve iterations within 1e-4 and after 1
iteration within 1e-3 (one Adam step moves each window's scale by lr times
its gradient's sign, so a near tie can part the two by ~lr; on these seeds
they stay within 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.io.weights import expand_conv_in, merge_offset, state_dict_from_jax
from rollingdepth_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
from rollingdepth_torch.pipelines import rollingimg as tri
from rollingdepth_torch.schedulers.dpmsolver import DPMSolverConfig, DPMSolverMultistepScheduler
from rollingdepth_tpu.io import weights as jweights
from rollingdepth_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
from rollingdepth_tpu.models.clip_text import CLIPTextModel as JCLIPTextModel
from rollingdepth_tpu.models.unet import UNet2DCondition
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.models.unet import unet_apply
from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig
from rollingdepth_tpu.pipelines import rollingimg as jri
from rollingdepth_tpu.schedulers import dpmsolver as jdpm

torch.set_num_threads(2)

SCHED = dict(algorithm_type="sde-dpmsolver++", use_karras_sigmas=True, steps_offset=1)
STEPS = dict(num_inference_steps=4)
SD15_TINY = dict(cross_attention_dim=16, use_linear_projection=False, attention_head_dim=2)


class FakeTokenizer:
    """Short chunks (7 tokens) so that a long prompt takes several."""

    model_max_length = 7
    bos_token_id = 0
    eos_token_id = 1

    def tokenize_ids(self, text):
        return [2 + (ord(c) % 5) for c in text.replace(" ", "")][:20]


class JaxNoise:
    """The JAX relight pipeline's draws: the shared map from PRNGKey(seed),
    the t2i init from fold_in(key, frame), a step's draw from
    fold_in(fold_in(key, id), step), all NHWC."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def _normal(self, key, shape):
        return np.asarray(jax.random.normal(key, tuple(shape), jnp.float32))

    def shared(self, shape):
        return self._normal(self.key, shape)

    def frames(self, ids, shape):
        return np.stack([self._normal(jax.random.fold_in(self.key, int(i)), shape) for i in ids])

    def steps(self, ids, step, shape):
        return np.stack([self._normal(jax.random.fold_in(jax.random.fold_in(self.key, int(i)), step), shape)
                         for i in ids])


def _unet_pair(in_channels, seed):
    jcfg = dataclasses.replace(JUNetConfig.tiny(in_channels=in_channels), **SD15_TINY)
    params = UNet2DCondition(jcfg).init(jax.random.PRNGKey(seed))
    unet = UNet2DConditionModel(dataclasses.replace(UNetConfig.tiny(in_channels=in_channels), **SD15_TINY),
                                device="cpu")
    unet.load_state_dict(state_dict_from_jax(params))
    return UNet2DCondition(jcfg), params, unet.eval()


def build_pair(snippet_batch=2, pipeline_cls=(jri.RollingImgPipeline, tri.RollingImgPipeline)):
    """(JAX pipeline, port pipeline) with the same weights."""
    j12, p12, t12 = _unet_pair(12, 0)
    j4, p4, t4 = _unet_pair(4, 2)
    vae_params = JAutoencoderKL(JVAEConfig.tiny()).init(jax.random.PRNGKey(1))
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    vae.load_state_dict(state_dict_from_jax(vae_params))
    jclip = JCLIPTextModel(JCLIPTextConfig.tiny())
    clip_params = jclip.init(jax.random.PRNGKey(3))
    clip = CLIPTextModel(CLIPTextConfig.tiny(), device="cpu").eval()
    clip.load_state_dict(state_dict_from_jax(clip_params))
    jpipe = pipeline_cls[0](
        j12, p12, JAutoencoderKL(JVAEConfig.tiny()), vae_params,
        jdpm.DPMSolverMultistepScheduler(jdpm.DPMSolverConfig(**SCHED)), FakeTokenizer(),
        lambda ids: jclip.apply(clip_params, ids), base_unet_params=p4, base_unet=j4, dtype=jnp.float32,
        snippet_batch=snippet_batch)
    tpipe = pipeline_cls[1](
        t12, vae, DPMSolverMultistepScheduler(DPMSolverConfig(**SCHED)), FakeTokenizer(),
        lambda ids: clip(ids), base_unet=t4, dtype=torch.float32, snippet_batch=snippet_batch, device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def frames(n=6, hw=(16, 16), seed=0):
    return np.random.RandomState(seed).rand(n, 3, *hw).astype(np.float32) * 2 - 1


def assert_scaled_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-6))


def run_both(pair, seed=5, iters=0, **kw):
    """forward on both sides with the same inputs and draws."""
    jpipe, tpipe = pair
    fg, bg = frames(), frames(seed=1)
    kw = dict(dict(dilations=[1, 2], cap_dilation=False, coalign_kwargs={"num_iterations": iters}, seed=seed),
              **STEPS, **kw)
    return jpipe.forward(fg, bg, **kw), tpipe.forward(fg, bg, noise=JaxNoise(seed), **kw)


def check_outputs(want, got, rgb_tol=1e-4):
    assert len(got.snippet_ls) == len(want.snippet_ls)
    for g, w in zip(got.snippet_ls, want.snippet_ls):
        assert_scaled_close(g, w, 1e-4)
    for name in ("R_pred", "G_pred", "B_pred"):
        g = getattr(got, name)
        assert g.shape == (6, 1, 16, 16) and np.isfinite(g).all() and g.min() >= 0 and g.max() <= 1
        np.testing.assert_allclose(g, getattr(want, name), rtol=0, atol=rgb_tol, err_msg=name)
    assert_scaled_close(got.aligned_snippet_pred_ls[0], want.aligned_snippet_pred_ls[0], rgb_tol)


# ---- the SD1.5 UNet, prompts, weight transforms


def test_sd15_config_matches_jax():
    for ch in (4, 12):
        assert dataclasses.asdict(UNetConfig.sd15(ch)) == dataclasses.asdict(JUNetConfig.sd15(ch))
    cfg = UNetConfig.sd15()
    assert [c // cfg.heads_at(i) for i, c in enumerate(cfg.block_out_channels)] == [40, 80, 160, 160]


@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])
def test_sd15_style_unet_matches_jax(hw):
    """12 input channels, conv ``proj_in``/``proj_out`` and an integer head
    count; (5, 7) takes odd sizes through the downsamplers.  2e-5 of the
    output scale (fp32 sums in another order)."""
    junet, params, unet = _unet_pair(12, 4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3) + hw + (12,)).astype(np.float32)
    ctx = rng.standard_normal((1, 9, 16)).astype(np.float32)
    apply = jax.jit(lambda p, x, c: unet_apply(p, junet.config, x, jnp.full((2,), 500), c))
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(ctx)))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), 500, torch.from_numpy(ctx)).numpy()
    assert_scaled_close(got, want, 2e-5)


@pytest.mark.parametrize("positive, negative", [("a long prompt with many words to force chunking", "short"),
                                                ("", "bad"), ("one", "")])
def test_encode_prompt_pair_matches_jax(pair, positive, negative):
    jpipe, tpipe = pair
    jc, juc = jri.encode_prompt_pair(jpipe.tokenizer, jpipe.text_apply, positive, negative)
    with torch.no_grad():
        c, uc = tri.encode_prompt_pair(tpipe.tokenizer, tpipe.text_apply, positive, negative)
    assert c.shape == uc.shape == jc.shape and c.shape[1] % 7 == 0
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(uc.numpy(), np.asarray(juc), rtol=2e-5, atol=2e-5)
    inner = tri.encode_prompt_inner(tpipe.tokenizer, tpipe.text_apply, "")
    assert inner.shape == (1, 7, 16)


def test_iclight_weight_transforms_match_jax():
    rng = np.random.default_rng(0)
    sd = {"conv_in.weight": rng.standard_normal((8, 4, 3, 3)).astype(np.float32),
          "conv_in.bias": rng.standard_normal(8).astype(np.float32),
          "down.weight": rng.standard_normal((3, 5)).astype(np.float32)}
    offset = {"conv_in.weight": rng.standard_normal((8, 12, 3, 3)).astype(np.float32),
              "down.weight": rng.standard_normal((3, 5)).astype(np.float32)}
    want = jweights.merge_offset(jweights.expand_conv_in(sd, 12), offset)
    got = merge_offset(expand_conv_in({k: torch.from_numpy(v) for k, v in sd.items()}, 12),
                       {k: torch.from_numpy(v) for k, v in offset.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    padded = expand_conv_in({"conv_in.weight": torch.ones(2, 4, 3, 3)}, 12)["conv_in.weight"]
    assert padded.shape == (2, 12, 3, 3) and not padded[:, 4:].any() and padded[:, :4].all()
    assert expand_conv_in({"conv_in.weight": torch.ones(2, 12, 3, 3)}, 12)["conv_in.weight"].shape[1] == 12


# ---- forward against JAX


@pytest.mark.parametrize("init_mode", ["shared_noise", "t2i", "passthrough"])
def test_forward_init_modes_match_jax(pair, init_mode):
    want, got = run_both(pair, init_mode=init_mode)
    check_outputs(want, got)


def test_forward_init_latents_override_matches_jax(pair):
    override = np.random.default_rng(3).standard_normal((6, 4, 8, 8)).astype(np.float32)
    want, got = run_both(pair, init_mode="t2i", init_latents_override=override)
    check_outputs(want, got)


def test_forward_one_iteration_solve_matches_jax(pair):
    want, got = run_both(pair, iters=1, init_mode="shared_noise", seed=9)
    check_outputs(want, got, rgb_tol=1e-3)


def test_t2i_init_latents_match_jax(pair):
    """The base UNet on each frame alone for t_start steps, from per-frame
    noise: 1e-4 of the latents' scale."""
    jpipe, tpipe = pair
    h = w = 8
    timesteps, sigmas = tpipe.scheduler.schedule(6)
    embeds = np.random.default_rng(4).standard_normal((1, 14, 16)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jpipe.t2i_init_latents(5, h, w, jnp.asarray(embeds), 3, timesteps, sigmas, key, 11, 6)
    chunks = {}
    got = tpipe.t2i_init_latents(5, h, w, torch.from_numpy(embeds), 3, timesteps, sigmas, JaxNoise(11), 6, chunks)
    assert got.shape == (5, h, w, 4) and chunks == {"t2i_unet": 3 * 3}  # 5 frames in chunks of 2, 3 steps
    assert_scaled_close(got.numpy(), np.asarray(want), 1e-4)


def test_independent_of_snippet_batch(pair):
    """Draws keyed by (seed, window or frame id, step): the chunking does
    not change the result.  Also ``keep_snippets=False`` and device
    outputs, and the default (torch.Generator) draws."""
    _, tpipe = pair
    fg, bg = frames(), frames(seed=1)
    kw = dict(dilations=[1, 2], cap_dilation=False, init_mode="t2i", seed=5, coalign_kwargs={"num_iterations": 3},
              **STEPS)
    a = tpipe.forward(fg, bg, **kw)
    try:
        tpipe.snippet_batch = 3
        b = tpipe.forward(fg, bg, **kw)
        # 6 frames: 4 + 2 windows, 2 t2i and 2 window chunks of 3, 2 steps each; 18 window frames decoded
        assert tpipe.last_chunks == {"encode": 4, "t2i_unet": 2 * 2, "unet": 2 * 2, "decode": 5}
    finally:
        tpipe.snippet_batch = 2
    np.testing.assert_allclose(b.R_pred, a.R_pred, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.snippet_ls[1], a.snippet_ls[1], rtol=0, atol=1e-6)
    c = tpipe.forward(fg, bg, keep_snippets=False, fetch_output=False, **kw)
    assert c.snippet_ls is None and c.aligned_snippet_pred_ls is None and torch.is_tensor(c.B_pred)
    np.testing.assert_allclose(c.B_pred.numpy(), a.B_pred, rtol=0, atol=1e-6)
    d = tpipe.forward(fg, bg, **dict(kw, seed=6))
    assert not np.allclose(d.R_pred, a.R_pred)


def test_call_entry_point_and_chunks(pair):
    """``__call__`` on frames at another size resizes them (cv2) to the
    working size; frames already at it go through untouched; the chunk
    counts of 6 frames, dilations [1, 2] (4 + 2 windows) at snippet batch 2;
    the dilation cap (a window of 3 at dilation 2 needs 9 frames)."""
    _, tpipe = pair
    kw = dict(dilations=[1, 2], cap_dilation=False, init_mode="shared_noise", seed=2,
              coalign_kwargs={"num_iterations": 0}, **STEPS)
    fg, bg = frames(), frames(seed=1)
    a = tpipe(input_fg_frames=fg, input_bg_frames=bg, width=16, height=16, **kw)
    assert tpipe.last_chunks == {"encode": 4, "unet": 3 * 2, "decode": 5}
    b = tpipe.forward(fg, bg, **kw)
    np.testing.assert_array_equal(a.R_pred, b.R_pred)
    c = tpipe(input_fg_frames=frames(hw=(20, 24)), input_bg_frames=frames(hw=(20, 24), seed=1), width=16,
              height=16, **kw)
    assert c.G_pred.shape == (6, 1, 16, 16)
    tpipe.forward(fg, bg, **dict(kw, cap_dilation=True))
    assert tpipe.last_chunks["unet"] == 4 * 2  # dilation 2 capped to 1: 4 + 4 windows
    with pytest.raises(ValueError, match="dilations should include 1"):
        tpipe.forward(fg, bg, dilations=[2])
    with pytest.raises(ValueError, match="init_mode"):
        tpipe.forward(fg, bg, dilations=[1], init_mode="nope", **STEPS)
