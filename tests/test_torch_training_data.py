"""``rollingdepth_torch.training_data`` against
``rollingdepth_tpu.training_data``: on the same clips through the same
encoder (JAX's tiny VAE), the windows, ``steps_per_epoch``, the epoch
order and every batch are equal exactly; the port's own encoder
(``vae_encode_fn``, weights carried by ``state_dict_from_jax``) within 2e-5
of the latents' scale; and two train steps over each package's batches
give the same loss and grad_norm (rtol 1e-5 and 1e-4, JAX's draws passed
to the port)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.io.weights import state_dict_from_jax
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
from rollingdepth_torch.schedulers.ddim import DDIMConfig, DDIMScheduler
from rollingdepth_torch.training import TrainConfig, make_train_step
from rollingdepth_torch.training_data import SnippetDataConfig, SnippetLatentDataset, vae_encode_fn
from rollingdepth_tpu import training as jt
from rollingdepth_tpu import training_data as jtd
from rollingdepth_tpu.models.unet import UNet2DCondition
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig
from rollingdepth_tpu.schedulers.ddim import DDIMConfig as JDDIMConfig
from rollingdepth_tpu.schedulers.ddim import DDIMScheduler as JDDIMScheduler

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vaes():
    jvae = JAutoencoderKL(JVAEConfig.tiny())
    params = jvae.init(jax.random.PRNGKey(1))
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    vae.load_state_dict(state_dict_from_jax(params))
    jax_encode = jax.jit(lambda frames: jvae.encode_mean(params, frames))
    return jax_encode, vae.eval()


def _clips(frames=(10, 10), h=16, w=16, seed=0):
    rng = np.random.RandomState(seed)
    rgb = [rng.rand(n, 3, h, w).astype(np.float32) * 2 - 1 for n in frames]
    dep = [rng.rand(n, 1, h, w).astype(np.float32) * 2 - 1 for n in frames]
    return rgb, dep


def _pair(jax_encode, config, frames):
    """Both datasets over the same clips, both through JAX's encoder."""
    rgb, dep = _clips(frames)
    jds = jtd.SnippetLatentDataset(jax_encode, rgb, dep, jtd.SnippetDataConfig(**dataclasses.asdict(config)))
    ds = SnippetLatentDataset(lambda x: torch.from_numpy(np.array(jax_encode(jnp.asarray(x.numpy())))), rgb, dep,
                              config, device="cpu")
    return jds, ds


CASES = [
    (SnippetDataConfig(snippet_len=3, dilations=(1, 2), cap_dilation=False, batch_size=4, seed=7), (10, 10)),
    # dilations 10 and 25 cap to 2 on 10 frames: the second is a duplicate and skipped
    (SnippetDataConfig(snippet_len=3, dilations=(1, 10, 25), cap_dilation=True, batch_size=3, seed=1), (10, 10)),
    # the 7-frame clip has no window at dilation 9
    (SnippetDataConfig(snippet_len=2, dilations=(1, 3, 9), cap_dilation=False, batch_size=5, seed=2), (10, 7)),
]


@pytest.mark.parametrize("config, frames", CASES, ids=["uncapped", "capped_duplicate", "span_guard"])
def test_dataset_matches_jax(vaes, config, frames):
    jds, ds = _pair(vaes[0], config, frames)
    assert len(ds) == len(jds) and ds.steps_per_epoch() == jds.steps_per_epoch() > 0
    assert [(c, list(r)) for c, r in ds.windows] == [(c, list(r)) for c, r in jds.windows]
    for epoch in (0, 1):
        got, want = list(ds.epoch(epoch, upload=False)), list(jds.epoch(epoch, upload=False))
        assert len(got) == len(want) == ds.steps_per_epoch()
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    uploaded = next(iter(ds.epoch(1)))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in uploaded.values())
    np.testing.assert_array_equal(uploaded["depth_latent"].numpy(), want[0]["depth_latent"])


def test_uncapped_window_counts(vaes):
    """Per clip of 10 frames: 8 windows at dilation 1, 6 at 2."""
    _, ds = _pair(vaes[0], CASES[0][0], (10, 10))
    assert len(ds) == 28 and ds.steps_per_epoch() == 7
    assert next(iter(ds.epoch(0)))["rgb_latent"].shape == (4, 3, 8, 8, 4)  # the tiny VAE halves


@pytest.mark.parametrize("frames, cap", [((2,), True), ((2,), False)])
def test_no_windows_raises_as_jax(vaes, frames, cap):
    """Clips shorter than one window: capping takes the dilation below 1,
    and uncapped windows do not fit."""
    config = SnippetDataConfig(snippet_len=3, dilations=(1,), cap_dilation=cap)
    with pytest.raises(ValueError, match="no snippet windows"):
        _pair(vaes[0], config, frames)
    with pytest.raises(ValueError, match="no snippet windows"):
        SnippetLatentDataset(vae_encode_fn(vaes[1]), *_clips(frames), config, device="cpu")


def test_vae_encode_fn_matches_jax_encoder(vaes):
    """The port's encoder in chunks of 3 against JAX's encode_mean."""
    jax_encode, vae = vaes
    rgb, _ = _clips((10,))
    frames = np.transpose(rgb[0], (0, 2, 3, 1))
    want = np.asarray(jax_encode(jnp.asarray(frames)))
    got = vae_encode_fn(vae, max_vae_bs=3)(torch.from_numpy(frames))
    assert not got.requires_grad and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    ds = SnippetLatentDataset(vae_encode_fn(vae, 3), *_clips((10,)), CASES[0][0], device="cpu")
    jds = jtd.SnippetLatentDataset(jax_encode, *_clips((10,)), jtd.SnippetDataConfig(**dataclasses.asdict(CASES[0][0])))
    for a, b in zip(ds.depth_latents + ds.rgb_latents, jds.depth_latents + jds.rgb_latents):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 * np.abs(b).max())


def test_two_train_steps_over_the_dataset(vaes):
    """JAX's jitted train step over JAX's batches, the port's over its own
    (equal) batches, from the same tiny UNet weights."""
    config = SnippetDataConfig(snippet_len=3, dilations=(1,), cap_dilation=True, batch_size=2, seed=3)
    jds, ds = _pair(vaes[0], config, (8, 8))
    cfg = TrainConfig(learning_rate=1e-3, lr_schedule="cosine", warmup_steps=2, total_steps=10)
    jtcfg = jt.TrainConfig(**dataclasses.asdict(cfg))
    jucfg = JUNetConfig.tiny(in_channels=8)
    params = UNet2DCondition(jucfg).init(jax.random.PRNGKey(0))
    jstep = jax.jit(jt.make_train_step(jucfg, JDDIMScheduler(JDDIMConfig()), jtcfg))
    state = jt.init_train_state(params, jtcfg)
    unet = UNet2DConditionModel(UNetConfig.tiny(in_channels=8), device="cpu")
    unet.load_state_dict(state_dict_from_jax(params))
    step = make_train_step(unet, DDIMScheduler(DDIMConfig()), cfg)
    text = np.random.default_rng(5).standard_normal((1, 2, 8)).astype(np.float32)
    for i, (jb, b) in enumerate(zip(jds.epoch(0), ds.epoch(0))):
        if i == 2:
            break
        np.testing.assert_array_equal(b["rgb_latent"].numpy(), np.asarray(jb["rgb_latent"]))
        key = jax.random.PRNGKey(i)
        state, want = jstep(state, dict(jb, text_embed=jnp.asarray(text)), key)
        k_t, k_noise = jax.random.split(key)
        t = torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000))).long()
        noise = torch.from_numpy(np.array(jax.random.normal(k_noise, b["depth_latent"].shape, jnp.float32)))
        got = step(dict(b, text_embed=torch.from_numpy(text)), timesteps=t, noise=noise)
        assert np.isfinite(got["loss"].item())
        assert got["loss"].item() == pytest.approx(float(want["loss"]), rel=1e-5)
        assert got["grad_norm"].item() == pytest.approx(float(want["grad_norm"]), rel=1e-4)
    assert int(state.step) == 2
