"""The port's Stable Diffusion t2i and i2i pipelines against the JAX ones:
classifier-free guidance on and off, latents and decoded images, img2img
at strength 0.5.  The tiny relight pair's 4-channel base UNet and VAE
(``test_torch_relight.py``) with the same weights; the JAX pipeline's
draws passed in (``init_noise``, and each step's ``fold_in(PRNGKey(seed),
i)``).  Tolerance: 1e-4 of the output's scale, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.pipelines.stable_diffusion import StableDiffusionImg2ImgPipeline, StableDiffusionPipeline
from rollingdepth_tpu.pipelines import stable_diffusion as jsd
from tests.test_torch_relight import FakeTokenizer, assert_scaled_close, build_pair, frames

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sd_pair():
    """SD t2i pipelines over the relight pair's 4-channel base UNet and VAE."""
    jrel, trel = build_pair()
    jpipe = jsd.StableDiffusionPipeline(jrel.base_unet, jrel.base_unet_params, jrel.vae, jrel.vae_params,
                                        jrel.scheduler, FakeTokenizer(), jrel.text_apply, dtype=jnp.float32)
    tpipe = StableDiffusionPipeline(trel.base_unet, trel.vae, trel.scheduler, FakeTokenizer(), trel.text_apply,
                                    dtype=torch.float32, device="cpu")
    return jpipe, tpipe


def _step_noise(seed):
    key = jax.random.PRNGKey(seed)
    return lambda i, shape: np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32))


@pytest.mark.parametrize("guidance", [7.0, 1.0])
@pytest.mark.parametrize("latents", [True, False])
def test_sd_t2i_matches_jax(sd_pair, guidance, latents):
    jpipe, tpipe = sd_pair
    init = np.random.default_rng(7).standard_normal((2, 4, 8, 8)).astype(np.float32)
    kw = dict(height=16, width=16, num_inference_steps=3, guidance_scale=guidance, batch=2, seed=3,
              init_noise=init, output_latents=latents)
    want = jpipe("a prompt", "bad", **kw)
    got = tpipe("a prompt", "bad", step_noise=_step_noise(3), **kw)
    assert got.shape == ((2, 8, 8, 4) if latents else (2, 3, 16, 16))
    assert_scaled_close(got, want, 1e-4)


def test_sd_i2i_matches_jax(sd_pair):
    jpipe, tpipe = sd_pair
    image = frames(n=2, seed=8)
    init = np.random.default_rng(9).standard_normal((2, 4, 8, 8)).astype(np.float32)
    kw = dict(num_inference_steps=4, strength=0.5, guidance_scale=3.0, seed=2, init_noise=init)
    j2i = jsd.StableDiffusionImg2ImgPipeline(jpipe.unet, jpipe.unet_params, jpipe.vae, jpipe.vae_params,
                                             jpipe.scheduler, jpipe.tokenizer, jpipe.text_apply, dtype=jnp.float32)
    want = j2i("relit", image, **kw)
    i2i = StableDiffusionImg2ImgPipeline(tpipe.unet, tpipe.vae, tpipe.scheduler, tpipe.tokenizer, tpipe.text_apply,
                                         dtype=torch.float32, device="cpu")
    got = i2i("relit", image, step_noise=_step_noise(2), **kw)
    assert got.shape == (2, 3, 16, 16)
    assert_scaled_close(got, want, 1e-4)
    # the default (torch.Generator) draws: deterministic in the seed
    a = tpipe("x", height=16, width=16, num_inference_steps=2, seed=1, output_latents=True)
    b = tpipe("x", height=16, width=16, num_inference_steps=2, seed=1, output_latents=True)
    np.testing.assert_array_equal(a, b)
