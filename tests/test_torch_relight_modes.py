"""The port's relight window modes and the other relight pipelines against
the JAX package's: ``turbo`` partitions, ``strides``, per-dilation snippet
lengths, generation 3 (``MyRollingDepthPipeline``: shared noise, the empty
prompt, ``cond_first``, the short schedule), generation 2 (the RGB
passthrough over the depth pipeline); SD t2i/i2i: ``test_torch_stable_diffusion.py``.

Same tiny pipelines, weights and JAX draws as ``test_torch_relight.py``.
Tolerances: windows (``snippet_ls``) within 1e-4 of their scale, R/G/B
after 0 solve iterations within 1e-4; the gen-2 output ([-1, 1]) within
2e-4 (all fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.pipelines.iclight import ICLightPassthroughPipeline
from rollingdepth_torch.pipelines.my_rollingdepth import MyRollingDepthPipeline
from rollingdepth_tpu.pipelines import iclight as jicl
from rollingdepth_tpu.pipelines import my_rollingdepth as jmy
from tests.test_torch_relight import JaxNoise, build_pair, check_outputs, frames, run_both

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("kw", [
    dict(turbo=True),  # partitions of each chain (wins over strides)
    dict(strides=[2, 1]),  # dilation 1's chain every 2 hops, dilation 2 stride-1
    dict(snippet_lengths=[3, 2]),  # lengths differ: one pass per dilation, ids from 0 in each
    dict(cond_first=True, empty_text=True),  # gen-3's UNet input order and context
])
def test_window_modes_match_jax(pair, kw):
    want, got = run_both(pair, init_mode="shared_noise", **kw)
    check_outputs(want, got)
    if kw.get("turbo"):
        assert [s.shape[0] for s in got.snippet_ls] == [2, 2]


def test_gen3_pipeline_matches_jax():
    """MyRollingDepthPipeline's defaults on both sides: shared noise, the
    empty prompt, cond first, the full 1-step schedule (no strength skip)."""
    jpipe, tpipe = build_pair(pipeline_cls=(jmy.MyRollingDepthPipeline, MyRollingDepthPipeline))
    fg, bg = frames(), frames(seed=1)
    kw = dict(dilations=[1, 2], cap_dilation=False, coalign_kwargs={"num_iterations": 0}, seed=4)
    want = jpipe.forward(fg, bg, **kw)
    got = tpipe.forward(fg, bg, noise=JaxNoise(4), **kw)
    check_outputs(want, got)
    assert tpipe.last_chunks["unet"] == 3 and "t2i_unet" not in tpipe.last_chunks  # 6 windows / 2, one step


def test_gen2_passthrough_matches_jax():
    """Generation 2 over the depth pipeline (8-channel UNet): the window
    denoise runs and is discarded, the windows' RGB latents are decoded and
    co-aligned per channel."""
    from tests.test_torch_pipeline import SCHED, _jax_parts, _torch_pipe
    from rollingdepth_tpu.models.unet import UNet2DCondition
    from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
    from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig
    from rollingdepth_tpu.pipelines.rollingdepth import RollingDepthPipeline as JRollingDepthPipeline
    from rollingdepth_tpu.schedulers.ddim import DDIMConfig, DDIMScheduler

    ucfg, unet_params, vae_params = _jax_parts()
    text = np.random.default_rng(5).standard_normal((1, 2, 8)).astype(np.float32)
    jdepth = JRollingDepthPipeline(UNet2DCondition(ucfg), unet_params, JAutoencoderKL(JVAEConfig.tiny()), vae_params,
                                   DDIMScheduler(DDIMConfig(**SCHED)), jnp.asarray(text), dtype=jnp.float32,
                                   snippet_batch=4)
    tdepth = _torch_pipe(unet_params, vae_params, text)
    video = (np.random.default_rng(6).random((9, 3, 16, 16)) * 255).astype(np.uint8)
    kw = dict(dilations=[1, 2], coalign_kwargs={"num_iterations": 0})
    want = jicl.ICLightPassthroughPipeline(jdepth).forward(video, **kw)
    got = ICLightPassthroughPipeline(tdepth).forward(video, **kw)
    assert got.shape == want.shape == (9, 3, 16, 16) and got.min() >= -1 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
