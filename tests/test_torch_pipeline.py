"""The slice as a whole: the port's fast-path pipeline against the JAX
pipeline, and the port's loader on a diffusers-layout checkpoint (the
refine and exact-merge paths: ``test_torch_refine.py``).

Tiny UNet, VAE and text encoder on both sides with the same weights
(``state_dict_from_jax``) and the same ``init_noise``, fp32,
``merge_in_latent=True``, dilations [1, 3], 10 frames of 32x32.

Tolerances: with the co-alignment cut to one iteration the two agree to
1e-4 (fp32 sum order, plus the JAX side's uint16 output quantisation of
3e-5).  Past that, the L1 solve's sign gradients turn sum-order
differences of 1e-7 into Adam steps of lr = 1e-3 whenever two windows
nearly agree on a pixel (see ``test_torch_aligner.py``; on this fixture
the two part by 1.5e-3 within 10 iterations), so the full 2000-iteration
run is held to 5e-2 absolute on the [-1, 1] depth and a correlation above
0.999."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rollingdepth_torch.io.pretrained import load_pipeline, load_rollingdepth_pipeline
from rollingdepth_torch.io.safetensors import save_file
from rollingdepth_torch.io.weights import state_dict_from_jax
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
from rollingdepth_torch.pipelines.rollingdepth import RollingDepthPipeline
from rollingdepth_torch.schedulers.ddim import DDIMConfig, DDIMScheduler
from rollingdepth_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
from rollingdepth_tpu.models.clip_text import CLIPTextModel as JCLIPTextModel
from rollingdepth_tpu.models.unet import UNet2DCondition
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig
from rollingdepth_tpu.pipelines.rollingdepth import RollingDepthPipeline as JRollingDepthPipeline
from rollingdepth_tpu.schedulers.ddim import DDIMConfig as JDDIMConfig
from rollingdepth_tpu.schedulers.ddim import DDIMScheduler as JDDIMScheduler

torch.set_num_threads(2)
SCHED = dict(beta_schedule="scaled_linear", timestep_spacing="trailing", prediction_type="v_prediction",
             steps_offset=1)
FAST = dict(dilations=[1, 3], merge_in_latent=True)


def _jax_parts(cross_dim=8):
    ucfg = dataclasses.replace(JUNetConfig.tiny(), cross_attention_dim=cross_dim)
    unet_params = UNet2DCondition(ucfg).init(jax.random.PRNGKey(0))
    vae_params = JAutoencoderKL(JVAEConfig.tiny()).init(jax.random.PRNGKey(1))
    return ucfg, unet_params, vae_params


def _torch_pipe(unet_params, vae_params, text, cross_dim=8):
    unet = UNet2DConditionModel(dataclasses.replace(UNetConfig.tiny(), cross_attention_dim=cross_dim),
                                device="cpu")
    unet.load_state_dict(state_dict_from_jax(unet_params))
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    vae.load_state_dict(state_dict_from_jax(vae_params))
    return RollingDepthPipeline(unet, vae, DDIMScheduler(DDIMConfig(**SCHED)), torch.from_numpy(text),
                                dtype=torch.float32, snippet_batch=4, device="cpu")


def _inputs(seed=0, n=10):
    rng = np.random.default_rng(seed)
    frames = (rng.random((n, 3, 32, 32)) * 255).astype(np.uint8)
    noise = rng.standard_normal((4, 16, 16)).astype(np.float32)
    return frames, noise


@pytest.fixture(scope="module")
def both():
    ucfg, unet_params, vae_params = _jax_parts()
    text = np.random.default_rng(5).standard_normal((1, 2, 8)).astype(np.float32)
    jpipe = JRollingDepthPipeline(UNet2DCondition(ucfg), unet_params, JAutoencoderKL(JVAEConfig.tiny()),
                                  vae_params, JDDIMScheduler(JDDIMConfig(**SCHED)), jnp.asarray(text),
                                  dtype=jnp.float32, snippet_batch=4)
    return jpipe, _torch_pipe(unet_params, vae_params, text)


@pytest.mark.parametrize("iters", [1, 2000])
def test_depth_pred_matches_jax_pipeline(both, iters):
    jpipe, tpipe = both
    frames, noise = _inputs()
    kw = dict(FAST, init_noise=noise, latent_coalign_kwargs={"num_iterations": iters})
    ref = jpipe.forward(frames, **kw).depth_pred
    got = tpipe.forward(frames, **kw).depth_pred
    assert got.shape == ref.shape == (10, 1, 32, 32)
    assert np.isfinite(got).all() and got.min() >= -1 and got.max() <= 1
    if iters == 1:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2)
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def test_chunking_and_call_entry_point(both):
    """Chunk counts are ceil(items / chunk size) (last chunk at its true size), and
    ``__call__`` with float frames gives what ``forward`` gives."""
    _, tpipe = both
    frames, _ = _inputs(seed=1, n=9)
    kw = dict(seed=0, latent_coalign_kwargs={"num_iterations": 5})  # __call__ takes no init_noise
    a = tpipe.forward(frames, **FAST, **kw)
    # 9 frames: windows 7 (d=1) + 3 (d=3) at snippet_batch 4 -> 3 UNet chunks
    assert tpipe.last_chunks == {"encode": 3, "unet": 3, "decode": 3}
    b = tpipe(input_frames=frames.astype(np.float32) / 127.5 - 1.0, **FAST, **kw)
    np.testing.assert_allclose(b.depth_pred, a.depth_pred, atol=1e-5)
    c = tpipe.forward(frames, **FAST, **kw, fetch_output=False)
    assert torch.is_tensor(c.depth_pred)


def test_unported_paths_raise(both, tmp_path):
    """What raises: dilations without 1, and a pipeline class no loader
    knows.  The relight class names go to the relight loader
    (``test_torch_relight_cli.py``), which needs a checkpoint; refinement
    and the exact merge run (``test_torch_refine.py``)."""
    _, tpipe = both
    frames, _ = _inputs()
    with pytest.raises(ValueError, match="dilations should include 1"):
        tpipe.forward(frames, dilations=[2, 3])
    (tmp_path / "model_index.json").write_text(json.dumps({"_class_name": "RollingImgPipeline"}))
    with pytest.raises(FileNotFoundError):
        load_pipeline(str(tmp_path), dtype="fp32", device="cpu")
    (tmp_path / "model_index.json").write_text(json.dumps({"_class_name": "NoSuchPipeline"}))
    with pytest.raises(ValueError, match="Unknown pipeline class"):
        load_pipeline(str(tmp_path), dtype="fp32", device="cpu")


def _write_checkpoint(root, unet_params, vae_params, clip_params, clip_cfg):
    from rollingdepth_tpu.io.tokenizer import bytes_to_unicode

    for sub, params, cfg, fname, prefix in (
        ("unet", unet_params, dataclasses.replace(UNetConfig.tiny(), cross_attention_dim=16),
         "diffusion_pytorch_model.safetensors", ""),
        ("vae", vae_params, VAEConfig.tiny(), "diffusion_pytorch_model.safetensors", ""),
        ("text_encoder", clip_params, clip_cfg, "model.safetensors", "text_model."),
    ):
        (root / sub).mkdir()
        save_file({prefix + k: v for k, v in state_dict_from_jax(params).items()}, str(root / sub / fname))
        (root / sub / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(SCHED))
    tok = root / "tokenizer"
    tok.mkdir()
    vocab = {}
    for u in bytes_to_unicode().values():
        vocab[u] = len(vocab)
    for u in bytes_to_unicode().values():
        vocab[u + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = 510
    vocab["<|endoftext|>"] = 511
    (tok / "vocab.json").write_text(json.dumps(vocab))
    (tok / "merges.txt").write_text("#version: 0.2\n")
    (root / "model_index.json").write_text(json.dumps({"_class_name": "RollingDepthPipeline"}))


def test_loader_on_written_checkpoint_matches_jax(tmp_path):
    """``load_rollingdepth_pipeline`` on a tiny diffusers-layout checkpoint
    written by the port's own writer, against the JAX pipeline built from
    the same weights and the JAX text encoder's empty-prompt embedding."""
    from rollingdepth_torch.models.clip_text import CLIPTextConfig

    ucfg, unet_params, vae_params = _jax_parts(cross_dim=16)
    jclip_cfg = dataclasses.replace(JCLIPTextConfig.tiny(), vocab_size=512)
    clip_params = JCLIPTextModel(jclip_cfg).init(jax.random.PRNGKey(2))
    _write_checkpoint(tmp_path, unet_params, vae_params, clip_params,
                      dataclasses.replace(CLIPTextConfig.tiny(), vocab_size=512))

    with pytest.raises(RuntimeError):
        load_rollingdepth_pipeline(str(tmp_path), dtype="fp32")  # no card, no device="cpu"
    pipe = load_pipeline(str(tmp_path), dtype="fp32", snippet_batch=4, device="cpu")
    assert pipe.dtype == torch.float32

    empty = JCLIPTextModel(jclip_cfg).apply(clip_params, jnp.asarray([[510, 511]]))
    jpipe = JRollingDepthPipeline(UNet2DCondition(ucfg), unet_params, JAutoencoderKL(JVAEConfig.tiny()),
                                  vae_params, JDDIMScheduler(JDDIMConfig(**SCHED)), empty,
                                  dtype=jnp.float32, snippet_batch=4)
    frames, noise = _inputs(seed=2)
    kw = dict(FAST, init_noise=noise, latent_coalign_kwargs={"num_iterations": 1})
    np.testing.assert_allclose(pipe.forward(frames, **kw).depth_pred, jpipe.forward(frames, **kw).depth_pred,
                               rtol=0, atol=1e-4)

    # the relight class name on the same directory: the relight loader, its
    # UNet's conv_in zero-padded to 12 input channels
    (tmp_path / "model_index.json").write_text(json.dumps({"_class_name": "RollingImgPipeline"}))
    relight = load_pipeline(str(tmp_path), dtype="fp32", device="cpu")
    assert type(relight).__name__ == "RollingImgPipeline" and relight.unet.config.in_channels == 12
    assert not relight.unet.conv_in.weight[:, 8:].any()
