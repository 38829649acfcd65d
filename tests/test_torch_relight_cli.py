"""The port's relight loader and ``-fi/-bi`` command line.

A tiny SD1.5-style checkpoint (4-channel UNet with conv projections, the
tiny VAE, a byte-level tokenizer, a tiny CLIP) and an IC-Light offset file
are written without diffusers, by the port's own safetensors writer (the
recipe of ``test_torch_pipeline.py``).  The port's loader must build the
JAX loader's weights from it: the 12-channel merged UNet and the 4-channel
base within 1e-6, the rest equal.  The CLI runs end to end on the CPU on
cv2-written clips, with the working resolution shrunk by monkeypatching
``RELIGHT_WIDTH``/``RELIGHT_HEIGHT``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from rollingdepth_torch import cli as tcli
from rollingdepth_torch.io.pretrained import load_pipeline
from rollingdepth_torch.io.pretrained_relight import OFFSET_FILE, load_relight_pipeline
from rollingdepth_torch.io.safetensors import save_file
from rollingdepth_torch.io.weights import state_dict_from_jax
from rollingdepth_torch.models.clip_text import CLIPTextConfig
from rollingdepth_torch.models.unet import UNetConfig
from rollingdepth_torch.models.vae import VAEConfig
from rollingdepth_torch.pipelines import rollingimg as tri
from rollingdepth_torch.pipelines.my_rollingdepth import MyRollingDepthPipeline
from rollingdepth_tpu.io import pretrained_relight as jpr
from rollingdepth_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
from rollingdepth_tpu.models.clip_text import CLIPTextModel as JCLIPTextModel
from rollingdepth_tpu.models.unet import UNet2DCondition
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig

torch.set_num_threads(2)

SD15_TINY = dict(cross_attention_dim=16, use_linear_projection=False, attention_head_dim=2)
CLIP = dict(vocab_size=512, max_position_embeddings=77)  # the tokenizer pads to 77


def write_sd15_checkpoint(root, class_name="RollingImgPipeline", offset=True):
    from rollingdepth_torch.io.tokenizer import bytes_to_unicode

    jcfg = dataclasses.replace(JUNetConfig.tiny(in_channels=4), **SD15_TINY)
    unet_params = UNet2DCondition(jcfg).init(jax.random.PRNGKey(0))
    vae_params = JAutoencoderKL(JVAEConfig.tiny()).init(jax.random.PRNGKey(1))
    clip_params = JCLIPTextModel(dataclasses.replace(JCLIPTextConfig.tiny(), **CLIP)).init(
        jax.random.PRNGKey(2))
    for sub, params, cfg, fname, prefix in (
        ("unet", unet_params, dataclasses.replace(UNetConfig.tiny(in_channels=4), **SD15_TINY),
         "diffusion_pytorch_model.safetensors", ""),
        ("vae", vae_params, VAEConfig.tiny(), "diffusion_pytorch_model.safetensors", ""),
        ("text_encoder", clip_params, dataclasses.replace(CLIPTextConfig.tiny(), **CLIP), "model.safetensors",
         "text_model."),
    ):
        (root / sub).mkdir()
        save_file({prefix + k: v for k, v in state_dict_from_jax(params).items()}, str(root / sub / fname))
        (root / sub / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    tok = root / "tokenizer"
    tok.mkdir()
    vocab = {}
    for suffix in ("", "</w>"):
        for u in bytes_to_unicode().values():
            vocab[u + suffix] = len(vocab)
    vocab.update({"<|startoftext|>": 510, "<|endoftext|>": 511})
    (tok / "vocab.json").write_text(json.dumps(vocab))
    (tok / "merges.txt").write_text("#version: 0.2\n")
    (root / "model_index.json").write_text(json.dumps({"_class_name": class_name}))
    if offset:  # IC-Light's offset: a 12-channel conv_in and one more tensor
        rng = np.random.default_rng(3)
        sd = state_dict_from_jax(unet_params)
        off = {"conv_in.weight": torch.from_numpy(rng.standard_normal((8, 12, 3, 3)).astype(np.float32) * 0.1),
               "conv_out.bias": torch.from_numpy(rng.standard_normal(sd["conv_out.bias"].shape).astype(np.float32))}
        save_file(off, str(root / OFFSET_FILE))
    return str(root)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_sd15_checkpoint(tmp_path_factory.mktemp("sd15"))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """fg.mp4 and, in bgs/, two backgrounds: 6 frames of 32x48 each."""
    import cv2

    d = tmp_path_factory.mktemp("relvid")
    (d / "bgs").mkdir()
    for name, seed in (("fg.mp4", 0), ("bgs/bg_a.mp4", 1), ("bgs/bg_b.mp4", 2)):
        w = cv2.VideoWriter(str(d / name), cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
        base = (np.random.RandomState(seed).rand(32, 48, 3) * 255).astype(np.uint8)
        for i in range(6):
            w.write(np.roll(base, i * 3, axis=1))
        w.release()
    return str(d / "fg.mp4"), str(d / "bgs"), str(d / "bgs" / "bg_a.mp4")


@pytest.mark.parametrize("with_offset", [True, False])
def test_loader_matches_jax_loader(tmp_path, with_offset):
    ckpt = write_sd15_checkpoint(tmp_path, offset=with_offset)
    jpipe = jpr.load_relight_pipeline(ckpt, dtype="fp32", snippet_batch=2)
    pipe = load_relight_pipeline(ckpt, dtype="fp32", snippet_batch=2, device="cpu")
    assert isinstance(pipe, tri.RollingImgPipeline) and pipe.dtype == torch.float32
    assert pipe.unet.config.in_channels == 12 and pipe.base_unet.config.in_channels == 4
    assert dataclasses.asdict(pipe.scheduler.config) == dataclasses.asdict(jpr.RELIGHT_SCHEDULER_CONFIG)
    for module, params in ((pipe.unet, jpipe.unet_params), (pipe.base_unet, jpipe.base_unet_params),
                           (pipe.vae, jpipe.vae_params)):
        want = state_dict_from_jax(params)
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    w_in = pipe.unet.conv_in.weight.detach()
    assert bool(w_in[:, 4:].any()) == with_offset  # zero-padded, then the offset added
    ids = np.array([[510, 70, 71, 511]])
    np.testing.assert_allclose(pipe.text_apply(torch.from_numpy(ids)).numpy(), np.asarray(jpipe.text_apply(ids)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("class_name, cls", [("RollingImgPipeline", tri.RollingImgPipeline),
                                             ("StableDiffusionPipeline", tri.RollingImgPipeline),
                                             ("StableDiffusionImg2ImgPipeline", tri.RollingImgPipeline),
                                             ("MyRollingDepthPipeline", MyRollingDepthPipeline)])
def test_load_pipeline_dispatches_relight_classes(tmp_path, class_name, cls):
    """The relight class names go to the relight loader, as in the JAX package."""
    pipe = load_pipeline(write_sd15_checkpoint(tmp_path, class_name, offset=False), dtype="fp32", device="cpu")
    assert type(pipe) is cls and pipe.unet.config.in_channels == 12


def test_relight_cli_end_to_end(checkpoint, clips, tmp_path, monkeypatch):
    """``-fi/-bi`` on the CPU: one ``<fg>_rgb.mp4`` with one background,
    ``<fg>_<bg>_rgb.mp4`` per background with several; the clip holds the
    frames at the working resolution."""
    import cv2

    monkeypatch.setattr(tri, "RELIGHT_WIDTH", 24)
    monkeypatch.setattr(tri, "RELIGHT_HEIGHT", 16)
    fg, bg_dir, bg_a = clips
    argv = ["-o", str(tmp_path / "out"), "-p", "none", "-c", checkpoint, "--device", "cpu", "--dilations", "1", "2",
            "--dtype", "fp32", "--frame-count", "6", "--seed", "1", "--snippet-batch", "4"]
    tcli.main(["-fi", fg, "-bi", bg_a] + argv)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["fg_rgb.mp4"]
    cap = cv2.VideoCapture(str(tmp_path / "out" / "fg_rgb.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (16, 24, 3)

    tcli.main(["-fi", fg, "-bi", bg_dir] + argv[:1] + [str(tmp_path / "out2")] + argv[2:])
    assert sorted(p.name for p in (tmp_path / "out2").iterdir()) == ["fg_bg_a_rgb.mp4", "fg_bg_b_rgb.mp4"]


def test_relight_call_on_videos(checkpoint, clips):
    """``__call__`` from video paths: the fg clip resized to the working
    size, R/G/B in [0, 1]."""
    pipe = load_relight_pipeline(checkpoint, dtype="fp32", snippet_batch=4, device="cpu")
    fg, _, bg_a = clips
    out = pipe(input_fg_video_path=fg, input_bg_video_path=bg_a, width=24, height=16, dilations=[1], frame_count=6,
               init_mode="shared_noise", num_inference_steps=4, seed=1, keep_snippets=False,
               coalign_kwargs={"num_iterations": 2})
    assert out.R_pred.shape == (6, 1, 16, 24) and out.snippet_ls is None
    assert all(np.isfinite(c).all() and c.min() >= 0 and c.max() <= 1 for c in (out.R_pred, out.G_pred, out.B_pred))


def test_quantize_still_raises_for_relight(checkpoint, clips, tmp_path):
    """A quantization mode the JAX package does not know raises, in the
    loader as in the CLI (``w8a8`` runs: ``test_relight_cli_w8a8``)."""
    fg, _, bg_a = clips
    with pytest.raises(ValueError, match="int4"):
        load_relight_pipeline(checkpoint, dtype="fp32", quantize="int4", device="cpu")
    with pytest.raises(SystemExit):
        tcli.main(["-fi", fg, "-bi", bg_a, "-o", str(tmp_path / "out"), "-c", checkpoint, "--device", "cpu",
                   "--quantize", "int4"])


def test_relight_cli_w8a8(checkpoint, clips, tmp_path, monkeypatch):
    """``-fi/-bi --quantize w8a8``: the relight UNet quantized, the base t2i
    UNet not (as the JAX loader does), and the clip written."""
    import cv2

    monkeypatch.setattr(tri, "RELIGHT_WIDTH", 24)
    monkeypatch.setattr(tri, "RELIGHT_HEIGHT", 16)
    pipe = load_relight_pipeline(checkpoint, dtype="fp32", quantize="w8a8", device="cpu")
    assert pipe.unet.down_blocks[0].resnets[0].conv1.weight_q.dtype == torch.int8
    assert pipe.unet.down_blocks[0].resnets[0].conv1.w_scale.dtype == torch.float32
    assert type(pipe.base_unet.down_blocks[0].resnets[0].conv1) is torch.nn.Conv2d
    fg, _, bg_a = clips
    tcli.main(["-fi", fg, "-bi", bg_a, "-o", str(tmp_path / "out"), "-p", "none", "-c", checkpoint, "--device",
               "cpu", "--dilations", "1", "--dtype", "fp32", "--frame-count", "6", "--seed", "1", "--snippet-batch",
               "4", "--quantize", "w8a8"])
    cap = cv2.VideoCapture(str(tmp_path / "out" / "fg_rgb.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (16, 24, 3)


@pytest.mark.parametrize("make", ["pipeline", "loader", "synthetic", "rmbg", "sd", "cli"])
def test_relight_entry_points_refuse_cpu_by_default(make, checkpoint, clips, tmp_path):
    """Without ``device=`` every relight entry point asks for the card and
    raises on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from rollingdepth_torch.models.rmbg import BriaRMBG
    from rollingdepth_torch.pipelines.stable_diffusion import StableDiffusionPipeline
    from rollingdepth_torch.utils.synthetic import random_relight_pipeline

    cpu = load_relight_pipeline(checkpoint, dtype="fp32", device="cpu")
    fg, _, bg_a = clips
    calls = {
        "pipeline": lambda: tri.RollingImgPipeline(cpu.unet, cpu.vae, cpu.scheduler, cpu.tokenizer, cpu.text_apply),
        "loader": lambda: load_relight_pipeline(checkpoint, dtype="fp32"),
        "synthetic": lambda: random_relight_pipeline(),
        "rmbg": lambda: BriaRMBG(),
        "sd": lambda: StableDiffusionPipeline(cpu.base_unet, cpu.vae, cpu.scheduler, cpu.tokenizer, cpu.text_apply),
        "cli": lambda: tcli.main(["-fi", fg, "-bi", bg_a, "-o", str(tmp_path / "out"), "-c", checkpoint]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[make]()
