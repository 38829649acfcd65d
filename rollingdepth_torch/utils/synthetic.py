"""The depth and relight pipelines at full width with seeded random weights.

Released weights are not part of the repository, so the on-card smoke and
the profiling script build the architectures with random weights drawn
from a seeded ``torch.Generator`` on the device:
- depth: rollingdepth-v1-0 (SD2 UNet with 8 input channels, the SD VAE,
  the OpenCLIP ViT-H text tower, a v-prediction DDIM with trailing spacing);
- relight: the IC-Light stack (the SD1.5 UNet as a 4-channel base and a
  12-channel merged copy, the SD VAE, CLIP ViT-L, DPM++ 2M SDE Karras, the
  RMBG U²-Net) with a byte-level tokenizer in place of CLIP's BPE files;
- training: the depth model's UNet, VAE, scheduler and empty-prompt
  embedding in fp32, with synthetic rgb and depth clips.
With a (dp, tp) ``mesh`` every rank builds the same full weights (same
seed, same device type), probes the whole UNet's scores (the bound is the
max over the ranks) and then keeps its tp shard (``parallel.shard_unet_``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.distributed as dist

from ..io.pretrained_relight import RELIGHT_SCHEDULER_CONFIG
from ..io.tokenizer import CLIPTokenizer, bytes_to_unicode
from ..io.weights import expand_conv_in, merge_offset
from ..models.clip_text import CLIPTextConfig, CLIPTextModel
from ..models.layers import init_random_
from ..models.rmbg import BriaRMBG
from ..models.unet import UNet2DConditionModel, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..ops.quant import apply_quantize
from ..ops.score_probe import calibrate_nomax
from ..parallel.sharding import shard_unet_
from ..pipelines.rollingdepth import RollingDepthPipeline
from ..pipelines.rollingimg import RollingImgPipeline
from ..schedulers.ddim import DDIMConfig, DDIMScheduler
from ..schedulers.dpmsolver import DPMSolverMultistepScheduler
from .device import resolve_device
from .presets import resolve_preset

# the CLIP tokenizer's ids for the empty prompt: BOS, EOS
EMPTY_PROMPT_IDS = (49406, 49407)


def preset_kwargs(preset: str, seed: int = 0) -> dict:
    """The pipeline call arguments of a CLI preset (``utils/presets.py``);
    its processing resolution and dtype are ``resolve_preset(preset).res``
    and ``.dtype``."""
    s = resolve_preset(preset)
    return dict(dilations=s.dilations, cap_dilation=s.cap_dilation, snippet_lengths=s.snippet_lengths,
                init_infer_steps=s.init_infer_steps, strides=s.strides, refine_step=s.refine_step,
                refine_snippet_len=s.refine_snippet_len, refine_start_dilation=s.refine_start_dilation,
                max_vae_bs=s.max_vae_bs, merge_in_latent=s.merge_in_latent, refine_in_latent=s.refine_in_latent,
                turbo_refine=s.turbo_refine, seed=seed)


FAST_PRESET = preset_kwargs("fast")
FULL_PRESET = preset_kwargs("full")  # res 1024, dilations [1, 10, 25], 10 refine steps, latent merge
PAPER_PRESET = preset_kwargs("paper")  # fp32, uncapped dilations, exact merge, stride-1 refine windows


# rollingdepth-v1-0's scheduler: v-prediction DDIM, scaled-linear betas, trailing spacing
DEPTH_SCHEDULER = DDIMConfig(beta_schedule="scaled_linear", timestep_spacing="trailing",
                             prediction_type="v_prediction", steps_offset=1)


def _calibrate(unet, mesh) -> float:
    """The max-free gate on the whole UNet, agreed over every rank of a mesh."""
    return calibrate_nomax(unet, group=None if mesh is None else dist.group.WORLD)


@torch.no_grad()
def random_depth_pipeline(device=None, dtype=torch.bfloat16, seed: int = 0, snippet_batch: int = 8, mesh=None,
                          quantize=None):
    """Returns (pipeline, score-probe bound).  The max-free gate is
    calibrated on the random UNet, as the loader does on real weights, and
    then the UNet is quantized (``quantize="w8a8"``) and sharded."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet = init_random_(UNet2DConditionModel(UNetConfig.sd21(), device=dev), gen).to(dtype).eval()
    vae = init_random_(AutoencoderKL(VAEConfig(), device=dev), gen).to(dtype).eval()
    text = init_random_(CLIPTextModel(CLIPTextConfig(), device=dev), gen).eval()
    bound = _calibrate(unet, mesh)
    apply_quantize(unet, quantize)
    empty = text(torch.tensor([EMPTY_PROMPT_IDS], device=dev))
    pipe = RollingDepthPipeline(shard_unet_(unet, mesh), vae, DDIMScheduler(DEPTH_SCHEDULER), empty, dtype=dtype,
                                snippet_batch=snippet_batch, device=dev, mesh=mesh)
    return pipe, bound


@dataclasses.dataclass
class TrainingSetup:
    unet: UNet2DConditionModel  # fp32, trainable
    vae: AutoencoderKL  # fp32, eval
    scheduler: DDIMScheduler
    text_embed: torch.Tensor  # [1, 2, 1024]: the unpadded empty prompt, as the loader embeds it
    rgb_clips: List[torch.Tensor]  # each [frames, 3, H, W] in [-1, 1]
    depth_clips: List[torch.Tensor]  # each [frames, 1, H, W] in [-1, 1]
    score_bound: float


@torch.no_grad()
def random_training_setup(device=None, seed: int = 0, clips: int = 2, frames: int = 8,
                          res: Tuple[int, int] = (480, 640), mesh=None) -> TrainingSetup:
    """rollingdepth-v1-0 at full width with seeded random weights, in fp32
    as a trainer holds it: the SD2 UNet (8 input channels), the SD VAE, the
    empty-prompt embedding of the OpenCLIP ViT-H text tower (the tower is
    dropped), the depth scheduler, and ``clips`` synthetic rgb and depth
    clips of ``frames`` frames at ``res`` (H, W), drawn on the device.  The
    max-free gate is calibrated on the UNet, as the loader does."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet = init_random_(UNet2DConditionModel(UNetConfig.sd21(), device=dev), gen)
    vae = init_random_(AutoencoderKL(VAEConfig(), device=dev), gen).eval()
    text = init_random_(CLIPTextModel(CLIPTextConfig(), device=dev), gen).eval()
    empty = text(torch.tensor([EMPTY_PROMPT_IDS], device=dev))
    del text
    bound = _calibrate(unet, mesh)
    shard_unet_(unet, mesh)
    h, w = res
    rgb = [torch.rand((frames, 3, h, w), generator=gen, device=dev) * 2 - 1 for _ in range(clips)]
    depth = [torch.rand((frames, 1, h, w), generator=gen, device=dev) * 2 - 1 for _ in range(clips)]
    return TrainingSetup(unet, vae, DDIMScheduler(DEPTH_SCHEDULER), empty, rgb, depth, bound)


# the relight CLI's call: t2i init, dilations [1, 25], windows of 3, a 40-step
# schedule entered at strength 0.5 (20 t2i and 20 window steps), the full
# 2000-step solves, no window copies kept
RELIGHT_CALL = dict(dilations=[1, 25], snippet_lengths=[3], strides=[1], init_mode="t2i", num_inference_steps=40,
                    strength=0.5, max_vae_bs=4, seed=12345, keep_snippets=False)

# CLIP ViT-L/14's text tower, SD1.5's text encoder
CLIP_VIT_L = CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
                            hidden_act="quick_gelu")


def byte_tokenizer() -> CLIPTokenizer:
    """A CLIP tokenizer without merges: every byte its own token (ids
    0-511), BOS and EOS at CLIP's 49406 and 49407.  The default relight
    prompts take one 77-token chunk each, as with CLIP's BPE."""
    vocab = {}
    for suffix in ("", "</w>"):
        for u in bytes_to_unicode().values():
            vocab[u + suffix] = len(vocab)
    vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    return CLIPTokenizer(vocab, [])


@torch.no_grad()
def random_relight_pipeline(device=None, dtype=torch.bfloat16, seed: int = 0, snippet_batch: int = 8, mesh=None):
    """Returns (RollingImgPipeline, score-probe bound).  The merged UNet is
    the base's state dict through the loader's transforms (conv_in padded
    to 12 channels, a random offset on conv_in so that the condition
    channels count); the max-free gate is calibrated on it, as the loader
    does."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = init_random_(UNet2DConditionModel(UNetConfig.sd15(), device=dev), gen).eval()
    w_in = base.conv_in.weight
    offset = (torch.rand((w_in.shape[0], 12) + tuple(w_in.shape[2:]), generator=gen, device=dev) * 2 - 1)
    sd12 = merge_offset(expand_conv_in(base.state_dict(), 12), {"conv_in.weight": offset / (12 * 9) ** 0.5})
    unet = UNet2DConditionModel(UNetConfig.sd15(in_channels=12), device=dev)
    unet.load_state_dict(sd12)
    unet, base = unet.to(dtype).eval(), base.to(dtype)
    vae = init_random_(AutoencoderKL(VAEConfig(), device=dev), gen).to(dtype).eval()
    text = init_random_(CLIPTextModel(CLIP_VIT_L, device=dev), gen).eval()
    rmbg = init_random_(BriaRMBG(device=dev), gen).eval()
    bound = _calibrate(unet, mesh)
    shard_unet_(unet, mesh)
    shard_unet_(base, mesh)

    def text_apply(ids: torch.Tensor) -> torch.Tensor:
        return text(ids.to(dev))

    pipe = RollingImgPipeline(unet, vae, DPMSolverMultistepScheduler(RELIGHT_SCHEDULER_CONFIG), byte_tokenizer(),
                              text_apply, base_unet=base, rmbg=rmbg, dtype=dtype, snippet_batch=snippet_batch,
                              device=dev, mesh=mesh)
    return pipe, bound
