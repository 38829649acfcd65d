"""The depth pipeline at full SD2 width with seeded random weights.

Released weights are not part of the repository, so the on-card smoke and
the profiling script build the rollingdepth-v1-0 architecture (SD2 UNet
with 8 input channels, the SD VAE, the OpenCLIP ViT-H text tower, a
v-prediction DDIM with trailing spacing) with random weights drawn from a
seeded ``torch.Generator`` on the device.
"""

from __future__ import annotations

import torch

from ..models.clip_text import CLIPTextConfig, CLIPTextModel
from ..models.layers import init_random_
from ..models.unet import UNet2DConditionModel, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..ops.score_probe import calibrate_nomax
from ..pipelines.rollingdepth import RollingDepthPipeline
from ..schedulers.ddim import DDIMConfig, DDIMScheduler
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


@torch.no_grad()
def random_depth_pipeline(device=None, dtype=torch.bfloat16, seed: int = 0, snippet_batch: int = 8):
    """Returns (pipeline, score-probe bound).  The max-free gate is
    calibrated on the random UNet, as the loader does on real weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    unet = init_random_(UNet2DConditionModel(UNetConfig.sd21(), device=dev), gen).to(dtype).eval()
    vae = init_random_(AutoencoderKL(VAEConfig(), device=dev), gen).to(dtype).eval()
    text = init_random_(CLIPTextModel(CLIPTextConfig(), device=dev), gen).eval()
    bound = calibrate_nomax(unet)
    empty = text(torch.tensor([EMPTY_PROMPT_IDS], device=dev))
    sched = DDIMScheduler(DDIMConfig(beta_schedule="scaled_linear", timestep_spacing="trailing",
                                     prediction_type="v_prediction", steps_offset=1))
    pipe = RollingDepthPipeline(unet, vae, sched, empty, dtype=dtype, snippet_batch=snippet_batch, device=dev)
    return pipe, bound
