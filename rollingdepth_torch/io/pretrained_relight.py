"""Relight pipeline assembly from a diffusers-layout SD1.5 checkpoint.

Counterpart of ``rollingdepth_tpu/io/pretrained_relight.py``.  The
reference performs the conv_in 4 -> 12 channel surgery and the IC-Light
fbc additive offset merge on its modules at inference start; here both are
state-dict transforms at load time (``io/weights.py``).  On the card the
max-free attention gate is calibrated on the merged UNet, whose offset
merge is exactly the kind of change that moves attention scales.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

from ..models.rmbg import BriaRMBG
from ..models.unet import UNet2DConditionModel, UNetConfig
from ..schedulers.dpmsolver import DPMSolverConfig, DPMSolverMultistepScheduler
from ..utils.device import resolve_device
from .pretrained import DTYPE_MAP, load_text_encoder, load_vae
from .safetensors import load_file
from .tokenizer import CLIPTokenizer
from .weights import expand_conv_in, load_config, load_module_state_dict, merge_offset

logger = logging.getLogger(__name__)

# the scheduler the reference registers: DPM++ 2M SDE with Karras sigmas
RELIGHT_SCHEDULER_CONFIG = DPMSolverConfig(
    num_train_timesteps=1000,
    beta_start=0.00085,
    beta_end=0.012,
    beta_schedule="linear",  # diffusers' default, which the reference does not override
    algorithm_type="sde-dpmsolver++",
    use_karras_sigmas=True,
    steps_offset=1,
)
OFFSET_FILE = "iclight_sd15_fbc.safetensors"


def load_relight_unet(checkpoint_dir: str, iclight_offset_path: Optional[str] = None, dtype=torch.float32,
                      device=None):
    """(merged 12-channel UNet, base 4-channel UNet).  The merged UNet is the
    base with conv_in zero-padded to 12 input channels and, when the file
    exists, the IC-Light offset added; the base serves the t2i init."""
    cfg = UNetConfig.from_dict(load_config(checkpoint_dir, "unet"))
    sd = load_module_state_dict(checkpoint_dir, "unet")
    base = UNet2DConditionModel(cfg, device=device, dtype=dtype)
    base.load_state_dict(sd)

    offset_exists = bool(iclight_offset_path) and os.path.exists(iclight_offset_path)
    if iclight_offset_path and not offset_exists:
        logger.warning("IC-Light offset %s not found; using unmerged weights", iclight_offset_path)
    sd12 = expand_conv_in(sd, 12)
    if offset_exists:
        sd12 = merge_offset(sd12, load_file(iclight_offset_path))
    merged = UNet2DConditionModel(dataclasses.replace(cfg, in_channels=12), device=device, dtype=dtype)
    merged.load_state_dict(sd12)
    return merged, base


def load_rmbg(model_dir: str, device=None) -> BriaRMBG:
    model = BriaRMBG(device=device)
    model.load_state_dict(load_module_state_dict(model_dir))
    return model.eval()


def load_relight_pipeline(checkpoint_dir: str, iclight_offset_path: Optional[str] = None,
                          rmbg_dir: Optional[str] = None, dtype="fp16", snippet_batch: int = 4, pipeline_cls=None,
                          quantize=None, device=None):
    """The relight pipeline (``pipeline_cls``, default RollingImgPipeline)
    from an SD1.5 checkpoint, its relight UNet quantized with
    ``quantize="w8a8"``; the offset defaults to ``iclight_sd15_fbc.safetensors``
    in the checkpoint directory when it is there."""
    from ..ops.quant import apply_quantize
    from ..ops.score_probe import calibrate_nomax
    from ..pipelines.rollingimg import RollingImgPipeline

    dev = resolve_device(device)
    tdtype = DTYPE_MAP[dtype] if isinstance(dtype, str) else dtype
    if iclight_offset_path is None:
        cand = os.path.join(checkpoint_dir, OFFSET_FILE)
        iclight_offset_path = cand if os.path.exists(cand) else None

    unet, base_unet = load_relight_unet(checkpoint_dir, iclight_offset_path, tdtype, dev)
    if dev.type == "cuda":  # the max-free kernel runs only on the card; probed before quantizing
        calibrate_nomax(unet.eval())
    # W8A8 on the 12-channel relight UNet only (the hot path, 20 SDE steps a
    # window); the base t2i UNet runs once a frame for the init latents
    unet = apply_quantize(unet, quantize)
    vae = load_vae(checkpoint_dir, tdtype, dev)
    text_model = load_text_encoder(checkpoint_dir, torch.float32, dev).eval()
    tokenizer = CLIPTokenizer.from_pretrained(checkpoint_dir)
    rmbg = load_rmbg(rmbg_dir, dev) if rmbg_dir and os.path.isdir(rmbg_dir) else None

    @torch.no_grad()
    def text_apply(ids: torch.Tensor) -> torch.Tensor:
        return text_model(ids.to(dev))

    pipe = (pipeline_cls or RollingImgPipeline)(
        unet, vae, DPMSolverMultistepScheduler(RELIGHT_SCHEDULER_CONFIG), tokenizer, text_apply,
        base_unet=base_unet, rmbg=rmbg, dtype=tdtype, snippet_batch=snippet_batch, device=dev,
    )
    pipe.text_model = text_model
    return pipe
