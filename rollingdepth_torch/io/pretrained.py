"""Diffusers-layout checkpoint loading into the port's depth pipeline.

Counterpart of ``rollingdepth_tpu/io/pretrained.py``: reads the
``model_index.json`` subfolders (unet, vae, scheduler, text_encoder,
tokenizer), loads each module's diffusers state dict into the port's
modules, calibrates the max-free attention gate on the loaded UNet when it
runs on the card, optionally quantizes the UNet to W8A8 (``quantize=``,
``ops/quant.py``) and precomputes the empty-prompt text embedding.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..models.clip_text import CLIPTextConfig, CLIPTextModel
from ..models.unet import UNet2DConditionModel, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..schedulers.ddim import DDIMConfig, DDIMScheduler
from ..utils.device import resolve_device
from .tokenizer import CLIPTokenizer
from .weights import load_config, load_module_state_dict

# "fp16" keeps the JAX package's meaning, bf16: the max-free kernel's
# exp2(s) reaches 2^96 by contract, which overflows fp16 but not bf16.
DTYPE_MAP = {
    "fp16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
    "float16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def _clip_key(key: str) -> Optional[str]:
    return None if "position_ids" in key else key.removeprefix("text_model.")


def load_unet(checkpoint_dir: str, dtype=torch.float32, device=None, subfolder: str = "unet"):
    unet = UNet2DConditionModel(UNetConfig.from_dict(load_config(checkpoint_dir, subfolder)),
                                device=device, dtype=dtype)
    unet.load_state_dict(load_module_state_dict(checkpoint_dir, subfolder))
    return unet


def load_vae(checkpoint_dir: str, dtype=torch.float32, device=None, subfolder: str = "vae"):
    vae = AutoencoderKL(VAEConfig.from_dict(load_config(checkpoint_dir, subfolder)), device=device, dtype=dtype)
    vae.load_state_dict(load_module_state_dict(checkpoint_dir, subfolder))
    return vae


def load_text_encoder(checkpoint_dir: str, dtype=torch.float32, device=None):
    model = CLIPTextModel(CLIPTextConfig.from_dict(load_config(checkpoint_dir, "text_encoder")),
                          device=device, dtype=dtype)
    sd = {}
    for k, v in load_module_state_dict(checkpoint_dir, "text_encoder").items():
        k2 = _clip_key(k)
        if k2 is not None:
            sd[k2] = v
    model.load_state_dict(sd)
    return model


def load_rollingdepth_pipeline(checkpoint_dir: str, dtype="fp16", snippet_batch: int = 8, quantize=None,
                               device=None):
    """Assemble the depth pipeline from a rollingdepth-v1-0-style checkpoint;
    ``quantize="w8a8"`` quantizes the UNet (``ops.quant.apply_quantize``)."""
    from ..ops.quant import apply_quantize
    from ..ops.score_probe import calibrate_nomax
    from ..pipelines.rollingdepth import RollingDepthPipeline

    dev = resolve_device(device)
    tdtype = DTYPE_MAP[dtype] if isinstance(dtype, str) else dtype
    unet = load_unet(checkpoint_dir, tdtype, dev).eval()
    if dev.type == "cuda":
        # the max-free kernel runs only on the card.  The JAX package skips
        # the probe on a quantized tree; the port probes the float weights,
        # before quantizing: W8A8 leaves q and k's projections within the
        # int8 grid of the float ones, and attention itself stays float
        calibrate_nomax(unet)
    unet = apply_quantize(unet, quantize)
    vae = load_vae(checkpoint_dir, tdtype, dev)
    scheduler = DDIMScheduler(DDIMConfig.from_dict(load_config(checkpoint_dir, "scheduler")))
    text_model = load_text_encoder(checkpoint_dir, torch.float32, dev).eval()
    tokenizer = CLIPTokenizer.from_pretrained(checkpoint_dir)
    ids = torch.tensor([tokenizer("", padding="do_not_pad")], device=dev)
    with torch.no_grad():
        empty_embed = text_model(ids)
    pipe = RollingDepthPipeline(unet, vae, scheduler, empty_embed, dtype=tdtype,
                                snippet_batch=snippet_batch, device=dev)
    pipe.tokenizer = tokenizer
    pipe.text_model = text_model
    return pipe


def load_pipeline(checkpoint_dir: str, dtype="fp16", **kwargs):
    """Dispatch on model_index.json's ``_class_name``: the depth pipeline,
    or the relight pipeline (``io/pretrained_relight.py``) for the relight,
    SD t2i/i2i and generation-3 class names, as the JAX loader does."""
    index_path = os.path.join(checkpoint_dir, "model_index.json")
    class_name = "RollingDepthPipeline"
    if os.path.exists(index_path):
        with open(index_path) as f:
            class_name = json.load(f).get("_class_name", class_name)
    if class_name in ("RollingDepthPipeline", "DiffusionPipeline"):
        return load_rollingdepth_pipeline(checkpoint_dir, dtype=dtype, **kwargs)
    if class_name in ("RollingImgPipeline", "StableDiffusionPipeline", "StableDiffusionImg2ImgPipeline"):
        from .pretrained_relight import load_relight_pipeline

        return load_relight_pipeline(checkpoint_dir, dtype=dtype, **kwargs)
    if class_name == "MyRollingDepthPipeline":
        from ..pipelines.my_rollingdepth import MyRollingDepthPipeline
        from .pretrained_relight import load_relight_pipeline

        return load_relight_pipeline(checkpoint_dir, dtype=dtype, pipeline_cls=MyRollingDepthPipeline, **kwargs)
    raise ValueError(f"Unknown pipeline class {class_name!r} in {index_path}")
