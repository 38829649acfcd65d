"""Stable Diffusion text-to-image and image-to-image on PyTorch.

Counterpart of ``rollingdepth_tpu/pipelines/stable_diffusion.py``: the
reference's relight pipeline builds both over its SD1.5 parts; they made
the t2i init latents it loads from a precomputed blob.  Classifier-free
guidance (two UNet passes a step unless ``guidance_scale == 1``),
strength-skip img2img, the relight path's chunked prompt encoding and the
DPM++ scheduler.

Randomness: the JAX pipeline draws the init from ``PRNGKey(seed)`` and step
``i``'s SDE draw for the whole batch from ``fold_in(PRNGKey(seed), i)``.
Here ``init_noise`` ([B, 4, h, w]) and ``step_noise(i, shape)`` take those
draws when given; by default each comes from ``SeededNoise(seed)``, one
``torch.Generator`` per (seed, step).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..schedulers.dpmsolver import DPMState
from ..utils.device import resolve_device
from .rollingimg import SeededNoise, as_draw, encode_prompt_pair


class StableDiffusionPipeline:
    """Text-to-image (and image-to-image with ``image=`` and ``strength < 1``)."""

    def __init__(self, unet, vae, scheduler, tokenizer, text_apply, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.unet = unet.to(device=self.device, dtype=dtype).eval()  # 4-channel base UNet
        self.vae = vae.to(device=self.device, dtype=dtype).eval()
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.text_apply = text_apply

    @torch.no_grad()
    def _denoise(self, latents, cond, uncond, timesteps, sigmas, begin_index: int, num_steps: int,
                 guidance_scale: float, seed: int, step_noise: Optional[Callable]) -> torch.Tensor:
        b = latents.shape[0]
        state = DPMState.init()
        for i, t in enumerate(timesteps):
            x = latents[:, None]  # one-frame windows
            eps = self.unet(x, int(t), cond)[:, 0]
            if guidance_scale != 1.0:
                eps_u = self.unet(x, int(t), uncond)[:, 0]
                eps = eps_u + guidance_scale * (eps - eps_u)
            shape = (b,) + tuple(latents.shape[1:])
            draw = step_noise(i, shape) if step_noise is not None else SeededNoise(seed, self.device).draw(shape, 1, i)
            prev, state = self.scheduler.step(eps.float(), begin_index + i, latents.float(), sigmas, num_steps, state,
                                              noise=as_draw(draw, self.device))
            latents = prev.to(self.dtype)
        return latents

    @torch.no_grad()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 25,
        guidance_scale: float = 7.0,
        batch: int = 1,
        seed: int = 0,
        image: Optional[np.ndarray] = None,  # [B, 3, H, W] in [-1, 1] -> img2img
        strength: float = 0.8,
        output_latents: bool = False,
        init_noise: Optional[np.ndarray] = None,  # [B, 4, h, w]
        step_noise: Optional[Callable] = None,  # (step i, shape) -> draw
    ) -> np.ndarray:
        """Images [B, 3, H, W] in [-1, 1] (or latents [B, h, w, 4]), numpy."""
        dev, dtype = self.device, self.dtype
        timesteps, sigmas = self.scheduler.schedule(num_inference_steps)
        override = None
        if init_noise is not None:
            override = torch.as_tensor(np.asarray(init_noise, np.float32)).permute(0, 2, 3, 1).to(dev)
        if image is not None:
            # img2img: encode, then noise to the strength-skipped sigma
            init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
            t_start = max(num_inference_steps - init_timestep, 0)
            img = torch.as_tensor(np.asarray(image)).to(dev).permute(0, 2, 3, 1).to(dtype)
            lat0 = self.vae.encode_mean(img)
            draw = override if override is not None else SeededNoise(seed, dev).draw(lat0.shape, 0)
            latents = self.scheduler.add_noise(lat0.float(), draw, sigmas[t_start]).to(dtype)
        else:
            t_start = 0
            factor = 2 ** (len(self.vae.config.block_out_channels) - 1)  # 8 for the SD VAE
            shape = (batch, height // factor, width // factor, 4)
            latents = (override if override is not None else SeededNoise(seed, dev).draw(shape, 0)).to(dtype)

        c, uc = encode_prompt_pair(self.tokenizer, self.text_apply, prompt, negative_prompt)
        b = latents.shape[0]
        cond = c.to(device=dev, dtype=dtype).expand(b, -1, -1)
        uncond = uc.to(device=dev, dtype=dtype).expand(b, -1, -1)
        latents = self._denoise(latents, cond, uncond, timesteps[t_start:], sigmas, t_start, num_inference_steps,
                                guidance_scale, seed, step_noise)
        if output_latents:
            return latents.float().cpu().numpy()
        return self.vae.decode(latents).float().permute(0, 3, 1, 2).cpu().numpy()


class StableDiffusionImg2ImgPipeline(StableDiffusionPipeline):
    """img2img is the ``image=`` path of the base pipeline."""

    def __call__(self, prompt: str, image: np.ndarray, strength: float = 0.8, **kw):
        return super().__call__(prompt, image=image, strength=strength, **kw)
