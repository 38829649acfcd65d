"""DDIM scheduler on PyTorch tensors.

Counterpart of ``rollingdepth_tpu/schedulers/ddim.py``: a frozen config and
the schedule constants in numpy (``schedulers/common.py``).  Per-step
scalars are fp32 host numbers, so ``step`` launches only elementwise
device work.  Arithmetic is in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .common import make_alphas_cumprod, spaced_timesteps


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"
    rescale_betas_zero_snr: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "DDIMConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class DDIMScheduler:
    def __init__(self, config: DDIMConfig = DDIMConfig()):
        self.config = config
        self.alphas_cumprod = np.asarray(
            make_alphas_cumprod(config.num_train_timesteps, config.beta_start, config.beta_end,
                                config.beta_schedule, config.rescale_betas_zero_snr),
            dtype=np.float32,
        )
        self.final_alpha_cumprod = np.float32(1.0 if config.set_alpha_to_one else self.alphas_cumprod[0])

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timestep grid."""
        c = self.config
        return spaced_timesteps(c.num_train_timesteps, num_inference_steps, c.timestep_spacing, c.steps_offset)

    def step(
        self,
        model_output: torch.Tensor,
        timestep: int,
        sample: torch.Tensor,
        num_inference_steps: int,
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One reverse step; returns (prev_sample, pred_x0) in sample's dtype."""
        cfg = self.config
        t = int(timestep)
        prev_t = t - cfg.num_train_timesteps // num_inference_steps
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        b_t = np.float32(1.0) - a_t
        sq_a, sq_b = float(np.sqrt(a_t)), float(np.sqrt(b_t))

        x = sample.float()
        out = model_output.float()
        if cfg.prediction_type == "epsilon":
            pred_x0 = (x - sq_b * out) / sq_a
            pred_eps = out
        elif cfg.prediction_type == "sample":
            pred_x0 = out
            pred_eps = (x - sq_a * pred_x0) / sq_b
        elif cfg.prediction_type == "v_prediction":
            pred_x0 = sq_a * x - sq_b * out
            pred_eps = sq_a * out + sq_b * x
        else:
            raise ValueError(f"prediction_type {cfg.prediction_type!r}")
        if cfg.clip_sample:
            pred_x0 = pred_x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)

        std = np.float32(0.0)
        if eta > 0.0:
            variance = (np.float32(1.0) - a_prev) / b_t * (np.float32(1.0) - a_t / a_prev)
            std = np.float32(eta) * np.sqrt(np.float32(variance))
        prev = float(np.sqrt(a_prev)) * pred_x0 + float(np.sqrt(np.float32(1.0) - a_prev - std**2)) * pred_eps
        if eta > 0.0:
            if generator is None:
                raise ValueError("eta > 0 needs an explicit torch.Generator")
            noise = torch.randn(out.shape, generator=generator, device=out.device)
            prev = prev + float(std) * noise
        return prev.to(sample.dtype), pred_x0.to(sample.dtype)

    def _sqrt_alphas(self, sample: torch.Tensor, timesteps) -> Tuple[torch.Tensor, torch.Tensor]:
        """sqrt(a_t) and sqrt(1 - a_t) at ``timesteps`` ([B], [B, n] or a
        scalar), shaped to broadcast over the sample's trailing dims."""
        ac = torch.as_tensor(self.alphas_cumprod, device=sample.device)
        t = torch.as_tensor(timesteps, device=sample.device).long()
        sqrt_a = ac[t].sqrt()
        sqrt_1ma = (1.0 - ac[t]).sqrt()
        extra = (1,) * (sample.ndim - sqrt_a.ndim)
        return sqrt_a.reshape(sqrt_a.shape + extra), sqrt_1ma.reshape(sqrt_1ma.shape + extra)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        """Forward-noise clean samples to per-sample ``timesteps``."""
        sqrt_a, sqrt_1ma = self._sqrt_alphas(original, timesteps)
        return (sqrt_a * original.float() + sqrt_1ma * noise.float()).to(original.dtype)

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        """The v-prediction target ``sqrt(a_t) noise - sqrt(1 - a_t) sample``,
        in fp32, in the sample's dtype."""
        sqrt_a, sqrt_1ma = self._sqrt_alphas(sample, timesteps)
        return (sqrt_a * noise.float() - sqrt_1ma * sample.float()).to(sample.dtype)
