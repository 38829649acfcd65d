"""Euler-Ancestral scheduler on PyTorch tensors.

Counterpart of ``rollingdepth_tpu/schedulers/euler_ancestral.py``: the
relight reference constructs it but never registers it, so no pipeline
runs it; it is kept for the scheduler set.  The sigma table is built on
the host in numpy; ``step`` is a function of the step index, and takes its
Gaussian draw as ``noise``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .common import make_alphas_cumprod, spaced_timesteps


@dataclasses.dataclass(frozen=True)
class EulerAncestralConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"
    timestep_spacing: str = "linspace"
    steps_offset: int = 0
    rescale_betas_zero_snr: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "EulerAncestralConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class EulerAncestralScheduler:
    def __init__(self, config: EulerAncestralConfig = EulerAncestralConfig()):
        self.config = config
        self.alphas_cumprod = make_alphas_cumprod(config.num_train_timesteps, config.beta_start, config.beta_end,
                                                  config.beta_schedule, config.rescale_betas_zero_snr)
        if config.rescale_betas_zero_snr:
            # the zero-SNR rescale puts the terminal alphas_cumprod at 0 (sigma inf);
            # diffusers patches it to the smallest fp16 positive value
            self.alphas_cumprod[-1] = 2**-24

    def schedule(self, num_inference_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """(timesteps [T] float32, sigmas [T+1] float32); linspace spacing
        keeps float timesteps."""
        cfg = self.config
        if cfg.timestep_spacing == "linspace":
            timesteps = np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps, dtype=np.float32)[::-1].copy()
        else:
            timesteps = spaced_timesteps(cfg.num_train_timesteps, num_inference_steps, cfg.timestep_spacing,
                                         cfg.steps_offset).astype(np.float32)
        sigmas_all = ((1 - self.alphas_cumprod) / self.alphas_cumprod) ** 0.5
        sigmas = np.interp(timesteps, np.arange(len(sigmas_all)), sigmas_all)
        return timesteps, np.concatenate([sigmas, [0.0]]).astype(np.float32)

    @staticmethod
    def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
        return sample / torch.tensor(float(np.sqrt(np.float32(sigma) ** 2 + 1)), dtype=sample.dtype)

    def step(
        self,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        sigmas: np.ndarray,
        noise: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One ancestral step at ``step_index``.  Returns (prev_sample, pred_x0)."""
        sigmas = np.asarray(sigmas, dtype=np.float32)
        sigma, sigma_to = sigmas[int(step_index)], sigmas[int(step_index) + 1]
        x, out = sample.float(), model_output.float()
        if self.config.prediction_type == "epsilon":
            pred_x0 = x - float(sigma) * out
        elif self.config.prediction_type == "v_prediction":
            pred_x0 = out * float(-sigma / np.sqrt(sigma**2 + 1)) + x / float(sigma**2 + 1)
        else:
            raise ValueError(f"prediction_type {self.config.prediction_type!r}")

        sigma_up = np.sqrt(sigma_to**2 * (sigma**2 - sigma_to**2) / sigma**2)
        sigma_down = np.sqrt(sigma_to**2 - sigma_up**2)
        derivative = (x - pred_x0) / float(sigma)
        prev = x + derivative * float(sigma_down - sigma)
        prev = prev + noise.float() * float(sigma_up)
        return prev.to(model_output.dtype), pred_x0.to(model_output.dtype)

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
        """sigma-space noising: x = x0 + sigma * eps."""
        out = original_samples.float() + float(np.float32(sigma)) * noise.float()
        return out.to(original_samples.dtype)
