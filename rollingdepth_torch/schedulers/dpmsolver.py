"""Multistep DPM-Solver / DPM-Solver++ (with the SDE variants) on PyTorch tensors.

Counterpart of ``rollingdepth_tpu/schedulers/dpmsolver.py``.  The relight
pipeline runs it as ``sde-dpmsolver++`` with Karras sigmas and
``steps_offset=1`` (``io/pretrained_relight.py``), entering a 40-step
schedule at strength 0.5.

- ``schedule`` is the JAX module's float64 numpy math, copied: Karras
  sigmas, ``_sigma_to_t`` and the ``final_sigmas_type`` tail.
- The step's per-step scalars (alpha, sigma, lambda, h) are numpy float32
  host numbers, so a step launches only elementwise device work.
- The multistep memory is an explicit ``DPMState`` (the previous converted
  model output and the warm-up counter), passed in and returned.
- The order is chosen by eager branches: first order while warming up
  (``lower_order_nums < 1``) and at the lower-order final step, second
  order otherwise.  Only the branch taken is computed.
- The SDE variants take their Gaussian draw as ``noise``; callers key it by
  work item so that results do not depend on how the work is batched.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .common import make_betas, rescale_zero_terminal_snr


@dataclasses.dataclass(frozen=True)
class DPMSolverConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    solver_order: int = 2
    prediction_type: str = "epsilon"
    thresholding: bool = False
    sample_max_value: float = 1.0
    algorithm_type: str = "dpmsolver++"  # dpmsolver | dpmsolver++ | sde-dpmsolver | sde-dpmsolver++
    solver_type: str = "midpoint"  # midpoint | heun
    lower_order_final: bool = True
    euler_at_final: bool = False
    use_karras_sigmas: bool = False
    lambda_min_clipped: float = -float("inf")
    timestep_spacing: str = "linspace"
    steps_offset: int = 0
    final_sigmas_type: str = "zero"  # zero | sigma_min
    rescale_betas_zero_snr: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "DPMSolverConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class DPMState(NamedTuple):
    """Multistep memory: the previous step's converted model output (fp32)
    and the warm-up counter (capped at ``solver_order``)."""

    prev_converted: Optional[torch.Tensor]
    lower_order_nums: int

    @staticmethod
    def init() -> "DPMState":
        return DPMState(prev_converted=None, lower_order_nums=0)


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Invert the sigma schedule by piecewise log-linear interpolation."""
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma - log_sigmas[:, np.newaxis]
    low_idx = np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    t = (1 - w) * low_idx + w * high_idx
    return t.reshape(np.shape(sigma))


def _f32(x) -> np.float32:
    return np.float32(x)


class DPMSolverMultistepScheduler:
    def __init__(self, config: DPMSolverConfig = DPMSolverConfig()):
        if config.solver_order > 2:
            raise NotImplementedError("solver_order up to 2 implemented (the reference pipelines use 2)")
        if config.algorithm_type in ("dpmsolver", "sde-dpmsolver") and config.final_sigmas_type == "zero":
            # sigma_t = 0 makes lambda_t infinite for the non-++ algorithms
            raise ValueError(
                f"`final_sigmas_type` {config.final_sigmas_type!r} is not supported for `algorithm_type` "
                f"{config.algorithm_type!r}. Please choose `sigma_min` instead."
            )
        self.config = config
        betas = make_betas(config.num_train_timesteps, config.beta_start, config.beta_end, config.beta_schedule)
        if config.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        if config.rescale_betas_zero_snr:
            self.alphas_cumprod[-1] = 2**-24

    # ---- host-side schedule ------------------------------------------------
    def schedule(self, num_inference_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """(timesteps [T] int32, sigmas [T+1] float32), descending."""
        cfg = self.config
        ac = self.alphas_cumprod.astype(np.float64)
        sigmas_all = ((1 - ac) / ac) ** 0.5
        log_sigmas = np.log(sigmas_all)

        lambda_t = np.log(np.sqrt(ac)) - np.log(np.sqrt(1 - ac))
        clipped_idx = int(np.searchsorted(np.flip(lambda_t), cfg.lambda_min_clipped))
        last_timestep = cfg.num_train_timesteps - clipped_idx

        if cfg.timestep_spacing == "linspace":
            timesteps = (
                np.linspace(0, last_timestep - 1, num_inference_steps + 1).round()[::-1][:-1].astype(np.int64)
            )
        elif cfg.timestep_spacing == "leading":
            step_ratio = last_timestep // (num_inference_steps + 1)
            timesteps = (np.arange(0, num_inference_steps + 1) * step_ratio).round()[::-1][:-1].astype(np.int64)
            timesteps = timesteps + cfg.steps_offset
        elif cfg.timestep_spacing == "trailing":
            step_ratio = cfg.num_train_timesteps / num_inference_steps
            timesteps = np.arange(last_timestep, 0, -step_ratio).round().astype(np.int64) - 1
        else:
            raise ValueError(f"timestep_spacing {cfg.timestep_spacing!r}")

        if cfg.use_karras_sigmas:
            flipped = np.flip(sigmas_all)
            sigma_min, sigma_max = flipped[-1], flipped[0]
            rho = 7.0
            ramp = np.linspace(0, 1, num_inference_steps)
            sigmas = (sigma_max ** (1 / rho) + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
            timesteps = _sigma_to_t(sigmas, log_sigmas).round().astype(np.int64)
        else:
            sigmas = np.interp(timesteps, np.arange(len(sigmas_all)), sigmas_all)

        if cfg.final_sigmas_type == "sigma_min":
            sigma_last = ((1 - ac[0]) / ac[0]) ** 0.5
        elif cfg.final_sigmas_type == "zero":
            sigma_last = 0.0
        else:
            raise ValueError(f"final_sigmas_type {cfg.final_sigmas_type!r}")

        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        return timesteps.astype(np.int32), sigmas

    # ---- step math -----------------------------------------------------------
    @staticmethod
    def _alpha_sigma(sigma) -> Tuple[np.float32, np.float32]:
        sigma = _f32(sigma)
        alpha_t = _f32(1.0) / np.sqrt(sigma * sigma + _f32(1.0))
        return alpha_t, sigma * alpha_t

    @classmethod
    def _lambda(cls, sigma) -> Tuple[np.float32, np.float32, np.float32]:
        alpha, sig = cls._alpha_sigma(sigma)
        with np.errstate(divide="ignore"):  # sigma = 0 at the final step: lambda = inf, as in fp32 on the device
            return alpha, sig, np.log(alpha) - np.log(sig)

    def convert_model_output(self, model_output: torch.Tensor, sample: torch.Tensor, sigma) -> torch.Tensor:
        cfg = self.config
        out, sample = model_output.float(), sample.float()
        alpha_t, sigma_t = self._alpha_sigma(sigma)
        a, s = float(alpha_t), float(sigma_t)
        if cfg.algorithm_type in ("dpmsolver++", "sde-dpmsolver++"):
            if cfg.thresholding:
                raise NotImplementedError("dynamic thresholding not used by the reference")
            if cfg.prediction_type == "epsilon":
                return (sample - s * out) / a
            if cfg.prediction_type == "sample":
                return out
            if cfg.prediction_type == "v_prediction":
                return a * sample - s * out
            raise ValueError(f"prediction_type {cfg.prediction_type!r}")
        if cfg.prediction_type == "epsilon":
            return out
        if cfg.prediction_type == "sample":
            return (sample - a * out) / s
        if cfg.prediction_type == "v_prediction":
            return a * out + s * sample
        raise ValueError(f"prediction_type {cfg.prediction_type!r}")

    def _first_order(self, m0, sample, sigma_t_raw, sigma_s_raw, noise):
        algo = self.config.algorithm_type
        alpha_t, sigma_t, lam_t = self._lambda(sigma_t_raw)
        alpha_s, sigma_s, lam_s = self._lambda(sigma_s_raw)
        h = lam_t - lam_s
        one = _f32(1.0)
        if algo == "dpmsolver++":
            return float(sigma_t / sigma_s) * sample - float(alpha_t * (np.exp(-h) - one)) * m0
        if algo == "dpmsolver":
            return float(alpha_t / alpha_s) * sample - float(sigma_t * (np.exp(h) - one)) * m0
        if algo == "sde-dpmsolver++":
            e2 = one - np.exp(_f32(-2.0) * h)
            return (float(sigma_t / sigma_s * np.exp(-h)) * sample + float(alpha_t * e2) * m0
                    + float(sigma_t * np.sqrt(e2)) * noise)
        if algo == "sde-dpmsolver":
            return (float(alpha_t / alpha_s) * sample - float(_f32(2.0) * sigma_t * (np.exp(h) - one)) * m0
                    + float(sigma_t * np.sqrt(np.exp(_f32(2.0) * h) - one)) * noise)
        raise ValueError(f"algorithm_type {algo!r}")

    def _second_order(self, m0, m1, sample, sigma_t_raw, sigma_s0_raw, sigma_s1_raw, noise):
        cfg = self.config
        algo = cfg.algorithm_type
        alpha_t, sigma_t, lam_t = self._lambda(sigma_t_raw)
        alpha_s0, sigma_s0, lam_s0 = self._lambda(sigma_s0_raw)
        _, _, lam_s1 = self._lambda(sigma_s1_raw)
        h = lam_t - lam_s0
        r0 = (lam_s0 - lam_s1) / h
        d1 = float(_f32(1.0) / r0) * (m0 - m1)
        mid = cfg.solver_type == "midpoint"
        one, two = _f32(1.0), _f32(2.0)
        if algo == "dpmsolver++":
            em = np.exp(-h) - one
            base = float(sigma_t / sigma_s0) * sample - float(alpha_t * em) * m0
            if mid:
                return base - float(_f32(0.5) * alpha_t * em) * d1
            return base + float(alpha_t * (em / h + one)) * d1
        if algo == "dpmsolver":
            ep = np.exp(h) - one
            base = float(alpha_t / alpha_s0) * sample - float(sigma_t * ep) * m0
            if mid:
                return base - float(_f32(0.5) * sigma_t * ep) * d1
            return base - float(sigma_t * (ep / h - one)) * d1
        if algo == "sde-dpmsolver++":
            e2 = one - np.exp(-two * h)
            base = (float(sigma_t / sigma_s0 * np.exp(-h)) * sample + float(alpha_t * e2) * m0
                    + float(sigma_t * np.sqrt(e2)) * noise)
            if mid:
                return base + float(_f32(0.5) * alpha_t * e2) * d1
            return base + float(alpha_t * (e2 / (-two * h) + one)) * d1
        if algo == "sde-dpmsolver":
            ep = np.exp(h) - one
            base = (float(alpha_t / alpha_s0) * sample - float(two * sigma_t * ep) * m0
                    + float(sigma_t * np.sqrt(np.exp(two * h) - one)) * noise)
            if mid:
                return base - float(sigma_t * ep) * d1
            return base - float(two * sigma_t * (ep / h - one)) * d1
        raise ValueError(f"algorithm_type {algo!r}")

    def step(
        self,
        model_output: torch.Tensor,
        step_index: int,
        sample: torch.Tensor,
        sigmas: np.ndarray,
        num_steps: int,
        state: DPMState,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, DPMState]:
        """One multistep update at ``step_index`` (position in the full
        schedule).  The SDE variants take their draw as ``noise``, shaped
        like ``model_output``."""
        cfg = self.config
        sigmas = np.asarray(sigmas, dtype=np.float32)
        step_index = int(step_index)
        sample_f = sample.float()
        sigma_s0, sigma_t = sigmas[step_index], sigmas[step_index + 1]
        sigma_s1 = sigmas[max(step_index - 1, 0)]

        m0 = self.convert_model_output(model_output, sample_f, sigma_s0)
        if cfg.algorithm_type in ("sde-dpmsolver", "sde-dpmsolver++"):
            if noise is None:
                raise ValueError("SDE algorithm types require noise")
            noise = noise.to(device=m0.device, dtype=torch.float32)

        lower_order_final = step_index == num_steps - 1 and (
            cfg.euler_at_final or (cfg.lower_order_final and num_steps < 15) or cfg.final_sigmas_type == "zero"
        )
        if cfg.solver_order == 1 or state.lower_order_nums < 1 or lower_order_final:
            prev = self._first_order(m0, sample_f, sigma_t, sigma_s0, noise)
        else:
            prev = self._second_order(m0, state.prev_converted.float(), sample_f, sigma_t, sigma_s0, sigma_s1, noise)
        new_state = DPMState(prev_converted=m0, lower_order_nums=min(state.lower_order_nums + 1, cfg.solver_order))
        return prev.to(model_output.dtype), new_state

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
        """alpha/sigma noising at ``sigma`` (the img2img strength start)."""
        alpha_t, sigma_t = self._alpha_sigma(sigma)
        out = float(alpha_t) * original_samples.float() + float(sigma_t) * noise.float()
        return out.to(original_samples.dtype)
