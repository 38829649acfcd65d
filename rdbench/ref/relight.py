"""The IC-Light FBC relight path (RollingImg, generation 4) in plain fp32
PyTorch: the reference that decides ``correct`` for the relight cells.

Written from IC-Light's description (github.com/lllyasviel/IC-Light, the
``fbc`` model: the SD1.5 UNet with ``conv_in`` widened to 12 input
channels, zero-initialised, and the ``iclight_sd15_fbc`` offset added to
every weight; img2img at strength 0.5 of a 40-step DPM++ 2M SDE schedule
with Karras sigmas) and RollingImg's video path over it, with the
settings a workload's call dict names:
1. VAE-encode the fg and the bg frames (RGB in [-1, 1]) and lay the two
   latents side by side on the channel axis: the 8-channel condition;
2. the prompt pair through the CLIP text tower, one 77-token chunk (BOS,
   up to 75 ids, EOS padding) at a time, the cond chunks and then the
   uncond chunks laid along the token axis as one context: one UNet pass a
   step, no guidance;
3. the t2i init: every frame alone through the base 4-channel UNet for the
   first ``t_start`` steps of the schedule, from a Gaussian map of its own;
4. windows of ``n`` frames at each dilation (capped so a window fits the
   clip), each denoised from its frames' init latents for the remaining
   steps through the 12-channel UNet, input ``[latent, condition]``;
5. every window frame decoded to RGB;
6. R, G and B each co-aligned on their own: a scale and a shift a window
   solved by Adam (betas (0.5, 0.9)) on an L1 loss against each frame's
   detached mean over its windows plus the same loss of the inverse values
   (clamped at 1e-3), on a border-cropped, subsampled view
   (``ref.depth.SolveProblem`` with that term added), the aligned windows
   averaged per frame at full resolution, and the channel shifted to a
   minimum of 0 and divided by its maximum.

Departures from the published description:
- the Gaussian draws are not a diffusers generator's: each is keyed as the
  program keys its own (``KeyedNoise``: splitmix64 of (seed, kind, id,
  step), one ``torch.Generator`` a key, on the device), so both sides see
  the same noise; window ids restart at 0 at every dilation, and a t2i
  step of frame k and the same step of window k of any dilation share a
  key (both are kind 2);
- the t2i init runs per clip, where RollingImg loads a precomputed blob;
- the prompts arrive as token ids (the configuration's), not as text
  through CLIP's BPE;
- the SDE step's scalars are float64 numbers of the float32 sigmas, where
  diffusers computes them in float32.
Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .depth import SolveProblem, cap_dilation, frame_sum, solve, windows
from .models import AutoencoderKL, CLIPTextModel, UNet2DConditionModel

# ---------------------------------------------------------------------------
# keyed noise
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1
SHARED, FRAME, STEP = 0, 1, 2  # the kinds of draw: a shared map, a frame's init, a sampler step


def key_seed(*key: int) -> int:
    """A 63-bit generator seed from a tuple of integers: splitmix64's mixing
    rounds over the key, one integer at a time."""
    h = 0x9E3779B97F4A7C15
    for v in key:
        h = ((h ^ (int(v) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


class KeyedNoise:
    """N(0, 1) draws, one ``torch.Generator`` seeded by ``key_seed(seed, *key)`` a key."""

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)

    def draw(self, shape: Sequence[int], *key: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(key_seed(self.seed, *key))
        return torch.randn(tuple(shape), generator=gen, device=self.device)

    def frame(self, frame: int, shape) -> torch.Tensor:
        return self.draw(shape, FRAME, frame)

    def step(self, item: int, step: int, shape) -> torch.Tensor:
        return self.draw(shape, STEP, item, step)


# ---------------------------------------------------------------------------
# DPM++ 2M SDE with Karras sigmas (diffusers' DPMSolverMultistepScheduler)
# ---------------------------------------------------------------------------


class DPMSolverSDE:
    """``sde-dpmsolver++``, second order (midpoint), epsilon prediction,
    Karras sigmas, the last step first order to a final sigma of 0."""

    def __init__(self, cfg: Dict):
        want = {"algorithm_type": "sde-dpmsolver++", "use_karras_sigmas": True, "solver_order": 2,
                "solver_type": "midpoint", "prediction_type": "epsilon", "final_sigmas_type": "zero",
                "lower_order_final": True, "euler_at_final": False}
        if any(cfg.get(k, v) != v for k, v in want.items()):
            raise ValueError(f"the reference scheduler is {want}")
        n, b0, b1 = cfg["num_train_timesteps"], cfg["beta_start"], cfg["beta_end"]
        if cfg["beta_schedule"] == "linear":
            betas = torch.linspace(b0, b1, n, dtype=torch.float32)
        elif cfg["beta_schedule"] == "scaled_linear":
            betas = torch.linspace(b0**0.5, b1**0.5, n, dtype=torch.float32) ** 2
        else:
            raise ValueError(f"beta_schedule {cfg['beta_schedule']!r}")
        ac = torch.cumprod(1.0 - betas, dim=0).double().numpy()
        self.train_sigmas = ((1.0 - ac) / ac) ** 0.5

    def schedule(self, steps: int):
        """(timesteps [steps] ints, sigmas [steps + 1] float32), descending."""
        log_sigmas = np.log(self.train_sigmas)
        lo, hi, rho = self.train_sigmas[0], self.train_sigmas[-1], 7.0
        ramp = np.linspace(0.0, 1.0, steps)
        sigmas = (hi ** (1 / rho) + ramp * (lo ** (1 / rho) - hi ** (1 / rho))) ** rho
        timesteps = [int(np.round(self._sigma_to_t(s, log_sigmas))) for s in sigmas]
        return timesteps, np.append(sigmas, 0.0).astype(np.float32)

    @staticmethod
    def _sigma_to_t(sigma: float, log_sigmas: np.ndarray) -> float:
        """The train step of ``sigma``: log-linear between its two neighbours."""
        log_sigma = np.log(max(sigma, 1e-10))
        low = min(int(np.cumsum(log_sigma - log_sigmas >= 0).argmax()), len(log_sigmas) - 2)
        w = np.clip((log_sigmas[low] - log_sigma) / (log_sigmas[low] - log_sigmas[low + 1]), 0.0, 1.0)
        return (1.0 - w) * low + w * (low + 1)

    @staticmethod
    def _alpha_sigma_lambda(sigma: float):
        alpha = 1.0 / math.sqrt(sigma * sigma + 1.0)
        sig = sigma * alpha
        return alpha, sig, (math.log(alpha) - math.log(sig)) if sig > 0 else math.inf

    def step(self, eps: torch.Tensor, i: int, x: torch.Tensor, sigmas: np.ndarray, prev_x0: Optional[torch.Tensor],
             noise: torch.Tensor):
        """One step from ``sigmas[i]`` to ``sigmas[i + 1]``: (the new sample,
        this step's x0 prediction, which is the next step's ``prev_x0``).
        First order at a run's first step (``prev_x0`` None) and at the
        schedule's last."""
        x, eps = x.float(), eps.float()
        a0, s0, l0 = self._alpha_sigma_lambda(float(sigmas[i]))
        at, st, lt = self._alpha_sigma_lambda(float(sigmas[i + 1]))
        x0 = (x - s0 * eps) / a0
        h = lt - l0
        e1, e2 = math.exp(-h), -math.expm1(-2.0 * h)  # exp(-h), 1 - exp(-2h)
        out = (st / s0 * e1) * x + (at * e2) * x0 + (st * math.sqrt(e2)) * noise
        if prev_x0 is not None and i != len(sigmas) - 2:
            _, _, l1 = self._alpha_sigma_lambda(float(sigmas[i - 1]))
            d1 = (x0 - prev_x0) / ((l0 - l1) / h)
            out = out + (0.5 * at * e2) * d1
        return out, x0


# ---------------------------------------------------------------------------
# the colour solve: the depth solve with the inverse term
# ---------------------------------------------------------------------------


class ColourSolve(SolveProblem):
    """``SolveProblem`` plus ``depth_loss_weight`` times the same relative
    L1 loss on the inverse of the aligned views (clamped at 1e-3), whose
    targets are each frame's detached mean of the inverses."""

    def objective(self, s: List[torch.Tensor], t: List[torch.Tensor]) -> torch.Tensor:
        total = super().objective(s, t)
        weight = self.cfg["depth_loss_weight"]
        if not weight:
            return total
        inv = torch.cat([(v * si[:, None, None] + ti[:, None, None]).reshape(-1, self.p)
                         for v, si, ti in zip(self.views, s, t)]).clamp(min=1e-3).reciprocal()
        with torch.no_grad():
            target = frame_sum(inv, self.frames, self.seq_len) / self.counts.clamp(min=1.0)[:, None]
            scale = target.abs().mean(-1).clamp(min=1e-12)
        loss = ((inv - target[self.frames]) / scale[self.frames][:, None]).abs().sum() / self.denom
        return total + self.cfg["loss_scale"] * weight * loss


def normalise(merged: torch.Tensor) -> torch.Tensor:
    """A channel shifted to a minimum of 0 and divided by its maximum."""
    merged = merged - merged.amin()
    return merged / merged.amax().clamp(min=1e-8)


# ---------------------------------------------------------------------------
# the path
# ---------------------------------------------------------------------------


def prompt_chunks(ids: Sequence[int], bos: int, eos: int, length: int) -> List[List[int]]:
    """``ids`` cut into chunks of ``length - 2``, each with BOS and EOS and padded with EOS to ``length``."""
    body = length - 2
    chunks = [[bos] + list(ids[i : i + body]) + [eos] for i in range(0, max(len(ids), 1), body)]
    return [c + [eos] * (length - len(c)) for c in chunks]


@torch.no_grad()
def prompt_context(text: CLIPTextModel, cond_ids: Sequence[int], uncond_ids: Sequence[int], bos: int, eos: int,
                   device) -> torch.Tensor:
    """[1, 2 k L, D]: the cond chunks, then the uncond chunks, each through
    the text tower alone; the shorter prompt's chunks repeat to the longer's
    count k."""
    length = text.config.max_position_embeddings
    c, u = (prompt_chunks(ids, bos, eos, length) for ids in (cond_ids, uncond_ids))
    k = max(len(c), len(u))
    c, u = (x * math.ceil(k / len(x)) for x in (c, u))
    embed = [text(torch.tensor([chunk], device=device)) for chunk in c[:k] + u[:k]]
    return torch.cat(embed, dim=1)


class RelightReference:
    """The relight path in fp32 on the base UNet ``base``, the 12-channel
    UNet ``unet``, ``vae`` and the prompt context ``context`` [1, L, D];
    ``scheduler`` and ``solve`` are the configuration's settings, ``seed``
    the call's (the noise).  Each stage takes its input from the caller, so
    that it can start from another path's state."""

    def __init__(self, base: UNet2DConditionModel, unet: UNet2DConditionModel, vae: AutoencoderKL,
                 context: torch.Tensor, scheduler: Dict, solve_cfg: Dict, seed: int,
                 keep: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """``keep`` rounds the latents a sampler carries from one step to the
        next (a control's lower precision); by default they stay fp32."""
        self.base, self.unet, self.vae, self.context = base, unet, vae, context
        self.sampler = DPMSolverSDE(scheduler)
        self.solve_cfg = solve_cfg
        self.noise = KeyedNoise(seed, context.device)
        self.keep = keep or (lambda z: z)

    @staticmethod
    def window_index(n_frames: int, call: Dict) -> List[np.ndarray]:
        """[S_g, n] frame indices of each dilation's windows."""
        if set(call["strides"]) != {1} or call.get("turbo") or call["init_mode"] != "t2i":
            raise ValueError("the reference runs stride-1 windows from the t2i init")
        (n,) = set(call["snippet_lengths"])
        return [windows(n_frames, n, cap_dilation(n_frames, n, d) if call["cap_dilation"] else d)
                for d in call["dilations"]]

    @staticmethod
    def window_ids(idx: List[np.ndarray]) -> np.ndarray:
        """Each window's noise id: its row within its dilation."""
        return np.concatenate([np.arange(m.shape[0]) for m in idx])

    def steps(self, call: Dict):
        """(timesteps, sigmas, t_start): the schedule entered at ``strength``."""
        total = call["num_inference_steps"]
        timesteps, sigmas = self.sampler.schedule(total)
        return timesteps, sigmas, total - min(int(total * call["strength"]), total)

    @torch.no_grad()
    def encode(self, frames: torch.Tensor, bs: int) -> torch.Tensor:
        """uint8 [N, 3, H, W] -> scaled latents [N, h, w, 4]."""
        x = frames.permute(0, 2, 3, 1).float() / 127.5 - 1.0
        return torch.cat([self.vae.encode_mean(x[i : i + bs]) for i in range(0, x.shape[0], bs)])

    @torch.no_grad()
    def t2i(self, frames: Sequence[int], hw, call: Dict) -> torch.Tensor:
        """The init latents [len(frames), h, w, 4] of frames ``frames``."""
        timesteps, sigmas, t_start = self.steps(call)
        shape = tuple(hw) + (4,)
        z = torch.stack([self.noise.frame(f, shape) for f in frames])
        prev = None
        for i in range(t_start):
            eps = self.base(z[:, None], timesteps[i], self.context)[:, 0]
            noise = torch.stack([self.noise.step(f, i, shape) for f in frames])
            z, prev = self.sampler.step(eps, i, z, sigmas, prev, noise)
            z = self.keep(z)
        return z

    @torch.no_grad()
    def denoise(self, cond: torch.Tensor, init: torch.Tensor, ids: Sequence[int], call: Dict) -> torch.Tensor:
        """Windows' conditions [W, n, h, w, 8] and init latents [W, n, h, w, 4],
        noise ids ``ids`` -> their denoised latents [W, n, h, w, 4]."""
        timesteps, sigmas, t_start = self.steps(call)
        z, prev = init.float(), None
        for i, t in enumerate(timesteps[t_start:]):
            eps = self.unet(torch.cat([z, cond], -1), t, self.context)
            noise = torch.stack([self.noise.step(k, i, z.shape[1:]) for k in ids])
            z, prev = self.sampler.step(eps, t_start + i, z, sigmas, prev, noise)
            z = self.keep(z)
        return z

    @torch.no_grad()
    def decode(self, z: torch.Tensor, bs: int) -> torch.Tensor:
        """[M, h, w, 4] -> RGB [M, H, W, 3]."""
        return torch.cat([self.vae.decode(z[i : i + bs].float()) for i in range(0, z.shape[0], bs)])

    @torch.no_grad()
    def solves(self, decoded: torch.Tensor, idx: List[np.ndarray], n_frames: int,
               dtype: torch.dtype = torch.float32) -> List[tuple]:
        """Every window frame's RGB [S, n, H, W, 3] (the windows of ``idx``
        in order) -> for R, G and B: (its ``ColourSolve``, the solved scales,
        the solved shifts), each one tensor a dilation.  ``dtype`` is the
        solve's (a control runs it a step below fp32)."""
        sizes = [m.shape[0] for m in idx]
        out = []
        for ch in range(3):
            problem = ColourSolve(list(torch.split(decoded[..., ch : ch + 1].float(), sizes)), idx, n_frames,
                                  self.solve_cfg, dtype)
            s, t, _ = solve(problem)
            out.append((problem, s, t))
        return out

    @staticmethod
    def colours(solved: List[tuple]) -> torch.Tensor:
        """``solves``' channels merged and normalised: R, G and B [3, N, 1, H, W]."""
        return torch.stack([normalise(p.merge(s, t).float()).permute(0, 3, 1, 2) for p, s, t in solved])
