"""The RollingDepth video-depth path in plain fp32 PyTorch: the reference
that decides ``correct`` for the depth cells.

Written from RollingDepth's description (Ke et al., "Video Depth without
Video Models", CVPR 2025) and its public pipeline, with the settings a
workload's call dict names:
1. VAE-encode every frame (RGB in [-1, 1]);
2. windows of ``n`` frames at each dilation (capped so a window fits the
   clip), every window denoised from one shared noise map by v-prediction
   DDIM (trailing spacing) through the UNet, the RGB latents beside the
   depth latents on the channel axis and the empty prompt as context;
3. the latent merge: a scale and a shift per window, solved by Adam
   (optax's ``adam``, betas (0.5, 0.9)) on an L1 loss against each frame's
   detached mean over its windows, on a border-cropped, subsampled view;
   then the aligned windows averaged per frame at full resolution;
4. decode, mean over RGB, min-max to [-1, 1];
5. with ``refine_step`` > 0: re-encode the depth, noise it to the middle of
   a ``2 * refine_step`` DDIM schedule, and per step denoise a partition of
   the frames into windows whose dilation anneals to 1 (the phase rotating
   with the step), averaging per frame; decode, clip to [-1, 1].
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .models import AutoencoderKL, UNet2DConditionModel

# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def cap_dilation(seq_len: int, n: int, dilation: int) -> int:
    """The largest dilation whose window of ``n`` frames fits the clip."""
    return max(1, min(dilation, int(seq_len / n) - 1))


def windows(seq_len: int, n: int, dilation: int) -> np.ndarray:
    """[S, n]: every window ``[i, i + d, ..., i + (n - 1) d]`` that fits."""
    span = (n - 1) * dilation + 1
    return np.stack([np.arange(i, i + span, dilation) for i in range(seq_len - span + 1)])


def partition_windows(seq_len: int, n: int, dilation: int, phase: int) -> np.ndarray:
    """[S, n]: each chain of frames ``r, r + d, ...`` cut into consecutive
    windows of ``n`` starting at ``phase % n``, with a head window over the
    first positions and a tail window over the last."""
    out = []
    for r in range(dilation):
        chain = np.arange(r, seq_len, dilation)
        if len(chain) < n:
            out.append(chain[np.clip(np.arange(len(chain) - n, len(chain)), 0, len(chain) - 1)])
            continue
        p0 = phase % n
        starts = list(range(p0, len(chain) - n + 1, n))
        if p0 > 0:
            starts.insert(0, 0)
        if not starts or starts[-1] + n < len(chain):
            starts.append(len(chain) - n)
        out += [chain[s : s + n] for s in starts]
    return np.stack(out)


def refine_gap(i: int, steps: int, start_dilation: int) -> int:
    """The gap between a refinement window's frames at step ``i``: from
    ``start_dilation - 1`` down to 0."""
    return int((1 - i / steps) * (start_dilation - 1))


# ---------------------------------------------------------------------------
# DDIM (scaled-linear betas, trailing spacing, v-prediction)
# ---------------------------------------------------------------------------


class DDIM:
    def __init__(self, cfg: Dict):
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, cfg["num_train_timesteps"],
                            dtype=np.float64) ** 2
        self.train_steps = cfg["num_train_timesteps"]
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.final_alpha = 1.0 if cfg["set_alpha_to_one"] else self.alphas_cumprod[0]
        if (cfg["beta_schedule"], cfg["timestep_spacing"], cfg["prediction_type"]) != (
                "scaled_linear", "trailing", "v_prediction"):
            raise ValueError("the reference DDIM has scaled-linear betas, trailing spacing and v-prediction")

    def timesteps(self, steps: int) -> List[int]:
        return [int(t) - 1 for t in np.round(np.arange(self.train_steps, 0, -self.train_steps / steps))]

    def step(self, out: torch.Tensor, t: int, x: torch.Tensor, steps: int) -> torch.Tensor:
        prev = t - self.train_steps // steps
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[prev] if prev >= 0 else self.final_alpha
        sa, sb = float(np.sqrt(a_t)), float(np.sqrt(1.0 - a_t))
        x0, eps = sa * x - sb * out, sa * out + sb * x
        return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(1.0 - a_prev)) * eps

    def add_noise(self, x: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        a = self.alphas_cumprod[t]
        return float(np.sqrt(a)) * x + float(np.sqrt(1.0 - a)) * noise


# ---------------------------------------------------------------------------
# co-alignment
# ---------------------------------------------------------------------------


def frame_sum(rows: torch.Tensor, frames: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Sum ``rows`` [R, ...] into ``seq_len`` frames by ``frames`` [R]: one
    product with a one-hot [seq_len, R] matrix, so no atomic add and the same
    bits on every run."""
    onehot = torch.zeros((seq_len, rows.shape[0]), device=rows.device, dtype=rows.dtype)
    onehot[frames, torch.arange(rows.shape[0], device=rows.device)] = 1.0
    return (onehot @ rows.reshape(rows.shape[0], -1)).reshape((seq_len,) + tuple(rows.shape[1:]))


class SolveProblem:
    """The co-alignment objective of windows ``groups`` [S_g, n, h, w, C]
    (one per dilation) with frame indices ``idx`` [S_g, n], in ``dtype``:
    a scale and a shift a window, an L1 loss of the aligned windows against
    each frame's detached mean over its windows, on a border-cropped,
    subsampled view, relative to that mean's size, plus the soft terms."""

    def __init__(self, groups: List[torch.Tensor], idx: List[np.ndarray], seq_len: int, cfg: Dict,
                 dtype: torch.dtype = torch.float32):
        dev = groups[0].device
        self.cfg, self.seq_len, self.dtype = cfg, seq_len, dtype
        self.groups = [g.to(dtype) for g in groups]
        b, f = cfg["border"], cfg["factor"]
        self.mn = torch.stack([g.amin() for g in self.groups]).amin()
        self.views = [(g[:, :, b:-b:f, b:-b:f, :] - self.mn).reshape(g.shape[0], g.shape[1], -1)
                      for g in self.groups]
        self.sizes = [v.shape[0] for v in self.views]
        self.frames = torch.as_tensor(np.concatenate([m.reshape(-1) for m in idx]), device=dev, dtype=torch.long)
        self.counts = torch.as_tensor(np.bincount(self.frames.cpu().numpy(), minlength=seq_len), device=dev,
                                      dtype=dtype)
        self.p = self.views[0].shape[-1]
        self.denom = float(sum(v.shape[1] for v in self.views) * seq_len * self.p)

    def objective(self, s: List[torch.Tensor], t: List[torch.Tensor]) -> torch.Tensor:
        """The objective at scales ``s`` and shifts ``t`` (one tensor a dilation)."""
        cfg, p = self.cfg, self.p
        aligned = torch.cat([(v * si[:, None, None] + ti[:, None, None]).reshape(-1, p)
                             for v, si, ti in zip(self.views, s, t)])
        with torch.no_grad():
            target = frame_sum(aligned, self.frames, self.seq_len) / self.counts.clamp(min=1.0)[:, None]
            scale = target.abs().mean(-1).clamp(min=1e-12)
        loss = ((aligned - target[self.frames]) / scale[self.frames][:, None]).abs().sum() / self.denom
        soft = sum(cfg["lmda2"] * torch.relu(1.0 - si).pow(2).sum() / si.shape[0]
                   + cfg["lmda3"] * ti.pow(2).sum() / ti.shape[0] for si, ti in zip(s, t))
        return cfg["loss_scale"] * loss + soft

    @torch.no_grad()
    def merge(self, s: List[torch.Tensor], t: List[torch.Tensor]) -> torch.Tensor:
        """The aligned windows averaged per frame at full resolution [seq_len, h, w, C]."""
        rows = torch.cat([(g * si[:, None, None, None, None] + (ti - self.mn * si)[:, None, None, None, None])
                          .reshape((-1,) + tuple(g.shape[2:])) for g, si, ti in zip(self.groups, s, t)])
        return frame_sum(rows, self.frames, self.seq_len) / self.counts.clamp(min=1.0)[:, None, None, None] + self.mn


def solve(problem: SolveProblem):
    """The solve from s = 1, t = 0 by optax's ``adam`` (betas (0.5, 0.9)):
    (scales, shifts, the objective at the last step, before its update)."""
    dev, dtype, cfg = problem.views[0].device, problem.dtype, problem.cfg
    s = [torch.ones(n, device=dev, dtype=dtype, requires_grad=True) for n in problem.sizes]
    t = [torch.zeros(n, device=dev, dtype=dtype, requires_grad=True) for n in problem.sizes]
    params = s + t
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    b1, b2, eps, lr = 0.5, 0.9, 1e-8, cfg["lr"]
    total = torch.zeros((), device=dev)
    with torch.enable_grad():  # the path runs under no_grad
        for step in range(1, cfg["num_iterations"] + 1):
            total = problem.objective(s, t)
            grads = torch.autograd.grad(total, params)
            with torch.no_grad():
                for x, g, m, v in zip(params, grads, mu, nu):
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g * g)
                    x.sub_(lr * (m / (1 - b1**step)) / ((v / (1 - b2**step)).sqrt() + eps))
    return [x.detach() for x in s], [x.detach() for x in t], float(total.detach())


def solve_and_merge(groups: List[torch.Tensor], idx: List[np.ndarray], seq_len: int, cfg: Dict,
                    dtype: torch.dtype = torch.float32):
    """Latent co-alignment: ``groups`` [S_g, n, h, w, C] (one per dilation),
    ``idx`` their [S_g, n] frame indices -> (merged [seq_len, h, w, C], the
    objective at the last step, before its update).  ``dtype`` is the
    solve's (a control runs it a step below fp32)."""
    problem = SolveProblem(groups, idx, seq_len, cfg, dtype)
    s, t, last = solve(problem)
    return problem.merge(s, t), last


def merge_residual(groups: List[torch.Tensor], idx: List[np.ndarray], merged: torch.Tensor,
                   pixel_stride: int = 5) -> float:
    """How far ``merged`` [N, h, w, C] is from a merge of ``groups``: every
    frame the mean over its windows of ``s * window + u``, one (s, u) a
    window, fitted by least squares (fp64) on every ``pixel_stride``-th latent
    value; the worst frame's RMS residual over the spread of ``merged``."""
    dev, n_frames = merged.device, merged.shape[0]
    m = merged.double().reshape(n_frames, -1)[:, ::pixel_stride]
    x = torch.cat([g.double().reshape(g.shape[0], g.shape[1], -1)[:, :, ::pixel_stride] for g in groups])
    frames = np.concatenate([i for i in idx])  # [W, n]
    counts = torch.as_tensor(np.bincount(frames.reshape(-1), minlength=n_frames), device=dev, dtype=torch.float64)
    w_count, p = x.shape[0], m.shape[1]
    a = torch.zeros((n_frames, p, 2 * w_count), device=dev, dtype=torch.float64)
    for w in range(w_count):
        for j, fr in enumerate(frames[w]):
            a[fr, :, w] += x[w, j] / counts[fr]
            a[fr, :, w_count + w] += 1.0 / counts[fr]
    # gelsd: the shifts of windows that cover the same frames are not each determined
    a = a.reshape(-1, 2 * w_count)
    sol = torch.linalg.lstsq(a.cpu(), m.reshape(-1, 1).cpu(), driver="gelsd").solution.to(dev)
    resid = m - (a @ sol).reshape(n_frames, p)
    return float(resid.pow(2).mean(dim=1).sqrt().max() / m.std())


# ---------------------------------------------------------------------------
# the path
# ---------------------------------------------------------------------------


class DepthReference:
    """The depth path in fp32 on ``unet``, ``vae`` and the empty-prompt
    embedding ``context`` [1, L, D]; ``scheduler`` and ``solve`` are the
    configuration's DDIM and latent-solve settings.  Two stages:
    ``windows`` (encode, the windows' denoise) and ``finish`` (the solve
    and merge, decode, min-max, and refinement where the call refines), so
    that ``finish`` can also start from another path's windows."""

    def __init__(self, unet: UNet2DConditionModel, vae: AutoencoderKL, context: torch.Tensor, scheduler: Dict,
                 solve: Dict):
        self.unet, self.vae, self.context = unet, vae, context
        self.ddim = DDIM(scheduler)
        self.solve = solve

    def encode(self, x: torch.Tensor, bs: int) -> torch.Tensor:
        return torch.cat([self.vae.encode_mean(x[i : i + bs]) for i in range(0, x.shape[0], bs)])

    def decode_depth(self, z: torch.Tensor, bs: int) -> torch.Tensor:
        """[N, h, w, 4] -> [N, 1, H, W]: the decoded RGB's mean."""
        return torch.cat([self.vae.decode(z[i : i + bs]).mean(-1) for i in range(0, z.shape[0], bs)])[:, None]

    @staticmethod
    def window_index(n_frames: int, call: Dict) -> List[np.ndarray]:
        """[S_g, n] frame indices of each dilation's windows."""
        if not call["merge_in_latent"] or call.get("refine_in_latent") or set(call["strides"]) != {1}:
            raise ValueError("the reference runs stride-1 windows, the latent merge, refining from the re-encoded depth")
        (n,) = set(call["snippet_lengths"])
        return [windows(n_frames, n, cap_dilation(n_frames, n, d) if call["cap_dilation"] else d)
                for d in call["dilations"]]

    @torch.no_grad()
    def windows(self, frames: torch.Tensor, noise: torch.Tensor, call: Dict):
        """``frames`` [N, 3, H, W] uint8, ``noise`` [4, h, w] -> the frames'
        latents [N, h, w, 4] and every window's denoised latents, one
        [S_g, n, h, w, 4] a dilation."""
        bs, sb = call["max_vae_bs"], call["snippet_batch"]
        (steps,) = set(call["init_infer_steps"])
        rgb = self.encode(frames.permute(0, 2, 3, 1).float() / 127.5 - 1.0, bs)
        noise = noise.permute(1, 2, 0).float()
        idx = self.window_index(frames.shape[0], call)
        all_idx = torch.as_tensor(np.concatenate(idx), device=rgb.device, dtype=torch.long)
        lats = []
        for a in range(0, all_idx.shape[0], sb):
            r = rgb[all_idx[a : a + sb]]
            z = noise.expand(r.shape)
            for t in self.ddim.timesteps(steps):
                z = self.ddim.step(self.unet(torch.cat([r, z], -1), t, self.context), t, z, steps)
            lats.append(z)
        return rgb, list(torch.split(torch.cat(lats), [m.shape[0] for m in idx]))

    @torch.no_grad()
    def finish(self, rgb: torch.Tensor, groups: List[torch.Tensor], noise: torch.Tensor, call: Dict) -> torch.Tensor:
        """The windows' latents ``groups`` -> depth [N, 1, H, W] in [-1, 1]."""
        merged, _ = solve_and_merge([g.float() for g in groups], self.window_index(rgb.shape[0], call),
                                    rgb.shape[0], self.solve)
        return self.after_merge(rgb, merged, noise, call)

    @torch.no_grad()
    def after_merge(self, rgb: torch.Tensor, merged: torch.Tensor, noise: torch.Tensor, call: Dict) -> torch.Tensor:
        """The merged latents [N, h, w, 4] -> depth [N, 1, H, W] in [-1, 1]."""
        bs = call["max_vae_bs"]
        depth = self.decode_depth(merged.float(), bs)
        depth = (depth - depth.amin()) / (depth.amax() - depth.amin()) * 2.0 - 1.0
        if call["refine_step"] <= 0:
            return depth
        latent = self.encode(depth.expand(-1, 3, -1, -1).permute(0, 2, 3, 1), bs)
        latent = self.refine(rgb, latent, noise.permute(1, 2, 0).float(), call, call["snippet_batch"])
        return self.decode_depth(latent, bs).clamp(-1.0, 1.0)

    def refine(self, rgb, latent, noise, call: Dict, sb: int) -> torch.Tensor:
        n_frames, n = rgb.shape[0], call["refine_snippet_len"]
        start = call["refine_start_dilation"]
        if call["cap_dilation"]:
            start = cap_dilation(n_frames, n, start)
        total = 2 * call["refine_step"]
        ts = self.ddim.timesteps(total)[total // 2 :]
        z = self.ddim.add_noise(latent, noise.expand(latent.shape), ts[0])
        partition = call["merge_in_latent"] if call.get("turbo_refine") is None else call["turbo_refine"]
        for i, t in enumerate(ts):
            d = refine_gap(i, len(ts), start) + 1
            m = partition_windows(n_frames, n, d, phase=i) if partition else windows(n_frames, n, d)
            ids = torch.as_tensor(m, device=rgb.device, dtype=torch.long)
            outs = []
            for a in range(0, ids.shape[0], sb):
                ic = ids[a : a + sb]
                src = z[ic]
                prev = self.ddim.step(self.unet(torch.cat([rgb[ic], src], -1), t, self.context), t, src, total)
                outs.append(prev.reshape((-1,) + tuple(z.shape[1:])))
            acc = frame_sum(torch.cat(outs), ids.reshape(-1), n_frames)
            cnt = torch.as_tensor(np.bincount(m.reshape(-1), minlength=n_frames), device=z.device,
                                  dtype=torch.float32)[:, None, None, None]
            z = torch.where(cnt > 0, acc / cnt.clamp(min=1.0), z)
        return z
