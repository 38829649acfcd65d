"""Builder of the depth cells: rollingdepth-v1-0 through ``RollingDepthPipeline.forward``.

A builder is everything of one entry that the general harness
(``rdbench/run.py``, ``control.py``, ``traffic.py``) asks for, found by
the name a configuration gives; a later entry adds a builder of its own:
- ``KINDS`` and ``draw_clip``: the traffic kinds it reads and a clip's
  contents; ``PHASE_PREFIXES``, ``PHASES``: its spans and the phases of
  each layer the per-layer metrics read;
- ``Program`` (``run``, ``timings``, ``counters``, ``setup_detail``,
  ``close``), ``sound``, ``clip_counts``;
- ``NUMBERS``, ``Reference(...).numbers`` and ``readings``: the check and
  its control.

The program side builds the port's UNet, VAE and text tower on the meta
device and loads the benchmark's seeded weights into them by their
diffusers names, calibrates the max-free attention gate on the UNet as the
loader does, embeds the empty prompt with the port's text tower, and wraps
them in the port's pipeline.  A clip is uploaded, run through ``forward``
with the clip's noise map as ``init_noise`` and the cell's call, and its
depth fetched to the host as a float32 array.

The reference side loads the same weights, cast to fp32, into the plain
modules of ``rdbench/ref`` and follows the program stage by stage
(``ref.depth``), each later stage from the program's own state:
- ``window_err``: every window's denoised latents (encode, UNet, DDIM),
  the program's against the reference's from the same frames and noise:
  the worst window's RMS difference over the reference windows' spread;
- ``depth_err``: the depth against the reference's solve, merge, decode,
  min-max and refinement run on the program's windows: the worst frame's
  RMS difference over the reference depth's spread;
- ``merge_err``: how far the program's merged latents are from any merge
  of its windows (``ref.depth.merge_residual``);
- ``solve_merge_err``: the program's merged latents against the
  reference's solve and merge of the program's windows: the worst frame's
  RMS difference over the reference merge's spread;
- ``decode_err``: the depth against the reference's decode, min-max and
  refinement of the program's merged latents, as ``depth_err``.
The solve's L1 residuals near 0 take their sign from rounding, and each
step of Adam moves a window by lr either way, so two solves of windows
that differ by the program's rounding part by far more than the windows
do; a number downstream of the solve that starts from the reference's
windows carries that, which refinement damps and the `fast` path does not
(``PERF.md``).  Each limit is set from the program's and its control's
readings.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import check, weights
from ..counts import module_counts, scaled, total
from ..ref import lowp, models as R
from ..ref.depth import (DepthReference, SolveProblem, cap_dilation, merge_residual, partition_windows, refine_gap,
                         solve, windows)

EMPTY_PROMPT_IDS = (49406, 49407)  # the CLIP tokenizer's BOS, EOS: the empty prompt
SERVED = {"bf16": torch.bfloat16, "fp32": torch.float32}
LATENT_STRIDE = 8  # the VAE's downsampling
KINDS = ("depth",)  # uint8 RGB frames and one shared noise map of the latent's size
PHASE_PREFIXES = ("rollingdepth.",)  # the pipeline's PhaseTimer spans
# the pipeline's phases by layer; ``refine`` also holds its re-encode and final decode
PHASES = {"unet": ("snippet_infer", "refine"), "vae": ("encode", "decode"), "coalign": ("coalign",)}
NUMBERS = ("window_err", "depth_err", "merge_err", "solve_merge_err", "decode_err")
SOLVE_NUMBERS = {"merge_err", "solve_merge_err"}  # from the program's windows alone


def draw_clip(rng: np.random.Generator, n: int, traffic: Dict) -> Dict[str, np.ndarray]:
    """``frames`` [n, 3, H, W] uint8 (uniform bytes: the work of every stage
    depends on the clip's shape alone) and ``noise`` [4, h, w] float32."""
    h, w = traffic["height"], traffic["width"]
    frames = rng.bit_generator.random_raw(n * 3 * h * w // 8).view(np.uint8).reshape(n, 3, h, w)
    noise = rng.standard_normal((4, h // LATENT_STRIDE, w // LATENT_STRIDE), dtype=np.float32)
    return {"frames": frames, "noise": noise}


def meta_models(cfg: Dict):
    """The reference's UNet, VAE and text tower on the meta device."""
    with torch.device("meta"):
        return (R.UNet2DConditionModel(R.UNetConfig.from_dict(cfg["unet"])),
                R.AutoencoderKL(R.VAEConfig.from_dict(cfg["vae"])),
                R.CLIPTextModel(R.CLIPTextConfig.from_dict(cfg["text_encoder"])))


def draw(cfg: Dict, seed: int, device):
    """The seeded state dicts of the UNet and VAE (served dtype) and of the text tower (fp32)."""
    dtype = SERVED[cfg["dtype"]]
    return weights.draw_models(meta_models(cfg), [dtype, dtype, torch.float32], seed, device)


class Program:
    """The port's depth pipeline for one cell, with ``quantize`` its W8A8 UNet."""

    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, quantize: Optional[str] = None):
        from rollingdepth_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
        from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
        from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
        from rollingdepth_torch.ops.quant import apply_quantize
        from rollingdepth_torch.ops.score_probe import calibrate_nomax
        from rollingdepth_torch.pipelines.rollingdepth import RollingDepthPipeline
        from rollingdepth_torch.schedulers.ddim import DDIMConfig, DDIMScheduler

        self.device = torch.device(device)
        call = dict(cell["call"])
        snippet_batch = call.pop("snippet_batch")  # the pipeline's, not the entry's
        # the configuration's solve settings, handed to the entry as the reference reads them
        self.call = dict(call, latent_coalign_kwargs=cfg["latent_solve"])
        sd_unet, sd_vae, sd_text = draw(cfg, seed, self.device)
        unet = UNet2DConditionModel(UNetConfig.from_dict(cfg["unet"]), device="meta")
        vae = AutoencoderKL(VAEConfig.from_dict(cfg["vae"]), device="meta")
        text = CLIPTextModel(CLIPTextConfig.from_dict(cfg["text_encoder"]), device="meta")
        for module, sd in ((unet, sd_unet), (vae, sd_vae), (text, sd_text)):
            module.load_state_dict(sd, assign=True)
        unet.eval(), vae.eval(), text.eval()
        # the loader's order: the gate on the float UNet, then W8A8
        self.gate_bound = calibrate_nomax(unet) if self.device.type == "cuda" else None
        apply_quantize(unet, quantize)
        with torch.no_grad():
            empty = text(torch.tensor([EMPTY_PROMPT_IDS], device=self.device))
        del text, sd_text
        self.pipe = RollingDepthPipeline(unet, vae, DDIMScheduler(DDIMConfig.from_dict(cfg["scheduler"])), empty,
                                         dtype=SERVED[cfg["dtype"]], snippet_batch=snippet_batch, device=self.device)
        self._decoded = []
        decode = vae.decode

        def recorded(z):  # the latents the VAE decodes: the merge's first, then refinement's
            self._decoded.append(z)
            return decode(z)

        vae.decode = recorded

    def run(self, clip: Dict[str, np.ndarray], verbose: bool = False) -> Dict:
        """Upload the clip, run the entry, fetch the depth [N, 1, H, W] (float32)
        to the host.  What the call made on the way stays on the card: every
        window's latents and the merged latents."""
        self._decoded = []
        frames = torch.from_numpy(clip["frames"]).to(self.device)
        depth = self.pipe.forward(frames, init_noise=clip["noise"], verbose=verbose, **self.call).depth_pred
        return {"depth": depth, "windows": self.pipe.last_window_latents,
                "merged": torch.cat(self._decoded)[: frames.shape[0]]}

    @property
    def timings(self) -> Dict[str, float]:
        return dict(self.pipe.last_timings)

    def counters(self) -> Dict:
        """The program's own counters, where it has them: kernel launches, the
        solve's captures, the gate (None for one it no longer keeps)."""
        from rollingdepth_torch import aligner
        from rollingdepth_torch.ops import attention, flash_attention as fa, group_norm as gn

        def read(get):
            try:
                return get()
            except (AttributeError, TypeError):
                return None

        return {"k1_launches": read(lambda: fa.flash_attention_nomax.launches),
                "k2_launches": read(lambda: fa.flash_attention_max.launches),
                "k3_launches": read(lambda: fa.flash_attention_wide.launches),
                "groupnorm_launches": read(lambda: gn.group_norm.launches),
                "solve_captures": read(lambda: sum(s.captures for s in aligner._SOLVES.values())),
                "max_free_gate_open": read(attention.nomax_allowed), "gate_bound": self.gate_bound}

    def setup_detail(self) -> Dict[str, float]:
        """Set-up's parts that are the program's: the seconds nvcc took (a
        checkout's first run; 0 once the build cache holds every kernel)."""
        from rollingdepth_torch.ops import _build

        return {"nvcc_s": sum(getattr(_build, "build_seconds", {}).values())}

    def close(self) -> None:
        """Free the program's weights and activations."""
        del self.pipe
        self._decoded = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sound(output: Dict, clip_frames: int, traffic: Dict) -> bool:
    """A served clip's depth: in shape, finite, within [-1, 1]."""
    depth = output["depth"]
    return (depth.shape == (clip_frames, 1, traffic["height"], traffic["width"]) and bool(np.isfinite(depth).all())
            and float(np.abs(depth).max()) <= 1.0001)


class Reference:
    """The plain depth path on the same weights, in fp32 with TF32 off, or
    with ``precision="fp8"`` its products in e4m3 (``ref/lowp.py``, a control).
    The models are built at first use: the solve's numbers need none."""

    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, precision: str = "fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.seed, self.precision = cfg, seed, precision
        self.device = torch.device(device)
        self.call = cell["call"]
        self.solve_cfg = cfg["latent_solve"]
        self._path = None

    @property
    def path(self) -> DepthReference:
        if self._path is None:
            modules = meta_models(self.cfg)
            for module, sd in zip(modules, draw(self.cfg, self.seed, self.device)):
                module.load_state_dict({k: v.float() for k, v in sd.items()}, assign=True)
                module.eval()
            unet, vae, text = modules
            with torch.no_grad():
                context = text(torch.tensor([EMPTY_PROMPT_IDS], device=self.device))
            if self.precision == "fp8":
                lowp.fp8_(unet), lowp.fp8_(vae)
            self._path = DepthReference(unet, vae, context, self.cfg["scheduler"], self.solve_cfg)
        return self._path

    def windows(self, clip: Dict[str, np.ndarray]):
        """The clip's frame latents and every window's latents."""
        dev = self.device
        return self.path.windows(torch.from_numpy(clip["frames"]).to(dev), torch.from_numpy(clip["noise"]).to(dev),
                                 self.call)

    def finish(self, rgb: torch.Tensor, windows, clip: Dict[str, np.ndarray]) -> np.ndarray:
        """The depth from the latents ``windows`` (another path's, or its own)."""
        noise = torch.from_numpy(clip["noise"]).to(self.device)
        return self.path.finish(rgb, [w.to(self.device) for w in windows], noise, self.call).cpu().numpy()

    def after_merge(self, rgb: torch.Tensor, merged: torch.Tensor, clip: Dict[str, np.ndarray]) -> np.ndarray:
        """The depth from the merged latents ``merged`` (another path's)."""
        noise = torch.from_numpy(clip["noise"]).to(self.device)
        return self.path.after_merge(rgb, merged.to(self.device), noise, self.call).cpu().numpy()

    def problem(self, windows, n_frames: int, dtype=torch.float32):
        """The solve's problem on ``windows`` (another path's), and its windows' frame indices."""
        idx = DepthReference.window_index(n_frames, self.call)
        return SolveProblem([w.to(self.device).float() for w in windows], idx, n_frames, self.solve_cfg, dtype), idx

    def numbers(self, clip: Dict[str, np.ndarray], output: Dict, names, start=None) -> Dict[str, float]:
        """The numbers ``names`` (of ``NUMBERS``) of the program's ``output``
        for ``clip``; ``start`` is this reference's ``windows(clip)``, if made."""
        n_frames, out = clip["frames"].shape[0], {}
        if set(names) - SOLVE_NUMBERS:
            rgb, windows = start or self.windows(clip)
        if "window_err" in names:
            out["window_err"] = check.worst_rel_err(output["windows"], windows)
        if "depth_err" in names:
            out["depth_err"] = check.worst_rel_err([output["depth"]], [self.finish(rgb, output["windows"], clip)])
        if "merge_err" in names:
            idx = DepthReference.window_index(n_frames, self.call)
            out["merge_err"] = merge_residual(output["windows"], idx, output["merged"])
        if "solve_merge_err" in names:
            problem, _ = self.problem(output["windows"], n_frames)
            out["solve_merge_err"] = check.worst_rel_err([output["merged"]], [problem.merge(*solve(problem)[:2])])
        if "decode_err" in names:
            out["decode_err"] = check.worst_rel_err([output["depth"]], [self.after_merge(rgb, output["merged"], clip)])
        return out


def readings(spec: Dict, seed: int, device, names) -> Dict:
    """The readings a cell's limits are set from (``rdbench/control.py``):
    clip 0 of ``seed`` at the cell's own size and call, after a warm-up
    clip; the program's numbers ``names`` and each one's control, one
    precision step below the one its stage runs in:
    - ``window_err``: the program with its own int8 path switched on (the
      W8A8 UNet, ``quantize="w8a8"``);
    - ``depth_err``, ``decode_err``: the reference's stage in fp8
      (``ref/lowp.py``) put in the program's place (the program has no int8
      path for them);
    - ``solve_merge_err``: the reference's solve in bf16 (the program
      solves in fp32);
    - ``merge_err``: the reference's merged latents rounded to fp8 (the
      program hands them on in bf16).
    ``faults``: ``solve_merge_err`` of a merge whose solve left its state
    as it was (every scale 1, every shift 0)."""
    from .. import traffic as gen

    cell, cfg, traffic = spec["cell"], spec["config"], spec["traffic"]
    builder = spec["builder"]
    clip = gen.make_clip(traffic, seed, 0, builder)
    n_frames = clip["frames"].shape[0]
    out, got = {"seed": seed}, {}
    for side, quantize in (("program", None), ("w8a8", "w8a8")):
        if side == "w8a8" and "window_err" not in names:
            continue
        program = Program(cfg, cell, seed, device, quantize=quantize)
        program.run(gen.make_clip(traffic, seed, gen.WARMUP_CLIP, builder))
        t0 = time.perf_counter()
        got[side] = program.run(clip)
        out[side + "_s"] = time.perf_counter() - t0
        out[side + "_counters"] = program.counters()
        program.close()
        del program
    t0 = time.perf_counter()
    ref = Reference(cfg, cell, seed, device)
    prog = got["program"]
    start = ref.windows(clip) if set(names) - SOLVE_NUMBERS else None
    out["program"] = ref.numbers(clip, prog, names, start)
    out["reference_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    low = Reference(cfg, cell, seed, device, precision="fp8")
    control, faults = {}, {}
    if "window_err" in names:  # the program's own int8 path
        control["window_err"] = check.worst_rel_err(got["w8a8"]["windows"], start[1])
    if "depth_err" in names:
        rgb = start[0]
        control["depth_err"] = check.worst_rel_err([low.finish(rgb, prog["windows"], clip)],
                                                   [ref.finish(rgb, prog["windows"], clip)])
    if set(names) & SOLVE_NUMBERS:
        problem, idx = ref.problem(prog["windows"], n_frames)
        s, t, _ = solve(problem)
        merged = problem.merge(s, t)
        if "solve_merge_err" in names:
            bf16, _ = ref.problem(prog["windows"], n_frames, torch.bfloat16)  # fp32's step below: bf16
            control["solve_merge_err"] = check.worst_rel_err([bf16.merge(*solve(bf16)[:2])], [merged])
            still = problem.merge([torch.ones_like(x) for x in s], [torch.zeros_like(x) for x in t])
            faults["solve_merge_err.state_unchanged"] = check.worst_rel_err([still], [merged])
        if "merge_err" in names:  # bf16's step below: fp8
            control["merge_err"] = merge_residual(problem.groups, idx, lowp.fp8_round(merged))
    if "decode_err" in names:
        rgb = start[0]
        control["decode_err"] = check.worst_rel_err([low.after_merge(rgb, prog["merged"], clip)],
                                                    [ref.after_merge(rgb, prog["merged"], clip)])
    out["control"], out["faults"] = control, faults
    out["control_s"] = time.perf_counter() - t0
    del ref, low
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def clip_counts(cfg: Dict, cell: Dict, traffic: Dict, n_frames: int) -> Dict[str, float]:
    """Operations and bytes of one clip of ``n_frames`` (``rdbench/counts``):
    encode every frame, every window's denoise steps, decode every frame;
    with refinement one more encode, the refinement windows of every step
    and one more decode."""
    call, itemsize = cell["call"], SERVED[cfg["dtype"]].itemsize
    hh, ww = traffic["height"], traffic["width"]
    h, w = hh // 8, ww // 8
    unet, vae, _ = meta_models(cfg)
    ctx = torch.zeros((1, len(EMPTY_PROMPT_IDS), unet.config.cross_attention_dim), device="meta")

    def unet_call(n):
        x = torch.zeros((1, n, h, w, unet.config.in_channels), device="meta")
        return module_counts(unet, lambda: unet(x, 999, ctx), itemsize)

    enc = module_counts(vae, lambda: vae.encode_mean(torch.zeros((1, hh, ww, 3), device="meta")), itemsize)
    dec = module_counts(vae, lambda: vae.decode(torch.zeros((1, h, w, 4), device="meta")), itemsize)
    (n,), (steps,) = set(call["snippet_lengths"]), set(call["init_infer_steps"])
    dil = [cap_dilation(n_frames, n, d) if call["cap_dilation"] else d for d in call["dilations"]]
    n_windows = sum(windows(n_frames, n, d).shape[0] for d in dil)
    parts = [scaled(enc, n_frames), scaled(unet_call(n), n_windows * steps), scaled(dec, n_frames)]
    if call["refine_step"] > 0:
        rn, start = call["refine_snippet_len"], call["refine_start_dilation"]
        if call["cap_dilation"]:
            start = cap_dilation(n_frames, rn, start)
        ref_windows = sum(partition_windows(n_frames, rn, refine_gap(i, call["refine_step"], start) + 1, i).shape[0]
                          for i in range(call["refine_step"]))
        parts += [scaled(enc, n_frames), scaled(unet_call(rn), ref_windows), scaled(dec, n_frames)]
    return total(*parts)
