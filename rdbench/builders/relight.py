"""Builder of the relight cells: iclight-fbc-sd15 through ``RollingImgPipeline.forward``.

What the harness asks of a builder is listed in ``builders/depth.py``.

The program side draws the benchmark's seeded weights (the base SD1.5
UNet, the IC-Light offset, the SD VAE, the CLIP ViT-L tower) and builds
the port's modules from them as its relight loader does
(``io/pretrained_relight.py``): the 12-channel UNet is the base's state
dict through ``expand_conv_in`` and ``merge_offset``, the max-free
attention gate is calibrated on it, and only it is quantized for W8A8.
The scheduler is the loader's (``RELIGHT_SCHEDULER_CONFIG``, which the
configuration's ``scheduler`` must equal) and the tokenizer gives the
configuration's ids for the pipeline's default prompt pair.  A clip's fg
and bg frames are uploaded as bytes, scaled to [-1, 1] on the card, run
through ``forward`` with the cell's call, and R, G and B fetched to the
host as float32.  The program records what the check needs by wrapping
calls, not by any change to the pipeline: the VAE's ``encode_mean`` (the
fg and bg frames' latents), ``t2i_init_latents`` (the init latents), the
12-channel UNet's (its input and output at the first window step, one
chunk a call), the VAE's ``decode`` (every window's denoised latents and
their RGB, in window order) and, for the call alone, the pipeline's
``DepthAligner`` (each channel's solved scales and shifts).

The reference side loads the same weights, cast to fp32, into the plain
modules of ``rdbench/ref`` and follows the program stage by stage
(``ref.relight``), each stage from the program's own state, on a sample
drawn by the seed so that it fits a run (``reference_s`` about 100-185 s
on the H100; the whole clip in fp32 was reckoned at 258-334 s):
- ``t2i_err``: one t2i chunk of ``snippet_batch`` frames through the
  base UNet's ``t_start`` steps from the keyed noise, against the
  program's init latents of those frames: the worst frame's RMS
  difference over the reference's spread;
- ``encode_err``: the fg and bg latents of the frames the UNet chunk
  below holds, the reference's encode of those frames against the
  program's: the worst latent, as above;
- ``unet_err``: the 12-channel UNet's prediction at the first window step
  for one UNet chunk of ``snippet_batch`` windows, on the program's own
  input, against the program's: the worst window, as above;
- ``window_err``: that chunk through the remaining steps, from the
  reference's encode of its fg and bg frames and the program's own init
  latents, against the program's denoised windows: the worst window;
- ``decode_err``: the reference's decode of those windows' latents (the
  program's) against the program's RGB of them: the worst frame;
- ``rgb_err``: R, G and B against the reference's three solves, merges
  and normalisations of every window the program decoded: the worst
  frame of any channel;
- ``solve_err``: each channel's solved scales and shifts against the
  reference's solve of the same windows: the worst channel's distance
  between the two over the sum of the distances each moved from where
  every solve starts (s = 1, t = 0).
Each limit is set from the program's and its control's readings
(``readings``, ``PERF.md`` section 2): a limit lies above every program
reading and below every control reading.
- ``t2i_err`` and ``window_err`` grow step by step: the program keeps its
  latents in bf16 between steps and runs every product in bf16, and each
  of its 20 steps adds that rounding to what came before.  With the
  weights' scale (N(0, 0.02^2)) the UNet's prediction moves a step's
  latents little, so the latents' rounding takes most of these two
  numbers (the 12-channel UNet's products in fp8 alone read 0.009-0.010
  against the program's 0.0085-0.0097); their controls keep the UNets'
  products and the latents in fp8.
- ``unet_err`` is one pass of bf16 products through the 12-channel UNet;
  its control is the program's own W8A8 IC-Light UNet (the int8 path the
  port serves), which the latents' rounding hides from ``window_err``.
- ``encode_err`` and ``decode_err`` are one pass of bf16 products (the
  program's frames enter its encode in bf16); their controls are the
  reference's encode and decode in fp8.  ``unet_err`` and ``window_err``
  start from the program's conditions or the reference's encode, and
  with these weights the UNet's prediction moves the latents little, so
  only ``encode_err`` sees the encode.
- ``rgb_err`` starts from the program's own RGB, so it reads the two
  fp32 solves' parting (the kernel's sums in another order than the
  plain steps', whose L1 signs near 0 flip) and the min-max's; its
  control is the solve run in bf16.  With these weights the windows of a
  frame differ little, so a merge of unsolved windows is near the solved
  one and ``rgb_err`` does not tell a solve that was skipped.
- ``solve_err`` reads the solve itself: a solve that left its state
  unchanged reads exactly 1 (``faults``), whatever the windows, and no
  reading exceeds 1.  The program reads the two fp32 solves' parting,
  whose flipped L1 signs send the two walks apart; two that moved as far
  in unrelated directions would read about 0.71, so the limit lies above
  that and below the fault's 1.  The control is the solve in bf16, whose
  scales near 1 round every step of lr = 1e-3 away (bf16 keeps 2^-7
  there).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import check, weights
from ..counts import module_counts, scaled, total
from ..ref import lowp, models as R
from ..ref.depth import cap_dilation, windows
from ..ref.relight import RelightReference, prompt_chunks, prompt_context

SERVED = {"bf16": torch.bfloat16, "fp32": torch.float32}
LATENT_STRIDE = 8  # the VAE's downsampling
KINDS = ("relight",)  # a fg and a bg clip of uint8 RGB frames
PHASE_PREFIXES = ("rollingimg.",)  # the pipeline's PhaseTimer spans
# the pipeline's phases by layer: ``init`` is the prompt pair and the base
# UNet's t2i init, ``snippet_infer`` the IC-Light UNet's windows and their
# sampler steps, ``encode`` and ``decode`` the VAE alone
PHASES = {"relight_t2i": ("init",), "relight_unet": ("snippet_infer",), "relight_vae": ("encode", "decode")}
NUMBERS = ("t2i_err", "encode_err", "unet_err", "window_err", "decode_err", "rgb_err", "solve_err")


def draw_clip(rng: np.random.Generator, n: int, traffic: Dict) -> Dict[str, np.ndarray]:
    """``frames`` (the fg clip) and ``background``, each [n, 3, H, W] uint8:
    uniform bytes, since the work of every stage depends on the shape alone."""
    h, w = traffic["height"], traffic["width"]
    fg, bg = (rng.bit_generator.random_raw(n * 3 * h * w // 8).view(np.uint8).reshape(n, 3, h, w) for _ in range(2))
    return {"frames": fg, "background": bg}


def meta_models(cfg: Dict):
    """The reference's base UNet, 12-channel UNet, VAE and text tower on the meta device."""
    ucfg = R.UNetConfig.from_dict(cfg["unet"])
    with torch.device("meta"):
        return (R.UNet2DConditionModel(ucfg),
                R.UNet2DConditionModel(dataclasses.replace(ucfg, in_channels=cfg["iclight"]["in_channels"])),
                R.AutoencoderKL(R.VAEConfig.from_dict(cfg["vae"])),
                R.CLIPTextModel(R.CLIPTextConfig.from_dict(cfg["text_encoder"])))


def draw(cfg: Dict, seed: int, device):
    """The seeded state dicts of the base UNet, the IC-Light offset and the
    VAE (served dtype) and of the text tower (fp32).  The offset holds the
    12-channel UNet's drawn weights, not its biases and norm weights: the
    merge adds it to the base's (with ``conv_in`` zero-padded)."""
    dtype = SERVED[cfg["dtype"]]
    base, iclight, vae, text = meta_models(cfg)
    sd_base, sd_offset, sd_vae, sd_text = weights.draw_models([base, iclight, vae, text],
                                                              [dtype, dtype, dtype, torch.float32], seed, device)
    offset = {k: v for k, v in sd_offset.items() if weights._kind(iclight, k) == "normal"}
    return sd_base, offset, sd_vae, sd_text


def merged_reference(sd_base: Dict[str, torch.Tensor], offset: Dict[str, torch.Tensor], in_channels: int):
    """The 12-channel UNet's state dict in fp32: ``conv_in`` widened with zeros, then the offset added."""
    sd = {k: v.float() for k, v in sd_base.items()}
    w = sd["conv_in.weight"]
    sd["conv_in.weight"] = torch.cat([w, w.new_zeros((w.shape[0], in_channels - w.shape[1]) + w.shape[2:])], 1)
    for k, v in offset.items():
        sd[k] = sd[k] + v.float()
    return sd


class PromptTokenizer:
    """The tokenizer the pipeline asks for its two prompts: the
    configuration's ids for each (CLIP's BPE files are not in the
    repository), 77-token chunks with CLIP's BOS and EOS."""

    def __init__(self, prompt: Dict, length: int):
        self.ids = {prompt["cond"]: prompt["cond_ids"], prompt["uncond"]: prompt["uncond_ids"]}
        self.model_max_length, self.bos_token_id, self.eos_token_id = length, prompt["bos_id"], prompt["eos_id"]

    def tokenize_ids(self, text: str):
        return list(self.ids[text])


class Program:
    """The port's relight pipeline for one cell, with ``quantize`` its W8A8 IC-Light UNet."""

    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, quantize: Optional[str] = None):
        from rollingdepth_torch.io.pretrained_relight import RELIGHT_SCHEDULER_CONFIG
        from rollingdepth_torch.io.weights import expand_conv_in, merge_offset
        from rollingdepth_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
        from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
        from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
        from rollingdepth_torch.ops.quant import apply_quantize
        from rollingdepth_torch.ops.score_probe import calibrate_nomax
        from rollingdepth_torch.pipelines import rollingimg
        from rollingdepth_torch.schedulers.dpmsolver import DPMSolverConfig, DPMSolverMultistepScheduler

        if DPMSolverConfig.from_dict(cfg["scheduler"]) != RELIGHT_SCHEDULER_CONFIG:
            raise ValueError("the configuration's scheduler is not the one the relight loader runs")
        prompt = cfg["prompt"]
        if (prompt["cond"], prompt["uncond"]) != (rollingimg.DEFAULT_PROMPT + ", " + rollingimg.DEFAULT_A_PROMPT,
                                                  rollingimg.DEFAULT_N_PROMPT):
            raise ValueError("the configuration's prompts are not the pipeline's defaults")
        self.device = torch.device(device)
        call = dict(cell["call"])
        snippet_batch = call.pop("snippet_batch")  # the pipeline's, not the entry's
        self.call = dict(call, coalign_kwargs=cfg["solve"])  # the solve's settings, as the reference reads them
        sd_base, offset, sd_vae, sd_text = draw(cfg, seed, self.device)
        ucfg = UNetConfig.from_dict(cfg["unet"])
        in_channels = cfg["iclight"]["in_channels"]
        base = UNet2DConditionModel(ucfg, device="meta")
        unet = UNet2DConditionModel(dataclasses.replace(ucfg, in_channels=in_channels), device="meta")
        vae = AutoencoderKL(VAEConfig.from_dict(cfg["vae"]), device="meta")
        text = CLIPTextModel(CLIPTextConfig.from_dict(cfg["text_encoder"]), device="meta")
        sd_unet = merge_offset(expand_conv_in(sd_base, in_channels), offset)
        for module, sd in ((base, sd_base), (unet, sd_unet), (vae, sd_vae), (text, sd_text)):
            module.load_state_dict(sd, assign=True)
            module.eval()
        del sd_unet, offset
        # the loader's order: the gate on the merged float UNet, then W8A8 on it alone
        self.gate_bound = calibrate_nomax(unet) if self.device.type == "cuda" else None
        apply_quantize(unet, quantize)
        dev = self.device

        def text_apply(ids: torch.Tensor) -> torch.Tensor:
            return text(ids.to(dev))

        tokenizer = PromptTokenizer(prompt, text.config.max_position_embeddings)
        self.pipe = rollingimg.RollingImgPipeline(
            unet, vae, DPMSolverMultistepScheduler(RELIGHT_SCHEDULER_CONFIG), tokenizer, text_apply, base_unet=base,
            dtype=SERVED[cfg["dtype"]], snippet_batch=snippet_batch, device=dev)
        self.totals: Dict[str, int] = {}
        self._rec = {}
        t2i, encode, decode, predict = self.pipe.t2i_init_latents, vae.encode_mean, vae.decode, unet.forward

        def t2i_recorded(*args, **kwargs):  # the init latents [N, h, w, 4]
            self._rec["init"] = t2i(*args, **kwargs)
            return self._rec["init"]

        def encode_recorded(x):  # a chunk of fg or bg frames: their latents
            out = encode(x)
            self._rec["encoded"].append(out)
            return out

        class RecordingAligner(rollingimg.DepthAligner):
            def run(aligner, *args, **kwargs):  # a channel's solve: its scales and shifts
                out = super().run(*args, **kwargs)
                self._rec["solves"].append((out[1], out[2]))
                return out

        def decode_recorded(z):  # a chunk of window frames: their latents, then their RGB
            out = decode(z)
            self._rec["windows"].append(z)
            self._rec["decoded"].append(out)
            return out

        def predict_recorded(x, t, context):  # each chunk's first window step: the input and the prediction
            out = predict(x, t, context)
            if self._rec["t0"] is None:
                self._rec["t0"] = t
            if t == self._rec["t0"]:
                self._rec["first_step"].append((x, out))
            return out

        self.pipe.t2i_init_latents = t2i_recorded
        self._aligner = RecordingAligner
        vae.encode_mean, vae.decode = encode_recorded, decode_recorded
        unet.forward = predict_recorded

    def run(self, clip: Dict[str, np.ndarray], verbose: bool = False) -> Dict:
        """Upload the clip's fg and bg frames, run the entry, fetch R, G and
        B ([3, N, 1, H, W] float32) to the host.  What the call made on the
        way stays on the card: the conditions (the fg and the bg frames'
        latents side by side, [N, h, w, 8]), the init latents, each UNet chunk's input and prediction at the first
        window step, every window frame's denoised latents and its RGB, in
        window order, and R's, G's and B's solved scales and shifts."""
        from rollingdepth_torch.pipelines import rollingimg

        self._rec = {"init": None, "t0": None, "first_step": [], "windows": [], "decoded": [], "encoded": [],
                     "solves": []}
        fg, bg = (torch.from_numpy(clip[k]).to(self.device).float().div_(127.5).sub_(1.0)
                  for k in ("frames", "background"))
        aligner, rollingimg.DepthAligner = rollingimg.DepthAligner, self._aligner
        try:
            out = self.pipe.forward(fg, bg, verbose=verbose, **self.call)
        finally:
            rollingimg.DepthAligner = aligner
        for k, v in getattr(self.pipe, "last_counters", {}).items():
            self.totals[k] = self.totals.get(k, 0) + v
        rec, enc, n = self._rec, torch.cat(self._rec["encoded"]), fg.shape[0]
        return {"cond": torch.cat([enc[:n], enc[n:]], -1),"rgb": np.stack([out.R_pred, out.G_pred, out.B_pred]), "init": rec["init"],
                "first_step": rec["first_step"], "windows": torch.cat(rec["windows"]),
                "decoded": torch.cat(rec["decoded"]), "solves": rec["solves"]}

    @property
    def timings(self) -> Dict[str, float]:
        return dict(self.pipe.last_timings)

    def counters(self) -> Dict:
        """The pipeline's own counters summed over the program's calls (none
        on a pipeline that keeps none), the kernels' launches, the gate."""
        from rollingdepth_torch.ops import attention, coalign, flash_attention as fa, group_norm as gn

        def read(get):
            try:
                return get()
            except (AttributeError, TypeError):
                return None

        return {**self.totals,
                "k1_launches": read(lambda: fa.flash_attention_nomax.launches),
                "k2_launches": read(lambda: fa.flash_attention_max.launches),
                "k3_launches": read(lambda: fa.flash_attention_wide.launches),
                "groupnorm_launches": read(lambda: gn.group_norm.launches),
                "coalign_launches": read(lambda: coalign.coalign.launches),
                "max_free_gate_open": read(attention.nomax_allowed), "gate_bound": self.gate_bound}

    def setup_detail(self) -> Dict[str, float]:
        """Set-up's parts that are the program's: the seconds nvcc took (a
        checkout's first run; 0 once the build cache holds every kernel)."""
        from rollingdepth_torch.ops import _build

        return {"nvcc_s": sum(getattr(_build, "build_seconds", {}).values())}

    def close(self) -> None:
        """Free the program's weights and activations."""
        del self.pipe
        self._rec = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sound(output: Dict, clip_frames: int, traffic: Dict) -> bool:
    """A served clip's R, G and B: in shape, finite, within [0, 1]."""
    rgb = output["rgb"]
    return (rgb.shape == (3, clip_frames, 1, traffic["height"], traffic["width"]) and bool(np.isfinite(rgb).all())
            and float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0001)


class Reference:
    """The plain relight path on the same weights, in fp32 with TF32 off, or
    with ``precision="fp8"`` its products and the latents its samplers carry
    from step to step in e4m3 (``ref/lowp.py``, a control: the program keeps
    both in bf16).  The models are built at first use; the stages' results are
    kept (``stages``) for the controls to compare with."""

    def __init__(self, cfg: Dict, cell: Dict, seed: int, device, precision: str = "fp32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.seed, self.precision = cfg, seed, precision
        self.device = torch.device(device)
        self.call = cell["call"]
        self.stages: Dict[str, torch.Tensor] = {}
        self._path = None

    @property
    def path(self) -> RelightReference:
        if self._path is None:
            cfg = self.cfg
            base, unet, vae, text = meta_models(cfg)
            sd_base, offset, sd_vae, sd_text = draw(cfg, self.seed, self.device)
            sd_unet = merged_reference(sd_base, offset, cfg["iclight"]["in_channels"])
            for module, sd in ((base, sd_base), (unet, sd_unet), (vae, sd_vae), (text, sd_text)):
                module.load_state_dict({k: v.float() for k, v in sd.items()}, assign=True)
                module.eval()
            p = cfg["prompt"]
            context = prompt_context(text, p["cond_ids"], p["uncond_ids"], p["bos_id"], p["eos_id"], self.device)
            keep = None
            if self.precision == "fp8":
                lowp.fp8_(base), lowp.fp8_(unet), lowp.fp8_(vae)
                keep = lowp.fp8_round
            self._path = RelightReference(base, unet, vae, context, cfg["scheduler"], cfg["solve"], self.call["seed"],
                                          keep)
        return self._path

    def sample(self, n_frames: int, n_windows: int):
        """The t2i chunk's frames and the UNet chunk's window rows the check
        runs, each one of the program's chunks, drawn by the seed."""
        sb = self.call["snippet_batch"]
        rng = np.random.default_rng([self.seed, 29])
        c, w = (int(rng.integers(-(-n // sb))) for n in (n_frames, n_windows))
        return np.arange(c * sb, min(c * sb + sb, n_frames)), np.arange(w * sb, min(w * sb + sb, n_windows))

    def t2i(self, frames: np.ndarray, hw) -> torch.Tensor:
        return self.path.t2i([int(f) for f in frames], hw, self.call)

    def used_frames(self, n_frames: int, rows: np.ndarray) -> np.ndarray:
        """The frames that window rows ``rows`` hold, ascending."""
        return np.unique(np.concatenate(RelightReference.window_index(n_frames, self.call))[rows])

    def conditions(self, clip: Dict[str, np.ndarray], frames: np.ndarray) -> torch.Tensor:
        """This reference's encode of fg and bg frames ``frames``, side by side: [F, h, w, 8]."""
        return torch.cat([self.path.encode(torch.from_numpy(clip[k][frames]).to(self.device), self.call["max_vae_bs"])
                          for k in ("frames", "background")], -1)

    def window_inputs(self, clip: Dict[str, np.ndarray], init: torch.Tensor, rows: np.ndarray,
                      cond: Optional[torch.Tensor] = None):
        """Window rows ``rows``' conditions from this reference's encode of
        their frames (``cond``, that encode of ``used_frames``, if given),
        their init latents from ``init`` [N, h, w, 4] (another path's), and
        their noise ids."""
        idx = self.path.window_index(clip["frames"].shape[0], self.call)
        frames = np.concatenate(idx)[rows]  # [W, n]
        used, where = np.unique(frames, return_inverse=True)
        cond = self.conditions(clip, used) if cond is None else cond
        where = torch.as_tensor(where.reshape(frames.shape), device=self.device)
        init = init.to(self.device)[torch.as_tensor(frames, device=self.device)]
        return cond[where], init, self.path.window_ids(idx)[rows]

    def first_step(self, x: torch.Tensor) -> torch.Tensor:
        """The 12-channel UNet's prediction at the first window step on the input ``x`` (another path's)."""
        timesteps, _, t_start = self.path.steps(self.call)
        with torch.no_grad():
            return self.path.unet(x.float(), timesteps[t_start], self.path.context)

    def numbers(self, clip: Dict[str, np.ndarray], output: Dict, names) -> Dict[str, float]:
        """The numbers ``names`` (of ``NUMBERS``) of the program's ``output`` for ``clip``."""
        n_frames = clip["frames"].shape[0]
        idx = RelightReference.window_index(n_frames, self.call)
        n = idx[0].shape[1]
        n_windows = sum(m.shape[0] for m in idx)
        t2i_frames, rows = self.sample(n_frames, n_windows)
        lat = output["windows"].reshape((n_windows, n) + tuple(output["windows"].shape[1:]))
        rgb = output["decoded"].reshape((n_windows, n) + tuple(output["decoded"].shape[1:]))
        st, out = self.stages, {}
        if "t2i_err" in names:
            st["t2i"] = self.t2i(t2i_frames, output["init"].shape[1:3])
            out["t2i_err"] = check.worst_rel_err([output["init"][torch.as_tensor(t2i_frames)]], [st["t2i"]])
        if names & {"encode_err", "window_err"}:
            used = self.used_frames(n_frames, rows)
            st["encode"] = self.conditions(clip, used)
        if "encode_err" in names:
            got = output["cond"][torch.as_tensor(used, device=output["cond"].device)]
            out["encode_err"] = check.worst_rel_err([fg_bg(got)], [fg_bg(st["encode"])])
        if "unet_err" in names:
            x, pred = output["first_step"][rows[0] // self.call["snippet_batch"]]
            st["unet"] = self.first_step(x)
            out["unet_err"] = check.worst_rel_err([pred], [st["unet"]])
        if "window_err" in names:
            st["windows"] = self.path.denoise(*self.window_inputs(clip, output["init"], rows, st["encode"]),
                                              self.call)
            out["window_err"] = check.worst_rel_err([lat[rows]], [st["windows"]])
        if "decode_err" in names:
            st["decode"] = self.path.decode(lat[rows].flatten(0, 1), self.call["max_vae_bs"])
            out["decode_err"] = check.worst_rel_err([rgb[rows].flatten(0, 1)], [st["decode"]])
        if names & {"rgb_err", "solve_err"}:
            st["solved"] = self.path.solves(rgb, idx, n_frames)
        if "rgb_err" in names:
            st["rgb"] = self.path.colours(st["solved"])
            out["rgb_err"] = check.worst_rel_err([torch.from_numpy(output["rgb"]).flatten(0, 1)],
                                                 [st["rgb"].flatten(0, 1)])
        if "solve_err" in names:
            out["solve_err"] = solve_err(output["solves"], st["solved"])
        return out


def fg_bg(cond: torch.Tensor) -> torch.Tensor:
    """Conditions [F, h, w, 8] as one latent a row: the fg frames', then the bg frames'."""
    return torch.cat([cond[..., :4], cond[..., 4:]])


def _flat(params) -> torch.Tensor:
    """A channel's (scales, shifts), each one tensor a dilation, as one fp64 vector on the host."""
    s, t = params
    return torch.cat([torch.cat([x.reshape(-1) for x in s]), torch.cat([x.reshape(-1) for x in t])]).double().cpu()


def solve_err(got, solved) -> float:
    """The program's solved scales and shifts ``got`` (a (scales, shifts)
    pair a channel) against the reference's solves ``solved`` (``solves``)
    of the same windows: the worst channel's distance between the two, over
    the sum of the distances each moved from where every solve starts
    (s = 1, t = 0).  By the triangle inequality it lies in [0, 1]; a solve
    that leaves its state unchanged reads exactly 1, and two solves that
    moved as far in unrelated directions read about 0.71."""
    if len(got) != len(solved):
        return check.MALFORMED
    worst = 0.0
    for params, (_, s, t) in zip(got, solved):
        g, w = _flat(params), _flat((s, t))
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            return check.MALFORMED
        start = torch.cat([torch.ones(g.shape[0] // 2), torch.zeros(g.shape[0] // 2)]).double()
        moved = (g - start).norm() + (w - start).norm()
        worst = max(worst, float((g - w).norm() / moved.clamp(min=1e-30)))
    return worst


def readings(spec: Dict, seed: int, device, names) -> Dict:
    """The readings a cell's limits are set from (``rdbench/control.py``):
    clip 0 of ``seed`` at the cell's own size and call; the program's
    numbers ``names`` and each one's control, one precision step below the
    one its stage runs in:
    - ``t2i_err``: the reference's t2i with the base UNet's products and
      the latents between steps in fp8 (the program has no int8 path for
      the base UNet);
    - ``unet_err``: the program with its own int8 path switched on (the
      W8A8 IC-Light UNet, ``quantize="w8a8"``), on its own input;
    - ``window_err``: the reference's windows with the 12-channel UNet's
      products and the latents between steps in fp8, from the same
      conditions and init;
    - ``decode_err``: the reference's decode in fp8;
    - ``encode_err``: the reference's encode in fp8;
    - ``rgb_err`` and ``solve_err``: the reference's solves in bf16 (the
      program solves in fp32).
    ``faults``: ``rgb_err`` and ``solve_err`` of solves that left their
    state as it was (every scale 1, every shift 0)."""
    from .. import traffic as gen

    cell, cfg, traffic = spec["cell"], spec["config"], spec["traffic"]
    clip = gen.make_clip(traffic, seed, 0, spec["builder"])
    n_frames = clip["frames"].shape[0]
    out, got = {"seed": seed}, {}
    for side, quantize in (("program", None), ("w8a8", "w8a8")):
        if side == "w8a8" and "unet_err" not in names:
            continue
        program = Program(cfg, cell, seed, device, quantize=quantize)
        t0 = time.perf_counter()
        got[side] = program.run(clip)
        out[side + "_s"] = time.perf_counter() - t0
        out[side + "_counters"] = program.counters()
        program.close()
        del program
    t0 = time.perf_counter()
    ref = Reference(cfg, cell, seed, device)
    prog = got["program"]
    out["program"] = ref.numbers(clip, prog, names)
    out["reference_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    low = Reference(cfg, cell, seed, device, precision="fp8")
    idx = RelightReference.window_index(n_frames, ref.call)
    n_windows = sum(m.shape[0] for m in idx)
    t2i_frames, rows = ref.sample(n_frames, n_windows)
    st, control, faults = ref.stages, {}, {}
    if "t2i_err" in names:
        control["t2i_err"] = check.worst_rel_err([low.t2i(t2i_frames, prog["init"].shape[1:3])], [st["t2i"]])
    if "encode_err" in names:
        control["encode_err"] = check.worst_rel_err([fg_bg(low.conditions(clip, ref.used_frames(n_frames, rows)))],
                                                    [fg_bg(st["encode"])])
    if "unet_err" in names:
        x, pred = got["w8a8"]["first_step"][rows[0] // ref.call["snippet_batch"]]
        want = st["unet"] if torch.equal(x, prog["first_step"][rows[0] // ref.call["snippet_batch"]][0]) else (
            ref.first_step(x))
        control["unet_err"] = check.worst_rel_err([pred], [want])
    if "window_err" in names:
        cond, init, ids = ref.window_inputs(clip, prog["init"], rows, st["encode"])
        control["window_err"] = check.worst_rel_err([low.path.denoise(cond, init, ids, ref.call)], [st["windows"]])
    if "decode_err" in names:
        lat = prog["windows"].reshape((n_windows, -1) + tuple(prog["windows"].shape[1:]))[rows].flatten(0, 1)
        control["decode_err"] = check.worst_rel_err([low.path.decode(lat, ref.call["max_vae_bs"])], [st["decode"]])
    if names & {"rgb_err", "solve_err"}:
        rgb = prog["decoded"].reshape((n_windows, -1) + tuple(prog["decoded"].shape[1:]))
        bf16 = ref.path.solves(rgb, idx, n_frames, torch.bfloat16)
        still = [([torch.ones_like(x) for x in s], [torch.zeros_like(x) for x in t]) for _, s, t in st["solved"]]
    if "rgb_err" in names:
        control["rgb_err"] = check.worst_rel_err([ref.path.colours(bf16).flatten(0, 1)], [st["rgb"].flatten(0, 1)])
        unchanged = ref.path.colours([(p, s, t) for (p, _, _), (s, t) in zip(st["solved"], still)])
        faults["rgb_err.state_unchanged"] = check.worst_rel_err([unchanged.flatten(0, 1)], [st["rgb"].flatten(0, 1)])
    if "solve_err" in names:
        control["solve_err"] = solve_err([(s, t) for _, s, t in bf16], st["solved"])
        faults["solve_err.state_unchanged"] = solve_err(still, st["solved"])
    out["control"], out["faults"] = control, faults
    out["control_s"] = time.perf_counter() - t0
    del ref, low
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def clip_counts(cfg: Dict, cell: Dict, traffic: Dict, n_frames: int) -> Dict[str, float]:
    """Operations and bytes of one clip of ``n_frames`` (``rdbench/counts``):
    encode every fg and bg frame, the prompt pair's chunks through the text
    tower, every frame's t2i steps through the base UNet, every window's
    remaining steps through the 12-channel UNet, decode every window frame."""
    call, itemsize = cell["call"], SERVED[cfg["dtype"]].itemsize
    hh, ww = traffic["height"], traffic["width"]
    h, w = hh // LATENT_STRIDE, ww // LATENT_STRIDE
    base, unet, vae, text = meta_models(cfg)
    p, length = cfg["prompt"], text.config.max_position_embeddings
    chunks = max(len(prompt_chunks(p[k], p["bos_id"], p["eos_id"], length)) for k in ("cond_ids", "uncond_ids"))
    ctx = torch.zeros((1, 2 * chunks * length, unet.config.cross_attention_dim), device="meta")
    (n,) = set(call["snippet_lengths"])
    steps = call["num_inference_steps"]
    t_start = steps - min(int(steps * call["strength"]), steps)
    dil = [cap_dilation(n_frames, n, d) if call["cap_dilation"] else d for d in call["dilations"]]
    n_windows = sum(windows(n_frames, n, d).shape[0] for d in dil)

    def unet_call(model, frames):
        x = torch.zeros((1, frames, h, w, model.config.in_channels), device="meta")
        return module_counts(model, lambda: model(x, 999, ctx), itemsize)

    enc = module_counts(vae, lambda: vae.encode_mean(torch.zeros((1, hh, ww, 3), device="meta")), itemsize)
    dec = module_counts(vae, lambda: vae.decode(torch.zeros((1, h, w, 4), device="meta")), itemsize)
    txt = module_counts(text, lambda: text(torch.zeros((1, length), dtype=torch.long, device="meta")), 4)
    return total(scaled(enc, 2 * n_frames), scaled(txt, 2 * chunks), scaled(unet_call(base, 1), n_frames * t_start),
                 scaled(unet_call(unet, n), n_windows * (steps - t_start)), scaled(dec, n_windows * n))
