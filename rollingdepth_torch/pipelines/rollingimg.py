"""RollingImg: temporally consistent fg/bg video relighting (IC-Light).

Counterpart of ``rollingdepth_tpu/pipelines/rollingimg.py``
(``RollingImgPipeline.__call__``, ``forward`` and ``t2i_init_latents``,
the prompt chunk encoding and the RMBG matting helpers):
1. the fg and bg clips at the fixed 720x640, VAE-encoded ``max_vae_bs``
   frames at a time and joined along channels into an 8-channel
   condition (fg 0-3, bg 4-7);
2. the prompt pair chunk-encoded (75 tokens and BOS/EOS a chunk), cond and
   uncond joined along the TOKEN axis into one context (one UNet pass, no
   classifier-free guidance); gen-3 takes the empty prompt instead;
3. init latents: ``t2i`` runs the base 4-channel UNet per frame through the
   first ``t_start`` steps of the schedule from per-frame noise;
   ``shared_noise`` repeats one Gaussian map; ``passthrough`` noises the fg
   latents to the entry sigma; ``init_latents_override`` takes them given;
4. the windows of every dilation (stride-1, ``strides`` or ``turbo``
   partitions) denoised together, ``snippet_batch`` at a time, through the
   12-channel IC-Light UNet (input ``[latent, cond]``, or ``[cond, latent]``
   with ``cond_first``) by DPM++ 2M SDE: a 40-step Karras schedule entered
   at strength 0.5, 20 steps executed;
5. every window frame decoded to RGB, ``max_vae_bs`` at a time;
6. R, G and B co-aligned each on its own (``aligner.py``) over the windows
   actually run, then each normalised to [0, 1].
The phases (``last_timings``, ``rollingimg.<phase>`` spans) are
``encode`` (1), ``init`` (2-3), ``snippet_infer`` (4), ``decode`` (5) and
``coalign`` (6).  Under a profiler the t2i init is an ``rd.t2i`` span and
each sampler step, with its noise draw, an ``rd.sampler`` span.
``last_counters`` counts what the last call did: ``iclight_unet_calls``,
``base_unet_calls``, ``sampler_steps`` and, with a provider that counts
them (``SeededNoise``), ``noise_generators`` seeded.

Randomness: torch cannot draw JAX's numbers, so every Gaussian draw comes
from a noise provider keyed as the JAX pipeline keys its PRNG: the shared
map by the seed, the t2i init by (seed, frame), each SDE step by (seed,
window or frame id, step).  Window ids restart at 0 for every dilation.
The default provider (``SeededNoise``) seeds one ``torch.Generator`` per
key, so results do not depend on ``snippet_batch``; tests pass a provider
that computes JAX's own draws.  Latents are NHWC (``[..., h, w, 4]``), as
in the JAX package, so the draws need no transpose.

With a ``mesh`` (``parallel/mesh.py``) the windows split in blocks over
``dp``: each dp rank runs the SDE denoise and the decode of its block (a
block short of ceil(S / dp) windows repeats its last window, id and all),
and the decoded windows are all-gathered, the padding dropped.  Draws are
keyed by window id, so the split cannot change one.  The t2i init and the
three solves run on every rank.

No counterpart for the JAX module's XLA machinery (row buckets and blocks,
``max_trips_per_dispatch``, the compile caches, ``decode_in_program``):
work items are independent and the last chunk runs at its true size.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..aligner import AlignerConfig, DepthAligner
from ..ops.quant import is_quantized, to_compute_dtype_
from ..parallel.sharding import gather_rows, shard_rows
from ..schedulers.dpmsolver import DPMState
from ..utils.device import resolve_device
from ..utils.profiling import PhaseTimer, clip_span, span
from .rollingdepth import unet_chunks
from .snippets import cap_max_dilation, chain_stride_index_matrix, partition_index_matrix, snippet_index_matrix

logger = logging.getLogger(__name__)

# the reference's fixed working resolution, prompt set and seed
RELIGHT_WIDTH = 720
RELIGHT_HEIGHT = 640
DEFAULT_PROMPT = "a man who is doing sports , natural lighting"
DEFAULT_A_PROMPT = "best quality"
DEFAULT_N_PROMPT = "lowres, bad anatomy, bad hands, cropped, worst quality"
DEFAULT_SEED = 12345
NUM_INFERENCE_STEPS = 40
HIGHRES_DENOISE = 0.5


@dataclasses.dataclass
class RollingImgOutput:
    R_pred: object  # [N, 1, H, W] in [0, 1]; numpy, or a device tensor with fetch_output=False
    G_pred: object
    B_pred: object
    snippet_ls: Optional[List]  # per dilation [S, n, 3, H, W]
    aligned_snippet_pred_ls: Optional[List]  # one [1, N, 3, H, W] in [-1, 1]


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix(*key: int) -> int:
    """A 63-bit generator seed from a tuple of integers (splitmix64 rounds)."""
    h = 0x9E3779B97F4A7C15
    for v in key:
        h = ((h ^ (int(v) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 29
    return h >> 1


class SeededNoise:
    """The default draws: one ``torch.Generator`` a key, on the device.

    - ``shared(shape)``: the one map of ``shared_noise`` and ``passthrough``;
    - ``frames(ids, shape)``: the t2i init, a map per frame id;
    - ``steps(ids, step, shape)``: an SDE step's draw per window (or, in the
      t2i init, frame) id.
    Each returns fp32 ``[len(ids), *shape]`` (``shape`` for ``shared``).
    ``generators`` counts the generators seeded."""

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.generators = 0

    def draw(self, shape, *key: int) -> torch.Tensor:
        """N(0, 1) of ``shape`` from the generator of (seed, *key)."""
        self.generators += 1
        gen = torch.Generator(device=self.device).manual_seed(_mix(self.seed, *key))
        return torch.randn(tuple(shape), generator=gen, device=self.device)

    def shared(self, shape) -> torch.Tensor:
        return self.draw(shape, 0)

    def frames(self, ids, shape) -> torch.Tensor:
        return torch.stack([self.draw(shape, 1, i) for i in ids])

    def steps(self, ids, step: int, shape) -> torch.Tensor:
        return torch.stack([self.draw(shape, 2, i, step) for i in ids])


def as_draw(draw, device) -> torch.Tensor:
    """A provider's draw (a tensor, or an array) as fp32 on ``device``."""
    if not torch.is_tensor(draw):
        draw = torch.from_numpy(np.array(draw, dtype=np.float32))
    return draw.to(device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# host resize helpers (cv2, imported where used: the card's machine has none)
# ---------------------------------------------------------------------------


def resize_frames(frames: np.ndarray, new_width: int, new_height: int) -> np.ndarray:
    """[N, C, H, W] -> [N, C, new_height, new_width], cv2 INTER_LINEAR."""
    import cv2

    out = []
    for f in frames:
        img = cv2.resize(f.transpose(1, 2, 0), (new_width, new_height), interpolation=cv2.INTER_LINEAR)
        if img.ndim == 2:  # cv2 drops a singleton channel dim
            img = img[:, :, None]
        out.append(img.transpose(2, 0, 1))
    return np.stack(out)


def resize_without_crop(image: np.ndarray, target_width: int, target_height: int) -> np.ndarray:
    import cv2

    return cv2.resize(image, (target_width, target_height), interpolation=cv2.INTER_LANCZOS4)


def resize_and_center_crop(image: np.ndarray, target_width: int, target_height: int) -> np.ndarray:
    import cv2

    h, w = image.shape[:2]
    scale = max(target_width / w, target_height / h)
    rw, rh = int(round(w * scale)), int(round(h * scale))
    resized = cv2.resize(image, (rw, rh), interpolation=cv2.INTER_LANCZOS4)
    left, top = (rw - target_width) // 2, (rh - target_height) // 2
    return resized[top : top + target_height, left : left + target_width]


# ---------------------------------------------------------------------------
# prompts
# ---------------------------------------------------------------------------


def encode_prompt_inner(tokenizer, text_apply, txt: str) -> torch.Tensor:
    """75-token chunks, each with BOS and EOS and EOS-padded to
    ``model_max_length``, encoded together: [num_chunks, 77, D]."""
    max_length = tokenizer.model_max_length
    chunk_length = max_length - 2
    id_start, id_end = tokenizer.bos_token_id, tokenizer.eos_token_id
    tokens = tokenizer.tokenize_ids(txt)
    chunks = [[id_start] + tokens[i : i + chunk_length] + [id_end]
              for i in range(0, max(len(tokens), 1), chunk_length)]
    chunks = [ck + [id_end] * (max_length - len(ck)) for ck in chunks]
    return text_apply(torch.tensor(chunks, dtype=torch.long))


def encode_prompt_pair(tokenizer, text_apply, positive: str, negative: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both prompts at the same chunk count (the shorter one repeated), each
    chunk laid along the token axis: ([1, 77*k, D], [1, 77*k, D])."""
    c = encode_prompt_inner(tokenizer, text_apply, positive)
    uc = encode_prompt_inner(tokenizer, text_apply, negative)
    k = max(len(c), len(uc))
    c = torch.cat([c] * math.ceil(k / len(c)))[:k]
    uc = torch.cat([uc] * math.ceil(k / len(uc)))[:k]
    return c.reshape(1, -1, c.shape[-1]), uc.reshape(1, -1, uc.shape[-1])


# ---------------------------------------------------------------------------
# RMBG matting
# ---------------------------------------------------------------------------


def _feed_size(h: int, w: int) -> Tuple[int, int]:
    """The U²-Net's input (height, width): ~256^2 pixels at the frame's
    aspect, each side a multiple of 64 (960x1088 for 640x720)."""
    k = (256.0 / float(h * w)) ** 0.5
    return int(64 * round(h * k)), int(64 * round(w * k))


@torch.no_grad()
def rmbg_matte(rmbg, feed: torch.Tensor, orig: torch.Tensor, sigma: float = 0.0):
    """The device part of matting: feed [c, 3, fh, fw] and frames [c, 3, h, w]
    (uint8 or float, 0..255) -> (matted [c, 3, h, w], alpha [c, 1, h, w]),
    fp32.  The U²-Net's first side output is resized to the frame with the
    JAX resize's rule (bilinear, half-pixel centres, antialiased when it
    shrinks), clipped to [0, 1]; matted = floor(clip(127 + (img - 127 +
    sigma) * alpha, 0, 255)), the floor being the uint8 truncation."""
    p = next(rmbg.parameters())
    x = feed.to(device=p.device, dtype=torch.float32) / 127.0 - 1.0
    alpha = rmbg(x.to(p.dtype))[0].float()
    alpha = F.interpolate(alpha, size=tuple(orig.shape[2:]), mode="bilinear", align_corners=False,
                          antialias=True).clamp(0.0, 1.0)
    img = orig.to(device=p.device, dtype=torch.float32)
    matted = (127.0 + (img - 127.0 + sigma) * alpha).clamp(0.0, 255.0)
    return matted.floor(), alpha


def run_rmbg(rmbg, img: np.ndarray, sigma: float = 0.0):
    """uint8 [H, W, 3] -> (matted uint8 [H, W, 3], alpha [H, W, 1])."""
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"run_rmbg takes an RGB image [H, W, 3], got {img.shape}")
    fh, fw = _feed_size(h, w)
    feed = resize_without_crop(img, fw, fh)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1)))[None]  # noqa: E731
    matted, alpha = rmbg_matte(rmbg, to_t(feed), to_t(img), sigma)
    return (matted[0].permute(1, 2, 0).cpu().numpy().astype(np.uint8),
            alpha[0].permute(1, 2, 0).cpu().numpy())


def run_rmbg_sequence(rmbg, frames: np.ndarray, sigma: float = 0.0, chunk: int = 8):
    """[N, 3, H, W] float in [0, 1] -> (matted [N, 3, H, W] on the 0..255
    scale, alphas [N, 1, H, W]): the LANCZOS feeds on the host (cv2), the
    rest on the device ``chunk`` frames at a time."""
    n, _, h, w = frames.shape
    if n == 0:
        return np.zeros((0, 3, h, w), np.float32), np.zeros((0, 1, h, w), np.float32)
    fh, fw = _feed_size(h, w)
    imgs = np.ascontiguousarray(frames.transpose(0, 2, 3, 1) * 255.0).astype(np.uint8)  # [N, H, W, 3]
    feeds = np.stack([resize_without_crop(im, fw, fh) for im in imgs])
    mats, alphas = [], []
    for i in range(0, n, chunk):
        to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
        m, a = rmbg_matte(rmbg, to_t(feeds[i : i + chunk]), to_t(imgs[i : i + chunk]), sigma)
        mats.append(m.cpu().numpy())
        alphas.append(a.cpu().numpy())
    return np.concatenate(mats), np.concatenate(alphas)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


class RollingImgPipeline:
    """12-channel IC-Light UNet + base UNet + VAE + DPM++ SDE + text encoder
    (+ RMBG), on one device, or one rank of a (dp, tp) ``mesh``."""

    rgb_latent_scale_factor = 0.18215

    def __init__(self, unet, vae, scheduler, tokenizer, text_apply, base_unet=None, rmbg=None,
                 dtype=torch.bfloat16, snippet_batch: int = 4, device=None, mesh=None):
        """``text_apply``: ids [B, L] (a CPU LongTensor) -> embeddings
        [B, L, D]; ``base_unet``: the 4-channel UNet before the merge, for
        the t2i init; ``rmbg``: the matting net, run in fp32."""
        self.device = resolve_device(device)
        self.dtype = dtype
        # W8A8 weights (ops/quant.py) keep int8 and their fp32 scales
        self.unet = to_compute_dtype_(unet, self.device, dtype).eval()
        self.vae = vae.to(device=self.device, dtype=dtype).eval()
        self.base_unet = None if base_unet is None else base_unet.to(device=self.device, dtype=dtype).eval()
        self.rmbg = None if rmbg is None else rmbg.to(device=self.device, dtype=torch.float32).eval()
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.text_apply = text_apply
        self.snippet_batch = snippet_batch
        self.mesh = mesh
        self.last_timings: Dict[str, float] = {}
        # chunks of the last call (this rank's): VAE encodes and decodes, t2i and window UNet calls
        self.last_chunks: Dict[str, int] = {}
        # what the last call did (this rank's), counted where it happens: module docstring
        self.last_counters: Dict[str, int] = {}
        self.clip_calls = 0  # forward's calls: the clip id of its rd.clip span

    def __call__(
        self,
        input_fg_video_path=None,
        input_bg_video_path=None,
        input_fg_frames=None,  # [N, 3, H, W] float in [-1, 1]
        input_bg_frames=None,
        start_frame: int = 0,
        frame_count: int = 253,
        processing_res: int = 1024,
        resample_method: str = "BILINEAR",
        dilations: Sequence[int] = (1, 25),
        cap_dilation: bool = True,
        snippet_lengths: Sequence[int] = (3,),
        strides: Sequence[int] = (1,),
        coalign_kwargs: Optional[Dict] = None,
        prompt: str = DEFAULT_PROMPT,
        a_prompt: str = DEFAULT_A_PROMPT,
        n_prompt: str = DEFAULT_N_PROMPT,
        seed: int = DEFAULT_SEED,
        init_mode: str = "t2i",  # t2i | shared_noise | passthrough
        verbose: bool = False,
        max_vae_bs: int = 4,
        apply_rmbg: bool = False,
        width: Optional[int] = None,
        height: Optional[int] = None,
        restore_res: bool = False,
        num_inference_steps: int = NUM_INFERENCE_STEPS,
        strength: float = HIGHRES_DENOISE,
        empty_text: bool = False,
        cond_first: bool = False,
        keep_snippets: bool = True,
        turbo: bool = False,
    ) -> RollingImgOutput:
        """Entry point with the JAX package's ``__call__`` arguments: clips
        from the video paths (the fg clip capped at 253 frames) unless frames
        are given, optional fg matting, both at ``width`` x ``height``
        (default 720x640; frames already at that size are not resized), and
        numpy outputs; ``restore_res`` resizes R/G/B back to the fg clip's
        size."""
        from ..io.video import load_video_frames

        width = RELIGHT_WIDTH if width is None else width
        height = RELIGHT_HEIGHT if height is None else height
        original_res = None
        if input_fg_frames is None:
            input_fg_frames, original_res = load_video_frames(
                input_fg_video_path, start_frame=start_frame, frame_count=253, processing_res=processing_res,
                resample_method=resample_method)
        if input_bg_frames is None:
            input_bg_frames, _ = load_video_frames(
                input_bg_video_path, start_frame=start_frame, frame_count=frame_count,
                processing_res=processing_res, resample_method=resample_method)
        if apply_rmbg and self.rmbg is not None:
            matted, _ = run_rmbg_sequence(self.rmbg, (np.asarray(input_fg_frames) + 1) / 2)
            input_fg_frames = matted / 127.0 - 1.0
        if restore_res and original_res is not None and max(original_res) > 2048:
            logger.warning("Resizing back to large resolution (%s) may result in significant memory usage.",
                           list(original_res))

        def sized(frames):
            if tuple(frames.shape[-2:]) == (height, width):
                return frames
            return resize_frames(np.asarray(frames), width, height)

        fg, bg = sized(input_fg_frames), sized(input_bg_frames)
        n = min(len(fg), len(bg))
        out = self.forward(
            fg[:n], bg[:n], dilations=list(dilations), cap_dilation=cap_dilation,
            snippet_lengths=list(snippet_lengths), strides=list(strides), coalign_kwargs=coalign_kwargs,
            prompt=prompt, a_prompt=a_prompt, n_prompt=n_prompt, seed=seed, init_mode=init_mode, verbose=verbose,
            max_vae_bs=max_vae_bs, num_inference_steps=num_inference_steps, strength=strength,
            empty_text=empty_text, cond_first=cond_first, keep_snippets=keep_snippets, turbo=turbo,
        )
        if restore_res and original_res is not None:
            oh, ow = int(original_res[0]), int(original_res[1])
            out.R_pred, out.G_pred, out.B_pred = (resize_frames(c, ow, oh) for c in (out.R_pred, out.G_pred,
                                                                                     out.B_pred))
        return out

    def _noise(self, draw) -> torch.Tensor:
        return as_draw(draw, self.device)

    @clip_span
    @torch.no_grad()
    def forward(
        self,
        input_fg_frames,  # [N, 3, H, W] float in [-1, 1]; numpy or torch
        input_bg_frames,
        dilations: List[int],
        cap_dilation: bool = True,
        snippet_lengths: List[int] = [3],
        strides: List[int] = [1],
        coalign_kwargs: Optional[Dict] = None,
        prompt: str = DEFAULT_PROMPT,
        a_prompt: str = DEFAULT_A_PROMPT,
        n_prompt: str = DEFAULT_N_PROMPT,
        seed: int = DEFAULT_SEED,
        init_mode: str = "t2i",
        verbose: bool = False,
        max_vae_bs: int = 4,
        num_inference_steps: int = NUM_INFERENCE_STEPS,
        strength: float = HIGHRES_DENOISE,
        empty_text: bool = False,  # gen-3: the empty prompt's embedding
        cond_first: bool = False,  # gen-3: UNet input [cond, latent]
        init_latents_override: Optional[np.ndarray] = None,  # [N, 4, h, w]
        fetch_output: bool = True,  # False: outputs stay device tensors
        keep_snippets: bool = True,  # False: only R/G/B_pred (no window copies, no aligned concat)
        turbo: bool = False,  # each dilation chain covered by a partition of windows
        noise=None,  # a provider like SeededNoise; default SeededNoise(seed, device)
    ) -> RollingImgOutput:
        if 1 not in dilations:
            raise ValueError("dilations should include 1")
        n_dil = len(dilations)
        if len(snippet_lengths) == 1:
            snippet_lengths = snippet_lengths * n_dil
        if len(strides) == 1:
            strides = strides * n_dil
        if not len(snippet_lengths) == len(strides) == n_dil:
            raise ValueError("per-dilation lists must have one entry per dilation")
        seq_len = int(input_fg_frames.shape[0])
        if cap_dilation:
            dilations = [cap_max_dilation(seq_len, sl, d, verbose) for sl, d in zip(snippet_lengths, dilations)]
        noise = SeededNoise(seed, self.device) if noise is None else noise
        generators = getattr(noise, "generators", None)
        # per-phase times; ROLLINGDEPTH_TRACE_DIR adds a trace of each (utils/profiling.py)
        timer = PhaseTimer(verbose, prefix="rollingimg", device=self.device)
        timings = timer.timings
        chunks: Dict[str, int] = {}
        counters = {"iclight_unet_calls": 0, "base_unet_calls": 0, "sampler_steps": 0}
        dtype, dev = self.dtype, self.device

        # ---- 1. encode fg and bg into the 8-channel condition
        with timer.phase("encode"):
            fg, bg = (torch.as_tensor(f).to(dev).permute(0, 2, 3, 1).to(dtype)
                      for f in (input_fg_frames, input_bg_frames))
            fg_lat = self._encode(fg, max_vae_bs, chunks)
            cond_latent = torch.cat([fg_lat, self._encode(bg, max_vae_bs, chunks)], dim=-1)  # [N, h, w, 8]
            del fg, bg

        with timer.phase("init"):
            # ---- 2. prompt embeddings: [cond ; uncond] along tokens, or the empty prompt (gen-3)
            if empty_text:
                prompt_embeds = encode_prompt_inner(self.tokenizer, self.text_apply, "")[:1]
            else:
                conds, unconds = encode_prompt_pair(self.tokenizer, self.text_apply, prompt + ", " + a_prompt,
                                                    n_prompt)
                prompt_embeds = torch.cat([conds, unconds], dim=1)
            prompt_embeds = prompt_embeds.to(device=dev, dtype=dtype)

            # ---- schedule entered at ``strength``
            timesteps, sigmas = self.scheduler.schedule(num_inference_steps)
            init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
            t_start = max(num_inference_steps - init_timestep, 0)

            # ---- 3. init latents (the scheduler is VP: pure-noise inits are N(0, 1))
            h, w = cond_latent.shape[1:3]
            if init_latents_override is not None:
                init = torch.as_tensor(np.asarray(init_latents_override, np.float32)).permute(0, 2, 3, 1)
                init_latents = init.to(device=dev, dtype=dtype)
            elif init_mode == "shared_noise":
                init_latents = self._noise(noise.shared((h, w, 4))).expand(seq_len, h, w, 4).to(dtype)
            elif init_mode == "t2i":
                init_latents = self.t2i_init_latents(seq_len, h, w, prompt_embeds, t_start, timesteps, sigmas, noise,
                                                     num_inference_steps, chunks, counters)
            elif init_mode == "passthrough":
                # gen-2: the fg latents noised to the entry sigma with one shared map
                shared = self._noise(noise.shared((h, w, 4))).expand(fg_lat.shape)
                init_latents = self.scheduler.add_noise(fg_lat.float(), shared, sigmas[t_start]).to(dtype)
            else:
                raise ValueError(f"init_mode {init_mode!r}")

        # ---- 4. every dilation's windows denoised
        with timer.phase("snippet_infer"):
            def make_idx(snip_len, dilation, stride):
                if turbo:  # a partition of each chain; wins over strides
                    return partition_index_matrix(seq_len, snip_len, dilation)
                if stride == 1:
                    return snippet_index_matrix(seq_len, snip_len, dilation)
                return chain_stride_index_matrix(seq_len, snip_len, dilation, stride)

            idx_ls = [make_idx(sl, d, st) for d, sl, st in zip(dilations, snippet_lengths, strides)]
            run = dict(prompt_embeds=prompt_embeds, timesteps=timesteps[t_start:], sigmas=sigmas,
                       begin_index=t_start, noise=noise, num_inference_steps=num_inference_steps,
                       cond_first=cond_first, chunks=chunks, counters=counters)
            if len(set(snippet_lengths)) == 1:
                # every window of every dilation in one pass; SDE draws keyed by the per-dilation row
                ids = np.concatenate([np.arange(m.shape[0]) for m in idx_ls])
                lats = [self._infer_snippets(cond_latent, init_latents, np.concatenate(idx_ls), ids, **run)]
                rows = [sum(m.shape[0] for m in idx_ls)]
            else:
                lats = [self._infer_snippets(cond_latent, init_latents, m, np.arange(m.shape[0]), **run)
                        for m in idx_ls]
                rows = [m.shape[0] for m in idx_ls]

        # ---- 5. every window frame decoded
        with timer.phase("decode"):
            groups = [self._decode_windows(lat, s_all, max_vae_bs, chunks) for lat, s_all in zip(lats, rows)]
            if len(groups) < len(idx_ls):
                groups = list(torch.split(groups[0], [m.shape[0] for m in idx_ls]))  # [S, n, 3, H, W]
            del lats

        # ---- 6. per-channel co-alignment, each channel to [0, 1]
        with timer.phase("coalign"):
            aligner = DepthAligner(AlignerConfig(**(coalign_kwargs or {})))
            channels = []
            for ch in range(3):
                merged = aligner.run([g[:, :, ch : ch + 1] for g in groups], dilations, index_mats=idx_ls,
                                     seq_len=seq_len)[0]
                merged = merged - merged.amin()
                channels.append(merged / merged.amax().clamp(min=1e-8))  # [N, 1, H, W] fp32

        snippet_ls = aligned_ls = None
        if keep_snippets:
            snippet_ls = groups
            aligned_ls = [(torch.cat(channels, dim=1) * 2.0 - 1.0)[None]]
        if verbose:
            logger.info("phase timings: %s", timer.summary())
        self.last_timings = timings
        self.last_chunks = chunks
        if generators is not None:
            counters["noise_generators"] = noise.generators - generators
        self.last_counters = counters
        if fetch_output:
            fetch = lambda x: x.float().cpu().numpy()  # noqa: E731
            channels = [fetch(c) for c in channels]
            if keep_snippets:
                snippet_ls = [fetch(g) for g in snippet_ls]
                aligned_ls = [fetch(a) for a in aligned_ls]
        return RollingImgOutput(R_pred=channels[0], G_pred=channels[1], B_pred=channels[2],
                                snippet_ls=snippet_ls, aligned_snippet_pred_ls=aligned_ls)

    def _encode(self, x: torch.Tensor, bs: int, chunks: Dict[str, int]) -> torch.Tensor:
        """[M, H, W, 3] -> [M, h, w, 4] scaled latents, ``bs`` frames a chunk."""
        chunks["encode"] = chunks.get("encode", 0) + -(-x.shape[0] // bs)
        return torch.cat([self.vae.encode_mean(x[i : i + bs]) for i in range(0, x.shape[0], bs)])

    def _decode(self, z: torch.Tensor, bs: int, chunks: Dict[str, int]) -> torch.Tensor:
        """[M, h, w, 4] -> [M, H, W, 3] RGB, ``bs`` frames a chunk."""
        chunks["decode"] = chunks.get("decode", 0) + -(-z.shape[0] // bs)
        return torch.cat([self.vae.decode(z[i : i + bs]) for i in range(0, z.shape[0], bs)])

    @torch.no_grad()
    def t2i_init_latents(self, seq_len: int, h: int, w: int, prompt_embeds, t_start: int, timesteps, sigmas,
                         noise, num_inference_steps: int = NUM_INFERENCE_STEPS,
                         chunks: Optional[Dict[str, int]] = None,
                         counters: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """Per-frame intermediate text-to-image latents [N, h, w, 4] (what
        the reference loads from a precomputed blob): the base UNet on each
        frame alone (one-frame windows) for the first ``t_start`` steps of
        the full schedule, from per-frame noise, SDE draws keyed by frame."""
        chunks = {} if chunks is None else chunks
        counters = {} if counters is None else counters
        if self.base_unet is None:
            logger.warning("no base UNet available; falling back to shared noise init")
            return self._noise(noise.shared((h, w, 4))).expand(seq_len, h, w, 4).to(self.dtype)
        bs = self.snippet_batch
        out = []
        with span("rd.t2i", {"frames": seq_len, "steps": t_start}):
            for c in range(0, seq_len, bs):
                fids = np.arange(c, min(c + bs, seq_len))
                lat = self._noise(noise.frames(fids, (h, w, 4))).to(self.dtype)
                state = DPMState.init()
                for i in range(t_start):
                    eps = self.base_unet(lat[:, None], int(timesteps[i]), prompt_embeds)[:, 0]
                    with span("rd.sampler", {"frames": len(fids), "step": i}):
                        step_noise = self._noise(noise.steps(fids, i, (h, w, 4)))
                        prev, state = self.scheduler.step(eps.float(), i, lat.float(), sigmas, num_inference_steps,
                                                          state, noise=step_noise)
                        lat = prev.to(self.dtype)
                    _count(counters, base_unet_calls=1, sampler_steps=1)
                out.append(lat)
        chunks["t2i_unet"] = chunks.get("t2i_unet", 0) + -(-seq_len // bs) * t_start
        return torch.cat(out)

    def _infer_snippets(self, cond_latent, init_latents, index_matrix: np.ndarray, snippet_ids: np.ndarray, *,
                        prompt_embeds, timesteps, sigmas, begin_index: int, noise, num_inference_steps: int,
                        cond_first: bool, chunks: Dict[str, int], counters: Dict[str, int]) -> torch.Tensor:
        """Windows [S, n] of the frame latents: the SDE denoise from
        ``begin_index``, at most ``snippet_batch`` windows at a time (a W8A8
        UNet's grouped as JAX groups them, ``rollingdepth.unet_chunks``).
        Returns the denoised latents [S, n, h, w, 4] in the pipeline dtype;
        with a mesh, this dp rank's block of the windows (``_decode_windows``
        gathers them)."""
        index_matrix = shard_rows(index_matrix, self.mesh, pad=True)
        snippet_ids = shard_rows(snippet_ids, self.mesh, pad=True)
        s = index_matrix.shape[0]
        sb, dtype = self.snippet_batch, self.dtype
        idx = torch.as_tensor(index_matrix, device=cond_latent.device, dtype=torch.long)
        lats = []
        bounds = unet_chunks(s, sb, is_quantized(self.unet), relight=True)
        for a, b in bounds:
            ic, sid = idx[a:b], snippet_ids[a:b]
            cond_c, lat = cond_latent[ic], init_latents[ic]  # [b, n, h, w, 8], [b, n, h, w, 4]
            state = DPMState.init()
            for i, t in enumerate(timesteps):
                x = torch.cat([cond_c, lat] if cond_first else [lat, cond_c], dim=-1)
                eps = self.unet(x, int(t), prompt_embeds)
                with span("rd.sampler", {"windows": b - a, "step": begin_index + i}):
                    step_noise = self._noise(noise.steps(sid, i, lat.shape[1:]))
                    prev, state = self.scheduler.step(eps.float(), begin_index + i, lat.float(), sigmas,
                                                      num_inference_steps, state, noise=step_noise)
                    lat = prev.to(dtype)
                _count(counters, iclight_unet_calls=1, sampler_steps=1)
            lats.append(lat)
        chunks["unet"] = chunks.get("unet", 0) + len(bounds) * len(timesteps)
        return torch.cat(lats)

    def _decode_windows(self, lat: torch.Tensor, s_all: int, vae_bs: int, chunks: Dict[str, int]) -> torch.Tensor:
        """Denoised windows [S, n, h, w, 4] -> every window frame decoded,
        [S, n, 3, H, W] in the pipeline dtype.  With a mesh ``lat`` is this dp
        rank's block and the decoded blocks are all-gathered to ``s_all``
        windows."""
        s, n = lat.shape[:2]
        img = self._decode(lat.reshape((s * n,) + lat.shape[2:]), vae_bs, chunks)  # [S*n, H, W, 3]
        img = img.reshape((s, n) + img.shape[1:]).permute(0, 1, 4, 2, 3).contiguous()
        return gather_rows(img, self.mesh, s_all)


def _count(counters: Dict[str, int], **incr: int) -> None:
    for k, v in incr.items():
        counters[k] = counters.get(k, 0) + v
