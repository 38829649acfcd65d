"""RollingDepth video-depth pipeline.

Counterpart of ``rollingdepth_tpu/pipelines/rollingdepth.py``
(``RollingDepthPipeline.__call__`` and ``forward``):
1. VAE-encode all frames, ``max_vae_bs`` at a time;
2. build the snippet windows of every dilation;
3. one DDIM denoise of every window through the UNet, ``snippet_batch``
   windows at a time, all starting from ONE shared noise map;
4. merge the windows per frame, either
   - in latent space (``merge_in_latent=True``): co-align the windows'
     latents (``aligner.py``), average them per frame and decode the N
     frames once, or
   - in depth space (``merge_in_latent=False``, the reference merge): decode
     every window's frames and co-align the decoded depth;
5. min-max normalise to [-1, 1];
6. with ``refine_step > 0``, refine: VAE-encode the merged depth (or take
   the merged latent, ``refine_in_latent``), noise it to the middle of a
   ``2 * refine_step`` DDIM schedule and take ``refine_step`` steps over
   windows whose dilation anneals to 1, averaging overlapping windows per
   frame; decode.
Work items are independent, so the last chunk of each loop runs at its
true size.

With a ``mesh`` (``parallel/mesh.py``; the JAX package's ``mesh=``) the
snippet windows split in blocks over ``dp``: each dp rank denoises its
block (a block short of ceil(S / dp) rows repeats its last window) and
the windows' latents are all-gathered once, the padding dropped; the
depth-space merge decodes every window the same way, and each refine step
runs its block of the step's windows into its own sum, all-reduced over
dp before the average.  The encode, the solves and the final decode run
on every rank.  A UNet sharded over ``tp`` (``parallel.shard_unet_``)
makes its own collectives; with no mesh nothing is communicated.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..aligner import AlignerConfig, DepthAligner, frame_sum, frame_table
from ..ops.quant import is_quantized, to_compute_dtype_
from ..parallel.mesh import axis
from ..parallel.sharding import gather_rows, row_block, shard_rows
from ..utils.device import resolve_device
from ..utils.profiling import PhaseTimer, clip_span
from .snippets import (
    cap_max_dilation,
    chain_stride_index_matrix,
    coverage_count,
    current_gap,
    partition_index_matrix,
    snippet_index_matrix,
)

logger = logging.getLogger(__name__)

# the JAX pipelines' small remainder chunk (``_infer_snippets``' tail_sb)
TAIL_CHUNK = 4


def unet_chunks(s: int, max_chunk: int, quantized: bool = False, relight: bool = False) -> List[Tuple[int, int]]:
    """[start, stop) of the windows of each UNet call over ``s`` windows:
    chunks of ``max_chunk``, each call at its true size.  A float UNet's
    windows do not depend on the grouping, so it takes the fewest calls.  A
    W8A8 UNet's activation scale spans one call, so the grouping is part of
    its result: with ``quantized`` the windows are grouped as the JAX
    pipelines group them on one device, chunks of ``max_chunk``
    (``chunking.pick_chunk``) and a remainder of at most two ``TAIL_CHUNK``s
    run as such (the mixed-chunk tail of the depth and, with ``relight``,
    the relight ``_infer_snippets``; JAX splits it to save padded windows,
    which the port does not run)."""
    if not quantized:
        return [(i, min(i + max_chunk, s)) for i in range(0, s, max_chunk)]
    sb = max_chunk if s >= max_chunk else max(1, min(max_chunk, -(-s // 4) * 4))
    s_main, rem = (s // sb) * sb, s % sb
    mixed = s_main > 0 and 0 < rem <= 2 * TAIL_CHUNK and sb > TAIL_CHUNK
    if relight:
        saved = (-s % sb) - (-rem % TAIL_CHUNK)
        mixed = mixed and saved > 0 and s <= 128
    stop = s_main if mixed else s
    bounds = [(i, min(i + sb, stop)) for i in range(0, stop, sb)]
    if mixed:
        bounds += [(i, min(i + TAIL_CHUNK, s)) for i in range(s_main, s, TAIL_CHUNK)]
    return bounds


class RollingDepthOutput:
    def __init__(self, input_frames, depth_pred, depth_coaligned, snippet_ls=None):
        self.input_frames = input_frames  # [N, 3, H, W]: uint8, or float in [-1, 1]
        self.depth_pred = depth_pred  # [N, 1, H, W] in [-1, 1]
        # [N, 1, H, W]; None when refinement read the merged latent and the output stays on the device
        self.depth_coaligned = depth_coaligned
        # per dilation [S, n, 1, H, W]; empty on the latent path, which never decodes a window
        self.snippet_ls: List = [] if snippet_ls is None else snippet_ls
        self._input_rgb = None

    @property
    def input_rgb(self) -> np.ndarray:
        """[N, 3, H, W] in [0, 1]."""
        if self._input_rgb is None:
            f = self.input_frames
            f = f.cpu().numpy() if torch.is_tensor(f) else np.asarray(f)
            if f.dtype == np.uint8:
                self._input_rgb = f.astype(np.float32) / 255.0
            else:
                self._input_rgb = f.astype(np.float32) / 2.0 + 0.5
        return self._input_rgb


class RollingDepthPipeline:
    """UNet (snippet-native) + VAE + DDIM + aligner, on one device, or one
    rank of a (dp, tp) ``mesh``."""

    def __init__(self, unet, vae, scheduler, empty_text_embed, dtype=torch.bfloat16,
                 snippet_batch: int = 8, device=None, mesh=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        # W8A8 weights (ops/quant.py) keep int8 and their fp32 scales
        self.unet = to_compute_dtype_(unet, self.device, dtype).eval()
        self.vae = vae.to(device=self.device, dtype=dtype).eval()
        self.scheduler = scheduler
        self.empty_text_embed = torch.as_tensor(empty_text_embed).to(device=self.device, dtype=dtype)
        self.snippet_batch = snippet_batch
        self.mesh = mesh
        self.last_timings: Dict[str, float] = {}
        # chunks of the last call (this rank's): every VAE encode and decode, snippet and refine UNet calls
        self.last_chunks: Dict[str, int] = {}
        # the last call's denoised windows, per dilation [S, n, h, w, 4] (every window, also under dp)
        self.last_window_latents: List[torch.Tensor] = []
        self.clip_calls = 0  # forward's calls: the clip id of its rd.clip span

    def __call__(
        self,
        input_video_path=None,
        input_frames=None,  # [N, 3, H, W]: uint8 or float in [-1, 1]; numpy or torch
        original_res=None,  # (H, W) before resize, for restore_res with input_frames
        start_frame: int = 0,
        frame_count: int = 0,
        processing_res: int = 1024,
        resample_method: str = "BILINEAR",
        dilations: Sequence[int] = (1, 25),
        cap_dilation: bool = True,
        snippet_lengths: Sequence[int] = (3,),
        init_infer_steps: Sequence[int] = (1,),
        strides: Sequence[int] = (1,),
        coalign_kwargs: Optional[Dict] = None,
        refine_step: int = 0,
        refine_snippet_len: int = 3,
        refine_start_dilation: int = 6,
        seed: Optional[int] = None,
        verbose: bool = False,
        max_vae_bs: int = 4,
        unload_snippet: bool = False,
        restore_res: bool = False,
        merge_in_latent: bool = False,
        latent_coalign_kwargs: Optional[Dict] = None,
        refine_in_latent: Optional[bool] = None,
        turbo_refine: Optional[bool] = None,
    ) -> RollingDepthOutput:
        """Entry point with the JAX package's ``__call__`` arguments: frames
        from ``input_video_path`` (``io/video.py``) unless ``input_frames``
        is given; ``restore_res`` resizes the depth back to ``original_res``."""
        if processing_res > 1024:
            logger.warning("Processing at high resolution (%d) may lead to suboptimal accuracy.", processing_res)
        if input_frames is None:
            from ..io.video import load_video_frames

            input_frames, original_res = load_video_frames(
                input_video_path, start_frame=start_frame, frame_count=frame_count,
                processing_res=processing_res, resample_method=resample_method, verbose=verbose, dtype="uint8",
            )
            logger.info("%d frames loaded from video %s", len(input_frames), input_video_path)
        elif original_res is None:
            original_res = tuple(input_frames.shape[-2:])
        if not torch.is_tensor(input_frames):
            input_frames = np.asarray(input_frames)

        out = self.forward(
            input_frames, dilations=list(dilations), cap_dilation=cap_dilation,
            snippet_lengths=list(snippet_lengths), init_infer_steps=list(init_infer_steps),
            strides=list(strides), coalign_kwargs=coalign_kwargs, refine_step=refine_step,
            refine_snippet_len=refine_snippet_len, refine_start_dilation=refine_start_dilation, seed=seed,
            verbose=verbose, max_vae_bs=max_vae_bs, unload_snippet=unload_snippet,
            merge_in_latent=merge_in_latent, latent_coalign_kwargs=latent_coalign_kwargs,
            refine_in_latent=refine_in_latent, turbo_refine=turbo_refine,
        )
        if restore_res:
            # on the device, bilinear with half-pixel centres and no
            # antialiasing: the rule of the JAX package's cv2.resize(INTER_LINEAR)
            depth = torch.as_tensor(out.depth_pred, device=self.device)
            out.depth_pred = F.interpolate(depth, size=tuple(int(s) for s in original_res), mode="bilinear",
                                           align_corners=False, antialias=False).cpu().numpy()
        return out

    @clip_span
    @torch.no_grad()
    def forward(
        self,
        input_frames,  # [N, 3, H, W]: uint8, or float in [-1, 1]; numpy or torch
        dilations: List[int],
        cap_dilation: bool = True,
        snippet_lengths: List[int] = [3],
        init_infer_steps: List[int] = [1],
        strides: List[int] = [1],
        coalign_kwargs: Optional[Dict] = None,  # AlignerConfig overrides of the depth-space solve
        refine_step: int = 0,
        refine_snippet_len: int = 3,
        refine_start_dilation: int = 6,
        seed: Optional[int] = None,
        verbose: bool = False,
        max_vae_bs: int = 4,
        unload_snippet: bool = False,  # snippet_ls as numpy arrays on the host
        init_noise: Optional[np.ndarray] = None,  # [4, h, w] shared noise override
        fetch_output: bool = True,  # False: the depth maps stay device tensors
        merge_in_latent: bool = False,
        latent_coalign_kwargs: Optional[Dict] = None,  # AlignerConfig overrides of the latent solve
        refine_in_latent: Optional[bool] = None,  # None = off: refine from the re-encoded depth
        turbo_refine: Optional[bool] = None,  # partition refine windows; None follows merge_in_latent
    ) -> RollingDepthOutput:
        if 1 not in dilations:
            raise ValueError("dilations should include 1")
        if len(set(snippet_lengths)) != len(snippet_lengths):
            raise ValueError("snippet_lengths must be distinct")
        n_dil = len(dilations)
        snippet_lengths = snippet_lengths * n_dil if len(snippet_lengths) == 1 else snippet_lengths
        init_infer_steps = init_infer_steps * n_dil if len(init_infer_steps) == 1 else init_infer_steps
        strides = strides * n_dil if len(strides) == 1 else strides
        if not (len(snippet_lengths) == len(init_infer_steps) == len(strides) == n_dil):
            raise ValueError("per-dilation lists must have one entry per dilation")
        if min(init_infer_steps) <= 0:
            raise ValueError("init_infer_steps must be positive")

        seq_len = int(input_frames.shape[0])
        if cap_dilation:
            dilations = [cap_max_dilation(seq_len, n, d, verbose) for n, d in zip(snippet_lengths, dilations)]
            refine_start_dilation = cap_max_dilation(seq_len, refine_snippet_len, refine_start_dilation, verbose)
        # the JAX package's flags: partition refine windows follow the latent
        # merge; handing the merged latent to refinement is opt-in
        if turbo_refine is None:
            turbo_refine = merge_in_latent
        refine_latent_direct = bool(merge_in_latent and refine_step > 0 and refine_in_latent)
        # per-phase times; ROLLINGDEPTH_TRACE_DIR adds a trace of each (utils/profiling.py)
        timer = PhaseTimer(verbose, prefix="rollingdepth", device=self.device)
        timings = timer.timings
        chunks: Dict[str, int] = {}
        dtype, dev = self.dtype, self.device

        # ---- 1. encode
        with timer.phase("encode"):
            frames = torch.as_tensor(input_frames).to(dev)
            if frames.dtype == torch.uint8:
                frames = frames.permute(0, 2, 3, 1).to(dtype) / 127.5 - 1.0
            else:
                frames = frames.permute(0, 2, 3, 1).to(dtype)
            rgb_latent = self._encode(frames, max_vae_bs, chunks)  # [N, h, w, 4]

        # ---- shared init noise: one map for every window
        h, w = rgb_latent.shape[1:3]
        if init_noise is not None:
            noise = torch.as_tensor(np.transpose(np.asarray(init_noise, np.float32), (1, 2, 0)))
            noise = noise.to(device=dev, dtype=dtype)
        else:
            gen = torch.Generator(device=dev).manual_seed(0 if seed is None else seed)
            noise = torch.randn((h, w, 4), generator=gen, device=dev).to(dtype)

        # ---- 2-3. windows and their denoise
        with timer.phase("snippet_infer"):
            idx_ls = [
                snippet_index_matrix(seq_len, n, d) if stride == 1
                else chain_stride_index_matrix(seq_len, n, d, stride)
                for d, n, stride in zip(dilations, snippet_lengths, strides)
            ]
            if len(set(snippet_lengths)) == 1 and len(set(init_infer_steps)) == 1:
                # every preset: all windows are interchangeable work items
                lat_all = self._infer_snippets(rgb_latent, noise, np.concatenate(idx_ls), init_infer_steps[0],
                                               chunks)
                lat_ls = list(torch.split(lat_all, [m.shape[0] for m in idx_ls]))
            else:
                lat_ls = [self._infer_snippets(rgb_latent, noise, m, st, chunks)
                          for m, st in zip(idx_ls, init_infer_steps)]

        self.last_window_latents = lat_ls

        # ---- 4. merge
        merged_lat, snippet_ls = None, []
        if merge_in_latent:
            with timer.phase("coalign"):
                lat_kwargs = {"factor": 3, "depth_loss_weight": 0.0}
                lat_kwargs.update(latent_coalign_kwargs or {})
                merged_lat, _, _, self.last_loss_history = DepthAligner(AlignerConfig(**lat_kwargs)).run(
                    lat_ls, dilations, restore_shift=True, channels_last=True, index_mats=idx_ls, seq_len=seq_len,
                )  # [N, h, w, 4]
            if refine_latent_direct and not fetch_output:
                # refinement reads the merged latent itself, and a caller that
                # keeps the output on the device asks for no coaligned depth:
                # no decode, depth_coaligned comes back None (as in the JAX package)
                depth_coaligned = None
            else:
                with timer.phase("decode"):
                    depth_coaligned = self._decode(merged_lat.to(dtype), max_vae_bs, chunks)[:, None].float()
        else:
            # decode every window's frames (the JAX package counts this in snippet_infer)
            with timer.phase("snippet_decode"):
                flat = torch.cat([lat.reshape((-1,) + lat.shape[2:]) for lat in lat_ls])
                mine = shard_rows(flat, self.mesh, pad=True)  # this dp rank's frames
                depth_flat = gather_rows(self._decode(mine.to(dtype), max_vae_bs, chunks), self.mesh,
                                         flat.shape[0]).float()  # [sum S*n, H, W]
                group_ls = [g.reshape(m.shape[0], m.shape[1], 1, *depth_flat.shape[1:])
                            for g, m in zip(torch.split(depth_flat, [m.size for m in idx_ls]), idx_ls)]
            timings["snippet_infer"] += timings["snippet_decode"]
            snippet_ls = [g.cpu().numpy() for g in group_ls] if unload_snippet else group_ls
            with timer.phase("coalign"):
                depth_coaligned, _, _, self.last_loss_history = DepthAligner(
                    AlignerConfig(**(coalign_kwargs or {}))
                ).run(group_ls, dilations, index_mats=idx_ls, seq_len=seq_len)  # [N, 1, H, W]

        # ---- 5. min-max normalise to [-1, 1]
        if depth_coaligned is not None:
            depth_coaligned = (depth_coaligned - depth_coaligned.amin()) / (
                depth_coaligned.amax() - depth_coaligned.amin()) * 2.0 - 1.0

        # ---- 6. refinement
        if refine_step > 0:
            with timer.phase("refine"):
                if refine_latent_direct:
                    depth_latent = merged_lat.to(dtype)
                else:
                    depth3 = depth_coaligned.expand(-1, 3, -1, -1).permute(0, 2, 3, 1).to(dtype)
                    depth_latent = self._encode(depth3, max_vae_bs, chunks)
                depth_latent = self._refine(rgb_latent, depth_latent, noise, refine_step, refine_snippet_len,
                                            refine_start_dilation, bool(turbo_refine), chunks)
                # clipped to [-1, 1], as the JAX package's uint16 fetch clips it
                depth_pred = self._decode(depth_latent, max_vae_bs, chunks)[:, None].float().clamp(-1.0, 1.0)
        else:
            depth_pred = depth_coaligned

        if verbose:
            logger.info("phase timings: %s", timer.summary())
        self.last_timings = timings
        self.last_chunks = chunks
        if fetch_output:
            depth_pred = depth_pred.cpu().numpy()
            depth_coaligned = depth_pred if refine_step <= 0 else depth_coaligned.cpu().numpy()
        return RollingDepthOutput(input_frames, depth_pred, depth_coaligned, snippet_ls)

    def _encode(self, x: torch.Tensor, bs: int, chunks: Dict[str, int]) -> torch.Tensor:
        """[M, H, W, 3] -> [M, h, w, 4] scaled latents, ``bs`` frames a chunk."""
        chunks["encode"] = chunks.get("encode", 0) + -(-x.shape[0] // bs)
        return torch.cat([self.vae.encode_mean(x[i : i + bs]) for i in range(0, x.shape[0], bs)])

    def _decode(self, z: torch.Tensor, bs: int, chunks: Dict[str, int]) -> torch.Tensor:
        """[M, h, w, 4] -> [M, H, W] depth, the decoded channels' mean."""
        chunks["decode"] = chunks.get("decode", 0) + -(-z.shape[0] // bs)
        return torch.cat([self.vae.decode(z[i : i + bs]).mean(dim=-1) for i in range(0, z.shape[0], bs)])

    def _infer_snippets(self, rgb_latent, noise, index_matrix: np.ndarray, infer_steps: int,
                        chunks: Dict[str, int]) -> torch.Tensor:
        """Gather windows [S, n, h, w, 4] from the frame latents and denoise
        them at most ``snippet_batch`` at a time (a W8A8 UNet's grouped as
        the JAX pipeline groups them, ``unet_chunks``); returns the windows' latents.  With
        a mesh this dp rank denoises its block of the windows and the blocks
        are all-gathered."""
        s_all = index_matrix.shape[0]
        index_matrix = shard_rows(index_matrix, self.mesh, pad=True)
        s = index_matrix.shape[0]
        sb = self.snippet_batch
        timesteps = [int(t) for t in self.scheduler.timesteps(infer_steps)]
        idx = torch.as_tensor(index_matrix, device=rgb_latent.device, dtype=torch.long)
        outs = []
        bounds = unet_chunks(s, sb, is_quantized(self.unet))
        for a, b in bounds:
            rgb = rgb_latent[idx[a:b]]  # [<= sb, n, h, w, 4]
            depth_lat = noise.expand(rgb.shape).to(self.dtype)
            for t in timesteps:
                eps = self.unet(torch.cat([rgb, depth_lat], dim=-1), t, self.empty_text_embed)
                depth_lat = self.scheduler.step(eps.float(), t, depth_lat.float(), infer_steps)[0].to(self.dtype)
            outs.append(depth_lat)
        chunks["unet"] = chunks.get("unet", 0) + len(bounds) * len(timesteps)
        return gather_rows(torch.cat(outs), self.mesh, s_all)

    def _refine(self, rgb_latent, depth_latent, noise, refine_step: int, snippet_len: int, start_dilation: int,
                partition: bool, chunks: Dict[str, int], skip_t_ratio: float = 0.5) -> torch.Tensor:
        """Coarse-to-fine rolling refinement (JAX ``_refine``).  The second
        half of a ``refine_step / skip_t_ratio`` schedule: noise the depth
        latents once at its first timestep, then per step denoise every
        window of that step's dilation (annealed from ``start_dilation`` to
        1) and average each frame over its windows.  ``partition`` takes a
        phase-rotated partition of the frames (~N/n windows a step) instead
        of the stride-1 windows (~N a step).  A frame no window covers keeps
        its latent.  With a mesh this dp rank runs its block of each step's
        windows and the sums are all-reduced over dp."""
        seq_len = rgb_latent.shape[0]
        total_steps = int(refine_step / skip_t_ratio)
        all_ts = self.scheduler.timesteps(total_steps)
        timesteps = [int(t) for t in all_ts[int(len(all_ts) * skip_t_ratio):]]
        n_steps, sb, dev = len(timesteps), self.snippet_batch, rgb_latent.device
        dp, _, dp_group = axis(self.mesh, "dp")
        depth = self.scheduler.add_noise(depth_latent.float(), noise.float().expand(depth_latent.shape),
                                         timesteps[0]).to(self.dtype)
        for i_step, t in enumerate(timesteps):
            gap = current_gap(i_step, n_steps, start_dilation, 1)
            if partition:
                m = partition_index_matrix(seq_len, snippet_len, gap + 1, phase=i_step)
            else:
                m = snippet_index_matrix(seq_len, snippet_len, gap + 1)
            start, stop = row_block(m.shape[0], self.mesh)
            idx = torch.as_tensor(m[start:stop], device=dev, dtype=torch.long)
            rows = []
            for c in range(0, idx.shape[0], sb):
                ic = idx[c : c + sb]
                src = depth[ic]  # every window of a step reads the step's input
                eps = self.unet(torch.cat([rgb_latent[ic], src], dim=-1), t, self.empty_text_embed)
                prev = self.scheduler.step(eps.float(), t, src.float(), total_steps)[0]
                rows.append(prev.reshape((-1,) + prev.shape[2:]))
            rows.append(torch.zeros((1,) + depth.shape[1:], device=dev))
            table = torch.as_tensor(frame_table([m[start:stop]], seq_len)[0], device=dev)
            acc = frame_sum(torch.cat(rows), table)  # this rank's windows, in the table's order
            if dp > 1:
                dist.all_reduce(acc, group=dp_group)
            chunks["refine_unet"] = chunks.get("refine_unet", 0) + -(-idx.shape[0] // sb)
            cnt = torch.as_tensor(coverage_count(m, seq_len), device=dev, dtype=torch.float32)[:, None, None, None]
            depth = torch.where(cnt > 0, acc / cnt.clamp(min=1.0), depth.float()).to(self.dtype)
        return depth
