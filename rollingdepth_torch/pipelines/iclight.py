"""Generation-2 IC-Light RGB passthrough pipeline.

Counterpart of ``rollingdepth_tpu/pipelines/iclight.py``: the reference
fork's first relighting experiment.  Over an 8-channel depth pipeline
(``pipelines/rollingdepth.py``) it runs the whole window denoise and
discards the result, decodes the windows' RGB condition latents instead,
and co-aligns R, G and B each on its own: the input video reconstructed
through the VAE by the window machinery, as a sanity check.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..aligner import AlignerConfig, DepthAligner
from .rollingdepth import RollingDepthPipeline
from .snippets import cap_max_dilation, snippet_index_matrix


class ICLightPassthroughPipeline:
    """Wraps a RollingDepthPipeline (8-channel UNet) with gen-2 semantics."""

    def __init__(self, depth_pipeline: RollingDepthPipeline):
        self.pipe = depth_pipeline

    @torch.no_grad()
    def forward(
        self,
        input_frames,  # [N, 3, H, W]: uint8, or float in [-1, 1]
        dilations: List[int],
        cap_dilation: bool = True,
        snippet_length: int = 3,
        init_infer_steps: int = 1,
        coalign_kwargs: Optional[Dict] = None,
        seed: int = 0,
        max_vae_bs: int = 4,
    ) -> np.ndarray:
        """[N, 3, H, W] in [-1, 1], numpy."""
        pipe = self.pipe
        seq_len = input_frames.shape[0]
        if cap_dilation:
            dilations = [cap_max_dilation(seq_len, snippet_length, d) for d in dilations]
        frames = torch.as_tensor(np.asarray(input_frames)).to(pipe.device).permute(0, 2, 3, 1)
        frames = frames.to(pipe.dtype) / 127.5 - 1.0 if frames.dtype == torch.uint8 else frames.to(pipe.dtype)
        chunks: Dict[str, int] = {}
        rgb_latent = pipe._encode(frames, max_vae_bs, chunks)

        h, w = rgb_latent.shape[1:3]
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        noise = torch.randn((h, w, 4), generator=gen, device=pipe.device).to(pipe.dtype)
        snippet_rgb_ls = []
        for d in dilations:
            idx = snippet_index_matrix(seq_len, snippet_length, d)
            pipe._infer_snippets(rgb_latent, noise, idx, init_infer_steps, chunks)  # run, and discarded
            snippets = rgb_latent[torch.as_tensor(idx, device=pipe.device)]  # [S, n, h, w, 4]
            flat = snippets.reshape((-1,) + snippets.shape[2:])
            img = torch.cat([pipe.vae.decode(flat[i : i + max_vae_bs]) for i in range(0, flat.shape[0], max_vae_bs)])
            snippet_rgb_ls.append(img.reshape(snippets.shape[:2] + img.shape[1:]).permute(0, 1, 4, 2, 3).float())

        aligner = DepthAligner(AlignerConfig(**(coalign_kwargs or {})))
        channels = []
        for ch in range(3):
            merged = aligner.run([s[:, :, ch : ch + 1] for s in snippet_rgb_ls], dilations)[0]
            merged = merged - merged.amin()
            merged = merged / merged.amax().clamp(min=1e-8)  # a constant channel would give 0/0
            channels.append((merged * 2.0 - 1.0).cpu().numpy())
        return np.concatenate(channels, axis=1)
