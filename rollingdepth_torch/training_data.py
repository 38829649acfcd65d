"""Training data: video clips -> snippet latent pair batches.

Counterpart of ``rollingdepth_tpu/training_data.py``:

- clips are VAE-encoded once (rgb frames, and depth maps replicated to 3
  channels through the same encoder, as inference encodes depth for
  refinement); the latents stay on the host as fp32 numpy;
- training examples are dilated snippet windows over those latents
  (``pipelines/snippets.py``), pooled across clips and dilations;
- batches ``{"rgb_latent": [B, n, h, w, 4], "depth_latent": ...}`` are
  gathered on the host; on the card the next one is uploaded from freshly
  pinned memory with ``non_blocking=True`` while the caller's step runs.

The epoch order is ``np.random.RandomState(seed + epoch).permutation``, so
the port and the JAX package give the same batches, and a run resumes from
(seed, step) alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .pipelines.snippets import cap_max_dilation, snippet_index_matrix
from .utils.device import resolve_device

EncodeFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SnippetDataConfig:
    snippet_len: int = 3
    dilations: Tuple[int, ...] = (1, 10, 25)
    cap_dilation: bool = True
    batch_size: int = 8
    seed: int = 0


def vae_encode_fn(vae, max_vae_bs: int = 4) -> EncodeFn:
    """``frames [N, H, W, 3] in [-1, 1] -> [N, h, w, 4]``: the VAE's scaled
    posterior mean, ``max_vae_bs`` frames a chunk, in the VAE's device and
    dtype.  Under ``no_grad``, not ``inference_mode``: a latent made in
    inference mode could not be saved for a backward pass."""
    p = next(vae.parameters())

    @torch.no_grad()
    def encode(frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(device=p.device, dtype=p.dtype)
        return torch.cat([vae.encode_mean(x[i : i + max_vae_bs]) for i in range(0, x.shape[0], max_vae_bs)])

    return encode


class SnippetLatentDataset:
    """Encodes clips once, then serves shuffled snippet-latent batches.

    ``encode_fn(frames_nhwc) -> latents [N, h, w, 4]``, typically
    ``vae_encode_fn(vae, max_vae_bs)``.  Clips are numpy arrays or tensors
    (on any device), rgb ``[N, 3, H, W]`` and depth ``[N, 1, H, W]`` in
    [-1, 1].  Batches are uploaded to ``device`` (the card unless given)."""

    def __init__(
        self,
        encode_fn: EncodeFn,
        rgb_clips: Sequence[Any],
        depth_clips: Sequence[Any],
        config: SnippetDataConfig = SnippetDataConfig(),
        device=None,
    ):
        if len(rgb_clips) != len(depth_clips):
            raise ValueError(f"{len(rgb_clips)} rgb clips but {len(depth_clips)} depth clips")
        self.config = config
        self.device = resolve_device(device)
        self.rgb_latents: List[np.ndarray] = []
        self.depth_latents: List[np.ndarray] = []
        self.windows: List[Tuple[int, np.ndarray]] = []  # (clip_id, [n] frame idx)

        for clip_id, (rgb, depth) in enumerate(zip(rgb_clips, depth_clips)):
            rgb, depth = torch.as_tensor(rgb).float(), torch.as_tensor(depth).float()
            if rgb.shape[0] != depth.shape[0]:
                raise ValueError(f"clip {clip_id}: {rgb.shape[0]} rgb frames but {depth.shape[0]} depth frames")
            # depth replicated to 3 channels through the same encoder, as the
            # inference refinement path encodes it
            for clip, latents in ((rgb, self.rgb_latents), (depth.repeat(1, 3, 1, 1), self.depth_latents)):
                latents.append(encode_fn(clip.permute(0, 2, 3, 1)).float().cpu().numpy())

            n_frames = rgb.shape[0]
            seen_dilations = set()  # dilations capped to one value would repeat every window
            for dilation in config.dilations:
                d = cap_max_dilation(n_frames, config.snippet_len, dilation, False) if config.cap_dilation else dilation
                # a short clip can cap d below 1, which snippet_index_matrix refuses
                if d < 1 or d in seen_dilations:
                    continue
                if n_frames < (config.snippet_len - 1) * d + 1:
                    continue
                seen_dilations.add(d)
                for row in snippet_index_matrix(n_frames, config.snippet_len, d):
                    self.windows.append((clip_id, row))
        if not self.windows:
            raise ValueError("no snippet windows — clips too short for config")

    def __len__(self) -> int:
        return len(self.windows)

    def steps_per_epoch(self) -> int:
        return len(self.windows) // self.config.batch_size

    def _gather(self, order: np.ndarray, step: int) -> Dict[str, np.ndarray]:
        bs = self.config.batch_size
        rows = [self.windows[r] for r in order[step * bs : (step + 1) * bs]]
        return {"rgb_latent": np.stack([self.rgb_latents[c][i] for c, i in rows]),
                "depth_latent": np.stack([self.depth_latents[c][i] for c, i in rows])}

    def _upload(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the device.  On the card each array is
        pinned afresh and copied with ``non_blocking``; PyTorch's pinned
        allocator reuses that memory only after the copy has completed."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True) for k, v in batch.items()}

    def epoch(self, epoch_idx: int, upload: bool = True) -> Iterator[Dict[str, Any]]:
        """One shuffled epoch of batches; the next batch is uploaded before
        the current one is handed over, so its copy overlaps the caller's
        step.  ``upload=False`` yields the host (numpy) batches."""
        rng = np.random.RandomState(self.config.seed + epoch_idx)
        order = rng.permutation(len(self.windows))
        n_steps = self.steps_per_epoch()
        if n_steps == 0:
            return
        put = self._upload if upload else (lambda b: b)
        pending = put(self._gather(order, 0))
        for step in range(n_steps):
            nxt = put(self._gather(order, step + 1)) if step + 1 < n_steps else None
            yield pending
            pending = nxt
