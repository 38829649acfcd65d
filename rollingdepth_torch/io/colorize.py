"""Depth-map colorization.

A copy of ``rollingdepth_tpu/io/colorize.py`` with matplotlib imported
inside ``colorize_depth``: a matplotlib colormap with an optional validity
mask, and a thread-pooled chunked variant for long videos.  Without
matplotlib, colorizing raises an ImportError that says so.
"""

from __future__ import annotations

import concurrent.futures
from typing import Optional

import numpy as np


def colorize_depth(
    depth: np.ndarray,
    min_depth: float,
    max_depth: float,
    cmap: str = "Spectral_r",
    valid_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[H,W] or [B,H,W] depth -> [B,H,W,3] float colors in [0,1]."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("colorize_depth needs matplotlib for its colormaps, and it is not installed") from e
    assert depth.ndim >= 2, "Invalid dimension"
    if depth.ndim < 3:
        depth = depth[np.newaxis]
    cm = matplotlib.colormaps[cmap]
    norm = ((depth - min_depth) / (max_depth - min_depth)).clip(0, 1)
    colored = cm(norm, bytes=False)[..., 0:3]
    if valid_mask is not None:
        mask = np.squeeze(valid_mask)
        if mask.ndim < 3:
            mask = mask[np.newaxis]
        colored[~mask.astype(bool)] = 0
    return colored


def colorize_depth_multi_thread(
    depth: np.ndarray,  # [N, 1, H, W]
    valid_mask: Optional[np.ndarray] = None,
    chunk_size: int = 4,
    num_threads: int = 4,
    color_map: str = "Spectral",
    verbose: bool = False,
) -> np.ndarray:
    """[N,1,H,W] -> uint8 [N,H,W,3], normalized over the whole clip."""
    depth = depth.squeeze(1)
    assert depth.ndim == 3
    n = depth.shape[0]
    valid = depth if valid_mask is None else depth[valid_mask]
    lo, hi = float(valid.min()), float(valid.max())

    out = np.empty((*depth.shape, 3), dtype=np.uint8)

    def work(i):
        chunk = colorize_depth(depth[i : i + chunk_size], lo, hi, cmap=color_map)
        out[i : i + min(chunk_size, n - i)] = (chunk * 255).astype(np.uint8)

    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as ex:
        list(ex.map(work, range(0, n, chunk_size)))
    return out
