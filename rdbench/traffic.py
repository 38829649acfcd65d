"""The general clip generator: a traffic file's parameters and a seed -> clips.

A traffic file (``rdbench/traffic/<name>.json``) gives:
- ``frames``: frames a clip, or ``frames_range`` [lo, hi] to draw each
  clip's length from (inclusive), by the seed;
- ``height``, ``width``: the processing size of a frame (multiples of 8);
- ``kind``: what a clip holds, which the cell's builder draws
  (``draw_clip(rng, frames, traffic)``, ``rdbench/builders/``) and checks
  against its ``KINDS``: a builder of another entry brings its own kind;
- ``pool`` (default ``POOL``): how many distinct clips set-up draws; the
  window takes clip k from ``k % pool``.
Clip k of seed s is drawn from ``numpy.random.default_rng([s, k])``, so a
clip is the same in every run and for both sides of a comparison.  Every
clip holds ``frames``, whose first axis is its length.  Drawing clips is
the benchmark's work, not the program's, so it happens in set-up: on the
card's host a 60-frame 432x768 clip took 0.31 s to draw, an eighth of its
time through the pipeline.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

POOL = 4
WARMUP_CLIP = 2**32 - 1  # the index of the set-up's warm-up clip, which no window reaches


def pool(traffic: Dict, seed: int, builder) -> list:
    """The clips a window cycles through, drawn in set-up."""
    return [make_clip(traffic, seed, k, builder) for k in range(traffic.get("pool", POOL))]


def clip_frames(traffic: Dict, seed: int, k: int) -> int:
    if "frames_range" in traffic:
        lo, hi = traffic["frames_range"]
        return int(np.random.default_rng([seed, k, 1]).integers(lo, hi + 1))
    return int(traffic["frames"])


def make_clip(traffic: Dict, seed: int, k: int, builder) -> Dict[str, np.ndarray]:
    """Clip ``k`` of ``seed``, drawn by ``builder.draw_clip``."""
    if traffic["kind"] not in builder.KINDS:
        raise ValueError(f"traffic kind {traffic['kind']!r} is not one of the builder's {builder.KINDS}")
    return builder.draw_clip(np.random.default_rng([seed, k]), clip_frames(traffic, seed, k), traffic)
