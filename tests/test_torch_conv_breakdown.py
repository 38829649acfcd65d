"""CPU tests of tools/conv_breakdown.py's reading of the conv kernel's cycle trace."""

from __future__ import annotations

import numpy as np
import pytest

from rollingdepth_torch.tools import conv_breakdown as cb


def _trace(grid, tiles, first_wait, loop, epilogue, gap, wait_a, wait_b):
    """A trace in the kernel's layout where every tile takes the same cycles."""
    t = np.zeros((cb.TRACE_CTAS, cb.TRACE_TILES, cb.TRACE_FIELDS), dtype=np.int64)
    for c in range(grid):
        now = 1000 * c
        for i in range(tiles):
            start = now
            landed = start + first_wait
            done = landed + loop
            end = done + epilogue
            t[c, i] = (start, landed, done, end, wait_a, wait_b)
            now = end + gap
    return t


def test_summarize_reads_each_phase():
    grid, tiles, steps = 3, 5, 18
    t = _trace(grid, tiles, first_wait=100, loop=18 * 1150, epilogue=2800, gap=200, wait_a=1100, wait_b=2600)
    row = cb.summarize(t, n_tiles=grid * tiles + 1, grid=grid, steps=steps)  # one CTA ran a sixth tile
    assert row["tiles_per_cta"] == tiles and row["steps_per_tile"] == steps
    assert row["first_tiles_wait"] == 100 and row["main_loop"] == 18 * 1150 and row["epilogue"] == 2800
    assert row["between_tiles"] == 200 and row["halo_wait_in_loop"] == 1100 and row["weight_wait_in_loop"] == 2600
    assert row["main_loop_per_step"] == 1150
    per_tile = 100 + 18 * 1150 + 2800 + 200
    assert row["cycles_per_tile"] == pytest.approx((tiles * per_tile - 200) / tiles)
    assert row["main_loop_share_of_tile"] == pytest.approx(18 * 1150 / row["cycles_per_tile"])


def test_peak_step_is_the_tile_over_the_tensor_rate():
    # 256 x 128 outputs x 64 channels, two operations a product, 4096 a cycle
    assert cb.PEAK_CYCLES_PER_STEP == 1024


def test_summarize_needs_two_tiles_per_cta():
    t = _trace(4, 1, 10, 10, 10, 10, 0, 0)
    with pytest.raises(ValueError):
        cb.summarize(t, n_tiles=4, grid=4, steps=9)
