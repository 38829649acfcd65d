"""The control comes out not correct, on the card at the cell's own size.

Each number's control (``control.py``: the program with its W8A8 UNet, the
reference's stages a precision step below) must fail it on every seed, and
the program itself pass them all.  Runs on the card only:
``python3 -m pytest rdbench/tests/test_rdbench_control.py -m cuda``.
"""

import pytest
import torch

from rdbench import check, control, run

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["depth-fast-60f", "depth-full-60f"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_program_passes(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.set_cache_dirs()
    limits = run.load_cell(cell)["cell"]["limits"]
    r = control.readings(cell, seed)
    assert check.passed(check.verdict(r["program"], limits)), r["program"]
    for key, value in r["control"].items():
        assert value > limits[key], (key, value)
