"""The verdict on the numbers that decide ``correct``.

A cell's builder (``rdbench/builders/<builder>.py``) computes the numbers
its ``NUMBERS`` names against its plain reference; a cell compares those
its ``limits`` name, each against its limit.  What is here is shared:
the relative error of a stack of rows, and the verdict.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

MALFORMED = 1e30  # the reading of an output of the wrong shape or with non-finite values


def worst_rel_err(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> float:
    """The largest RMS difference of one row (dim 0 of each tensor) over the
    RMS spread of all of ``ref``."""
    got = torch.cat([torch.as_tensor(g).double().cpu().reshape(g.shape[0], -1) for g in got])
    ref = torch.cat([torch.as_tensor(r).double().cpu().reshape(r.shape[0], -1) for r in ref])
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return MALFORMED
    rows = (got - ref).pow(2).mean(dim=1).sqrt()
    return float(rows.max() / ref.std().clamp(min=1e-30))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number without a limit fails."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
