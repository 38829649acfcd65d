"""Device resolution for the port's entry points.

The port runs on a CUDA card.  An entry point called without ``device=``
asks for ``"cuda"``; on a host without a card that raises instead of
quietly running the whole pipeline on the CPU.  Tests and CPU tools pass
``device="cpu"`` explicitly.  ``card_name`` is what a timing tool prints
beside its numbers.
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rollingdepth_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of each card, a line each
    (``NVIDIA H100 80GB HBM3, 700.00 W``), or "cpu" where it reads none."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "cpu"
    return smi or "cpu"
