"""Processes, their devices and the clip round-robin across them.

Counterpart of ``rollingdepth_tpu/parallel/multihost.py``.  A JAX process
is a host that owns several devices; a port process owns one rank, as
``torchrun`` launches it:

    torchrun --nproc-per-node N -m rollingdepth_torch.cli -i clips/ -o out/

- ``initialize_distributed`` joins the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), and does nothing
  in a single process, as the JAX version;
- clips are independent, so the CLI splits the clip list round-robin over
  the processes (``shard_work``) with no collective at all; every rank runs
  its own pipeline on its own card;
- ``local_mesh`` builds the (dp, tp) mesh over one host's ranks, for a
  pipeline or a train step that spans them.

The backend is a transport choice, made explicit and logged: ``nccl`` when
every rank of a host has a card of its own, ``gloo`` when ranks share a
card (NCCL refuses two ranks on one device) or the caller asks for the
CPU.  gloo moves CUDA tensors through host memory; the work stays on the
card either way.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import best_mesh_shape

logger = logging.getLogger(__name__)

ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def local_device() -> torch.device:
    """This rank's card, ``cuda:{LOCAL_RANK % device_count}`` (ranks beyond
    the host's card count share cards); ``cuda`` on a host without one, which
    ``utils.device.resolve_device`` refuses."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device(f"cuda:{_env_int('LOCAL_RANK', 0) % n}" if n else "cuda")


def choose_backend(device=None) -> str:
    """``gloo`` for the CPU, or when this host runs more ranks
    (``LOCAL_WORLD_SIZE``) than it has cards; else ``nccl``.  ``device``
    None is the card (``utils.device.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo"
    ranks_here = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    return "nccl" if ranks_here <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device=None, timeout: datetime.timedelta = datetime.timedelta(minutes=10)
                           ) -> Optional[str]:
    """Join the process group from torchrun's variables; returns the
    backend, or None when none of them is set (a single process) or the
    group already exists.  ``device`` ("cpu" or a CUDA device; default this
    rank's card, raising without one) picks the backend (``choose_backend``); on
    the card the rank's device is set and CUDA initialized first.
    ``timeout`` bounds every collective."""
    if dist.is_initialized() or not any(v in os.environ for v in ENV_VARS):
        return None
    world, rank = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = local_device()  # "cuda" names no card: this rank's own
    backend = choose_backend(dev)
    if dev.type == "cuda":
        # before any group or mesh: DeviceMesh would otherwise pick the
        # device LOCAL_RANK, which does not exist when ranks share a card
        torch.cuda.set_device(dev)
        torch.cuda.init()
    logger.info("rank %d of %d: backend %s on %s", rank, world, backend, dev)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank, timeout=timeout)
    return backend


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_mesh(shape: Optional[Tuple[int, int]] = None, device_type: Optional[str] = None):
    """The (dp, tp) mesh over THIS host's ranks (``LOCAL_WORLD_SIZE`` of
    them, adjacent in rank): a ("host", "dp", "tp") mesh over every rank,
    sliced to this host's ("dp", "tp").  Collectives of the pipeline then
    never leave the host.  ``device_type`` as for ``mesh.make_mesh``.
    Needs an initialized process group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("local_mesh needs an initialized process group: call initialize_distributed() first")
    world = dist.get_world_size()
    per_host = _env_int("LOCAL_WORLD_SIZE", world)
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of {per_host}")
    dp, tp = best_mesh_shape(per_host) if shape is None else shape
    if dp * tp != per_host:
        raise ValueError(f"mesh shape {(dp, tp)} != {per_host} ranks on this host")
    mesh = init_device_mesh(resolve_device(device_type).type, (world // per_host, dp, tp),
                            mesh_dim_names=("host", "dp", "tp"))
    return mesh["dp", "tp"]


def shard_work(items: Sequence, process_id: Optional[int] = None, num_processes: Optional[int] = None) -> List:
    """Disjoint, deterministic slice of ``items`` for this process
    (round-robin so heterogeneous clip lengths balance).  Identity in
    single-process runs."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return [item for i, item in enumerate(items) if i % n == pid]


def is_primary_host(process_id: Optional[int] = None) -> bool:
    """True on the process that should write shared outputs / logs."""
    return (process_index() if process_id is None else process_id) == 0
