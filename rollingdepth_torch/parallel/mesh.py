"""The (dp, tp) device mesh over the ranks of a ``torch.distributed`` group.

Counterpart of ``rollingdepth_tpu/parallel/mesh.py``.  The JAX package
leaves distribution to XLA GSPMD on one process that owns every device;
the port runs one process per rank and writes each collective by hand:
- ``dp`` splits the snippet windows (and a training batch) in blocks; the
  ranks of a dp group denoise disjoint windows with no traffic between
  them, and gather the results once;
- ``tp`` splits the transformer blocks' projections Megatron's way
  (``sharding.py``): one all-reduce after every row-parallel linear.
The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("dp", "tp")``; rank ``r`` sits at (r // tp, r % tp), so
the ranks of a tp group are adjacent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

from ..utils.device import resolve_device


def best_mesh_shape(n_devices: int, max_tp: int = 4) -> Tuple[int, int]:
    """Split devices into (dp, tp).

    tp is kept small (heads at the coarsest UNet level = 20 for SD2, and conv
    channel dims bound the useful tp) and must divide the device count; dp
    takes the rest — snippet parallelism scales linearly with zero attention
    traffic between chips.
    """
    tp = 1
    for cand in (4, 2):
        if cand <= max_tp and n_devices % cand == 0 and n_devices >= cand * 2:
            tp = cand
            break
    return n_devices // tp, tp


def make_mesh(shape: Optional[Tuple[int, int]] = None, device_type: Optional[str] = None):
    """A (dp, tp) ``DeviceMesh`` over every rank of the default group;
    ``shape`` defaults to ``best_mesh_shape(world size)``, ``device_type``
    to the card (``utils.device.resolve_device``; "cpu" for gloo on the
    host).  Needs an initialized process group
    (``multihost.initialize_distributed``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: call "
                           "parallel.multihost.initialize_distributed() first")
    world = dist.get_world_size()
    dp, tp = best_mesh_shape(world) if shape is None else shape
    if dp * tp != world:
        raise ValueError(f"mesh shape {(dp, tp)} != {world} ranks")
    return init_device_mesh(resolve_device(device_type).type, (dp, tp), mesh_dim_names=("dp", "tp"))


def axis(mesh, name: str) -> Tuple[int, int, Optional[dist.ProcessGroup]]:
    """(size, this rank's index, group) of the mesh axis ``name``; (1, 0,
    None) without a mesh."""
    if mesh is None:
        return 1, 0, None
    size = mesh.size(mesh.mesh_dim_names.index(name))
    return size, mesh.get_local_rank(name), mesh.get_group(name)
