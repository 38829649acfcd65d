"""Distribution over ``torch.distributed``: the (dp, tp) mesh, Megatron tp
of the UNet, dp of the snippet windows and clip round-robin across
processes.  Counterpart of ``rollingdepth_tpu/parallel/``."""

from .mesh import best_mesh_shape, make_mesh  # noqa: F401
from .sharding import shard_rows, shard_unet_, unet_param_sharding  # noqa: F401
