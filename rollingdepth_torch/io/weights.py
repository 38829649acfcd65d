"""Diffusers-layout checkpoint reading, and the bridge from JAX pytrees.

The port's modules carry diffusers parameter names, so a diffusers state
dict loads with ``load_state_dict`` as it is.  This module finds and reads
a module's weight files (single-file, sharded ``*.index.json`` and
``fp16``-variant safetensors, or a torch ``.bin``) and its config, and
converts a parameter pytree of the JAX package (nested dicts and lists of
arrays) back into a diffusers-named state dict: ``state_dict_from_jax`` is
the inverse of ``rollingdepth_tpu.io.weights.state_dict_to_pytree``
(``quant_state_dict_from_jax`` carries a W8A8 pytree's int8 kernels), and
``adamw_state_from_jax`` carries optax's Adam moments across to
``torch.optim.AdamW`` the same way.  The IC-Light transforms
(``expand_conv_in``, ``merge_offset``) act on such state dicts at load
time.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .safetensors import load_file

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# JAX pytree -> diffusers state dict
# ---------------------------------------------------------------------------


def _leaf_to_torch(name: str, arr: np.ndarray):
    """Our leaf name + array -> (diffusers leaf name, tensor layout).  A
    W8A8 ``kernel_q`` becomes ``weight_q`` in the same layout as ``weight``."""
    if name in ("kernel", "kernel_q"):
        out = "weight" if name == "kernel" else "weight_q"
        if arr.ndim == 4:  # conv HWIO -> OIHW
            return out, np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:  # linear [I, O] -> [O, I]
            return out, np.transpose(arr, (1, 0))
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """Flatten a JAX parameter pytree into a diffusers-named state dict.

    List index ``i`` becomes the path segment ``.i``; ``to_out`` becomes
    diffusers' ``to_out.0``; the GEGLU halves ``ff.proj_h``/``ff.proj_gate``
    are fused back into ``ff.net.0.proj`` (value half first) and ``ff.out``
    becomes ``ff.net.2``."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            arr = np.asarray(node)
            flat[".".join(prefix)] = arr if arr.dtype == np.int8 else arr.astype(np.float32)

    walk(params, [])
    out: StateDict = {}
    for key, arr in flat.items():
        parts = key.split(".")
        leaf, path = parts[-1], parts[:-1]
        if ".ff.proj_gate." in f".{key}.":
            continue  # fused together with its proj_h half below
        name, t = _leaf_to_torch(leaf, arr)
        if path and path[-1] == "proj_h" and len(path) > 1 and path[-2] == "ff":
            gate_key = ".".join(path[:-1] + ["proj_gate", leaf])
            _, g = _leaf_to_torch(leaf, flat[gate_key])
            t = np.concatenate([t, g], axis=0)
            path = path[:-1] + ["net", "0", "proj"]
        elif path and path[-1] == "out" and len(path) > 1 and path[-2] == "ff":
            path = path[:-1] + ["net", "2"]
        elif path and path[-1] == "to_out":
            path = path + ["0"]
        out[".".join(path + [name])] = torch.from_numpy(np.array(t, copy=True))
    return out


def quant_state_dict_from_jax(qparams: Mapping[str, Any]) -> StateDict:
    """A W8A8 UNet pytree of the JAX package (``quantize_unet_params``) as
    the state dict of a port UNet after ``ops.quant.quantize_unet_``: each
    ``kernel_q`` (``[in, out]``/HWIO int8) becomes ``weight_q`` (``[out,
    in]``/OIHW int8), ``w_scale`` stays fp32 [out], and the GEGLU halves'
    ``kernel_q`` and ``w_scale`` fuse into ``ff.net.0.proj`` as ``kernel``
    does (``state_dict_from_jax``)."""
    sd = state_dict_from_jax(qparams)
    if not any(k.endswith(".weight_q") for k in sd):
        raise ValueError("no kernel_q leaf: not a W8A8 pytree (use state_dict_from_jax)")
    return sd


def _find_adam_state(opt_state):
    """The node of an optax state tree with ``count``, ``mu`` and ``nu``."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adamw_state_from_jax(opt_state, module: torch.nn.Module) -> Dict[torch.nn.Parameter, Dict[str, torch.Tensor]]:
    """optax's Adam state as ``torch.optim.AdamW`` per-parameter state of
    ``module``: ``optimizer.state.update(adamw_state_from_jax(s, module))``.

    ``opt_state`` is a ``ScaleByAdamState`` or a state tree holding one (the
    ``chain(clip_by_global_norm, adamw)`` state), with numpy leaves.  ``mu``
    and ``nu`` become ``exp_avg`` and ``exp_avg_sq`` through
    ``state_dict_from_jax``'s names and layouts (moments are elementwise, so
    the kernel transposes and the GEGLU fusion carry them exactly);
    ``count`` becomes every parameter's ``step``."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) in opt_state")
    mu, nu = state_dict_from_jax(adam.mu), state_dict_from_jax(adam.nu)
    step = float(np.asarray(adam.count))
    out: Dict[torch.nn.Parameter, Dict[str, torch.Tensor]] = {}
    for name, p in module.named_parameters():
        if name not in mu:
            raise KeyError(f"optax state has no moments for parameter {name!r}")
        out[p] = {"step": torch.tensor(step, dtype=torch.float32),
                  "exp_avg": mu[name].to(device=p.device, dtype=p.dtype),
                  "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype)}
    return out


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------


def _load_weight_file(path: str) -> StateDict:
    if path.endswith(".safetensors"):
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_sharded(d: str, index_path: str) -> StateDict:
    """Multi-file checkpoint: the index's ``weight_map`` names each
    tensor's shard."""
    with open(index_path) as f:
        weight_map: Dict[str, str] = json.load(f)["weight_map"]
    out: StateDict = {}
    for shard in sorted(set(weight_map.values())):
        out.update(_load_weight_file(os.path.join(d, shard)))
    missing = [k for k in weight_map if k not in out]
    if missing:
        raise ValueError(
            f"sharded checkpoint {index_path} is missing tensors "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}"
        )
    return out


def load_module_state_dict(
    model_dir: str, subfolder: Optional[str] = None, variant: Optional[str] = None
) -> StateDict:
    """A diffusers module's weights from a checkpoint directory.

    ``variant=None`` prefers the base file and falls back to an ``fp16``
    variant when only that exists."""
    d = os.path.join(model_dir, subfolder) if subfolder else model_dir
    variants = [variant] if variant else [None, "fp16"]
    bases = [
        ("diffusion_pytorch_model", ".safetensors"),
        ("model", ".safetensors"),
        ("diffusion_pytorch_model", ".bin"),
        ("pytorch_model", ".bin"),
    ]
    tried = []
    for var in variants:
        for stem, ext in bases:
            name = f"{stem}.{var}{ext}" if var else f"{stem}{ext}"
            path = os.path.join(d, name)
            tried += [name, name + ".index.json"]
            if os.path.exists(path):
                return _load_weight_file(path)
            if os.path.exists(path + ".index.json"):
                return _load_sharded(d, path + ".index.json")
    raise FileNotFoundError(f"No weight file found under {d} (tried {tried})")


def load_config(model_dir: str, subfolder: Optional[str] = None) -> dict:
    d = os.path.join(model_dir, subfolder) if subfolder else model_dir
    for name in ("config.json", "scheduler_config.json"):
        path = os.path.join(d, name)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    raise FileNotFoundError(f"No config json under {d}")


# ---------------------------------------------------------------------------
# IC-Light checkpoint transforms
# ---------------------------------------------------------------------------


def expand_conv_in(state_dict: Mapping[str, torch.Tensor], new_in_channels: int) -> StateDict:
    """conv_in's input channels zero-padded to ``new_in_channels`` (4 -> 12
    for the relight UNet: latent, fg and bg latents)."""
    sd = dict(state_dict)
    w = sd["conv_in.weight"]  # [O, I, kh, kw]
    if w.shape[1] < new_in_channels:
        pad = w.new_zeros((w.shape[0], new_in_channels - w.shape[1]) + tuple(w.shape[2:]))
        sd["conv_in.weight"] = torch.cat([w, pad], dim=1)
    return sd


def merge_offset(state_dict: Mapping[str, torch.Tensor], offset: Mapping[str, Any]) -> StateDict:
    """IC-Light's additive offset merge: merged[k] = origin[k] + offset[k]."""
    sd = dict(state_dict)
    for k, v in offset.items():
        sd[k] = sd[k] + torch.as_tensor(v).to(sd[k])
    return sd
