"""Diffusion fine-tuning step for the RollingDepth UNet.

Counterpart of ``rollingdepth_tpu/training.py``: on (rgb latent, depth
latent) snippet pairs the UNet learns the epsilon or v prediction of the
noised depth latent, conditioned on the rgb latent, with cross-frame
snippet attention active.  Self-attention on the card runs forward through
the flash kernels and backward through a blocked plain recompute
(``ops/flash_attention.py`` ``FlashAttention``).

The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` on every
parameter, as ``torch.optim.AdamW`` behind optax's clipping rule
(``clip_by_global_norm_``); update k takes the learning rate
``schedule(k)``, k counted from 0.  Checkpoints are ``torch.save`` files
written atomically; the JAX package uses orbax.

With a (dp, tp) ``mesh`` (the JAX step under ``with mesh:``) the UNet is a
tp shard (``parallel.shard_unet_``) and each dp rank takes its block of
the batch, timesteps and noise; gradients and the loss are averaged over
dp, and the global norm adds the tp shards' squares across tp, counting
every replicated parameter once.  AdamW is elementwise, so each shard's
update is the unsharded one's.  Checkpoints gather the shards: rank 0
writes one unsharded file, which ``restore_train_state`` shards again.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .parallel.mesh import axis
from .parallel.sharding import shard_rows, shard_tensor, unet_param_sharding, unshard_tensor
from .schedulers.ddim import DDIMScheduler

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-5
    weight_decay: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0
    prediction_type: str = "epsilon"  # epsilon | v_prediction
    # LR schedule: "constant" | "cosine" (linear warmup, cosine decay to 0)
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 10_000  # cosine horizon


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule(init, end, steps)`` at ``count``."""
    if steps <= 0:
        return init
    count = min(max(count, 0), steps)
    return (init - end) * (1 - count / steps) + end


def make_lr_schedule(cfg: TrainConfig) -> Schedule:
    """The learning rate of update ``k``: constant, a linear warm-up from 0
    (``optax.linear_schedule``), or a warm-up then a cosine decay to 0 at
    ``total_steps`` (``optax.warmup_cosine_decay_schedule``, warm-up at
    least one step)."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant" and cfg.warmup_steps == 0:
        return lambda step: lr
    if cfg.lr_schedule == "constant":
        return lambda step: _linear(0.0, lr, cfg.warmup_steps, step)
    if cfg.lr_schedule == "cosine":
        warmup = max(cfg.warmup_steps, 1)
        decay = cfg.total_steps - warmup
        if decay <= 0:
            raise ValueError(f"cosine schedule needs total_steps > warmup steps, got {cfg.total_steps} <= {warmup}")

        def schedule(step: int) -> float:
            if step < warmup:
                return _linear(0.0, lr, warmup, step)
            count = min(step - warmup, decay)
            return lr * 0.5 * (1 + math.cos(math.pi * count / decay))

        return schedule
    raise ValueError(f"lr_schedule {cfg.lr_schedule!r}")


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.AdamW:
    """optax's ``adamw`` (eps 1e-8, decoupled weight decay on every
    parameter); the train step sets each update's learning rate."""
    return torch.optim.AdamW(params, lr=make_lr_schedule(cfg)(0), betas=(cfg.b1, cfg.b2), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def optimizer_step(optimizer: torch.optim.Optimizer) -> int:
    """The updates taken so far: AdamW's per-parameter ``step`` (optax's
    ``count``), 0 before the first."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float, tp_sharded: Optional[List[bool]] = None,
                         tp_group=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient times
    ``max_norm / norm`` when the global norm exceeds ``max_norm``, else
    untouched (no epsilon, unlike ``clip_grad_norm_``).  Returns the
    unclipped global norm, without waiting for the device.  With
    ``tp_group``, the squares of the gradients flagged in ``tp_sharded``
    are summed over the group's shards; the others, the same on every
    rank, count once."""
    if tp_group is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        flags = torch.tensor(tp_sharded, device=sq.device)
        shard_sq = torch.where(flags, sq, 0.0).sum()
        dist.all_reduce(shard_sq, group=tp_group)
        norm = torch.sqrt(torch.where(flags, 0.0, sq).sum() + shard_sq)
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
    return norm


def training_loss(unet: torch.nn.Module, scheduler: DDIMScheduler, prediction_type: str,
                  batch: Dict[str, torch.Tensor], timesteps: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``loss_fn``: the depth latent noised to
    ``timesteps`` (one per snippet, every frame alike), concatenated after
    the rgb latent, through the UNet; the mean squared error of the
    prediction (fp32) against ``noise`` (epsilon) or the velocity."""
    rgb, depth = batch["rgb_latent"], batch["depth_latent"]
    b, n = depth.shape[:2]
    t_frames = timesteps[:, None].expand(b, n)
    depth32 = depth.float()
    noisy = scheduler.add_noise(depth32, noise, t_frames).to(rgb.dtype)
    pred = unet(torch.cat([rgb, noisy], dim=-1), timesteps, batch["text_embed"])
    if prediction_type == "epsilon":
        target = noise.float()
    elif prediction_type == "v_prediction":
        target = scheduler.get_velocity(depth32, noise, t_frames)
    else:
        raise ValueError(prediction_type)
    return torch.mean((pred.float() - target) ** 2)


def all_reduce_mean_(tensors: List[torch.Tensor], group, size: int) -> None:
    """Each tensor replaced by its mean over ``group`` (of ``size`` ranks),
    one all-reduce a tensor."""
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(size)


def apply_gradients(optimizer: torch.optim.Optimizer, params: List[torch.nn.Parameter], cfg: TrainConfig,
                    schedule: Schedule, tp_sharded: Optional[List[bool]] = None,
                    tp_group=None) -> Tuple[torch.Tensor, float]:
    """One update of optax's ``chain(clip_by_global_norm, adamw)`` from the
    parameters' ``.grad`` (a missing one counts as zero, as optax updates
    every parameter), at the learning rate ``schedule(k)`` of update k.
    Returns the unclipped global gradient norm and the learning rate.
    ``tp_sharded``/``tp_group``: see ``clip_by_global_norm_``."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = clip_by_global_norm_([p.grad for p in params], cfg.grad_clip, tp_sharded, tp_group)
    lr = schedule(optimizer_step(optimizer))
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return grad_norm, lr


def make_train_step(unet: torch.nn.Module, scheduler: DDIMScheduler, cfg: TrainConfig, mesh=None):
    """Returns ``train_step(batch, generator=None, *, timesteps=None,
    noise=None) -> metrics``, which takes one optimizer update of ``unet``.

    ``batch``: ``{"rgb_latent": [B, n, h, w, 4], "depth_latent": [B, n, h,
    w, 4], "text_embed": [1, L, D]}`` on the UNet's device.  ``timesteps``
    ([B], drawn uniformly from [0, num_train_timesteps)) and ``noise`` (fp32,
    the depth latent's shape, standard normal) are drawn from ``generator``
    (on the batch's device) unless passed.  Metrics: ``loss`` and
    ``grad_norm`` (the unclipped global norm) as 0-d device tensors, ``lr``,
    and on the card ``cuda_events`` (see ``step_seconds``).  The optimizer
    (``make_optimizer``) is ``train_step.optimizer``: restore a checkpoint
    or optax's state (``io.weights.adamw_state_from_jax``) into it.

    With a (dp, tp) ``mesh`` every rank passes the whole batch (and draws
    the whole batch's timesteps and noise from the same generator state),
    takes its dp block of it (the batch must split evenly over dp), and
    returns the metrics of the whole batch: the loss is the mean of the dp
    ranks' means."""
    if cfg.prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(cfg.prediction_type)
    dp, _, dp_group = axis(mesh, "dp")
    tp, _, tp_group = axis(mesh, "tp")
    split = unet_param_sharding(unet, mesh)
    tp_sharded = [split[n] is not None for n, _ in unet.named_parameters()] if tp > 1 else None
    params = list(unet.parameters())
    opt = make_optimizer(params, cfg)
    schedule = make_lr_schedule(cfg)
    num_train_timesteps = scheduler.config.num_train_timesteps

    def train_step(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, *,
                   timesteps: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None) -> dict:
        depth = batch["depth_latent"]
        if timesteps is None:
            timesteps = torch.randint(0, num_train_timesteps, depth.shape[:1], generator=generator,
                                      device=depth.device)
        if noise is None:
            noise = torch.randn(depth.shape, generator=generator, device=depth.device, dtype=torch.float32)
        if dp > 1:
            if depth.shape[0] % dp:
                raise ValueError(f"a batch of {depth.shape[0]} does not split over dp = {dp}")
            batch = {k: (v if k == "text_embed" else shard_rows(v, mesh)) for k, v in batch.items()}
            timesteps, noise = shard_rows(timesteps, mesh), shard_rows(noise, mesh)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if depth.is_cuda else []
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        opt.zero_grad(set_to_none=True)
        loss = training_loss(unet, scheduler, cfg.prediction_type, batch, timesteps, noise)
        mark(1)
        loss.backward()
        mark(2)
        if dp > 1:
            # the mean of the dp ranks' means and of their gradients
            loss = loss.detach()
            all_reduce_mean_([loss] + [p.grad for p in params if p.grad is not None], dp_group, dp)
        grad_norm, lr = apply_gradients(opt, params, cfg, schedule, tp_sharded, tp_group)
        mark(3)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "lr": lr, "cuda_events": events}

    train_step.optimizer = opt
    return train_step


def step_seconds(metrics: dict) -> Dict[str, float]:
    """Forward, backward and optimizer seconds of a step on the card, from
    its CUDA events; waits for the step to finish."""
    events = metrics["cuda_events"]
    events[-1].synchronize()
    return {name: a.elapsed_time(b) / 1e3 for name, a, b in zip(("forward", "backward", "optimizer"), events,
                                                                   events[1:])}


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _convert_tp_state(model: dict, opt: dict, unet: torch.nn.Module, mesh, convert) -> Tuple[dict, dict]:
    """State dicts of ``unet`` and its optimizer with every tp-split tensor
    (a parameter, its ``exp_avg`` and ``exp_avg_sq``) passed through
    ``convert(name, tensor, dim)``, in the same order on every rank."""
    split = unet_param_sharding(unet, mesh)
    names = [n for n, _ in unet.named_parameters()]

    def conv(name, t):
        dim = split.get(name)
        return convert(name, t, dim) if dim is not None and torch.is_tensor(t) and t.ndim else t

    model = {k: conv(k, v) for k, v in model.items()}
    state = {i: {k: conv(names[i], v) for k, v in st.items()} for i, st in opt["state"].items()}
    return model, dict(opt, state=state)


def save_train_state(path: str, unet: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh=None) -> None:
    """Write the model's and optimizer's state dicts and the step to
    ``path``: ``torch.save`` into a temporary file beside it, flushed to
    disk, then ``os.replace``, so ``path`` never holds a partial file.
    With a ``mesh`` every rank calls it: the tp shards are gathered and
    rank 0 writes one unsharded file."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    tp, _, tp_group = axis(mesh, "tp")
    model, opt = unet.state_dict(), optimizer.state_dict()
    if tp > 1:
        model, opt = _convert_tp_state(model, opt, unet, mesh,
                                       lambda name, t, dim: unshard_tensor(name, t, dim, tp_group, tp))
    if mesh is not None and dist.get_rank() != 0:
        dist.barrier()
        return
    state = {"model": model, "optimizer": opt, "step": optimizer_step(optimizer)}
    try:
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
        if mesh is not None:
            dist.barrier()


def restore_train_state(path: str, unet: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh=None) -> int:
    """Load a ``save_train_state`` checkpoint (always unsharded) into
    ``unet`` and ``optimizer`` (built as the saved ones were, on the same
    mesh); returns the step.  With a tp ``mesh`` each rank keeps its shard."""
    state = torch.load(path, map_location=next(unet.parameters()).device, weights_only=True)
    model, opt = state["model"], state["optimizer"]
    tp, rank, _ = axis(mesh, "tp")
    if tp > 1:
        model, opt = _convert_tp_state(model, opt, unet, mesh,
                                       lambda name, t, dim: shard_tensor(name, t, dim, rank, tp))
    unet.load_state_dict(model)
    optimizer.load_state_dict(opt)
    return int(state["step"])
