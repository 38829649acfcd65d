"""Rank bodies for ``test_torch_parallel.py``: the port's sharded paths, run
in four gloo ranks on the CPU as a (dp, tp) = (2, 2) mesh.

Imports no JAX: the ranks load the weights and inputs the test process
made (numpy, ``state_dict_from_jax``), and the test holds what they return
to the JAX package.  The tiny relight stack is port-only (random weights
from seeds), built here for the ranks and for the test's unsharded run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from rollingdepth_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from rollingdepth_torch.models.layers import init_random_
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.models.vae import AutoencoderKL, VAEConfig
from rollingdepth_torch.parallel.mesh import axis, make_mesh
from rollingdepth_torch.parallel.multihost import is_primary_host, shard_work
from rollingdepth_torch.parallel.sharding import copy_to_tp, reduce_from_tp, shard_unet_, unet_param_sharding
from rollingdepth_torch.pipelines.rollingdepth import RollingDepthPipeline
from rollingdepth_torch.pipelines.rollingimg import RollingImgPipeline
from rollingdepth_torch.schedulers.ddim import DDIMConfig, DDIMScheduler
from rollingdepth_torch.schedulers.dpmsolver import DPMSolverConfig, DPMSolverMultistepScheduler
from rollingdepth_torch.training import TrainConfig, make_train_step, restore_train_state, save_train_state

DEPTH_SCHED = dict(beta_schedule="scaled_linear", timestep_spacing="trailing", prediction_type="v_prediction",
                   steps_offset=1)
TRAIN_SCHED = dict(beta_schedule="scaled_linear", prediction_type="v_prediction", timestep_spacing="trailing")
TRAIN_CFG = TrainConfig(learning_rate=1e-3)
# the UNet of tests/test_parallel.py's tp test (4 heads at both levels) and train test
TP_UNET = dict(sample_size=8, in_channels=8, out_channels=4, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), block_out_channels=(32, 64), layers_per_block=1,
               cross_attention_dim=32, attention_head_dim=4, norm_num_groups=4)
TRAIN_UNET = dict(TP_UNET, block_out_channels=(16, 32), cross_attention_dim=16)

# the pipeline calls; 9 frames at dilations [1, 2, 3] make 15 windows, an odd count over dp = 2
WINDOWS = dict(dilations=[1, 2, 3], cap_dilation=False, refine_start_dilation=3)
ONE_ITER = dict(coalign_kwargs={"num_iterations": 1}, latent_coalign_kwargs={"num_iterations": 1})
DEPTH_CALLS = {  # name: call arguments (with init_noise)
    "fast_1": dict(WINDOWS, merge_in_latent=True, **ONE_ITER),
    "fast_full": dict(WINDOWS, merge_in_latent=True),
    "exact_1": dict(WINDOWS, merge_in_latent=False, **ONE_ITER),
    "refine_1": dict(WINDOWS, merge_in_latent=True, refine_step=2, turbo_refine=False, **ONE_ITER),
    "refine_full": dict(WINDOWS, merge_in_latent=True, refine_step=2, turbo_refine=False),
}
RELIGHT_CALL = dict(dilations=[1, 2, 3], cap_dilation=False, coalign_kwargs={"num_iterations": 0}, seed=5,
                    num_inference_steps=4)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor",
               "broadcast", "all_to_all", "all_to_all_single")


def depth_pipeline(sd: Dict, mesh=None) -> RollingDepthPipeline:
    """The tiny pipeline of ``test_torch_pipeline.py`` from its state dicts,
    the UNet sharded over the mesh's tp."""
    unet = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    unet.load_state_dict(sd["unet"])
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    vae.load_state_dict(sd["vae"])
    return RollingDepthPipeline(shard_unet_(unet, mesh), vae, DDIMScheduler(DDIMConfig(**DEPTH_SCHED)),
                                torch.from_numpy(sd["text"]), dtype=torch.float32, snippet_batch=4, device="cpu",
                                mesh=mesh)


def run_depth(pipe: RollingDepthPipeline, frames, noise) -> Dict:
    out = {}
    for name, kw in DEPTH_CALLS.items():
        o = pipe.forward(frames, init_noise=noise, **kw)
        out[name] = {"depth": o.depth_pred, "windows": torch.cat(pipe.last_window_latents).numpy(),
                     "snippet_ls": [np.asarray(g) for g in o.snippet_ls], "chunks": dict(pipe.last_chunks)}
    return out


class FakeTokenizer:
    """Short chunks (7 tokens), as ``test_torch_relight.py``'s."""

    model_max_length = 7
    bos_token_id = 0
    eos_token_id = 1

    def tokenize_ids(self, text):
        return [2 + (ord(c) % 5) for c in text.replace(" ", "")][:20]


def relight_pipeline(mesh=None) -> RollingImgPipeline:
    """A tiny SD1.5-style relight stack with seeded random weights."""
    gen = torch.Generator().manual_seed(7)
    sd15 = dict(cross_attention_dim=16, use_linear_projection=False, attention_head_dim=2)
    unet = init_random_(UNet2DConditionModel(dataclasses.replace(UNetConfig.tiny(12), **sd15), device="cpu"), gen)
    base = init_random_(UNet2DConditionModel(dataclasses.replace(UNetConfig.tiny(4), **sd15), device="cpu"), gen)
    vae = init_random_(AutoencoderKL(VAEConfig.tiny(), device="cpu"), gen)
    clip = init_random_(CLIPTextModel(CLIPTextConfig.tiny(), device="cpu"), gen).eval()
    sched = DPMSolverMultistepScheduler(DPMSolverConfig(algorithm_type="sde-dpmsolver++", use_karras_sigmas=True,
                                                        steps_offset=1))
    return RollingImgPipeline(shard_unet_(unet, mesh), vae, sched, FakeTokenizer(), lambda ids: clip(ids),
                              base_unet=shard_unet_(base, mesh), dtype=torch.float32, snippet_batch=2, device="cpu",
                              mesh=mesh)


def relight_frames():
    """fg and bg: 7 frames of 16x16 (9 windows at dilations [1, 2, 3])."""
    rs = np.random.RandomState(0)
    return tuple(rs.rand(7, 3, 16, 16).astype(np.float32) * 2 - 1 for _ in range(2))


def run_relight(pipe: RollingImgPipeline) -> Dict:
    o = pipe.forward(*relight_frames(), **RELIGHT_CALL)
    return {"rgb": np.concatenate([o.R_pred, o.G_pred, o.B_pred], axis=1), "snippet_ls": o.snippet_ls,
            "chunks": dict(pipe.last_chunks)}


class CollectiveSpy:
    """Counts the calls of ``torch.distributed``'s collectives while active."""

    def __init__(self):
        self.counts = {name: 0 for name in COLLECTIVES}

    def __enter__(self):
        self._orig = {name: getattr(dist, name) for name in COLLECTIVES}
        for name, fn in self._orig.items():
            def spy(*a, _name=name, _fn=fn, **k):
                self.counts[_name] += 1
                return _fn(*a, **k)

            setattr(dist, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(dist, name, fn)


def _megatron_mlp(inp: Dict, mesh, g_op) -> Dict:
    """The column- then row-parallel MLP of ``inp`` as this tp rank's shard,
    through f and ``g_op``; returns the output and every gradient."""
    tp, r, group = axis(mesh, "tp")
    x = torch.from_numpy(inp["x"]).requires_grad_()
    w1 = torch.from_numpy(inp["w1"]).chunk(tp, 0)[r].clone().requires_grad_()
    b1 = torch.from_numpy(inp["b1"]).chunk(tp, 0)[r].clone().requires_grad_()
    w2 = torch.from_numpy(inp["w2"]).chunk(tp, 1)[r].clone().requires_grad_()
    b2 = torch.from_numpy(inp["b2"]).clone().requires_grad_()
    h = F.gelu(F.linear(copy_to_tp(x, group), w1, b1))
    y = g_op(F.linear(h, w2), group) + b2
    (y * torch.from_numpy(inp["gy"])).sum().backward()
    return {"y": y.detach().numpy(), "x": x.grad.numpy(), "w1": w1.grad.numpy(), "b1": b1.grad.numpy(),
            "w2": w2.grad.numpy(), "b2": b2.grad.numpy()}


def _library_all_reduce(x, group):
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def _collectives(inp: Dict, mesh) -> Dict:
    """Collective calls inside UNet calls: at tp = 1 on a (4, 1) mesh (the
    pipeline's dp denoise and a bare UNet call), at tp = 2 on the (2, 2) mesh
    (no grad, and forward plus backward)."""
    out = {}
    mesh41 = make_mesh((4, 1), "cpu")
    pipe = depth_pipeline(inp["pipe"], mesh41)
    inside = CollectiveSpy()
    unet_forward = pipe.unet.forward

    def counted(*a, **k):
        with inside:
            return unet_forward(*a, **k)

    pipe.unet.forward = counted
    with CollectiveSpy() as whole:
        pipe.forward(inp["frames"], init_noise=inp["noise"], **DEPTH_CALLS["fast_1"])
    out["tp1_pipeline"] = {"inside_unet": dict(inside.counts), "whole_call": dict(whole.counts),
                           "unet_calls": pipe.last_chunks["unet"]}
    x = torch.from_numpy(inp["unet_x"])
    ctx = torch.from_numpy(inp["unet_text"])
    unet = UNet2DConditionModel(UNetConfig(**TP_UNET), device="cpu")
    unet.load_state_dict(inp["unet_sd"])
    with CollectiveSpy() as spy, torch.no_grad():
        shard_unet_(unet, mesh41)(x, 500, ctx)
    out["tp1_unet"] = dict(spy.counts)

    shard_unet_(unet, mesh)
    with CollectiveSpy() as spy, torch.no_grad():
        unet(x, 500, ctx)
    out["tp2_no_grad"] = dict(spy.counts)
    with CollectiveSpy() as spy:
        unet(x, 500, ctx).square().mean().backward()
    out["tp2_grad"] = dict(spy.counts)
    out["sharded_blocks"] = sum(1 for m in unet.modules() if getattr(m, "tp_group", None) is not None
                                and type(m).__name__ == "Attention") // 2
    out["transformer_blocks"] = sum(1 for m in unet.modules() if type(m).__name__ == "BasicTransformerBlock")
    return out


def _train(inp: Dict, mesh, ckpt: str) -> Dict:
    """One dp+tp step from JAX's init with JAX's draws, the checkpoint
    written unsharded; then a fresh model restored from it and a second step
    on both, which must agree bit for bit."""
    unet = UNet2DConditionModel(UNetConfig(**TRAIN_UNET), device="cpu")
    unet.load_state_dict(inp["sd"])
    shard_unet_(unet, mesh)
    sched = DDIMScheduler(DDIMConfig(**TRAIN_SCHED))
    step = make_train_step(unet, sched, TRAIN_CFG, mesh=mesh)
    to_t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    m = step(to_t(inp["batch"]), timesteps=torch.from_numpy(inp["t"]), noise=torch.from_numpy(inp["noise"]))
    out = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lr": m["lr"]}
    save_train_state(ckpt, unet, step.optimizer, mesh)

    fresh = init_random_(UNet2DConditionModel(UNetConfig(**TRAIN_UNET), device="cpu"), torch.Generator().manual_seed(1))
    shard_unet_(fresh, mesh)
    step_b = make_train_step(fresh, sched, TRAIN_CFG, mesh=mesh)
    out["restored_step"] = restore_train_state(ckpt, fresh, step_b.optimizer, mesh)
    kw = dict(timesteps=torch.from_numpy(inp["t2"]), noise=torch.from_numpy(inp["noise2"]))
    m_a = step(to_t(inp["batch2"]), **kw)
    m_b = step_b(to_t(inp["batch2"]), **kw)
    out["second_step_equal"] = bool(torch.equal(m_a["loss"], m_b["loss"]) and torch.equal(m_a["grad_norm"],
                                                                                        m_b["grad_norm"]))
    out["second_step_params_max_diff"] = max((a - b).abs().max().item()
                                             for a, b in zip(unet.parameters(), fresh.parameters()))
    out["local_numel"] = sum(p.numel() for p in unet.parameters())
    return out


def w8a8_unet(inp: Dict, mesh=None) -> Dict:
    """The TP_UNET quantized to W8A8 (``quantize_unet_``, then
    ``shard_unet_``), one call per dp block of ``unet_x``'s two windows
    (this dp rank's; both, one after the other, without a mesh); and, as a
    planted fault, with each row-parallel shard's activation scale taken
    from its own shard (no abs-max all-reduce)."""
    from rollingdepth_torch.ops import quant

    dp, r, _ = axis(mesh, "dp")
    unet = UNet2DConditionModel(UNetConfig(**TP_UNET), device="cpu")
    unet.load_state_dict(inp["unet_sd"])
    shard_unet_(quant.quantize_unet_(unet), mesh)
    blocks = torch.from_numpy(inp["unet_x"]).chunk(2)
    blocks = blocks if mesh is None else blocks[r : r + 1]
    ctx = torch.from_numpy(inp["unet_text"])
    with torch.no_grad():
        out = {"w8a8": np.concatenate([unet(x, 500, ctx).numpy() for x in blocks])}
        if mesh is not None:
            orig = quant.quantize_activation
            quant.quantize_activation = lambda t, group=None: orig(t)
            try:
                out["local_absmax"] = unet(blocks[0], 500, ctx).numpy()
            finally:
                quant.quantize_activation = orig
    return out


def rank_main(rank: int, inputs_path: str, ckpt: str) -> Dict:
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh((2, 2), "cpu")
    res: Dict = {"rank": rank, "dp": axis(mesh, "dp")[:2], "tp": axis(mesh, "tp")[:2],
                 "shard_work": shard_work(list(range(7))), "primary": is_primary_host()}
    res["mlp"] = _megatron_mlp(inp["mlp"], mesh, reduce_from_tp)
    res["mlp_library_g"] = _megatron_mlp(inp["mlp"], mesh, _library_all_reduce)

    unet = UNet2DConditionModel(UNetConfig(**TP_UNET), device="cpu")
    unet.load_state_dict(inp["unet_sd"])
    before = unet_param_sharding(unet, mesh)
    shard_unet_(unet, mesh)
    with torch.no_grad():
        res["unet_tp2"] = unet(torch.from_numpy(inp["unet_x"]), 500, torch.from_numpy(inp["unet_text"])).numpy()
    res["split_before_after"] = (before, unet_param_sharding(unet, mesh))

    res["w8a8"] = w8a8_unet(inp, mesh)
    res["collectives"] = _collectives(inp, mesh)
    res["depth"] = run_depth(depth_pipeline(inp["pipe"], mesh), inp["frames"], inp["noise"])
    res["relight"] = run_relight(relight_pipeline(mesh))
    res["train"] = _train(inp["train"], mesh, ckpt)
    return res


def failing_rank(rank: int) -> None:
    """Rank 1 raises; the others wait in a collective it never joins."""
    if rank == 1:
        raise ValueError("planted failure of rank 1")
    dist.barrier()


def hanging_rank(rank: int) -> None:
    import time

    time.sleep(120)


def cli_rank(rank: int, argv, out_root: str) -> Dict:
    """``python -m rollingdepth_torch.cli`` as one rank of the group (its
    clips into ``out_root/rank<r>``), after the host-local mesh of a world
    of one-rank hosts."""
    import os

    from rollingdepth_torch import cli
    from rollingdepth_torch.parallel.multihost import local_mesh

    os.environ["LOCAL_WORLD_SIZE"] = "1"
    mesh = local_mesh(device_type="cpu")
    res = {"local_mesh": (mesh.mesh_dim_names, tuple(mesh.mesh.shape)), "world": dist.get_world_size()}
    cli.main(list(argv) + ["-o", os.path.join(out_root, f"rank{rank}")])
    return res


# a UNet whose self-attention takes K1 on the card: d = 64 at both levels, 768 tokens at level 0
CUDA_UNET = dict(TP_UNET, block_out_channels=(128, 256), attention_head_dim=(2, 4), cross_attention_dim=64)


def cuda_tp_rank(rank: int, dtype_name: str) -> Dict:
    """One rank of a (1, 2) mesh on the card: the UNet of ``CUDA_UNET``
    whole and as its tp shard, with the kernels' launches of each call."""
    from rollingdepth_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    mesh = make_mesh((1, 2), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    unet = init_random_(UNet2DConditionModel(UNetConfig(**CUDA_UNET), device="cuda"), gen).to(dtype)
    x = torch.randn((2, 3, 16, 16, 8), generator=gen, device="cuda").to(dtype)
    ctx = torch.randn((1, 4, 64), generator=gen, device="cuda").to(dtype)
    out = {"backend": dist.get_backend(), "device": torch.cuda.current_device()}
    with torch.no_grad():
        fa.reset_launch_counts()
        out["whole"] = unet(x, 500, ctx).float().cpu()
        out["whole_launches"] = {fn.__name__: fn.launches for fn in fa.KERNELS}
        shard_unet_(unet, mesh)
        fa.reset_launch_counts()
        out["shard"] = unet(x, 500, ctx).float().cpu()
        out["shard_launches"] = {fn.__name__: fn.launches for fn in fa.KERNELS}
    return out
