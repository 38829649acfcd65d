"""Clip round-robin across processes, executed: 2 workers over 5 clips.

Counterpart of ``scripts/multihost_demo.py``.  Clips are independent, so
the port splits WORK, whole clips, across processes with no collective:
each worker joins the process group (``parallel/launch.py``, gloo), takes
its round-robin slice of the clip list (``parallel.multihost.shard_work``)
and runs its own pipeline on it.  The launcher then checks:
- the workers' clip sets are disjoint and together cover every clip;
- every output is finite and of the clip's shape;
- every output equals a single-process run of its clip, bit for bit
  (one process, no group, the same one CPU thread a worker has).
Prints one JSON line ``{"ok": true, ...}`` on success.

    python -m rollingdepth_torch.tools.multihost_demo [OUTDIR] [--device cuda|cpu]

The pipeline is the tiny one of the CPU tests with weights from a seed.  It
runs on the card unless ``--device cpu`` is given (``utils/device.py``: no
card raises); on one card both workers share it over gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

N_CLIPS = 5
N_FRAMES = 8
H, W = 32, 48
N_WORKERS = 2


def build_pipeline(device):
    from ..models.layers import init_random_
    from ..models.unet import UNet2DConditionModel, UNetConfig
    from ..models.vae import AutoencoderKL, VAEConfig
    from ..pipelines.rollingdepth import RollingDepthPipeline
    from ..schedulers.ddim import DDIMConfig, DDIMScheduler

    gen = torch.Generator().manual_seed(0)
    unet = init_random_(UNet2DConditionModel(UNetConfig.tiny(), device="cpu"), gen)
    vae = init_random_(AutoencoderKL(VAEConfig.tiny(), device="cpu"), gen)
    sched = DDIMScheduler(DDIMConfig(beta_schedule="scaled_linear", timestep_spacing="trailing"))
    return RollingDepthPipeline(unet, vae, sched, torch.zeros(1, 2, 8), dtype=torch.float32, snippet_batch=2,
                                device=device)


def clip(i: int) -> np.ndarray:
    return (np.random.RandomState(100 + i).rand(N_FRAMES, 3, H, W) * 255).astype(np.uint8)


def run_clips(pipe, ids, outdir: str, tag: str) -> None:
    for i in ids:
        out = pipe.forward(clip(i), dilations=[1, 2], cap_dilation=True, refine_step=0, seed=0, max_vae_bs=4,
                           merge_in_latent=True, latent_coalign_kwargs={"num_iterations": 50})
        depth = out.depth_pred
        if not (np.isfinite(depth).all() and depth.shape == (N_FRAMES, 1, H, W)):
            raise AssertionError(f"clip {i}: depth {depth.shape} not finite or of the wrong shape")
        np.save(os.path.join(outdir, f"clip{i}_{tag}.npy"), depth)


def worker(rank: int, outdir: str, device: str) -> dict:
    from ..parallel.multihost import is_primary_host, process_count, shard_work

    mine = shard_work(list(range(N_CLIPS)))
    run_clips(build_pipeline(device), mine, outdir, f"worker{rank}")
    return {"rank": rank, "clips": mine, "processes": process_count(), "primary": is_primary_host()}


def launcher(outdir: str, device=None) -> dict:
    from ..parallel.launch import run_ranks
    from ..utils.device import resolve_device

    device = str(resolve_device(device))
    os.makedirs(outdir, exist_ok=True)
    manifests = run_ranks(worker, N_WORKERS, args=(outdir, device), device=device, threads=1, timeout=600)
    sets = [set(m["clips"]) for m in manifests]
    if set().union(*sets) != set(range(N_CLIPS)) or sum(len(s) for s in sets) != N_CLIPS:
        raise AssertionError(f"clip sets {sets} are not a partition of {N_CLIPS} clips")
    if [m["processes"] for m in manifests] != [N_WORKERS] * N_WORKERS or [m["primary"] for m in manifests] != [
            True] + [False] * (N_WORKERS - 1):
        raise AssertionError(f"manifests {manifests}")

    # every clip again in this process, alone, on one thread as a worker runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_clips(build_pipeline(device), range(N_CLIPS), outdir, "single")
    finally:
        torch.set_num_threads(threads)
    checked = []
    for m in manifests:
        for i in m["clips"]:
            multi = np.load(os.path.join(outdir, f"clip{i}_worker{m['rank']}.npy"))
            single = np.load(os.path.join(outdir, f"clip{i}_single.npy"))
            err = float(np.abs(multi - single).max())
            if err != 0.0:
                raise AssertionError(f"clip {i}: worker {m['rank']} differs from a single process by {err}")
            checked.append({"clip": i, "worker": m["rank"], "max_err_vs_single": err})
    result = {"ok": True, "n_processes": N_WORKERS, "clips_per_worker": [sorted(s) for s in sets],
              "numerics_check": checked}
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("outdir", nargs="?", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.outdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            launcher(tmp, args.device)
    else:
        launcher(args.outdir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
