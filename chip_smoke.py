#!/usr/bin/env python3
"""Drive the PyTorch port of RollingDepth on one CUDA card and check it.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a by nvcc at
first use, into rollingdepth_torch/build/).  Imports nothing of JAX.
Phases, each of which must pass or the script exits non-zero:

1. build   the CUDA kernels of the path (one nvcc per source, in parallel);
2. kernels each kernel against its plain PyTorch version at the main
           path's shapes (bf16 and, for K1 and K3, fp32), at ragged shapes (bf16
           and fp32), with its time,
           the plain version's time, one SDPA call's time as a yardstick
           (the port never calls SDPA) and the card's data-sheet bound;
   conv    the 3x3 conv op (K4, K5; on no model path): both wrappers at the
           VAE decoder's widths (bf16), two ragged bf16 cases and a ragged
           fp32 case with the launch counts from 0, then each against its
           plain version (in bf16 also the mean bound, against the plain
           version without one (tap, 64-channel chunk)), with its time, the
           plain time, one cuDNN ``F.conv2d`` call's time as a yardstick,
           the bound and the bytes its tiles load through L2;
   variants the flash-attention sweep (K6-K10; on no model path):
           ``tools/bench_flash_variants.sweep`` at [2|8, 15552, 5, 64] bf16
           with the launch counts from 0, then each variant against its
           plain version at [8, 15552, 5, 64] and a ragged [2, 3001, 5, 64]
           with L_k 2,999, with times as for the kernels;
3. main    the fast preset (dilations [1, 25], one DDIM step, latent-space
           merge, bf16, snippet_batch 8, max_vae_bs 4) on a synthetic
           60-frame 432x768 clip at full SD2 width with seeded random
           weights: a warm-up call, then a timed call whose kernel launch
           counts must equal what the chunking implies;
   w8a8    the W8A8 serving mode (``ops/quant.py``): (a) the int8 GEMM
           (``torch._int_mm``) and the im2col int8 conv at an SD2 shape
           each, bit for bit against the exact product of the same int8
           operands on the CPU; (b) the same fast call with the UNet
           quantized: one UNet chunk within JAX's quantized-UNet bounds of
           the bf16 UNet (correlation > 0.99, rms < 0.1 of the spread), the
           K1/K3 launches equal to the bf16 call's, the depth finite and
           within JAX's pipeline bound of the bf16 call's (correlation >
           0.95), its time and fps beside the bf16 call's; (c) ``tools/bench_int8.py``'s slim
           set (bf16 against int8, with bounds);
4. gate    the same pipeline on a 12-frame clip with the max-free gate
           closed, so that narrow heads take the running-max kernel;
5. full    the full preset (res 1024, dilations [1, 10, 25], latent merge,
           10 refine steps over partition windows, bf16) on a synthetic
           60-frame 576x1024 clip: a short warm-up, then a timed call;
6. check   kernels against the plain attention path: one UNet chunk and
           one VAE decode chunk at the main path's shapes (bf16), and the
           depth of a 12-frame clip through the whole path in fp32 (the
           fp32 kernels) with the co-alignment solves cut to 0 steps: the
           fast preset, then two refine steps over partition windows after
           the latent merge and over stride-1 windows after the depth-space
           merge; the bf16 whole-path drift after the full solve is logged;
7. paper   the paper preset (fp32, uncapped dilations [1, 10, 25], the
           depth-space merge of every decoded window, 10 refine steps over
           stride-1 windows) on 51 frames, the fewest on which dilation 25
           has a window, at the preset's 432x768;
8. relight the IC-Light relight path (``pipelines/rollingimg.py``) at full
           SD1.5 width with random weights, bf16, on a synthetic 24-frame
           720x640 fg/bg pair: t2i init, dilations [1, 25] (capped to
           [1, 7]), windows of 3, 20 DPM++ SDE steps, decode, the three
           per-channel solves; a 6-frame warm-up, then a timed call; then
           one 12-channel UNet chunk (bf16) and a 6-frame fp32 run with the
           solves cut to 0 steps against the plain attention path, and the
           RMBG matte on one chunk of 960x1088 feeds;
9. train   the training path (``training.py``, ``training_data.py``) at
           full SD2 width in fp32 with random weights: the snippet-latent
           dataset of 2 synthetic clips of 8 frames at 480x640 (windows of
           3, dilations 1 and 2, batches of 2 snippets; encoded by the VAE,
           K3 fp32), then 4 AdamW steps (cosine schedule, 2 warm-up steps)
           with self-attention forward on K1 fp32 and backward by the plain
           recompute; per step loss, grad_norm and the forward, backward and
           optimizer seconds; the state is saved with ``save_train_state``;
10. train_check one more step twice from that saved state with the same
           timesteps and noise, with the kernels and on the plain attention
           path: loss, grad_norm and the updated parameters against each
           other, and every parameter that the plain path gives a gradient
           gets a nonzero one through the kernels; then each
           ``FlashAttention``'s dq, dk, dv against autograd through
           ``plain_attention`` (K1 bf16 and fp32, K2 bf16, K3 fp32) with the
           times of both backwards.
11. parallel ranks of a (dp, tp) mesh on this one card over gloo
           (``parallel/``), each against one process: 4 ranks at (2, 2) run
           the fast preset on 12 frames at 432x768 in bf16 (windows within
           2e-2 of their scale) and in fp32 with the solves cut to 0 steps
           (windows 1e-4, depth 1e-3) with each rank's launches against its
           chunks at its local heads, then one fp32 train step at 256x320
           (loss rtol 1e-5, grad_norm rtol 1e-4, parameters within
           ``PAR_PARAMS_TOL``, which a skipped update on one shard exceeds);
           2 ranks at (2, 1) run the relight call on 6 frames (2e-2);
           first, the 4 ranks run one W8A8 UNet chunk (2 windows a dp rank),
           bit for bit against one process (the int32 sums are exact), and
           the same chunk with each row-parallel shard's activation scale
           from its own shard (no abs-max all-reduce), which must differ.
12. groupnorm the bf16 GroupNorm pair (``ops/group_norm.py``, XLA's
           reduction and loop fusion of the JAX norm and the silu after it,
           written by hand) at every input that the counted calls of
           ``main``, ``w8a8``, ``gate_closed``, ``full``, ``relight`` and the
           bf16 parallel ranks gave it (the wrapper records each
           ``(N, C, H, W, groups, eps, silu)`` it launches at, in
           ``group_norm.inputs``), and at ragged shapes (``NORM_RAGGED``):
           each through the public wrapper with the count from 0, against
           its plain version: the bf16 rule, the output bit for bit the
           plain version's pass on the pair's own statistics (so it differs
           from the plain version only in a group whose bf16 mean or inv
           rounds apart; those groups and the share of bit-equal elements
           are logged), the statistics within ``NORM_STATS_TOL`` of
           ``torch.var_mean``'s (the statistics without each image's last
           chunk must exceed it), two calls bit-equal;
           with its time, the plain time, one ``F.group_norm`` call's time
           and the bound; an NCHW x and an autograd-recording call must
           raise.
repeat  two runs of each serving path on the same frames, weights and seed
           must be bit-equal (``torch.equal``), each logged with its element
           count and differences: ``fast`` (the warm-up against the timed
           call in main), ``full`` (a second 12-frame call against its
           warm-up), ``paper`` (the depth-space solve and full-resolution
           merge twice on the paper call's decoded windows), relight's R, G
           and B (a second 6-frame call against its warm-up), and
           ``tools/multihost_demo.py`` on the card in a subprocess (each
           worker's clips against one process's, bit for bit).  With
           ``--measure-repeats`` a pair that differs is logged and the run
           goes on (to measure a tree whose runs differ, such as an older
           commit's package); the script then exits 1 before its ``kernels``
           line.
solve      each path's co-alignment solve is one launch of the solve kernel
           (``ops/coalign.py``): for ``fast`` (the latent solve of the timed
           call), ``paper`` (the depth-space solve, with the inverse term)
           and relight's R channel (one of its call's three channel solves),
           the solve again from the call's recorded inputs through the
           kernel, twice (bit for bit), and as the same step run eagerly
           on the card and on the CPU; against the CPU's run the merged
           output within 2e-2 of its largest value at the call's 2000
           steps, and scales, shifts, history and merged output within
           rtol/atol 1e-5 at 10 steps (each, where the card's eager run
           parts from the CPU's by more, within twice that parting);
           logged with the kernel's device time (CUDA events), the eager
           solves' seconds, the bytes bound (the views read once a step at
           3.35 TB/s) and the launches counted (one a solve); then one
           ``fast`` call under ``torch.profiler``, whose phases' device idle
           shares (``coalign`` among them) come from
           ``tools/profile_fast_path.device_shares``.
In main, full, paper, relight and train the kernel launch counts must
equal what the chunk and step counts imply (``attention_kernel_launches``,
``relight_kernel_launches``, ``train_kernel_launches``), and K1's and
K2's cut launches (products narrower than the padding, ``cut_launches``)
must be every narrow launch of relight (``relight_cut_launches``: SD1.5's
d = 40 and 80) and none of main and full (SD2's d = 64); in every bf16 call
(main, w8a8, gate_closed, full, relight, the parallel ranks) the GroupNorm
pair's launches must equal ``norm_kernel_launches`` (so the plain norm ran
0 times: on the card the wrapper launches or raises), in fp32 (paper,
train, the fp32 ranks) the pair none; the depth must be
finite, of the clip's shape and within [-1, 1], and R/G/B within [0, 1].  The card's
machine has no video decoder, so no phase reads a video: frames are made
on the card.

Prints the card's name and power limit, a JSON line per measurement, a
``{"kernels": [...]}`` line (a row per kernel for each of the TPU kernels
K1-K10; K9 has two, one per instantiation; K1 and K3 have a second row for
their fp32 instantiation, the paper path's; then the GroupNorm pair, with
``"tpu_kernel": null``, timed at the main path's input that moves the most
bytes over the call, with its launches by path, the main path's sums over
all its inputs and each of its inputs), and as its last line
``{"ok": true, "device": {...}}``.  The kernels phase also times K1, K2
and K3 at the relight path's shapes (``relight_shapes`` in their rows), and
K1 bf16 and fp32 at the parallel phase's tp = 2 shapes (``tp_shapes``).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from rollingdepth_torch.tools.bench_flash_variants import cuda_ms

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, data sheet (SXM, 700 W)
H100_TF32_FLOPS = 495e12  # dense tensor-core peak, tf32
H100_FP32_FLOPS = 67e12  # outside the tensor cores
TF32_TERMS = 3  # the fp32 attention kernels take each product as three tf32 products
H100_BYTES_PER_S = 3.35e12


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


@contextlib.contextmanager
def plain_attention():
    """Every attention call on the plain PyTorch path (no kernel)."""
    os.environ["ROLLINGDEPTH_ATTN"] = "xla"
    try:
        yield
    finally:
        del os.environ["ROLLINGDEPTH_ATTN"]


def depth_drift(a, b) -> dict:
    """Mean and max |a - b|, their correlation, and the rms of a - b over b's
    spread (with the correlation, JAX's drift measure for a quantized UNet);
    numpy arrays or tensors."""
    a, b = (np.asarray(x.float().cpu() if hasattr(x, "cpu") else x, np.float64) for x in (a, b))
    d = np.abs(a - b)
    return {"mean_abs_err": float(d.mean()), "max_abs_err": float(d.max()),
            "corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]),
            "rel_rms": float(np.sqrt((d * d).mean()) / b.std()), "finite": bool(np.isfinite(a).all())}


def diff_stats(a, b) -> dict:
    """How two runs' outputs (tensors or arrays of one shape) differ."""
    import torch

    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    d = (a.double() - b.double()).abs()
    return {"elements": a.numel(), "differ": int((a != b).sum()), "max_abs": float(d.max()),
            "mean_abs": float(d.mean()), "equal": bool(torch.equal(a, b))}


REPEATS_DIFFERED = []  # with --measure-repeats: the paths whose two runs differed


def repeat_verdict(record: dict, measure_only: bool) -> None:
    """Log one repeat pair; raise unless its two runs were equal, or, with
    ``measure_only``, note it and go on."""
    log({"phase": "repeat", **record})
    if record["equal"]:
        return
    if not measure_only:
        raise AssertionError(f"{record['path']}: two runs on the same inputs differ: {record}")
    REPEATS_DIFFERED.append(record["path"])


def held_equal(path: str, a, b, seconds_added: float, measure_only: bool = False, **extra) -> None:
    """Two runs of one path on the same inputs, weights and seed: logged
    (elements, how many differ, max and mean |difference|, and ``extra``,
    such as each run's coalign seconds), then bit for bit or raise."""
    repeat_verdict({"path": path, **diff_stats(a, b), "seconds_added": seconds_added, **extra}, measure_only)


@contextlib.contextmanager
def solve_probe():
    """Records what the co-alignment solves do meanwhile: each
    ``DepthAligner.run`` call's config and arguments (``calls``), the
    ``aligner.Problem`` of each solve (``solves``), and the kernel's launches
    (``launches``, read when the block ends)."""
    from rollingdepth_torch import aligner
    from rollingdepth_torch.ops import coalign as co

    probe = {"calls": [], "solves": []}
    run, solve, before = aligner.DepthAligner.run, aligner.solve, co.coalign.launches

    def recording_run(self, *args, **kwargs):
        probe["calls"].append((self.config, args, kwargs))
        return run(self, *args, **kwargs)

    def recording_solve(p, kernel):
        probe["solves"].append(p)
        return solve(p, kernel)

    aligner.DepthAligner.run, aligner.solve = recording_run, recording_solve
    try:
        yield probe
    finally:
        aligner.DepthAligner.run, aligner.solve = run, solve
        probe["launches"] = co.coalign.launches - before


@contextlib.contextmanager
def eager_solves():
    """Every solve as the same step run eagerly, ``_optimize(kernel=False)``."""
    from rollingdepth_torch.aligner import DepthAligner

    optimize = DepthAligner._optimize
    DepthAligner._optimize = lambda self, *a, **kw: optimize(self, *a, kernel=False, **kw)
    try:
        yield
    finally:
        DepthAligner._optimize = optimize


@contextlib.contextmanager
def timed_kernel(torch, times: list):
    """Each launch of the solve kernel timed on the card (CUDA events)."""
    from rollingdepth_torch import aligner

    launch = aligner.coalign

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(*args, **kwargs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)

    aligner.coalign = timed
    try:
        yield
    finally:
        aligner.coalign = launch


SOLVE_SHORT_STEPS = 10  # the kernel against the CPU's eager steps at rtol/atol SOLVE_TOL (tests/test_torch_aligner.py)
SOLVE_TOL = 1e-5
SOLVE_FULL_TOL = 2e-2  # at the call's 2000 steps, the merged output, of its largest value
HBM_BYTES_S = 3.35e12


def solve_kernel_check(torch, path: str, probe: dict, smi: str) -> dict:
    """The first solve of a path's call (``probe``), again from its recorded
    inputs: through the kernel twice (bit for bit: merged output, scales,
    shifts, history) and as the same step run eagerly, on the card and on
    the CPU.  Against the CPU's run (``tests/test_torch_aligner_cuda.py``
    says why that one): at the call's steps the merged output within
    ``SOLVE_FULL_TOL`` of its largest value, or within twice the card's
    eager run's parting from it where that is larger; at
    ``SOLVE_SHORT_STEPS`` steps each output within ``SOLVE_TOL``, or
    within twice the card's eager run's parting from it.  Every
    solve of the call must have been one launch.  Logs and returns the
    record: launches, the kernel's device seconds, the solves' seconds and
    the bytes bound."""
    import dataclasses

    from rollingdepth_torch import aligner

    cfg, args, kwargs = probe["calls"][0]
    if probe["launches"] != len(probe["calls"]):
        raise AssertionError(f"{path}: {probe['launches']} kernel launches for {len(probe['calls'])} solves")

    def solve(c, mode: str) -> tuple:
        times, run_args = [], (([g.cpu() for g in args[0]],) + tuple(args[1:])) if mode == "cpu" else args
        with solve_probe() as rerun, (timed_kernel(torch, times) if mode == "kernel" else eager_solves()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            merged, scales, shifts, history = aligner.DepthAligner(c).run(*run_args, **kwargs)
            torch.cuda.synchronize()
        return [x.cpu() for x in (merged, *scales, *shifts, history)], time.perf_counter() - t0, times, rerun

    (out, kernel_s, times, rerun), (again, _, times2, _) = (solve(cfg, "kernel") for _ in range(2))
    card, eager_s, _, eager_probe = solve(cfg, "card")
    cpu, cpu_s, _, _ = solve(cfg, "cpu")
    repeat = all(torch.equal(a, b) for a, b in zip(out, again))
    scale = float(cpu[0].abs().max())
    full_err = float((out[0] - cpu[0]).abs().max()) / scale
    card_err = float((card[0] - cpu[0]).abs().max()) / scale
    short = dataclasses.replace(cfg, num_iterations=SOLVE_SHORT_STEPS)
    short_k, short_c, short_e = solve(short, "kernel")[0], solve(short, "card")[0], solve(short, "cpu")[0]
    names = ["merged"] + [f"s{i}" for i in range(len(args[0]))] + [f"t{i}" for i in range(len(args[0]))] + ["history"]
    short_err = {n: [float(((a - b).abs() - SOLVE_TOL * b.abs()).max()), float((a - b).abs().max()),
                     float((c - b).abs().max())] for n, a, c, b in zip(names, short_k, short_c, short_e)}
    # each output within the tolerance of the CPU's run, or no farther from it than twice the card's eager run
    short_ok = all(e <= SOLVE_TOL or k <= 2 * c for e, k, c in short_err.values())
    entry = rerun["solves"][0]
    view_bytes = 4 * sum(n * w for n, w in zip(entry.sizes, entry.widths)) * entry.views.shape[-1]
    record = {"phase": "solve", "path": path, "views": [list(v.shape) for v in args[0]],
              "table": list(entry.slots.shape), "iterations": cfg.num_iterations,
              "inverse_term": cfg.depth_loss_weight != 0.0, "solves_in_call": len(probe["calls"]),
              "launches_in_call": probe["launches"], "launches_in_rerun": rerun["launches"],
              "launches_eager": eager_probe["launches"], "kernel_device_s": times + times2,
              "kernel_s": kernel_s, "eager_card_s": eager_s, "eager_cpu_s": cpu_s, "view_bytes": view_bytes,
              "bound_s": view_bytes * cfg.num_iterations / HBM_BYTES_S, "repeat_equal": repeat,
              "merged_err": full_err, "card_eager_merged_err": card_err,
              "merged_bound": max(SOLVE_FULL_TOL, 2 * card_err),
              "short_steps": {"excess_over_rtol, kernel_err, card_eager_err": short_err}, "short_ok": short_ok,
              "card": smi}
    log(record)
    if not repeat:
        raise AssertionError(f"{path}: two kernel solves on the same inputs differ: {record}")
    if rerun["launches"] != 1 or eager_probe["launches"] != 0:
        raise AssertionError(f"{path}: the rerun launched the kernel {rerun['launches']} times (want 1), "
                             f"the eager solve {eager_probe['launches']} (want 0)")
    if not full_err <= record["merged_bound"] or not short_ok:
        raise AssertionError(f"{path}: the kernel's solve is not the eager steps' within the tolerances: {record}")
    return record


def coalign_idle_share(torch, run, smi: str) -> dict:
    """One call under ``torch.profiler`` (CPU and CUDA): each phase's host
    time, device busy time and idle share, as ``tools/profile_fast_path.py``
    reads them; logs and returns the record."""
    from torch.profiler import ProfilerActivity, profile

    from rollingdepth_torch.tools.profile_fast_path import device_shares

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    phases, call, kernels = device_shares(prof.events())
    record = {"phase": "coalign_profile", "path": "fast", "profiled_s": profiled_s, "phases": phases, "call": call,
              "kernels": len(kernels), "seconds": time.perf_counter() - t0, "card": smi}
    log(record)
    if not kernels or "coalign" not in phases:
        raise AssertionError(f"the profiler saw no kernel or no coalign span: {record}")
    return record


def kernel_calls(attn, cfg, n: int, h: int, w: int, tp: int = 1) -> list:
    """Each self-attention call of one UNet call that takes a kernel, as
    (``narrow`` or ``wide``, tokens, local heads, d) (see ``unet_kernel_calls``)."""
    sizes = [(h, w)]
    for _ in cfg.block_out_channels[1:]:
        h, w = -(-h // 2), -(-w // 2)
        sizes.append((h, w))
    bottom = len(sizes) - 1
    blocks = [(i, cfg.layers_per_block) for i, kind in enumerate(cfg.down_block_types)
              if kind == "CrossAttnDownBlock2D"] + [(bottom, 1)]
    blocks += [(bottom - i, cfg.layers_per_block + 1) for i, kind in enumerate(cfg.up_block_types)
               if kind == "CrossAttnUpBlock2D"]
    calls = []
    for level, count in blocks:
        tokens = n * sizes[level][0] * sizes[level][1]
        heads = cfg.heads_at(level)
        d = cfg.block_out_channels[level] // heads
        if attn.auto_selects_kernel(True, tokens, tokens, d):
            local = heads // tp if heads % tp == 0 else heads
            calls += [("narrow" if d < 128 else "wide", tokens, local, d)] * count
    return calls


def unet_kernel_calls(attn, cfg, n: int, h: int, w: int, tp: int = 1) -> dict:
    """Self-attention calls of one UNet call that take a kernel, by head
    width: the transformer blocks level by level (each latent side halves,
    rounding up, at every downsampler), at n * h_l * w_l tokens, by the
    dispatch's auto rule (``ops/attention.py``): ``narrow`` (d < 128, K1 or
    K2) and ``wide`` (K3).  SD2 at 768x432: 15 narrow (its d = 64 mid-block
    under the rule's 256 tokens); SD1.5 on 3 frames at 720x640: 10 narrow
    (d = 40, 80) and 6 wide (d = 160, the mid-block's 360 tokens included),
    on one frame 10 and 5 (the mid-block's 120 tokens stay plain).  On a tp
    shard (``parallel/sharding.py``) a level whose heads tp divides runs
    heads / tp of them with the same d (``kernel_calls``), so a call takes
    the kernel it takes unsharded."""
    calls = {"narrow": 0, "wide": 0}
    for kind, *_ in kernel_calls(attn, cfg, n, h, w, tp):
        calls[kind] += 1
    return calls


def narrow_kernel_calls(attn, cfg, n: int, h: int, w: int) -> int:
    """The narrow-kernel calls of one UNet call (``unet_kernel_calls``): 15
    at 768x432, 16 at 1024x576, where the SD2 mid-block's 432 tokens pass
    the rule's 256."""
    return unet_kernel_calls(attn, cfg, n, h, w)["narrow"]


def attention_kernel_launches(attn, pipe, chunks, lat_hw, snippet_len: int, refine_len: int, narrow: str,
                              tp: int = 1) -> dict:
    """The launches a pipeline call implies from its chunk counts: the
    narrow kernel ``narrow`` per UNet chunk (snippets and refinement), the
    wide kernel once per VAE encode and decode chunk (the mid-block's d=512
    head).  On a rank of a (dp, tp) mesh: that rank's chunks, each UNet
    call on its local heads (``unet_kernel_calls``)."""
    cfg = pipe.unet.config
    n_narrow = (unet_kernel_calls(attn, cfg, snippet_len, *lat_hw, tp=tp)["narrow"] * chunks["unet"]
                + unet_kernel_calls(attn, cfg, refine_len, *lat_hw, tp=tp)["narrow"] * chunks.get("refine_unet", 0))
    want = {"flash_attention_nomax": 0, "flash_attention_max": 0,
            "flash_attention_wide": chunks["encode"] + chunks["decode"]}
    want[narrow] = n_narrow
    return want


def relight_kernel_launches(attn, pipe, chunks, lat_hw, snippet_len: int, narrow: str) -> dict:
    """The launches a relight call implies from its chunk counts: per window
    UNet chunk (``snippet_len`` frames) and per t2i UNet chunk (one frame)
    the calls of ``unet_kernel_calls``, the narrow ones on ``narrow``, and
    the wide kernel once more per VAE encode and decode chunk (the
    mid-block's d = 512 head)."""
    window = unet_kernel_calls(attn, pipe.unet.config, snippet_len, *lat_hw)
    t2i = unet_kernel_calls(attn, pipe.unet.config, 1, *lat_hw)
    n_unet, n_t2i = chunks["unet"], chunks.get("t2i_unet", 0)
    want = {"flash_attention_nomax": 0, "flash_attention_max": 0,
            "flash_attention_wide": window["wide"] * n_unet + t2i["wide"] * n_t2i + chunks["encode"] + chunks["decode"]}
    want[narrow] = window["narrow"] * n_unet + t2i["narrow"] * n_t2i
    return want


def cut_counts(fa) -> dict:
    """K1's and K2's launches whose products ran narrower than the padding."""
    return {fn.__name__: fn.cut_launches for fn in fa.NARROW}


def relight_cut_launches(attn, fa, pipe, chunks, lat_hw, snippet_len: int, narrow: str) -> dict:
    """The narrow launches of a relight call (``relight_kernel_launches``)
    whose heads run their products narrower than the padding
    (``flash_attention.product_widths``): SD1.5's d = 40 and 80, every one."""
    cfg = pipe.unet.config
    n = 0
    for frames, calls in ((snippet_len, chunks["unet"]), (1, chunks.get("t2i_unet", 0))):
        n += calls * sum(kind == "narrow" and max(fa.product_widths(d)) < fa.padded_width(d)
                         for kind, _, _, d in kernel_calls(attn, cfg, frames, *lat_hw))
    want = {"flash_attention_nomax": 0, "flash_attention_max": 0}
    want[narrow] = n
    return want


def unet_norm_calls(cfg) -> int:
    """GroupNorms of one UNet call: two a ResNet block, one a transformer
    block, and ``conv_norm_out``.  SD2 and SD1.5: 22 ResNet blocks (2 a down
    level, 2 in the mid-block, 3 an up level) and 16 transformer blocks, 61."""
    resnets = len(cfg.down_block_types) * cfg.layers_per_block + 2 + len(cfg.up_block_types) * (cfg.layers_per_block + 1)
    attns = (sum(cfg.layers_per_block for kind in cfg.down_block_types if kind == "CrossAttnDownBlock2D") + 1
             + sum(cfg.layers_per_block + 1 for kind in cfg.up_block_types if kind == "CrossAttnUpBlock2D"))
    return 2 * resnets + attns + 1


def vae_norm_calls(cfg, part: str) -> int:
    """GroupNorms of one VAE ``encode`` or ``decode`` call: two a ResNet block
    (``layers_per_block`` a level in the encoder, one more in the decoder,
    and the mid-block's two), the mid-block attention's norm and
    ``conv_norm_out``.  SD's VAE: 22 an encode, 30 a decode."""
    resnets = len(cfg.block_out_channels) * (cfg.layers_per_block + (part == "decode")) + 2
    return 2 * resnets + int(cfg.mid_block_add_attention) + 1


def norm_kernel_launches(pipe, chunks: dict) -> int:
    """The GroupNorm pair's launches a bf16 pipeline call implies from its
    chunk counts: ``unet_norm_calls`` per UNet chunk (snippets, refinement,
    relight's t2i init on its base UNet), ``vae_norm_calls`` per encode and
    decode chunk.  Every GroupNorm of a bf16 call takes the pair (fp32 calls
    take ``F.group_norm``, and none)."""
    unet = unet_norm_calls(pipe.unet.config) * (chunks.get("unet", 0) + chunks.get("refine_unet", 0))
    if chunks.get("t2i_unet"):
        unet += unet_norm_calls(pipe.base_unet.config) * chunks["t2i_unet"]
    vae = pipe.vae.config
    return unet + vae_norm_calls(vae, "encode") * chunks.get("encode", 0) + vae_norm_calls(vae, "decode") * chunks.get(
        "decode", 0)


def check_depth(what, out, shape) -> None:
    """depth_pred and depth_coaligned: the clip's shape, finite, within [-1, 1]."""
    for name in ("depth_pred", "depth_coaligned"):
        d = getattr(out, name)
        if d.shape != shape:
            raise AssertionError(f"{what}: {name} shape {d.shape} != {shape}")
        if not (np.isfinite(d).all() and d.min() >= -1.0001 and d.max() <= 1.0001):
            raise AssertionError(f"{what}: {name} not finite or outside [-1, 1]")


def attention_bound_ms(b, lq, lk, h, d, itemsize) -> tuple:
    """Least time for one attention call: q, k, v read once and o written
    once at the memory rate, or QK^T and PV at the peak rate of the type:
    bf16 on the tensor cores; fp32 as three tf32 products each (3xTF32, the
    kernels' route, near-fp32 products)."""
    nbytes = (2 * b * lq * h * d + 2 * b * lk * h * d) * itemsize
    flops = 4.0 * b * h * lq * lk * d
    if itemsize == 2:
        t_ops = flops / H100_BF16_FLOPS
    else:
        t_ops = TF32_TERMS * flops / H100_TF32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, t_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def conv_bound_ms(n, h, w, cin, cout, itemsize) -> tuple:
    """Least time for one conv call: x, w and b read once and o written once
    at the memory rate, or 2 * 9 * Cin operations per output at the peak
    rate of the type."""
    nbytes = (n * h * w * (cin + cout) + 9 * cin * cout + cout) * itemsize
    flops = 2.0 * n * h * w * cout * 9 * cin
    peak = H100_BF16_FLOPS if itemsize == 2 else H100_FP32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


# bf16 kernels: the mean |error| against the plain version, as a fraction
# of the mean |output|.  The max bound (2e-2 of the output's scale) alone
# would pass an attention kernel that skipped or repeated one key tile at
# the main shape, which moves outputs by about 1e-3 against a max tolerance
# of about 3e-3; rounding alone keeps the mean error far below this bound
# (PERF.md).
MEAN_TOL_BF16 = 1e-2
DROPPED_KEYS = 32  # the smallest key tile of the attention kernels


def drop_key_tile(torch, k, v) -> tuple:
    """k and v [B, L_k, H, D] with DROPPED_KEYS keys taken out of the middle."""
    a = k.shape[1] // 2 // DROPPED_KEYS * DROPPED_KEYS
    return tuple(torch.cat([t[:, :a], t[:, a + DROPPED_KEYS:]], 1) for t in (k, v))


def drop_tap_chunk(torch, w):
    """w [3, 3, Cin, Cout] without tap (0, 0)'s last 64-channel chunk of
    input channels (the conv kernels' unit of work)."""
    c0 = (w.shape[2] - 1) // 64 * 64
    out = w.clone()
    out[0, 0, c0:c0 + 64] = 0
    return out


def held_to_plain(what, got, ref, bf16, plain_dropped) -> dict:
    """Raise unless ``got`` is finite and within the bounds of ``ref``: max
    |error| within 2e-2 (bf16) or 1e-4 (fp32) of the output's scale and, in
    bf16, mean |error| within MEAN_TOL_BF16 of the mean |output|.
    ``plain_dropped()`` is the plain version without one tile of work
    (``drop_key_tile``, ``drop_tap_chunk``): its shift from ``ref`` must
    exceed the bound, the mean bound in bf16 and the max bound in fp32, so
    that a kernel that skipped a tile would fail."""
    diff = (got.float() - ref.float()).abs()
    err, tol = diff.max().item(), (2e-2 if bf16 else 1e-4) * ref.float().abs().max().item()
    if not err <= tol or not got.isfinite().all():
        raise AssertionError(f"{what}: max err {err} > {tol}")
    out = {"max_abs_err": err, "tol": tol}
    shift = (plain_dropped().float() - ref.float()).abs()
    if bf16:
        mean_err, mean_tol = diff.mean().item(), MEAN_TOL_BF16 * ref.float().abs().mean().item()
        shift = shift.mean().item()
        if not mean_err <= mean_tol < shift:
            raise AssertionError(f"{what}: mean err {mean_err}, bound {mean_tol}, dropped-tile shift {shift}")
        out.update(mean_abs_err=mean_err, mean_tol=mean_tol, dropped_tile_shift=shift)
    else:
        shift = shift.max().item()
        if not tol < shift:
            raise AssertionError(f"{what}: dropped-tile max shift {shift} within the bound {tol}")
        out.update(dropped_tile_shift=shift)
    return out


CONV_SHAPES = ((4, 432, 768, 128, 128), (4, 216, 384, 256, 256), (4, 108, 192, 512, 512))
CONV_RAGGED_BF16 = ((2, 37, 53, 136, 200), (1, 5, 65, 72, 136))


def conv_phase(torch, conv):
    """K4 and K5: the public conv op with the counts from 0, then each kernel
    against its plain version; returns the first shape's row per kernel."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = []  # (N, H, W, Cin, Cout), x, w, b
    for shape, dtype in ([(s, torch.bfloat16) for s in CONV_SHAPES + CONV_RAGGED_BF16]
                         + [((2, 37, 53, 13, 21), torch.float32)]):
        n, h, w, cin, cout = shape
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dtype)
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda") * (9 * cin) ** -0.5).to(dtype)
        b = torch.randn((cout,), generator=gen, device="cuda").to(dtype)
        cases.append((shape, x, wt, b))

    conv.reset_launch_counts()
    for _, x, wt, b in cases:
        for fn in conv.KERNELS:
            fn(x, wt, b)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in conv.KERNELS}
    if launches != {fn.__name__: len(cases) for fn in conv.KERNELS}:
        raise AssertionError(f"conv launches {launches} != {len(cases)} calls each")
    log({"phase": "conv", "calls": len(cases), "launches": launches})

    rows = {}
    for shape, x, wt, b in cases:
        n, h, w, cin, cout = shape
        bf16 = x.dtype == torch.bfloat16
        plain = lambda: conv.conv3x3_reference(x, wt, b)  # noqa: E731
        ref = plain()
        dropped = conv.conv3x3_reference(x, drop_tap_chunk(torch, wt), b)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2)  # NHWC memory: channels_last
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, b, padding=1), 10)
        bound_ms, bound_by = conv_bound_ms(n, h, w, cin, cout, x.element_size())
        for fn in conv.KERNELS:
            got = fn(x, wt, b)
            torch.cuda.synchronize()
            # bf16: one rounding of the output plus the bias add, the bf16
            # bounds; fp32 (TF32 off): 1e-4 of the output's scale
            errs = held_to_plain(f"{fn.__name__} {shape} {x.dtype}", got, ref, bf16, lambda: dropped)
            row = {"name": fn.__name__, "shape": list(shape), "dtype": str(x.dtype).split(".")[-1], **errs,
                   "ms": cuda_ms(lambda: fn(x, wt, b), 10), "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if bf16:
                row["l2_bytes"] = conv.bf16_tma_bytes(fn, *shape)
            log(row)
            rows.setdefault(fn.__name__, row)
            del got
        del ref, dropped
    del cases
    return rows, launches


VARIANT_CASES = (((8, 15552, 5, 64), 15552, True), ((2, 3001, 5, 64), 2999, False))  # [B, L_q, H, D], L_k, main


def variants_phase(torch, fv, bench):
    """K6-K10: the sweep entry point with the counts from 0, then each
    variant against its plain version; returns the main shape's rows."""
    import torch.nn.functional as F

    iters = 3
    fv.reset_launch_counts()
    sweep = bench.sweep(iters=iters, verbose=False)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in fv.KERNELS}
    per_shape = {fn.__name__: 1 + 2 + iters for fn in fv.KERNELS}  # check, warm-up, timed
    per_shape["flash_fused"] += 1  # the sweep's reference
    want = {name: n * len(bench.SHAPES) for name, n in per_shape.items()}
    if launches != want:
        raise AssertionError(f"variant launches {launches} != {want}")
    log({"phase": "variants", "sweep": sweep, "launches": launches})

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for (b, lq, h, d), lk, main in VARIANT_CASES:
        q = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        iters = 10 if main else 50
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        bound_ms, bound_by = attention_bound_ms(b, lq, lk, h, d, q.element_size())
        for fn in fv.KERNELS:
            name = fn.__name__
            got = fn(q, k, v)
            plain = lambda: fv.reference(name, q, k, v)  # noqa: E731
            ref = plain()
            torch.cuda.synchronize()
            # scores, P and the output rounded to bf16, exp2 by the SFU's
            # approximation: the bf16 bounds, as for K1-K3
            errs = held_to_plain(f"{name} {(b, lq, h, d)} L_k={lk}", got, ref, True,
                                 lambda: fv.reference(name, q, *drop_key_tile(torch, k, v)))
            row = {"name": name, "shape": [b, lq, h, d], "L_k": lk, "dtype": "bfloat16", **errs,
                   "ms": cuda_ms(lambda: fn(q, k, v), iters),
                   "plain_ms": cuda_ms(plain, 2 if main else 5, warmup=1), "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            log(row)
            if main:
                rows[name] = row
            del got, ref
        del q, k, v
    return rows, launches


# ---- the GroupNorm pair (ops/group_norm.py), XLA's fusion written by hand

# ragged inputs beside those the paths give the pair (``group_norm_phase``):
# (N, C, H, W, silu), ragged H*W and C/G = 10, 20, 30, 80, 4
NORM_RAGGED = ((3, 320, 37, 53, True), (2, 640, 13, 29, False), (5, 960, 11, 7, True), (1, 2560, 3, 5, True),
               (3, 128, 101, 67, False))
NORM_GROUPS, NORM_EPS = 32, 1e-6  # the ragged inputs' and the refusals'
# the pair's fp32 statistics against torch.var_mean's: |mean error| in
# standard deviations, |inv / inv_ref - 1|; fp32 sums in another order
# part them by ~1e-7, the statistics without one block's chunk by >1e-4
NORM_STATS_TOL = 1e-5


def held_norm_counts(what, gn, pipe, chunks, seen: dict) -> int:
    """Raise unless a bf16 call's pair launches equal ``norm_kernel_launches``;
    keeps the inputs the call gave the pair (``group_norm.inputs``) in
    ``seen[what]`` and returns the launches.  The equality also means the
    plain version ran 0 times: on a CUDA tensor the wrapper launches or
    raises, so a bf16 norm that went elsewhere would leave the count short."""
    got, want = gn.group_norm.launches, norm_kernel_launches(pipe, chunks)
    if got != want or sum(gn.group_norm.inputs.values()) != got:
        raise AssertionError(f"{what}: {got} GroupNorm pair launches ({sum(gn.group_norm.inputs.values())} by input),"
                             f" want {want} from chunks {chunks}")
    seen[what] = dict(gn.group_norm.inputs)
    return got


def norm_bound_ms(n, c, h, w) -> tuple:
    """Least time for one GroupNorm (+ silu) call: x read once and y written
    once (bf16), weight and bias once, at the memory rate; or ~12 fp32
    operations an element (statistics, the four rounded ops, silu) at the
    non-tensor fp32 peak."""
    elems = n * c * h * w
    t_bytes, t_ops = (4 * elems + 4 * c) / H100_BYTES_PER_S * 1e3, 12.0 * elems / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def norm_inputs(torch, gen, n, c, h, w) -> tuple:
    """x [N, C, H, W] bf16 in channels_last memory (a per-channel scale and
    offset, and a ramp over the pixels, so that the image's last statistics
    chunk differs from the rest), weight and bias [C] bf16."""
    x = torch.randn((n, h, w, c), generator=gen, device="cuda")
    x = x * (0.5 + torch.rand(c, generator=gen, device="cuda")) + torch.randn(c, generator=gen, device="cuda")
    x = x + torch.linspace(0, 1, h * w, device="cuda").reshape(1, h, w, 1)
    wt = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    return x.bfloat16().permute(0, 3, 1, 2), wt.bfloat16(), (0.2 * torch.randn(c, generator=gen, device="cuda")).bfloat16()


def norm_stats_error(torch, x, mean, inv, groups, eps, pixels=None) -> float:
    """How far (mean, inv) [N, G] are from torch.var_mean's fp32 statistics of
    x's first ``pixels`` pixels (all by default): the larger of |mean error|
    in standard deviations and |inv / inv_ref - 1|."""
    n, c, h, w = x.shape
    xg = x.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)[:, :pixels].float()
    var, ref = torch.var_mean(xg, dim=(1, 3), correction=0)
    err_mean = ((mean - ref).abs() / var.sqrt()).max().item()
    err_inv = (inv / torch.rsqrt(var + eps) - 1).abs().max().item()
    return max(err_mean, err_inv)


def held_norm(torch, gn, what, x, wt, b, groups, eps, silu) -> dict:
    """The public wrapper (the models' call) against the plain version on the
    same x: the bf16 kernel rule (max |error| within 2e-2 of the output's
    scale, mean within MEAN_TOL_BF16 of the mean |output|) and y in
    channels_last memory; the statistics of a second call (``_launch``)
    within NORM_STATS_TOL of torch.var_mean's, a bound the statistics
    without each image's last chunk (one block of the statistics kernel)
    must exceed, and its y bit-equal to the first; and y bit for bit the
    plain version's pass on the pair's own statistics
    (``gn.apply_reference``), so that y can differ from the plain version
    only in a group whose bf16 mean or inv rounds apart (``flipped_groups``,
    logged with the share of bit-equal elements)."""
    n, c, h, w = x.shape
    y = gn.group_norm(x, wt, b, groups, eps, silu)
    again, mean, inv = gn._launch(x, wt, b, groups, eps, silu)
    ref = gn.group_norm_reference(x, wt, b, groups, eps, silu)
    torch.cuda.synchronize()
    diff = (y.float() - ref.float()).abs()
    err, tol = diff.max().item(), 2e-2 * ref.float().abs().max().item()
    mean_err, mean_tol = diff.mean().item(), MEAN_TOL_BF16 * ref.float().abs().mean().item()
    share = (y == ref).float().mean().item()
    pass_exact = bool(torch.equal(y, gn.apply_reference(x, mean, inv, wt, b, silu)))
    xg = x.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups).float()
    var_r, mean_r = torch.var_mean(xg, dim=(1, 3), correction=0)
    flipped = ((mean.bfloat16() != mean_r.bfloat16())
               | (inv.bfloat16() != torch.rsqrt(var_r + eps).bfloat16())).sum().item()
    del xg
    stats = norm_stats_error(torch, x, mean, inv, groups, eps)
    per_chunk, chunks = gn.stats_plan(n, h * w, c)
    dropped = (norm_stats_error(torch, x, mean, inv, groups, eps, (chunks - 1) * per_chunk)
               if chunks > 1 else None)
    out = {"max_abs_err": err, "tol": tol, "mean_abs_err": mean_err, "mean_tol": mean_tol, "equal_share": share,
           "pass_exact": pass_exact, "flipped_groups": flipped, "groups_total": n * groups, "stats_err": stats, "stats_tol": NORM_STATS_TOL, "dropped_chunk_stats_err": dropped,
           "stats_chunks": chunks, "repeat_equal": bool(torch.equal(y, again)), "finite": bool(y.isfinite().all()),
           "channels_last": y.shape == x.shape and y.is_contiguous(memory_format=torch.channels_last)}
    if not (out["finite"] and err <= tol and mean_err <= mean_tol and pass_exact
            and stats <= NORM_STATS_TOL and (dropped is None or dropped > NORM_STATS_TOL) and out["repeat_equal"]
            and out["channels_last"]):
        raise AssertionError(f"{what}: GroupNorm pair against the plain version: {out}")
    return out


def group_norm_phase(torch, gn, seen: dict, smi) -> list:
    """The pair at every input the bf16 paths gave it (``seen``: path ->
    ``group_norm.inputs`` of its counted call) and at ``NORM_RAGGED``: each
    input once, with the count from 0, held to the plain version
    (``held_norm``) and timed beside it, one ``F.group_norm`` call (the
    library's yardstick, norm only) and the bound; a non-channels_last x
    and an autograd-recording call must raise.  Returns a row an input, the
    paths' in the order first seen, then the ragged ones; each row carries
    its launches by path."""
    import torch.nn.functional as F

    inputs = {}  # (N, C, H, W, groups, eps, silu) -> {path: launches}
    for path, counts in seen.items():
        for key, launched in counts.items():
            inputs.setdefault(key, {})[path] = launched
    for n, c, h, w, silu in NORM_RAGGED:
        inputs.setdefault((n, c, h, w, NORM_GROUPS, NORM_EPS, silu), {})["ragged"] = 0
    gen = torch.Generator(device="cuda").manual_seed(8)
    gn.reset_launch_counts()
    rows, t0 = [], time.perf_counter()
    for i, ((n, c, h, w, groups, eps, silu), by_path) in enumerate(inputs.items()):
        x, wt, b = norm_inputs(torch, gen, n, c, h, w)
        errs = held_norm(torch, gn, f"groupnorm {(n, c, h, w)} groups={groups} eps={eps} silu={silu} "
                         f"of {sorted(by_path)}", x, wt, b, groups, eps, silu)
        if gn.group_norm.launches != i + 1:
            raise AssertionError(f"groupnorm: {gn.group_norm.launches} wrapper launches after {i + 1} inputs")
        big = n * c * h * w > 5e7
        bound_ms, bound_by = norm_bound_ms(n, c, h, w)
        row = {"phase": "groupnorm", "paths": by_path, "shape": [n, c, h, w], "groups": groups, "eps": eps,
               "silu": silu, **errs, "ms": cuda_ms(lambda: gn._launch(x, wt, b, groups, eps, silu), 10 if big else 50),
               "plain_ms": cuda_ms(lambda: gn.group_norm_reference(x, wt, b, groups, eps, silu),
                                   3 if big else 10, warmup=1),
               "library_ms": cuda_ms(lambda: F.group_norm(x, groups, wt, b, eps), 10 if big else 50),
               "bound_ms": bound_ms, "bound_by": bound_by, "pair_bytes": 6 * n * c * h * w}
        log(row)
        rows.append(row)
        del x, wt, b
    x, wt, b = norm_inputs(torch, gen, 2, 320, 9, 16)
    nchw, recorded = x.contiguous(), x.detach().clone().requires_grad_()
    refusals = {}
    for name, call in (("nchw", lambda: gn.group_norm(nchw, wt, b, NORM_GROUPS, NORM_EPS, True)),
                       ("autograd", lambda: gn.group_norm(recorded, wt, b, NORM_GROUPS, NORM_EPS, True))):
        try:
            with torch.enable_grad():
                call()
            refusals[name] = "ran"
        except (ValueError, RuntimeError) as e:
            refusals[name] = str(e)[:80]
    if "ran" in refusals.values():
        raise AssertionError(f"groupnorm: the pair took what it must refuse: {refusals}")
    paths = sorted({p for r in rows for p in r["paths"]})
    log({"phase": "groupnorm_summary", "inputs": len(rows),
         "inputs_by_path": {p: sum(p in r["paths"] for r in rows) for p in paths},
         "seconds": time.perf_counter() - t0, "refusals": refusals, "card": smi})
    return rows


def norm_path_totals(rows: list, path: str) -> dict:
    """One call of ``path``'s GroupNorm work as the rows time it: each input's
    ms, plain, library and bound times its launches on that path, summed."""
    return {k: sum(r[k] * r["paths"][path] for r in rows if path in r["paths"])
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}


def kernel_phase(torch, fa):
    """Each kernel against its plain version; returns the main-shape rows."""
    import torch.nn.functional as F

    cases = [  # (kernel, [B, L_q, H, D], L_k, dtype, row of the kernels line)
        ("nomax", (8, 15552, 5, 64), 15552, torch.bfloat16, "nomax"),
        ("nomax", (8, 1008, 20, 64), 1008, torch.bfloat16, None),
        ("nomax", (2, 3001, 5, 64), 2999, torch.bfloat16, None),
        ("nomax", (1, 1000, 5, 64), 1000, torch.float32, None),
        ("nomax", (8, 27648, 5, 64), 27648, torch.bfloat16, None),  # the full preset's res 1024
        ("nomax", (8, 15552, 5, 64), 15552, torch.float32, "nomax_fp32"),  # the paper preset's res 768
        ("max", (8, 15552, 5, 64), 15552, torch.bfloat16, "max"),
        ("max", (8, 1008, 20, 64), 1008, torch.bfloat16, None),
        ("max", (2, 3001, 5, 64), 2999, torch.bfloat16, None),
        ("max", (1, 1000, 5, 64), 1000, torch.float32, None),
        ("wide", (4, 5184, 1, 512), 5184, torch.bfloat16, "wide"),
        ("wide", (2, 1001, 1, 512), 999, torch.bfloat16, None),
        ("wide", (1, 1000, 1, 512), 999, torch.float32, None),
        ("wide", (2, 1001, 1, 512), 999, torch.float32, None),
        ("wide", (4, 9216, 1, 512), 9216, torch.bfloat16, None),  # res 1024
        ("wide", (4, 5184, 1, 512), 5184, torch.float32, "wide_fp32"),  # res 768
        # the relight path at 720x640 (latent 80x90): the 12-channel UNet on
        # windows of 3 frames (levels 0-2 and the mid-block), the base UNet on
        # one frame (t2i init), the VAE mid-block; 8 windows or frames a chunk
        ("nomax", (8, 21600, 8, 40), 21600, torch.bfloat16, "relight"),
        ("nomax", (8, 5400, 8, 80), 5400, torch.bfloat16, "relight"),
        ("nomax", (8, 7200, 8, 40), 7200, torch.bfloat16, "relight"),
        ("nomax", (8, 1800, 8, 80), 1800, torch.bfloat16, "relight"),
        ("max", (8, 21600, 8, 40), 21600, torch.bfloat16, "relight"),
        ("max", (8, 5400, 8, 80), 5400, torch.bfloat16, "relight"),
        ("wide", (8, 1380, 8, 160), 1380, torch.bfloat16, "relight"),
        ("wide", (8, 360, 8, 160), 360, torch.bfloat16, "relight"),
        ("wide", (8, 460, 8, 160), 460, torch.bfloat16, "relight"),
        ("wide", (4, 7200, 1, 512), 7200, torch.bfloat16, "relight"),
        # the parallel phase's tp = 2 shards at 432x768: a dp rank's chunk of
        # 6 windows, level 1 on 5 of its 10 heads, level 2 on 10 of its 20
        ("nomax", (6, 3888, 5, 64), 3888, torch.bfloat16, "tp"),
        ("nomax", (6, 1008, 10, 64), 1008, torch.bfloat16, "tp"),
        ("nomax", (6, 3888, 5, 64), 3888, torch.float32, "tp"),
        ("nomax", (6, 1008, 10, 64), 1008, torch.float32, "tp"),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"relight": [], "tp": []}
    for name, (b, lq, h, d), lk, dtype, row_key in cases:
        q = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, lk, h, d), generator=gen, device="cuda").to(dtype)
        wrapper = getattr(fa, f"flash_attention_{name}")
        flags = dict(no_max=name == "nomax", sum_rounded=name != "wide")
        plain = lambda: fa.attention_exp2_reference(q, k, v, **flags)  # noqa: E731
        got = wrapper(q, k, v)
        ref = plain()
        torch.cuda.synchronize()
        # bf16: P and the output are rounded to bf16 and exp2 is the SFU's
        # approximation, so the bf16 bounds; fp32: 1e-4 of the output's scale
        errs = held_to_plain(f"{name} {(b, lq, h, d)} L_k={lk} {dtype}", got, ref, dtype == torch.bfloat16,
                             lambda: fa.attention_exp2_reference(q, *drop_key_tile(torch, k, v), **flags))
        iters = 50 if lq * lk * b * h <= 1e9 else 10 if dtype == torch.bfloat16 else 3
        ms = cuda_ms(lambda: wrapper(q, k, v), iters)
        plain_ms = cuda_ms(plain, 2 if lq > 4000 else 5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        bound_ms, bound_by = attention_bound_ms(b, lq, lk, h, d, q.element_size())
        row = {"name": name, "shape": [b, lq, h, d], "L_k": lk, "dtype": str(dtype).split(".")[-1],
               **errs, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        log(row)
        if row_key in ("relight", "tp"):
            rows[row_key].append(row)
        elif row_key:
            rows[row_key] = row
        del q, k, v, got, ref
    return rows


RELIGHT_FRAMES = 24
RELIGHT_RES = (3, 640, 720)  # the reference's fixed working size (H, W)
RMBG_FEED = (8, 3, 960, 1088)  # the feed run_rmbg makes for 640x720 frames, 8 a chunk


def check_rgb(what, out, shape) -> None:
    """R, G and B of the clip's shape, finite, within [0, 1]."""
    for name in ("R_pred", "G_pred", "B_pred"):
        c = getattr(out, name)
        if c.shape != shape or not (np.isfinite(c).all() and c.min() >= 0.0 and c.max() <= 1.0):
            raise AssertionError(f"{what}: {name} {c.shape} (want {shape}) not finite or outside [0, 1]")


def relight_phase(torch, attn, fa, gn, gen, smi, measure_only: bool, seen: dict):
    """The relight path (``pipelines/rollingimg.py``) at full SD1.5 width with
    random weights: a 6-frame warm-up, then a timed bf16 call on 24 frames of
    720x640 (``RELIGHT_CALL``: dilations [1, 25] capped to [1, 7], 22 + 10
    windows of 3) whose launches must equal what its chunks imply; one bf16
    12-channel UNet chunk against the plain attention path; a 6-frame fp32
    run (solves cut to 0 steps) against the plain attention path; the RMBG
    matte on one chunk of feeds.  Returns the timed call's launches and the
    parallel phase's single-process relight results."""
    from rollingdepth_torch.pipelines.rollingimg import encode_prompt_pair, rmbg_matte
    from rollingdepth_torch.utils.synthetic import RELIGHT_CALL, random_relight_pipeline

    t0 = time.perf_counter()
    pipe, bound = random_relight_pipeline("cuda", torch.bfloat16, seed=0, snippet_batch=8)
    if not attn.nomax_allowed():
        raise AssertionError(f"relight: the score probe closed the gate on random weights (bound {bound})")
    torch.cuda.synchronize()
    log({"phase": "relight_setup", "seconds": time.perf_counter() - t0, "score_bound": bound,
         "unet_params": sum(p.numel() for p in pipe.unet.parameters())})
    n, lat_hw = RELIGHT_FRAMES, (RELIGHT_RES[1] // 8, RELIGHT_RES[2] // 8)
    fg = torch.rand((n,) + RELIGHT_RES, generator=gen, device="cuda") * 2 - 1
    bg = torch.rand((n,) + RELIGHT_RES, generator=gen, device="cuda") * 2 - 1

    t0 = time.perf_counter()
    warm = pipe.forward(fg[:6], bg[:6], verbose=True, **RELIGHT_CALL)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_coalign = pipe.last_timings["coalign"]
    t0 = time.perf_counter()
    again = pipe.forward(fg[:6], bg[:6], verbose=True, **RELIGHT_CALL)
    held_equal("relight_6_frames_rgb", np.concatenate([warm.R_pred, warm.G_pred, warm.B_pred], axis=1),
               np.concatenate([again.R_pred, again.G_pred, again.B_pred], axis=1), time.perf_counter() - t0,
               measure_only, coalign_s=[warm_coalign, pipe.last_timings["coalign"]])
    del warm, again
    # the parallel phase's reference (c): 6 frames, solves cut to 0 steps, every window kept
    call6 = dict(RELIGHT_CALL, coalign_kwargs={"num_iterations": 0}, keep_snippets=True)
    ref6 = pipe.forward(fg[:6], bg[:6], **call6)
    parallel_ref = {"fg": fg[:6].cpu(), "bg": bg[:6].cpu(), "call": call6, "snippet_ls": ref6.snippet_ls,
                    "rgb": np.concatenate([ref6.R_pred, ref6.G_pred, ref6.B_pred], axis=1)}
    del ref6
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.perf_counter()
    with solve_probe() as probe:
        out = pipe.forward(fg, bg, verbose=True, **RELIGHT_CALL)
        torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    cut = cut_counts(fa)
    chunks = dict(pipe.last_chunks)
    check_rgb("relight", out, (n, 1) + RELIGHT_RES[1:])
    want = relight_kernel_launches(attn, pipe, chunks, lat_hw, 3, "flash_attention_nomax")
    if launches != want:
        raise AssertionError(f"relight: launches {launches} != {want} implied by chunks {chunks}")
    want_cut = relight_cut_launches(attn, fa, pipe, chunks, lat_hw, 3, "flash_attention_nomax")
    if cut != want_cut or cut["flash_attention_nomax"] != launches["flash_attention_nomax"]:
        raise AssertionError(f"relight: cut launches {cut} != {want_cut}, or not every K1 launch")
    norms = held_norm_counts("relight", gn, pipe, chunks, seen)
    log({"phase": "relight", "frames": n, "res": list(RELIGHT_RES[1:]), "warmup_frames": 6, "warmup_s": warm_s,
         "total_s": total_s, "fps": n / total_s, "timings_s": pipe.last_timings, "chunks": chunks,
         "launches": launches, "cut_launches": cut, "norm_launches": norms,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    # the three channel solves, a launch each, then R's solve again: kernel against eager steps
    if len(probe["calls"]) != 3:
        raise AssertionError(f"relight: {len(probe['calls'])} solves, not one a channel")
    solve_kernel_check(torch, "relight_r", probe, smi)
    del probe

    # one 12-channel UNet chunk (8 windows of 3 frames, the prompt pair's
    # 154 tokens), kernels against the plain attention path, bf16: 5e-2 of the output scale
    checks = {}
    with torch.no_grad():
        c, uc = encode_prompt_pair(pipe.tokenizer, pipe.text_apply, "a relit scene, best quality", "lowres")
        ctx = torch.cat([c, uc], dim=1).to(torch.bfloat16)
        x = torch.randn((8, 3) + lat_hw + (12,), generator=gen, device="cuda").to(torch.bfloat16)
        u_k = pipe.unet(x, 500, ctx)
        with plain_attention():
            u_p = pipe.unet(x, 500, ctx)
    err, scale = (u_k.float() - u_p.float()).abs().max().item(), u_p.float().abs().max().item()
    checks["unet12_chunk"] = {"max_abs_err": err, "scale": scale, "context_tokens": ctx.shape[1]}
    if not err <= 5e-2 * scale:
        raise AssertionError(f"relight unet chunk: kernels vs plain attention max err {err} > 5e-2 * {scale}")

    # the RMBG matte on one chunk of the feeds run_rmbg makes for 640x720 (fp32)
    feed = torch.rand(RMBG_FEED, generator=gen, device="cuda") * 255
    orig = torch.rand((RMBG_FEED[0],) + RELIGHT_RES, generator=gen, device="cuda") * 255
    matted, alpha = rmbg_matte(pipe.rmbg, feed, orig)
    torch.cuda.synchronize()
    if not (alpha.isfinite().all() and alpha.min() >= 0 and alpha.max() <= 1 and matted.isfinite().all()):
        raise AssertionError("rmbg: alpha not finite or outside [0, 1]")
    checks["rmbg"] = {"feed": list(RMBG_FEED), "alpha_mean": alpha.mean().item(),
                      "ms": cuda_ms(lambda: rmbg_matte(pipe.rmbg, feed, orig), 3, warmup=1)}
    del pipe, out, u_k, u_p, x, feed, orig, matted, alpha

    # fp32, 6 frames, solves cut to 0 steps: kernels against the plain attention path
    pipe32, _ = random_relight_pipeline("cuda", torch.float32, seed=0, snippet_batch=8)
    kw = dict(RELIGHT_CALL, coalign_kwargs={"num_iterations": 0})
    got = pipe32.forward(fg[:6], bg[:6], **kw)
    chunks32 = dict(pipe32.last_chunks)
    with plain_attention():
        ref = pipe32.forward(fg[:6], bg[:6], **kw)
    rgb = lambda o: np.concatenate([o.R_pred, o.G_pred, o.B_pred], axis=1)  # noqa: E731
    checks["relight_fp32_6_frames_no_solve"] = drift = dict(depth_drift(rgb(got), rgb(ref)), chunks=chunks32)
    if not (drift["max_abs_err"] <= 1e-3 and drift["corr"] > 0.99999):
        raise AssertionError(f"relight fp32 with kernels vs plain attention: {drift}")
    log({"phase": "relight_check", **checks, "card": smi})
    del pipe32
    return launches, parallel_ref, norms


TRAIN_CLIPS, TRAIN_FRAMES, TRAIN_RES = 2, 8, (480, 640)
TRAIN_STEPS = 4
TRAIN_VAE_BS = 4
# windows of 3 at dilations 1 and 2, uncapped (capping takes 2 to 1 on 8
# frames): 6 + 4 windows a clip, batches of 2 snippets
TRAIN_DATA = dict(snippet_len=3, dilations=(1, 2), cap_dilation=False, batch_size=2, seed=0)
TRAIN_CONFIG = dict(lr_schedule="cosine", warmup_steps=2, total_steps=10)
# the Function's backward against autograd through plain_attention:
# (kernel, [B, L, H, D], dtype); level 0 of the train step's UNet, and the
# VAE mid-block of its encode chunks
GRAD_CASES = (("nomax", (2, 14400, 5, 64), "bfloat16"), ("nomax", (2, 14400, 5, 64), "float32"),
              ("max", (2, 14400, 5, 64), "bfloat16"), ("wide", (4, 4800, 1, 512), "float32"))


def train_kernel_launches(attn, cfg, snippet_len: int, lat_hw, steps: int, encode_chunks: int) -> dict:
    """The launches the train phase implies: each step's UNet forward makes
    the kernel calls of ``unet_kernel_calls`` (narrow ones on K1 while the
    gate is open; the backward launches none), each VAE encode chunk one
    wide launch (the mid-block's d = 512 head).  SD2 at 480x640 on windows
    of 3: 15 narrow a step."""
    calls = unet_kernel_calls(attn, cfg, snippet_len, *lat_hw)
    return {"flash_attention_nomax": calls["narrow"] * steps, "flash_attention_max": 0,
            "flash_attention_wide": calls["wide"] * steps + encode_chunks}


def params_within(what, got: dict, ref: dict, lr: float) -> dict:
    """Raise unless every parameter of ``got`` ({name: tensor}) is within
    1e-6 + 2.2 lr of ``ref``'s after one update from the same state: Adam
    moves a parameter by at most about lr, so a gradient near 0 whose sign
    differs between the two runs parts them by up to 2 lr."""
    if got.keys() != ref.keys():
        raise AssertionError(f"{what}: parameter names differ")
    tol = 1e-6 + 2.2 * lr
    name, err = max(((n, (got[n].float() - ref[n].float()).abs().max().item()) for n in ref), key=lambda x: x[1])
    if not err <= tol:
        raise AssertionError(f"{what}: {name} moved apart by {err} > {tol}")
    return {"max_abs_diff": err, "param": name, "tol": tol}


def _grad_flags(torch, params: dict) -> dict:
    """{name: whether its gradient has a nonzero value}, one device sync."""
    flags = torch.stack([p.grad.abs().amax() > 0 for p in params.values()]).tolist()
    return dict(zip(params, flags))


def train_phase(torch, attn, fa, smi, ckpt: str):
    """The training path at full SD2 width (fp32, random weights): the
    dataset's encode and TRAIN_STEPS steps, launches against what they
    imply; saves the state to ``ckpt``.  Returns (setup, dataset, step,
    launches)."""
    from rollingdepth_torch.ops import group_norm as gn
    from rollingdepth_torch.training import TrainConfig, make_train_step, save_train_state, step_seconds
    from rollingdepth_torch.training_data import SnippetDataConfig, SnippetLatentDataset, vae_encode_fn
    from rollingdepth_torch.utils.synthetic import random_training_setup

    t0 = time.perf_counter()
    setup = random_training_setup("cuda", seed=0, clips=TRAIN_CLIPS, frames=TRAIN_FRAMES, res=TRAIN_RES)
    if not attn.nomax_allowed():
        raise AssertionError(f"train: the score probe closed the gate on random weights ({setup.score_bound})")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.perf_counter()
    data = SnippetLatentDataset(vae_encode_fn(setup.vae, TRAIN_VAE_BS), setup.rgb_clips, setup.depth_clips,
                                SnippetDataConfig(**TRAIN_DATA), device="cuda")
    encode_s = time.perf_counter() - t0
    encode_chunks = 2 * TRAIN_CLIPS * math.ceil(TRAIN_FRAMES / TRAIN_VAE_BS)  # rgb and depth of each clip

    step = make_train_step(setup.unet, setup.scheduler, TrainConfig(**TRAIN_CONFIG))
    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    metrics = []
    for batch in data.epoch(0):
        metrics.append(step(dict(batch, text_embed=setup.text_embed), gen))
        if len(metrics) == TRAIN_STEPS:
            break
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    rows = [{"step": i, "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lr": m["lr"],
             "seconds": step_seconds(m)} for i, m in enumerate(metrics)]
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError(f"train: loss or grad_norm not finite: {rows}")
    lat_hw = (TRAIN_RES[0] // 8, TRAIN_RES[1] // 8)
    want = train_kernel_launches(attn, setup.unet.config, TRAIN_DATA["snippet_len"], lat_hw, TRAIN_STEPS,
                                 encode_chunks)
    if launches != want or gn.group_norm.launches:
        raise AssertionError(f"train: launches {launches} != {want} ({TRAIN_STEPS} steps, "
                             f"{encode_chunks} encode chunks), or {gn.group_norm.launches} GroupNorm pairs (fp32: 0)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    save_train_state(ckpt, setup.unet, step.optimizer)
    log({"phase": "train", "clips": TRAIN_CLIPS, "frames": TRAIN_FRAMES, "res": list(TRAIN_RES),
         "windows": len(data), "batch": TRAIN_DATA["batch_size"], "config": TRAIN_CONFIG, "setup_s": setup_s,
         "encode_s": encode_s, "encode_chunks": encode_chunks, "steps_s": steps_s, "steps": rows,
         "launches": launches, "peak_mem_gb": peak, "save_s": time.perf_counter() - t0,
         "checkpoint_gb": os.path.getsize(ckpt) / 2**30,
         "unet_params": sum(p.numel() for p in setup.unet.parameters()), "card": smi})
    return setup, data, step, launches


def train_check_phase(torch, attn, fa, setup, data, step, smi, ckpt: str) -> None:
    """One step twice from the saved state with the same timesteps and
    noise, with the kernels and on the plain attention path; then each
    Function's gradients against plain autograd at the path's shapes."""
    from rollingdepth_torch.training import restore_train_state, step_seconds

    batch = dict(next(iter(data.epoch(1))), text_embed=setup.text_embed)
    gen = torch.Generator(device="cuda").manual_seed(5)
    t = torch.randint(0, setup.scheduler.config.num_train_timesteps, (TRAIN_DATA["batch_size"],), generator=gen,
                      device="cuda")
    noise = torch.randn(batch["depth_latent"].shape, generator=gen, device="cuda")
    params = dict(setup.unet.named_parameters())
    runs = {}
    for mode in ("kernels", "plain"):
        t0 = time.perf_counter()
        at_step = restore_train_state(ckpt, setup.unet, step.optimizer)
        restore_s = time.perf_counter() - t0
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with plain_attention() if mode == "plain" else contextlib.nullcontext():
            m = step(batch, timesteps=t, noise=noise)
            seconds = step_seconds(m)
        runs[mode] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lr": m["lr"],
                      "nonzero": _grad_flags(torch, params), "params": {n: p.detach().cpu() for n, p in params.items()},
                      "attn1": {n: p.grad.clone() for n, p in params.items() if ".attn1.to_" in n},
                      "launches": {fn.__name__: fn.launches for fn in fa.KERNELS}, "seconds": seconds,
                      "restore_s": restore_s, "from_step": at_step,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    k, p = runs["kernels"], runs["plain"]
    narrow = unet_kernel_calls(attn, setup.unet.config, TRAIN_DATA["snippet_len"], TRAIN_RES[0] // 8,
                               TRAIN_RES[1] // 8)["narrow"]
    if k["launches"]["flash_attention_nomax"] != narrow or sum(p["launches"].values()):
        raise AssertionError(f"train_check: launches {k['launches']} (want {narrow} K1), plain {p['launches']}")
    if not abs(k["loss"] - p["loss"]) <= 1e-5 * abs(p["loss"]):
        raise AssertionError(f"train_check: loss {k['loss']} vs plain {p['loss']}")
    if not abs(k["grad_norm"] - p["grad_norm"]) <= 1e-4 * abs(p["grad_norm"]):
        raise AssertionError(f"train_check: grad_norm {k['grad_norm']} vs plain {p['grad_norm']}")
    missing = [n for n, nz in p["nonzero"].items() if nz and not k["nonzero"][n]]
    if missing:
        raise AssertionError(f"train_check: no gradient through the kernels for {missing[:5]} ({len(missing)})")
    moved = params_within("train_check", k["params"], p["params"], p["lr"])
    attn1 = {n: (k["attn1"][n] - g).abs().max().item() / g.abs().max().item() for n, g in p["attn1"].items()}
    checks = {"from_step": p["from_step"], "lr": p["lr"], "t": t.tolist(),
              "loss": {"kernels": k["loss"], "plain": p["loss"]},
              "grad_norm": {"kernels": k["grad_norm"], "plain": p["grad_norm"]},
              "params": moved, "params_with_grad": sum(p["nonzero"].values()), "params_total": len(params),
              "attn1_projections": len(attn1), "attn1_grad_max_rel_err": max(attn1.values()),
              "seconds": {"kernels": k["seconds"], "plain": p["seconds"]},
              "peak_mem_gb": {"kernels": k["peak_mem_gb"], "plain": p["peak_mem_gb"]},
              "restore_s": [k["restore_s"], p["restore_s"]], "launches": k["launches"]}
    del runs, k, p
    step.optimizer.zero_grad(set_to_none=True)

    gen = torch.Generator(device="cuda").manual_seed(6)
    grads = []
    for name, shape, dtype in GRAD_CASES:
        q, k_, v, g = (torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype)) for _ in range(4))
        q, k_, v = (x.requires_grad_() for x in (q, k_, v))
        out_f = fa.FlashAttention.apply(getattr(fa, f"flash_attention_{name}"), q, k_, v, None)
        out_p = attn.plain_attention(q, k_, v)
        got = torch.autograd.grad(out_f, (q, k_, v), g, retain_graph=True)
        ref = torch.autograd.grad(out_p, (q, k_, v), g, retain_graph=True)
        bound = 2e-2 if dtype == "bfloat16" else 1e-4
        row = {"kernel": name, "shape": list(shape), "dtype": dtype, "bound": bound}
        for which, a, b in zip(("dq", "dk", "dv"), got, ref):
            err, scale = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
            if not (a.isfinite().all() and err <= bound * scale):
                raise AssertionError(f"train_check: {name} {shape} {dtype} {which} err {err} > {bound} * {scale}")
            row[which] = {"max_abs_err": err, "scale": scale}
        row["backward_ms"] = cuda_ms(lambda: torch.autograd.grad(out_f, (q, k_, v), g, retain_graph=True), 3, warmup=1)
        row["plain_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(out_p, (q, k_, v), g, retain_graph=True), 3,
                                           warmup=1)
        grads.append(row)
        del q, k_, v, g, out_f, out_p, got, ref
    log({"phase": "train_check", **checks, "function_grads": grads, "card": smi})


# ---- the W8A8 serving mode (ops/quant.py): int8 products, the fast preset, the int8 probe

W8A8_DRIFT = {"corr": 0.99, "rel_rms": 0.1}  # JAX's bounds for a quantized UNet (tests/test_quant.py)
W8A8_DEPTH_CORR = 0.95  # JAX's bound for the W8A8 pipeline's depth against the float one's
W8A8_TP_WINDOWS = 4  # the (2, 2) mesh's W8A8 UNet chunk: 2 windows a dp rank


def w8a8_phase(torch, attn, fa, gn, pipe, frames, ref_out, ref_s, ref_launches, smi, norms: dict, seen: dict) -> dict:
    """(a) The int8 GEMM and convolution of ``ops/quant.py`` on the card, at
    an SD2 shape each (one window of the level-0 GEGLU projection; the
    level-0 3x3 conv on one window), bit for bit against the exact product
    of the same int8 operands on the CPU (float64, exact at these sums).
    (b) The fast preset with the UNet quantized (a copy of ``pipe``'s): one
    UNet chunk against the bf16 UNet within JAX's drift bounds, the depth's
    drift against ``ref_out`` (same frames, same noise) logged, the K1/K3
    launches equal to the bf16 call's, its time beside ``ref_s``.  (c) The
    int8 probe's slim set (``tools/bench_int8.py``).  Returns the parallel
    phase's W8A8 reference: the quantized UNet on each dp block of a chunk."""
    import copy

    import torch.nn.functional as F

    from rollingdepth_torch.ops.quant import int8_conv_chunks, int8_matmul, quantize_unet_
    from rollingdepth_torch.pipelines.rollingdepth import RollingDepthPipeline
    from rollingdepth_torch.tools import bench_int8
    from rollingdepth_torch.utils.synthetic import FAST_PRESET

    gen = torch.Generator(device="cuda").manual_seed(3)

    def int8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    # (a)
    a, w = int8((3 * 54 * 96, 320)), int8((2 * 1280, 320))
    got = int8_matmul(a, w)
    torch.cuda.synchronize()
    exact = (a.cpu().double() @ w.cpu().double().t()).long()
    x, k = int8((3, 54, 96, 320)), int8((320, 320, 3, 3))
    got_c = torch.cat([acc for _, acc in int8_conv_chunks(x, k, 1, 1)])
    exact_c = F.conv2d(x.cpu().double().permute(0, 3, 1, 2), k.cpu().double(), padding=1).permute(0, 2, 3, 1).long()
    products = {"gemm": {"shape": [a.shape[0], a.shape[1], w.shape[0]], "dtype": str(got.dtype),
                         "bit_equal": bool(torch.equal(got.cpu().long(), exact))},
                "conv": {"shape": list(x.shape) + [k.shape[0]], "dtype": str(got_c.dtype),
                         "bit_equal": bool(torch.equal(got_c.cpu().long(), exact_c))}}
    if not all(v["bit_equal"] and v["dtype"] == "torch.int32" for v in products.values()):
        raise AssertionError(f"w8a8: int8 products on the card differ from the exact product: {products}")
    del a, w, got, x, k, got_c

    # (b)
    t0 = time.perf_counter()
    qunet = quantize_unet_(copy.deepcopy(pipe.unet))
    qpipe = RollingDepthPipeline(qunet, pipe.vae, pipe.scheduler, pipe.empty_text_embed, dtype=pipe.dtype,
                                 snippet_batch=pipe.snippet_batch, device="cuda")
    setup_s = time.perf_counter() - t0
    with torch.no_grad():
        xu = torch.randn((8, 3, 54, 96, 8), generator=gen, device="cuda").to(pipe.dtype)
        chunk = depth_drift(qunet(xu, 999, pipe.empty_text_embed), pipe.unet(xu, 999, pipe.empty_text_embed))
        half = W8A8_TP_WINDOWS // PARALLEL_MESH[0]
        par_ref = {"w8a8_x": xu[:W8A8_TP_WINDOWS].cpu(), "empty_text_embed": pipe.empty_text_embed.cpu(),
                   "w8a8_unet": torch.cat([qunet(xu[i : i + half], 999, pipe.empty_text_embed)
                                           for i in range(0, W8A8_TP_WINDOWS, half)]).cpu()}
    if not (chunk["finite"] and chunk["corr"] > W8A8_DRIFT["corr"] and chunk["rel_rms"] < W8A8_DRIFT["rel_rms"]):
        raise AssertionError(f"w8a8: quantized UNet chunk drifts beyond {W8A8_DRIFT}: {chunk}")
    t0 = time.perf_counter()
    qpipe(input_frames=frames[:12], **FAST_PRESET)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.perf_counter()
    out_q = qpipe(input_frames=frames, verbose=True, **FAST_PRESET)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    chunks = dict(qpipe.last_chunks)
    check_depth("w8a8", out_q, ref_out.depth_pred.shape)
    lat_hw = (frames.shape[2] // 8, frames.shape[3] // 8)
    want = attention_kernel_launches(attn, qpipe, chunks, lat_hw, 3, 3, "flash_attention_nomax")
    if launches != want or launches != ref_launches:
        raise AssertionError(f"w8a8: launches {launches} != {want} implied by chunks {chunks}, "
                             f"or != the bf16 call's {ref_launches}")
    norms["w8a8"] = held_norm_counts("w8a8", gn, qpipe, chunks, seen)
    depth = depth_drift(out_q.depth_pred, ref_out.depth_pred)
    if not (depth["finite"] and depth["corr"] > W8A8_DEPTH_CORR):
        raise AssertionError(f"w8a8: depth {depth} against the bf16 call's, bound corr > {W8A8_DEPTH_CORR}")
    n = frames.shape[0]
    log({"phase": "w8a8", "products": products, "unet_chunk_vs_bf16": chunk, "bounds": W8A8_DRIFT,
         "depth_vs_bf16": depth, "depth_corr_bound": W8A8_DEPTH_CORR, "frames": n,
         "res": list(frames.shape[2:]), "setup_s": setup_s, "warmup_12_frames_s": warm_s, "total_s": total_s,
         "fps": n / total_s, "bf16_total_s": ref_s, "bf16_fps": n / ref_s, "timings_s": qpipe.last_timings,
         "chunks": chunks, "launches": launches, "norm_launches": norms["w8a8"], "card": smi})
    del qpipe, qunet, out_q, xu
    _free_card(torch)

    # (c)
    t0 = time.perf_counter()
    rows = bench_int8.sweep(full=False, iters=5, verbose=False)
    log({"phase": "w8a8_int8_probe", "rows": rows, "seconds": time.perf_counter() - t0, "card": smi})
    return par_ref


# ---- the parallel phase: ranks of a (dp, tp) mesh, all on the one card, over gloo

PARALLEL_MESH = (2, 2)
PARALLEL_FRAMES = 12  # fast preset windows: 10 at dilation 1, 2 at dilation 25 capped to 5
RELIGHT_MESH = (2, 1)
RANK_TIMEOUT = 300  # seconds a spawn of ranks may take in all; a failed or hung rank ends it sooner
# four ranks peak at ~14.1 GiB each in the train step (PERF.md); what this process may keep
PARENT_RESERVED_GB = 4.0
PAR_TRAIN_FRAMES, PAR_TRAIN_RES = 6, (256, 320)
# windows of 3 at dilation 1 on 6 frames: one global batch of 4 snippets
PAR_TRAIN_DATA = dict(snippet_len=3, dilations=(1,), cap_dilation=False, batch_size=4, seed=0)
# (d)'s parameters against one process's after the step: sound runs read
# 1.78e-6, an update skipped on one shard about lr = 3e-5 (PERF.md)
PAR_PARAMS_TOL = 1e-5


def _free_card(torch) -> dict:
    """Free what this process holds cached on the card, cuBLAS's workspaces
    too (a live block pins its whole cached segment); returns what it still
    holds and the card's memory in use (all processes)."""
    import gc

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()  # cuBLAS keeps its workspaces in the caching allocator
    torch.cuda.empty_cache()
    used = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.strip()
    return {"allocated_gb": torch.cuda.memory_allocated() / 2**30, "reserved_gb": torch.cuda.memory_reserved() / 2**30,
            "card_used_mib": used}


def _max_err(torch, got, ref) -> dict:
    got, ref = torch.as_tensor(got).float().cpu(), torch.as_tensor(ref).float().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(ref.shape)}")
    return {"max_abs_err": (got - ref).abs().max().item(), "scale": ref.abs().max().item(),
            "finite": bool(got.isfinite().all())}


def parallel_depth_train_rank(rank: int, spec_path: str, params_path: str) -> dict:
    """One rank of the (2, 2) mesh: (e) one W8A8 UNet chunk, (a) the fast
    preset at full SD2 width on 12 frames in bf16 and in fp32 (solves cut to
    0 steps) with (b) its launches, then (d) one fp32 train step; each
    against the single-process results in ``spec_path`` and ``params_path``."""
    import torch
    import torch.distributed as dist

    from rollingdepth_torch.ops import attention as attn
    from rollingdepth_torch.ops import flash_attention as fa
    from rollingdepth_torch.ops import group_norm as gn
    from rollingdepth_torch.parallel.mesh import axis, make_mesh
    from rollingdepth_torch.models.layers import init_random_
    from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
    from rollingdepth_torch.ops import quant
    from rollingdepth_torch.parallel.sharding import shard_tensor, shard_unet_, unet_param_sharding
    from rollingdepth_torch.training import TrainConfig, make_train_step, step_seconds
    from rollingdepth_torch.utils.synthetic import FAST_PRESET, random_depth_pipeline, random_training_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(PARALLEL_MESH, "cuda")
    tp, tp_rank, _ = axis(mesh, "tp")
    out = {"rank": rank, "backend": dist.get_backend(), "device": torch.cuda.current_device(),
           "dp": axis(mesh, "dp")[:2], "tp": (tp, tp_rank)}
    # (e) one W8A8 UNet chunk: random_depth_pipeline's UNet (its first draw
    # from the seed), quantized, then sharded; this dp rank's block of the windows
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    unet = init_random_(UNet2DConditionModel(UNetConfig.sd21(), device="cuda"), gen).to(torch.bfloat16).eval()
    shard_unet_(quant.quantize_unet_(unet), mesh)
    dp, dp_rank, _ = axis(mesh, "dp")
    block = spec["w8a8_x"].chunk(dp)[dp_rank].cuda()
    with torch.no_grad():
        got = unet(block, 999, spec["empty_text_embed"].cuda())
    want = spec["w8a8_unet"].chunk(dp)[dp_rank]
    out["w8a8_unet"] = dict(depth_drift(got, want), bit_equal=bool(torch.equal(got.cpu(), want)),
                            seconds=time.perf_counter() - t0)
    # the planted fault the check must catch: each row-parallel shard scales
    # its activation by its own abs-max (no MAX all-reduce over tp)
    orig = quant.quantize_activation
    quant.quantize_activation = lambda t, group=None: orig(t)
    try:
        with torch.no_grad():
            local = unet(block, 999, spec["empty_text_embed"].cuda())
    finally:
        quant.quantize_activation = orig
    out["w8a8_unet_local_absmax"] = dict(depth_drift(local, want), bit_equal=bool(torch.equal(local.cpu(), want)))
    del unet, block, got, local
    _free_card(torch)

    frames = spec["frames"].cuda()
    lat_hw = (frames.shape[2] // 8, frames.shape[3] // 8)
    no_solve = dict(FAST_PRESET, latent_coalign_kwargs={"num_iterations": 0}, coalign_kwargs={"num_iterations": 0})
    for dtype, kw in ((torch.bfloat16, FAST_PRESET), (torch.float32, no_solve)):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        pipe, bound = random_depth_pipeline("cuda", dtype, seed=0, mesh=mesh)
        fa.reset_launch_counts()
        gn.reset_launch_counts()
        t1 = time.perf_counter()
        o = pipe(input_frames=frames, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        chunks = dict(pipe.last_chunks)
        res = {"launches": {fn.__name__: fn.launches for fn in fa.KERNELS},
               "want": attention_kernel_launches(attn, pipe, chunks, lat_hw, 3, 3, "flash_attention_nomax", tp=tp),
               "chunks": chunks, "local_heads": [c[2] for c in kernel_calls(attn, pipe.unet.config, 3, *lat_hw, tp)],
               "norms": gn.group_norm.launches,  # bf16: the pair on every norm; fp32: F.group_norm
               "norms_want": norm_kernel_launches(pipe, chunks) if dtype == torch.bfloat16 else 0,
               "norm_inputs": list(gn.group_norm.inputs.items()),  # (input, launches) pairs: JSON-safe
               "score_bound": bound, "nomax_allowed": attn.nomax_allowed(),
               "windows": _max_err(torch, torch.cat(pipe.last_window_latents), spec[f"{name}_windows"]),
               "setup_s": t1 - t0, "call_s": t2 - t1}
        if dtype == torch.float32:
            res["depth"] = _max_err(torch, o.depth_pred, spec["float32_depth"])
        out[name] = res
        del pipe, o
        _free_card(torch)

    # (d) one fp32 train step of the global batch, this rank's dp block of it
    t0 = time.perf_counter()
    setup = random_training_setup("cuda", seed=0, clips=1, frames=PAR_TRAIN_FRAMES, res=PAR_TRAIN_RES, mesh=mesh)
    unet, sched = setup.unet, setup.scheduler
    del setup
    out["memory_before_step"] = _free_card(torch)
    step = make_train_step(unet, sched, TrainConfig(), mesh=mesh)
    split = unet_param_sharding(unet, mesh)
    # a planted fault for the parameter bound: this rank's shard of one split
    # parameter as if its update had been skipped
    planted = next(n for n, d in split.items() if d is not None)
    planted_before = dict(unet.named_parameters())[planted].detach().clone()
    batch = {k: v.cuda() for k, v in spec["train_batch"].items()}
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    m = step(batch, timesteps=spec["train_t"].cuda(), noise=spec["train_noise"].cuda())
    seconds = step_seconds(m)
    t2 = time.perf_counter()
    ref = torch.load(params_path, mmap=True, weights_only=True)
    diffs = {}
    for n, p in unet.named_parameters():
        want = ref[n] if split[n] is None else shard_tensor(n, ref[n], split[n], tp_rank, tp)
        diffs[n] = (p.detach() - want.to(p.device)).abs().max().item()
        if n == planted:
            skipped = (planted_before - want.to(p.device)).abs().max().item()
    worst = max(diffs, key=diffs.get)
    out["train"] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lr": m["lr"],
                    "params_max_abs_diff": diffs[worst], "param": worst,
                    "skipped_update": {"param": planted, "max_abs_diff": skipped}, "params_sharded": sum(
                        d is not None for d in split.values()),
                    "local_params": sum(p.numel() for p in unet.parameters()), "step_seconds": seconds,
                    "setup_s": t1 - t0, "step_s": t2 - t1, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                    "peak_reserved_gb": torch.cuda.max_memory_reserved() / 2**30}
    return out


def parallel_relight_rank(rank: int, spec_path: str) -> dict:
    """One rank of the (2, 1) mesh: (c) the relight call on 6 frames at
    720x640 in bf16 with the solves cut to 0 steps, against one process."""
    import torch
    import torch.distributed as dist

    from rollingdepth_torch.ops import attention as attn
    from rollingdepth_torch.ops import flash_attention as fa
    from rollingdepth_torch.ops import group_norm as gn
    from rollingdepth_torch.parallel.mesh import axis, make_mesh
    from rollingdepth_torch.utils.synthetic import random_relight_pipeline

    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(RELIGHT_MESH, "cuda")
    t0 = time.perf_counter()
    pipe, _ = random_relight_pipeline("cuda", torch.bfloat16, seed=0, mesh=mesh)
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    t1 = time.perf_counter()
    o = pipe.forward(spec["fg"].cuda(), spec["bg"].cuda(), **spec["call"])
    torch.cuda.synchronize()
    rgb = np.concatenate([o.R_pred, o.G_pred, o.B_pred], axis=1)
    chunks = dict(pipe.last_chunks)
    lat_hw = (spec["fg"].shape[2] // 8, spec["fg"].shape[3] // 8)
    return {"rank": rank, "backend": dist.get_backend(), "dp": axis(mesh, "dp")[:2], "chunks": chunks,
            "launches": {fn.__name__: fn.launches for fn in fa.KERNELS},
            "want": relight_kernel_launches(attn, pipe, chunks, lat_hw, 3, "flash_attention_nomax"),
            "norms": gn.group_norm.launches, "norms_want": norm_kernel_launches(pipe, chunks),
            "norm_inputs": list(gn.group_norm.inputs.items()),  # (input, launches) pairs: JSON-safe
            "windows": [_max_err(torch, g, r) for g, r in zip(o.snippet_ls, spec["snippet_ls"])],
            "rgb": _max_err(torch, rgb, spec["rgb"]), "setup_s": t1 - t0, "call_s": time.perf_counter() - t1}


def parallel_phase(torch, smi, refs: dict, tmp: str) -> dict:
    """Ranks on the one card over gloo, each against one process: (a) and
    (b) on a (2, 2) mesh of 4 ranks with (d) in the same ranks, (c) on a
    (2, 1) mesh of 2 ranks.  ``refs``: the single-process results the earlier
    phases kept.  Returns the ranks' launches by check."""
    from rollingdepth_torch.parallel.launch import run_ranks
    from rollingdepth_torch.training import TrainConfig, make_train_step
    from rollingdepth_torch.training_data import SnippetDataConfig, SnippetLatentDataset, vae_encode_fn
    from rollingdepth_torch.utils.synthetic import random_training_setup

    t0 = time.perf_counter()
    # (d)'s reference: the single-process step on the global batch, then the card is freed
    setup = random_training_setup("cuda", seed=0, clips=1, frames=PAR_TRAIN_FRAMES, res=PAR_TRAIN_RES)
    data = SnippetLatentDataset(vae_encode_fn(setup.vae, 4), setup.rgb_clips, setup.depth_clips,
                                SnippetDataConfig(**PAR_TRAIN_DATA), device="cuda")
    batch = dict(next(iter(data.epoch(0))), text_embed=setup.text_embed)
    gen = torch.Generator(device="cuda").manual_seed(7)
    t = torch.randint(0, setup.scheduler.config.num_train_timesteps, (PAR_TRAIN_DATA["batch_size"],),
                      generator=gen, device="cuda")
    noise = torch.randn(batch["depth_latent"].shape, generator=gen, device="cuda")
    m = make_train_step(setup.unet, setup.scheduler, TrainConfig())(batch, timesteps=t, noise=noise)
    single = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "lr": m["lr"]}
    spec_path, params_path, relight_path = (os.path.join(tmp, f) for f in ("par.pt", "params.pt", "relight.pt"))
    torch.save({n: p.detach().cpu() for n, p in setup.unet.named_parameters()}, params_path)
    torch.save(dict(refs["depth"], train_batch={k: v.detach().cpu() for k, v in batch.items()}, train_t=t.cpu(),
                    train_noise=noise.cpu()), spec_path)
    torch.save(refs["relight"], relight_path)
    del setup, data, batch, m, t, noise
    parent = _free_card(torch)
    log({"phase": "parallel_references", "train_single": single, "seconds": time.perf_counter() - t0,
         "parent_memory_at_spawn": parent})
    if parent["reserved_gb"] > PARENT_RESERVED_GB:
        segments = sorted(((seg["total_size"], [b["size"] for b in seg["blocks"] if b["state"] == "active_allocated"])
                           for seg in torch.cuda.memory_snapshot()), reverse=True)[:8]
        raise AssertionError(f"parallel: this process still holds {parent['reserved_gb']:.1f} GiB of the card; "
                             f"the ranks need it.  Largest segments (bytes, live blocks): {segments}")

    # the ranks' allocators grow segments in place: less of the card lost to fragments
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_depth_train_rank, 4, args=(spec_path, params_path), timeout=RANK_TIMEOUT)
        depth_train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        relight = run_ranks(parallel_relight_rank, 2, args=(relight_path,), timeout=RANK_TIMEOUT)
        relight_s = time.perf_counter() - t0
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf

    for r in ranks:
        for name, max_rel in (("bfloat16", 2e-2), ("float32", 1e-4)):
            res = r[name]
            if res["launches"] != res["want"] or res["norms"] != res["norms_want"]:
                raise AssertionError(f"parallel rank {r['rank']} {name}: launches {res['launches']} != {res['want']} "
                                     f"or GroupNorm {res['norms']} != {res['norms_want']}, from chunks {res['chunks']}")
            w = res["windows"]
            if not (w["finite"] and w["max_abs_err"] <= max_rel * w["scale"]):
                raise AssertionError(f"parallel rank {r['rank']} {name}: windows {w} beyond {max_rel} of the scale")
        # int32 sums are exact, so the sharded chunk is one process's bit for bit
        q, planted = r["w8a8_unet"], r["w8a8_unet_local_absmax"]
        if not (q["finite"] and q["bit_equal"]) or planted["bit_equal"]:
            raise AssertionError(f"parallel rank {r['rank']}: W8A8 UNet chunk {q} not bit-equal to one process, "
                                 f"or the planted local abs-max {planted} passes")
        d = r["float32"]["depth"]
        if not (d["finite"] and d["max_abs_err"] <= 1e-3):
            raise AssertionError(f"parallel rank {r['rank']} fp32 depth {d} beyond 1e-3")
        tr = r["train"]
        if not abs(tr["loss"] - single["loss"]) <= 1e-5 * abs(single["loss"]):
            raise AssertionError(f"parallel rank {r['rank']}: loss {tr['loss']} vs one process {single['loss']}")
        if not abs(tr["grad_norm"] - single["grad_norm"]) <= 1e-4 * abs(single["grad_norm"]):
            raise AssertionError(f"parallel rank {r['rank']}: grad_norm {tr['grad_norm']} vs {single['grad_norm']}")
        skipped = tr["skipped_update"]["max_abs_diff"]
        if not tr["params_max_abs_diff"] <= PAR_PARAMS_TOL < skipped:
            raise AssertionError(f"parallel rank {r['rank']}: {tr['param']} moved apart by {tr['params_max_abs_diff']}"
                                 f", a skipped update by {skipped}; bound {PAR_PARAMS_TOL}")
    for r in relight:
        if r["launches"] != r["want"] or r["norms"] != r["norms_want"]:
            raise AssertionError(f"parallel relight rank {r['rank']}: launches {r['launches']} != {r['want']} "
                                 f"or GroupNorm {r['norms']} != {r['norms_want']}, from chunks {r['chunks']}")
        for w in r["windows"] + [r["rgb"]]:
            if not (w["finite"] and w["max_abs_err"] <= 2e-2 * w["scale"]):
                raise AssertionError(f"parallel relight rank {r['rank']}: {w} beyond 2e-2 of the scale")
    log({"phase": "parallel", "mesh": list(PARALLEL_MESH), "relight_mesh": list(RELIGHT_MESH),
         "backend": sorted({r["backend"] for r in ranks + relight}), "frames": PARALLEL_FRAMES,
         "train_single": single, "ranks": ranks, "relight_ranks": relight,
         "seconds": {"depth_train_ranks": depth_train_s, "relight_ranks": relight_s},
         "card": smi})
    launches = {}
    for check, rs in (("bfloat16", ranks), ("float32", ranks)):
        launches[check] = [r[check]["launches"] for r in rs]
    launches["relight"] = [r["launches"] for r in relight]
    launches["norms"] = [r["bfloat16"]["norms"] for r in ranks]
    launches["relight_norms"] = [r["norms"] for r in relight]
    # the inputs the ranks gave the pair, launches summed over the ranks
    launches["norm_inputs"] = {path: {} for path in ("parallel_ranks", "parallel_relight_ranks")}
    for path, results in (("parallel_ranks", [r["bfloat16"] for r in ranks]), ("parallel_relight_ranks", relight)):
        for r in results:
            for key, launched in r["norm_inputs"]:
                launches["norm_inputs"][path][key] = launches["norm_inputs"][path].get(key, 0) + launched
    return launches


FULL_RES = (3, 576, 1024)  # the full preset's res 1024, 16:9
PAPER_FRAMES = 51  # 3 frames at dilation 25 span 51
PAPER_RES = (3, 432, 768)  # the paper preset's res 768, 16:9


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port on one card and hold its kernels and paths.")
    parser.add_argument("--measure-repeats", action="store_true",
                        help="log how each repeat pair differs and go on (to measure a tree whose runs differ); "
                             "the script then exits 1 at its end, without its last line, if any pair differed")
    args = parser.parse_args(argv)
    measure_only = args.measure_repeats
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    from rollingdepth_torch.aligner import AlignerConfig, DepthAligner
    from rollingdepth_torch.ops import _build
    from rollingdepth_torch.ops import attention as attn
    from rollingdepth_torch.ops import conv3x3 as conv
    from rollingdepth_torch.ops import flash_attention as fa
    from rollingdepth_torch.ops import flash_variants as fv
    from rollingdepth_torch.ops import group_norm as gn
    from rollingdepth_torch.pipelines.snippets import snippet_index_matrix
    from rollingdepth_torch.tools import bench_flash_variants as bench
    from rollingdepth_torch.tools import multihost_demo as demo_mod
    from rollingdepth_torch.utils.device import card_name
    from rollingdepth_torch.utils.synthetic import FAST_PRESET, FULL_PRESET, PAPER_PRESET, random_depth_pipeline

    smi = card_name()
    log(smi)
    # fp32 references run in full fp32: TF32 off for matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32}
    log({"phase": "env", **card})

    t0 = time.perf_counter()
    _build.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": _build.build_seconds})

    rows = kernel_phase(torch, fa)
    t0 = time.perf_counter()
    conv_rows, conv_launches = conv_phase(torch, conv)
    t1 = time.perf_counter()
    variant_rows, variant_launches = variants_phase(torch, fv, bench)
    log({"phase": "slice2_seconds", "conv": t1 - t0, "variants": time.perf_counter() - t1})

    # ---- main path at full SD2 width
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    pipe, bound = random_depth_pipeline("cuda", dtype, seed=0)
    n_params = sum(p.numel() for p in pipe.unet.parameters())
    if not attn.nomax_allowed():
        raise AssertionError(f"score probe closed the gate on healthy random weights (bound {bound})")
    torch.cuda.synchronize()
    log({"phase": "setup", "seconds": time.perf_counter() - t0, "unet_params": n_params, "score_bound": bound})

    gen = torch.Generator(device="cuda").manual_seed(1)
    n_frames, height, width = 60, 432, 768
    frames = torch.randint(0, 256, (n_frames, 3, height, width), generator=gen, device="cuda", dtype=torch.uint8)
    fast = FAST_PRESET

    t0 = time.perf_counter()
    with solve_probe() as warm_probe:
        warm = pipe(input_frames=frames, verbose=True, **fast).depth_pred
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_coalign = pipe.last_timings["coalign"]

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.perf_counter()
    with solve_probe() as fast_probe:
        out = pipe(input_frames=frames, verbose=True, **fast)
        torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNELS}
    chunks = dict(pipe.last_chunks)
    check_depth("main", out, (n_frames, 1, height, width))
    lat_hw = (height // 8, width // 8)
    want = attention_kernel_launches(attn, pipe, chunks, lat_hw, 3, 3, "flash_attention_nomax")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} implied by chunks {chunks}")
    if any(cut_counts(fa).values()):  # SD2's heads are all d = 64: none runs narrower
        raise AssertionError(f"main: cut launches {cut_counts(fa)}, want none")
    seen = {}  # path -> the inputs its counted call gave the GroupNorm pair
    norms = {"main": held_norm_counts("main", gn, pipe, chunks, seen)}
    log({"phase": "main", "frames": n_frames, "res": [height, width], "warmup_s": warm_s, "total_s": total_s,
         "fps": n_frames / total_s, "timings_s": pipe.last_timings, "chunks": chunks, "launches": launches,
         "norm_launches": norms["main"],
         "solve_launches": [warm_probe["launches"], fast_probe["launches"]],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    held_equal("fast", warm, out.depth_pred, 0.0, measure_only,  # the warm-up is the same call
               coalign_s=[warm_coalign, pipe.last_timings["coalign"]])
    del warm
    # the latent solve: one launch in the warm-up and one in the timed call
    if warm_probe["launches"] != 1:
        raise AssertionError(f"fast: the warm-up's solve took {warm_probe['launches']} kernel launches, not 1")
    solve_kernel_check(torch, "fast", fast_probe, smi)
    del warm_probe, fast_probe
    coalign_idle_share(torch, lambda: pipe(input_frames=frames, **fast), smi)

    # ---- the W8A8 serving mode on the same frames and noise
    t0 = time.perf_counter()
    w8a8_ref = w8a8_phase(torch, attn, fa, gn, pipe, frames, out, total_s, launches, smi, norms, seen)
    log({"phase": "w8a8_seconds", "seconds": time.perf_counter() - t0})

    # ---- the same path with the max-free gate closed: the running-max kernel
    attn.set_nomax_allowed(False)
    try:
        fa.reset_launch_counts()
        gn.reset_launch_counts()
        out_g = pipe(input_frames=frames[:12], **fast)
        torch.cuda.synchronize()
        launches_g = {fn.__name__: fn.launches for fn in fa.KERNELS}
        chunks_g = dict(pipe.last_chunks)
    finally:
        attn.set_nomax_allowed(True)
    norms["gate_closed"] = held_norm_counts("gate_closed", gn, pipe, chunks_g, seen)
    want_g = attention_kernel_launches(attn, pipe, chunks_g, lat_hw, 3, 3, "flash_attention_max")
    if launches_g != want_g or not torch.isfinite(torch.from_numpy(out_g.depth_pred)).all():
        raise AssertionError(f"gate-closed launches {launches_g} != {want_g}, or non-finite depth")
    log({"phase": "gate_closed", "frames": 12, "chunks": chunks_g, "launches": launches_g})

    # ---- the full preset: res 1024, latent merge, 10 refine steps
    full_frames = torch.randint(0, 256, (n_frames,) + FULL_RES, generator=gen, device="cuda", dtype=torch.uint8)
    t0 = time.perf_counter()
    warm = pipe(input_frames=full_frames[:12], verbose=True, **FULL_PRESET).depth_pred
    torch.cuda.synchronize()
    warm_full_s = time.perf_counter() - t0
    warm_coalign = pipe.last_timings["coalign"]
    t0 = time.perf_counter()
    again = pipe(input_frames=full_frames[:12], verbose=True, **FULL_PRESET).depth_pred
    held_equal("full_12_frames", warm, again, time.perf_counter() - t0, measure_only,
               coalign_s=[warm_coalign, pipe.last_timings["coalign"]])
    del warm, again
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.perf_counter()
    out_f = pipe(input_frames=full_frames, verbose=True, **FULL_PRESET)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    launches_f = {fn.__name__: fn.launches for fn in fa.KERNELS}
    chunks_f = dict(pipe.last_chunks)
    check_depth("full", out_f, (n_frames, 1) + FULL_RES[1:])
    want_f = attention_kernel_launches(attn, pipe, chunks_f, (FULL_RES[1] // 8, FULL_RES[2] // 8),
                                       FULL_PRESET["snippet_lengths"][0], FULL_PRESET["refine_snippet_len"],
                                       "flash_attention_nomax")
    if launches_f != want_f:
        raise AssertionError(f"full: launches {launches_f} != {want_f} implied by chunks {chunks_f}")
    if any(cut_counts(fa).values()):
        raise AssertionError(f"full: cut launches {cut_counts(fa)}, want none")
    norms["full"] = held_norm_counts("full", gn, pipe, chunks_f, seen)
    log({"phase": "full", "frames": n_frames, "res": list(FULL_RES[1:]), "warmup_frames": 12,
         "warmup_s": warm_full_s, "total_s": full_s, "fps": n_frames / full_s, "timings_s": pipe.last_timings,
         "chunks": chunks_f, "launches": launches_f, "norm_launches": norms["full"],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    del full_frames, out_f

    # ---- kernels against the plain attention path: one UNet chunk and one
    # VAE decode chunk at the main path's shapes (bf16), then the whole path
    # on 12 frames in fp32 and, as a measurement only, in bf16
    with torch.no_grad():
        x = torch.randn((8, 3, 54, 96, 8), generator=gen, device="cuda").to(dtype)
        z = torch.randn((4, 54, 96, 4), generator=gen, device="cuda").to(dtype)
        u_k, d_k = pipe.unet(x, 999, pipe.empty_text_embed), pipe.vae.decode(z)
        with plain_attention():
            u_p, d_p = pipe.unet(x, 999, pipe.empty_text_embed), pipe.vae.decode(z)
            depth_p = pipe(input_frames=frames[:12], **fast).depth_pred
        # the parallel phase's reference (a) in bf16: the windows of the same call with the kernels
        pipe(input_frames=frames[:12], **fast)
        par_refs = {"frames": frames[:12].cpu(), "bfloat16_windows": torch.cat(pipe.last_window_latents).cpu(),
                    **w8a8_ref}
    checks = {}
    for name, a, b in (("unet_chunk", u_k, u_p), ("vae_decode_chunk", d_k, d_p)):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        checks[name] = {"max_abs_err": err, "scale": scale}
        # bf16 activations through the whole model: 5e-2 of the output scale
        if not err <= 5e-2 * scale:
            raise AssertionError(f"{name}: kernels vs plain attention max err {err} > 5e-2 * {scale}")
    # a live tensor pins its whole cached segment, which the parallel phase's ranks need
    del x, z, u_k, d_k, u_p, d_p
    # bf16 rounding differences pass through 2000 L1 Adam steps and a
    # random-weight decoder; no bound of their own, so this is logged only
    checks["depth_bf16_12_frames"] = depth_drift(out_g.depth_pred, depth_p)
    del pipe, out, out_g
    # fp32 with the co-alignment solve cut to 0 steps: the L1 Adam solve
    # turns any difference in its input, fp32 rounding included, into steps
    # of lr (on an H100, mean |depth error| 2e-3 and 3e-2 after 2000 steps in
    # two runs on the same seeds), so the comparison that isolates the kernels stops
    # before it.  Bound: 10x the 1e-4 that tests/test_torch_pipeline.py holds
    # the port to against JAX at one step, for the full-width model's depth
    pipe32, _ = random_depth_pipeline("cuda", torch.float32, seed=0)
    no_solve = dict(fast, latent_coalign_kwargs={"num_iterations": 0}, coalign_kwargs={"num_iterations": 0})
    refine_cases = (  # the refine path after each merge, two steps
        ("depth_fp32_12_frames_no_solve", no_solve),
        ("refine_turbo_latent_fp32_12_frames_no_solve",
         dict(no_solve, refine_step=2, merge_in_latent=True, turbo_refine=True)),
        ("refine_stride1_exact_fp32_12_frames_no_solve",
         dict(no_solve, refine_step=2, merge_in_latent=False, turbo_refine=False)),
    )
    for name, kw in refine_cases:
        depth_k = pipe32(input_frames=frames[:12], **kw).depth_pred
        if kw is no_solve:  # the parallel phase's reference (a) in fp32
            par_refs.update(float32_windows=torch.cat(pipe32.last_window_latents).cpu(),
                            float32_depth=torch.from_numpy(depth_k))
        with plain_attention():
            depth_p = pipe32(input_frames=frames[:12], **kw).depth_pred
        checks[name] = drift = dict(depth_drift(depth_k, depth_p), chunks=dict(pipe32.last_chunks))
        if not (drift["max_abs_err"] <= 1e-3 and drift["corr"] > 0.99999):
            raise AssertionError(f"{name}: fp32 depth with kernels vs plain attention: {drift}")
    log({"phase": "check", **checks})
    del frames

    # ---- the paper preset: fp32, exact merge, stride-1 refinement (the
    # check phase above has run this pipeline, so no warm-up of its own)
    paper_frames = torch.randint(0, 256, (PAPER_FRAMES,) + PAPER_RES, generator=gen, device="cuda",
                                 dtype=torch.uint8)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.perf_counter()
    with solve_probe() as paper_probe:
        out_p = pipe32(input_frames=paper_frames, verbose=True, **PAPER_PRESET)
        torch.cuda.synchronize()
    paper_s = time.perf_counter() - t0
    launches_p = {fn.__name__: fn.launches for fn in fa.KERNELS}
    chunks_p = dict(pipe32.last_chunks)
    check_depth("paper", out_p, (PAPER_FRAMES, 1) + PAPER_RES[1:])
    snippet_shapes = [list(g.shape) for g in out_p.snippet_ls]
    if [g[0] for g in snippet_shapes] != [PAPER_FRAMES - 2 * d for d in PAPER_PRESET["dilations"]]:
        raise AssertionError(f"paper: snippet_ls {snippet_shapes} for dilations {PAPER_PRESET['dilations']}")
    want_p = attention_kernel_launches(attn, pipe32, chunks_p, (PAPER_RES[1] // 8, PAPER_RES[2] // 8),
                                       PAPER_PRESET["snippet_lengths"][0], PAPER_PRESET["refine_snippet_len"],
                                       "flash_attention_nomax")
    if launches_p != want_p:
        raise AssertionError(f"paper: launches {launches_p} != {want_p} implied by chunks {chunks_p}")
    norms["paper"] = gn.group_norm.launches  # fp32: every norm on F.group_norm
    if norms["paper"] != 0:
        raise AssertionError(f"paper (fp32): GroupNorm counts {norms['paper']}, want none")
    log({"phase": "paper", "frames": PAPER_FRAMES, "res": list(PAPER_RES[1:]), "total_s": paper_s,
         "fps": PAPER_FRAMES / paper_s, "timings_s": pipe32.last_timings, "chunks": chunks_p,
         "launches": launches_p, "snippet_ls": snippet_shapes,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    # the depth-space solve (2000 steps) and the full-resolution merge, twice on the call's decoded windows
    t0 = time.perf_counter()
    dil_p = PAPER_PRESET["dilations"]
    idx_p = [snippet_index_matrix(PAPER_FRAMES, g.shape[1], d) for g, d in zip(out_p.snippet_ls, dil_p)]
    merged, solve_s = [], []
    for _ in range(2):
        t1 = time.perf_counter()
        merged.append(DepthAligner(AlignerConfig()).run(out_p.snippet_ls, dil_p, index_mats=idx_p,
                                                        seq_len=PAPER_FRAMES)[0])
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t1)
    held_equal("paper_solve", *merged, time.perf_counter() - t0, measure_only, coalign_s=solve_s)
    del merged
    solve_kernel_check(torch, "paper", paper_probe, smi)  # the depth-space solve, with the inverse term
    del pipe32, paper_frames, out_p, paper_probe

    # ---- the relight path at 720x640, full SD1.5 width
    t0 = time.perf_counter()
    launches_r, relight_ref, norms["relight"] = relight_phase(torch, attn, fa, gn, gen, smi, measure_only, seen)
    log({"phase": "relight_seconds", "seconds": time.perf_counter() - t0})

    # ---- the training path at full SD2 width, fp32, 480x640
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "train_state.pt")
        setup, data, train_step, launches_t = train_phase(torch, attn, fa, smi, ckpt)
        train_check_phase(torch, attn, fa, setup, data, train_step, smi, ckpt)
        del setup, data, train_step
    log({"phase": "train_seconds", "seconds": time.perf_counter() - t0})

    # ---- the sharded paths: ranks of a (dp, tp) mesh on this card, over gloo
    _free_card(torch)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches_par = parallel_phase(torch, smi, {"depth": par_refs, "relight": relight_ref}, tmp)
    log({"phase": "parallel_seconds", "seconds": time.perf_counter() - t0})

    # ---- the GroupNorm pair at every input the bf16 paths gave it, against its plain version
    norm_rows = group_norm_phase(torch, gn, {**seen, **launches_par["norm_inputs"]}, smi)

    # ---- the multihost demo on the card (its default): 2 workers, each clip bit for bit against one process
    t0 = time.perf_counter()
    demo = subprocess.run([sys.executable, "-m", "rollingdepth_torch.tools.multihost_demo"], capture_output=True,
                          text=True, timeout=600)
    result = json.loads(demo.stdout.strip().splitlines()[-1]) if demo.returncode == 0 else {}
    checked = result.get("numerics_check", [])
    if demo.returncode != 0:
        print(f"multihost demo: rc {demo.returncode}\n{demo.stderr[-4000:]}", file=sys.stderr)
    repeat_verdict({"path": "multihost_demo", "rc": demo.returncode, "clips": len(checked),
                    "elements": len(checked) * demo_mod.N_FRAMES * demo_mod.H * demo_mod.W,
                    "equal": bool(result.get("ok")) and len(checked) == demo_mod.N_CLIPS
                    and all(c["max_err_vs_single"] == 0.0 for c in checked),
                    "seconds_added": time.perf_counter() - t0}, measure_only)
    if REPEATS_DIFFERED:
        print(f"chip_smoke: two runs on the same inputs differed: {REPEATS_DIFFERED}", file=sys.stderr)
        return 1

    replaces = {
        "nomax": "rollingdepth_tpu/ops/flash_attention.py:103",
        "max": "rollingdepth_tpu/ops/flash_attention.py:44",
        "wide": "rollingdepth_tpu/ops/flash_attention.py:166",
    }
    counted = {"nomax": launches["flash_attention_nomax"], "max": launches_g["flash_attention_max"],
               "wide": launches["flash_attention_wide"]}
    # the parallel phase's launches per rank: (a) bf16 on the (2, 2) mesh, (c) relight on (2, 1)
    par = lambda check, name: [r[f"flash_attention_{name}"] for r in launches_par[check]]  # noqa: E731
    by_phase = {name: {"main": launches[f"flash_attention_{name}"], "gate_closed": launches_g[f"flash_attention_{name}"],
                       "full": launches_f[f"flash_attention_{name}"], "relight": launches_r[f"flash_attention_{name}"],
                       "parallel_ranks": par("bfloat16", name), "parallel_relight_ranks": par("relight", name)}
                for name in ("nomax", "max", "wide")}
    row_keys = ("shape", "L_k", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    relight_rows = {name: [{k: r[k] for k in row_keys} for r in rows["relight"] if r["name"] == name]
                    for name in ("nomax", "max", "wide")}
    tp_rows = {dtype: [{k: r[k] for k in row_keys} for r in rows["tp"] if r["dtype"] == dtype]
               for dtype in ("bfloat16", "float32")}
    flash_src, conv_src = "rollingdepth_torch/csrc/flash_attn.cu", "rollingdepth_torch/csrc/conv3x3.cu"

    def entry(name, tpu, source, replaces_at, launched, r, on_main_path, **extra):
        # every bf16 kernel: TMA tile loads and wgmma on the tensor cores
        return {"name": name, "tpu_kernel": tpu, "route": "cuda", "source": source, "replaces": replaces_at,
                "design": "tma+wgmma", "launches": launched, "on_main_path": on_main_path,
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["shape"], **extra}

    kernels = [entry(f"flash_attention_{name}", tpu, flash_src, replaces[name], counted[name], rows[name], True,
                     launches_by_phase=by_phase[name], relight_shapes=relight_rows[name],
                     **({"tp_shapes": tp_rows["bfloat16"]} if name == "nomax" else {}))
               for tpu, name in (("K1", "nomax"), ("K2", "max"), ("K3", "wide"))]
    # the fp32 instantiations (3xTF32 wgmma after a split pre-pass), the paper path's;
    # bound_ms is the 3xTF32 bound
    kernels += [entry(f"flash_attention_{name}_fp32", tpu, flash_src, replaces[name],
                      launches_p[f"flash_attention_{name}"], rows[f"{name}_fp32"], True, design="3xtf32 tma+wgmma",
                      dtype="float32", launches_by_phase={"paper": launches_p[f"flash_attention_{name}"],
                                                          "train": launches_t[f"flash_attention_{name}"],
                                                          "parallel_ranks": par("float32", name)},
                      **({"tp_shapes": tp_rows["float32"]} if name == "nomax" else {}))
                for tpu, name in (("K1", "nomax"), ("K3", "wide"))]
    kernels += [entry(name, tpu, conv_src, f"rollingdepth_tpu/ops/conv3x3.py:{line}", conv_launches[name],
                      conv_rows[name], False)
                for tpu, name, line in (("K4", "conv3x3_same", 40), ("K5", "conv3x3_same_db", 132))]
    # K7 and K9 (without bf16_exp) launch K2's and K1's kernels; the K9 row
    # with bf16_exp is its own instantiation, so K9 has two rows
    for tpu, name, line, shares in (("K6", "flash_exp2", 29, None), ("K7", "flash_fused", 103, "rd_flash_max"),
                                    ("K8", "flash_bf16", 193, None), ("K9", "flash_nomax", 283, "rd_flash_nomax"),
                                    ("K9", "flash_nomax_bf16_exp", 283, None), ("K10", "flash_nomask", 363, None)):
        extra = {"shares_kernel": shares} if shares else {}
        kernels.append(entry(name, tpu, flash_src, f"scripts/bench_flash_variants.py:{line}",
                             variant_launches[name], variant_rows[name], False, **extra))
    # the GroupNorm pair: XLA's reduction and loop fusion written by hand (no TPU kernel)
    # its row: the main path's input with the most elements moved over the call (elements x launches);
    # main_path sums the times over every input of the call, paths_with_inputs counts the inputs a path gave it
    norm_phases = {**norms, "parallel_ranks": launches_par["norms"],
                   "parallel_relight_ranks": launches_par["relight_norms"]}
    main_rows = [r for r in norm_rows if "main" in r["paths"]]
    top = max(main_rows, key=lambda r: math.prod(r["shape"]) * r["paths"]["main"])
    norm_keys = ("shape", "eps", "silu", "max_abs_err", "equal_share", "flipped_groups", "ms", "bound_ms")
    kernels.append(entry("group_norm", None, "rollingdepth_torch/csrc/group_norm.cu",
                         "rollingdepth_tpu/models/layers.py:126 (XLA fusion)", norms["main"], top, True,
                         design="stats+merge+fused pass", launches_by_phase=norm_phases, silu=top["silu"],
                         eps=top["eps"], library="F.group_norm (norm only)",
                         main_path=norm_path_totals(norm_rows, "main"),
                         inputs_by_path={p: sum(p in r["paths"] for r in norm_rows)
                                         for p in sorted({p for r in norm_rows for p in r["paths"]})},
                         main_inputs=[dict({k: r[k] for k in norm_keys}, launches=r["paths"]["main"])
                                      for r in main_rows]))
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
