"""Throughput of the fast-preset depth pipeline on the card.

    python -m rollingdepth_torch.tools.bench [n_frames] [n_clips] [--mode fast|fast1024|full|paper]
        [--quantize [w8a8]] [--fp32] [--ref-merge] [--turbo] [--sb N] [--vb N] [--stride N]
        [--device cuda|cpu] [--tiny]

Counterpart of the JAX package's ``bench.py``, with its workload and its
measurement:
- the preset's shape (``fast``: dilations [1, 25] capped by the clip's
  length, windows of 3 frames, one DDIM step, bf16, the latent merge) on
  16:9 frames of 768x432 (``--mode`` picks another preset's edge, dilations,
  refinement, cap and merge from ``utils/presets.py``; ``--ref-merge``/``--turbo``
  force the merge), on the
  SD2 UNet and the SD VAE with random weights drawn on the card
  (``utils/bench_init.py``; throughput does not depend on the weights),
  ``--sb`` windows a UNet call (16) and ``--vb`` frames a VAE call (16, 8
  in fp32), ``--quantize`` the W8A8 UNet (``ops/quant.py``);
- the steady state over consecutive clips of ``n_frames`` (60): clip k+1
  uploads on a side stream while clip k computes, each clip waits only for
  the one before it; then the same loop on a clip already on the card (the
  headline ``value``), and one clip with its depth fetched to the host.

Prints the card's ``nvidia-smi`` name and power limit on stderr, and ONE
JSON line ``{"metric", "value", "unit", "vs_baseline", ...}`` with the JAX
bench's metric names (``depth_fps_768p_fast_1chip``, ``_w8a8``, ``_fp32``,
``_refmerge``, ``_turbo``; ``_tiny`` with ``--tiny``), and ``_stride{N}``
for ``--stride`` N other than 1, which the JAX bench leaves out (it files
a stride run under the stride-1 metric).  ``vs_baseline`` is
the JAX bench's estimate of an RTX 3090 on the same workload
(``flops_per_frame`` at 40% of 71 TFLOP/s).  ``--device cpu --tiny`` runs
the tiny UNet and VAE on 32x16 frames on the host, to check the tool itself.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np

MODES = ("fast", "fast1024", "full", "paper")  # presets of utils/presets.py
TINY_EDGE = 32  # --tiny: the frames' long side


def flops_per_frame(h=768, w=432, dilation_count=2, snippet_len=3, unet_steps=1, refine_step=0):
    """The JAX bench's FLOP model of the fast preset per video frame: the SD2
    UNet at 2 x 680 GMAC per 64x64 latent, the SD VAE at 2 x 560 GMAC to
    encode and 2 x 1150 GMAC to decode per 512x512 image, both scaled by
    area; one encode a frame, one UNet step and one decode a frame per
    dilation, and per refine step one more UNet eval, plus one re-encode and
    one decode.  It undercounts the windows' overlap (each frame sits in
    ``snippet_len`` windows), which keeps ``vs_baseline`` conservative."""
    lat_h, lat_w = h // 8, w // 8
    unet_per_frame = 2 * 680e9 * (lat_h * lat_w) / (64 * 64)
    vae_scale = (h * w) / (512 * 512)
    enc = 2 * 560e9 * vae_scale
    dec = 2 * 1150e9 * vae_scale
    total = enc + dilation_count * (unet_steps * unet_per_frame + dec)
    if refine_step:
        total += refine_step * unet_per_frame + enc + dec
    return total


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_frames", type=int, nargs="?", default=60)
    ap.add_argument("n_clips", type=int, nargs="?", default=4, help="timed clips")
    ap.add_argument("--mode", default="fast", choices=MODES)
    ap.add_argument("--quantize", nargs="?", const="w8a8", default=None, choices=["w8a8"])
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--ref-merge", action="store_true", dest="ref_merge")
    ap.add_argument("--turbo", action="store_true")
    ap.add_argument("--sb", type=int, default=16)
    ap.add_argument("--vb", type=int, default=None)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny UNet and VAE on tiny frames (a check of the tool)")
    return ap.parse_args(argv)


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "cpu"


def build_pipeline(args, dev, dtype):
    """The SD2 UNet and SD VAE (or the tiny ones) with random weights drawn
    on ``dev``; the max-free gate calibrated on the float UNet on the card,
    then the UNet quantized with ``--quantize``."""
    import torch

    from ..models.unet import UNet2DConditionModel, UNetConfig
    from ..models.vae import AutoencoderKL, VAEConfig
    from ..ops.quant import apply_quantize
    from ..ops.score_probe import calibrate_nomax
    from ..pipelines.rollingdepth import RollingDepthPipeline
    from ..schedulers.ddim import DDIMConfig, DDIMScheduler
    from ..utils.bench_init import device_random_params

    ucfg = UNetConfig.tiny() if args.tiny else UNetConfig.sd21(in_channels=8)
    vcfg = VAEConfig.tiny() if args.tiny else VAEConfig()
    gen = torch.Generator(device=dev)
    unet = device_random_params(UNet2DConditionModel(ucfg, device=dev), gen.manual_seed(0), dtype).eval()
    vae = device_random_params(AutoencoderKL(vcfg, device=dev), gen.manual_seed(1), dtype).eval()
    if dev.type == "cuda":
        calibrate_nomax(unet)
    apply_quantize(unet, args.quantize)
    scheduler = DDIMScheduler(DDIMConfig(beta_schedule="scaled_linear", timestep_spacing="trailing"))
    text = torch.zeros((1, 2, ucfg.cross_attention_dim), device=dev, dtype=dtype)
    return RollingDepthPipeline(unet, vae, scheduler, text, dtype=dtype, snippet_batch=args.sb, device=dev)


def main(argv=None) -> int:
    args = _parse(argv)
    import torch

    from ..utils.device import resolve_device
    from ..utils.presets import resolve_preset

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("bench: no CUDA device (--device cpu runs on the host)", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    vb = args.vb or (8 if args.fp32 else 16)
    preset = resolve_preset(args.mode)
    dilations, refine_step, cap_dil = preset.dilations, preset.refine_step, preset.cap_dilation
    merge_latent = (preset.merge_in_latent and not args.ref_merge) or args.turbo
    max_edge = TINY_EDGE if args.tiny else preset.res
    h, w = max_edge, (max_edge * 9 // 16) // 8 * 8  # 16:9 at the preset's edge, as the JAX bench
    card = card_name() if on_card else "cpu"
    print(f"[bench] card: {card}", file=sys.stderr)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    pipe = build_pipeline(args, dev, dtype)
    sync()
    setup_s = time.perf_counter() - t0
    print(f"[bench] setup {setup_s:.1f}s", file=sys.stderr)

    rng = np.random.RandomState(0)
    clips = [(rng.rand(args.n_frames, 3, h, w) * 255).astype(np.uint8) for _ in range(min(3, args.n_clips + 1))]
    kwargs = dict(dilations=dilations, cap_dilation=cap_dil, refine_step=refine_step, seed=0, max_vae_bs=vb,
                  fetch_output=False, strides=[args.stride], merge_in_latent=merge_latent)
    side = torch.cuda.Stream(dev) if on_card else None

    def upload(clip: np.ndarray):
        t = torch.from_numpy(clip)
        if not on_card:
            return t
        with torch.cuda.stream(side):
            t = t.pin_memory().to(dev, non_blocking=True)
        side.synchronize()
        return t

    def fetch_and_check(depth):
        depth = depth.float().cpu().numpy()
        assert np.isfinite(depth).all(), "non-finite depth"
        return depth

    def timed(clip_dev, **extra):
        t = time.perf_counter()
        out = pipe.forward(clip_dev, **kwargs, **extra)
        fetch_and_check(out.depth_pred)
        return time.perf_counter() - t

    warm_s = timed(upload(clips[0]), verbose=True)
    print(f"[bench] warmup {warm_s:.1f}s; phase timings {pipe.last_timings}", file=sys.stderr)
    steady_s = timed(upload(clips[1 % len(clips)]), verbose=True)
    phase_timings = dict(pipe.last_timings)
    print(f"[bench] steady verbose clip {steady_s:.1f}s; phase timings {phase_timings}", file=sys.stderr)
    # the steady state: clip k+1 uploads while clip k computes; clip k waits
    # only for clip k-1 (an event), the last one after the loop
    n_clips, n_frames = args.n_clips, args.n_frames
    pool = concurrent.futures.ThreadPoolExecutor(1)
    t0 = time.perf_counter()
    up_next = pool.submit(upload, clips[1 % len(clips)])
    outs, done, marks = [], [], []
    for i in range(1, n_clips + 1):
        clip_dev = up_next.result()
        if i < n_clips:
            up_next = pool.submit(upload, clips[(i + 1) % len(clips)])
        outs.append(pipe.forward(clip_dev, **kwargs).depth_pred)
        if on_card:
            done.append(torch.cuda.Event())
            done[-1].record()
            if len(done) >= 2:
                done[-2].synchronize()
        marks.append(time.perf_counter() - t0)
    sync()
    elapsed = time.perf_counter() - t0
    pool.shutdown()
    fps = n_clips * n_frames / elapsed
    for out in outs:
        fetch_and_check(out)
    per_clip = np.diff([0.0] + marks[:-1] + [elapsed])  # the last clip's wall ends at the final sync
    overhead_per_clip = elapsed / n_clips - sum(phase_timings.values())
    print(f"[bench] {n_clips}x{n_frames} frames in {elapsed:.2f}s -> {fps:.2f} fps; per-clip walls "
          f"{[round(float(x), 2) for x in per_clip]}", file=sys.stderr)

    # the headline: the same loop on a clip already on the card
    clip_dev = upload(clips[0])
    outs, done = [], []
    t0 = time.perf_counter()
    for _ in range(n_clips):
        outs.append(pipe.forward(clip_dev, **kwargs).depth_pred)
        if on_card:
            done.append(torch.cuda.Event())
            done[-1].record()
            if len(done) >= 2:
                done[-2].synchronize()
    sync()
    dev_elapsed = time.perf_counter() - t0
    fps_device = n_clips * n_frames / dev_elapsed
    fetch_and_check(outs[-1])
    print(f"[bench] device-resident {n_clips}x{n_frames} in {dev_elapsed:.2f}s -> {fps_device:.2f} fps",
          file=sys.stderr)

    # one clip with its upload and its depth's fetch inside the time
    t0 = time.perf_counter()
    out = pipe.forward(upload(clips[0]), **kwargs)
    fetch_and_check(out.depth_pred)
    fetch_incl_fps = n_frames / (time.perf_counter() - t0)

    est_3090_fps = 71e12 * 0.40 / flops_per_frame(h, w, dilation_count=len(dilations), refine_step=refine_step)
    metric = "depth_fps_768p_fast_1chip" if args.mode == "fast" else f"depth_fps_{args.mode}_1chip"
    suffix = "".join(s for s, on in (("_w8a8", args.quantize), ("_fp32", args.fp32), ("_refmerge", args.ref_merge),
                                     ("_turbo", args.turbo), (f"_stride{args.stride}", args.stride != 1),
                                     ("_tiny", args.tiny)) if on)
    result = {
        "metric": metric + suffix,
        "value": fps_device,
        "unit": "frames/sec",
        "vs_baseline": fps_device / est_3090_fps,
        "fps_upload_inclusive": fps,
        "fps_fetch_inclusive": fetch_incl_fps,
        "overhead_s_per_clip": overhead_per_clip,
        "phase_timings_s": phase_timings,
        "frames": [n_frames, h, w],
        "stride": args.stride,
        "setup_s": setup_s,
        "card": card,
        "torch": torch.__version__,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
