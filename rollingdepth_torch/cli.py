"""Command line: video depth and relighting with the PyTorch port.

    python -m rollingdepth_torch.cli -i clip.mp4 -o out/ [-p fast|fast1024|full|paper|none] [--device cuda]
    python -m rollingdepth_torch.cli -fi fg.mp4 -bi bg.mp4 -o out/ -c <sd15 checkpoint> [--device cuda]

The JAX package's CLI (``rollingdepth_tpu/cli.py``) with the same flags,
presets and overrides (``utils/presets.py``) and the same outputs per clip:
``<stem>_pred.npy`` ([N, H, W] float32 in [-1, 1]), one mp4 per colour map,
``<stem>_rgbd.mp4`` (input and first colour map side by side) and, with
``--save-snippets``, ``<stem>_snippets.npz``; ``--eval`` runs the AbsRel/δ1
harness (``eval.py``) instead; ``-fi``/``-bi`` relight each fg clip over
each bg clip (``pipelines/rollingimg.py``) into ``<fg>_rgb.mp4``, or
``<fg>_<bg>_rgb.mp4`` when there are several backgrounds.  Where it differs:
- ``--device`` (default this rank's card, ``parallel.multihost.local_device``)
  picks the torch device; without a card the default raises, and
  ``--device cpu`` runs on the CPU;
- the batch defaults are the presets' (``max_vae_bs`` 4, ``snippet_batch``
  8), with no per-backend tuning, and there is no compile cache;
- launched by ``torchrun --nproc-per-node N -m rollingdepth_torch.cli ...``,
  each rank takes every N-th clip (``parallel.multihost.shard_work``, as the
  JAX CLI splits clips over hosts) on its own card, with no collective; a
  single process takes every clip.
``--quantize w8a8`` quantizes the UNet (the relight UNet for ``-fi/-bi``)
as the JAX CLI does (``ops/quant.py``).
Reading video needs OpenCV or the native decoder (``io/video.py``), and the
colour maps need matplotlib.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import logging
import os
import queue
import threading
from pathlib import Path

import numpy as np

from .utils.presets import resolve_preset, str2bool

OVERRIDES = {
    "res", "snippet_lengths", "cap_dilation", "dtype", "refine_snippet_len",
    "refine_start_dilation", "dilations", "refine_step", "init_infer_steps", "strides",
    "max_vae_bs", "unload_snippet", "restore_res", "resample_method",
    "start_frame", "frame_count", "seed", "verbose", "snippet_batch",
    "merge_in_latent", "refine_in_latent", "turbo_refine",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run video depth estimation / relighting using RollingDepth (PyTorch port).")
    parser.add_argument("-i", "--input-video", type=str, default=None, dest="input_video",
                        help="Input video(s): file, .txt list, or directory (depth mode).")
    parser.add_argument("-fi", "--input-fg-video", type=str, default=None, dest="input_fg_video",
                        help="Foreground video(s) (relight mode).")
    parser.add_argument("-bi", "--input-bg-video", type=str, default=None, dest="input_bg_video",
                        help="Background video(s) (relight mode).")
    parser.add_argument("-o", "--output-dir", type=str, required=True, dest="output_dir")
    parser.add_argument("-p", "--preset", type=str, default="fast",
                        choices=["fast", "fast1024", "full", "paper", "none"])
    parser.add_argument("--start-frame", "--from", type=int, default=0, dest="start_frame")
    parser.add_argument("--frame-count", "--frames", type=int, default=0, dest="frame_count")
    parser.add_argument("-c", "--checkpoint", type=str, default="prs-eth/rollingdepth-v1-0")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: this rank's card, cuda:LOCAL_RANK; cpu runs on the host).")
    parser.add_argument("--res", "--processing-resolution", type=int, default=None, dest="res")
    parser.add_argument("--max-vae-bs", type=int, default=None, help="VAE encode/decode batch (default: 4).")
    parser.add_argument("--fps", "--output-fps", type=int, default=0, dest="output_fps")
    parser.add_argument("--restore-res", "--restore-resolution", type=str2bool,
                        default=False, dest="restore_res")
    parser.add_argument("--save-sbs", "--save-side-by-side", type=str2bool, default=True, dest="save_sbs")
    parser.add_argument("--save-npy", type=str2bool, default=True)
    parser.add_argument("--save-snippets", type=str2bool, default=False)
    parser.add_argument("--cmap", "--color-maps", type=str, nargs="+",
                        default=["Spectral_r", "Greys_r"], dest="color_maps")
    parser.add_argument("-d", "--dilations", type=int, nargs="+", default=None, dest="dilations")
    parser.add_argument("--cap-dilation", type=str2bool, default=None, dest="cap_dilation")
    parser.add_argument("--dtype", "--data-type", "--precision", type=str, default=None,
                        choices=["fp16", "fp32", "bf16", None], dest="dtype")
    parser.add_argument("--snip-len", "--snippet-lengths", type=int, nargs="+",
                        default=None, dest="snippet_lengths")
    parser.add_argument("--refine-step", type=int, default=None, dest="refine_step")
    parser.add_argument("--refine-snippet-len", type=int, default=None)
    parser.add_argument("--refine-start-dilation", type=int, default=None)
    parser.add_argument("--init-infer-steps", type=int, nargs="+", default=None)
    parser.add_argument("--strides", type=int, nargs="+", default=None,
                        help="window stride per dilation chain, 1..snippet_len (1 = sliding windows, "
                             "snippet_len = a partition of the frames)")
    parser.add_argument("--resample-method", type=str, default="BILINEAR",
                        choices=["BILINEAR", "NEAREST_EXACT", "BICUBIC"])
    parser.add_argument("--unload-snippet", type=str2bool, default=False)
    parser.add_argument("--merge-in-latent", type=str2bool, default=None, dest="merge_in_latent",
                        help="Co-align and merge the snippet latents and decode N frames once (fast "
                             "presets); false = decode every snippet and merge in depth space.")
    parser.add_argument("--refine-in-latent", type=str2bool, default=None, dest="refine_in_latent",
                        help="Feed the merged latent directly into refinement (skips "
                             "decode->minmax-renorm->re-encode). Default off.")
    parser.add_argument("--turbo-refine", type=str2bool, default=None, dest="turbo_refine",
                        help="Partition refine windows (~snippet_len x fewer UNet evals per refine "
                             "step); false = stride-1 windows. Default follows --merge-in-latent.")
    parser.add_argument("--snippet-batch", type=int, default=None, help="Snippets denoised per UNet call (default: 8).")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "w8a8"],
                        help="Serving-mode weight+activation quantization of the UNet (w8a8: int8 "
                             "weights per output channel, int8 activations per tensor; the relight "
                             "UNet only for -fi/-bi).")
    parser.add_argument("--attn-backend", type=str, default=None, choices=["auto", "flash", "xla"],
                        dest="attn_backend",
                        help="Attention: auto (the CUDA kernels on the card), flash (always the "
                             "kernels) or xla (always the plain PyTorch path).")
    parser.add_argument("--eval", type=str, default=None, dest="eval_dataset",
                        help="run AbsRel/delta1 evaluation instead of video inference: a dataset name "
                             "(scannet|bonn_rgbd|pointodyssey|dydtof) using the bundled data_split "
                             "manifests, or a path to a split dir of rgb,depth CSV manifests")
    parser.add_argument("--eval-data-root", type=str, default=None,
                        help="directory the manifests' relative frame paths resolve under")
    parser.add_argument("--eval-max-sequences", type=int, default=None,
                        help="evaluate only the first N manifests (deterministic order)")
    parser.add_argument("--eval-depth-scale", type=float, default=None,
                        help="override the per-dataset GT uint16->meters decode factor (eval.py "
                             "DATASET_DEPTH_SCALE)")
    # relight-mode flags
    parser.add_argument("--prompt", type=str, default=None)
    parser.add_argument("--a-prompt", type=str, default=None, dest="a_prompt")
    parser.add_argument("--n-prompt", type=str, default=None, dest="n_prompt")
    parser.add_argument("--init-mode", type=str, default="t2i", choices=["t2i", "shared_noise", "passthrough"])
    parser.add_argument("--turbo-relight", type=str2bool, default=False, dest="turbo_relight")
    return parser


def resolve_args(argv=None):
    """(parsed flags, settings): the preset with the flags given explicitly laid over it."""
    from .parallel.multihost import local_device

    input_args = build_parser().parse_args(argv)
    if input_args.device is None:
        input_args.device = str(local_device())
    overrides = {k: v for k, v in vars(input_args).items() if k in OVERRIDES and v is not None}
    return input_args, resolve_preset(input_args.preset, overrides)


def _load(args, settings):
    from .io.pretrained import load_rollingdepth_pipeline

    logging.info("Loading checkpoint from %s", args.checkpoint)
    return load_rollingdepth_pipeline(args.checkpoint, dtype=settings.dtype, snippet_batch=settings.snippet_batch,
                                      quantize=args.quantize, device=args.device)


def run_depth(args, settings) -> None:
    from .io.video import enumerate_videos, load_video_frames
    from .parallel.multihost import shard_work

    pipe = _load(args, settings)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    # torchrun ranks split the clip list round-robin; identity in one process
    videos = shard_work(enumerate_videos(args.input_video))

    merge_in_latent = settings.merge_in_latent
    if merge_in_latent and args.save_snippets:
        # the latent merge never decodes a snippet
        logging.warning("--save-snippets requires the depth-space merge; disabling merge-in-latent.")
        merge_in_latent = False

    # decode clip k+1 on a host thread while clip k computes
    decode_q: "queue.Queue" = queue.Queue(maxsize=1)

    def _decoder():
        for v in videos:
            try:
                frames, orig = load_video_frames(
                    v, start_frame=settings.start_frame, frame_count=settings.frame_count,
                    processing_res=settings.res, resample_method=settings.resample_method, dtype="uint8",
                )
                decode_q.put((v, frames, orig, None))
            except Exception as e:  # noqa: BLE001
                decode_q.put((v, None, None, e))

    threading.Thread(target=_decoder, daemon=True).start()

    # colorize and write clip k while clip k+1 computes (one worker keeps the
    # order; an exception surfaces at the next result())
    save_pool = concurrent.futures.ThreadPoolExecutor(1)
    pending = None
    for _ in videos:
        v, frames, orig, err = decode_q.get()
        if err is not None:
            raise err
        video_path = Path(v)
        logging.info("Processing %s", video_path)
        out = pipe(
            input_frames=frames, original_res=orig, dilations=list(settings.dilations),
            cap_dilation=settings.cap_dilation, snippet_lengths=list(settings.snippet_lengths),
            init_infer_steps=list(settings.init_infer_steps), strides=list(settings.strides),
            refine_step=settings.refine_step, refine_snippet_len=settings.refine_snippet_len,
            refine_start_dilation=settings.refine_start_dilation, seed=settings.seed, verbose=settings.verbose,
            max_vae_bs=settings.max_vae_bs, unload_snippet=settings.unload_snippet,
            restore_res=settings.restore_res, merge_in_latent=merge_in_latent,
            refine_in_latent=settings.refine_in_latent, turbo_refine=settings.turbo_refine,
        )
        if pending is not None:
            pending.result()
        pending = save_pool.submit(save_depth_outputs, out, video_path, output_dir, args)
    if pending is not None:
        pending.result()
    save_pool.shutdown()
    logging.info("Finished. %d predictions are saved to %s", len(videos), output_dir)


def save_depth_outputs(pipe_out, video_path: Path, output_dir: Path, args) -> None:
    """The output suite of one clip."""
    from .io.colorize import colorize_depth_multi_thread
    from .io.video import concatenate_videos_horizontally, get_video_fps, write_video_from_numpy

    depth_pred = pipe_out.depth_pred  # [N, 1, H, W]
    output_fps = args.output_fps
    if not output_fps > 0:
        try:
            output_fps = int(get_video_fps(video_path))
        except Exception:  # noqa: BLE001
            output_fps = 0
        if output_fps <= 0:
            # containers without fps metadata probe as 0.0; an encoder would refuse it
            output_fps = 30

    if args.save_npy:
        np.save(output_dir / f"{video_path.stem}_pred.npy", depth_pred.squeeze(1))  # [N, H, W]

    if args.save_snippets and pipe_out.snippet_ls:
        snippet_dict = {f"dilation{i}": (s.cpu().numpy() if hasattr(s, "cpu") else s).squeeze(2)
                        for i, s in enumerate(pipe_out.snippet_ls)}
        np.savez_compressed(output_dir / f"{video_path.stem}_snippets.npz", **snippet_dict)

    for i_cmap, cmap in enumerate(args.color_maps):
        if cmap == "":
            continue
        colored_np = colorize_depth_multi_thread(
            depth=depth_pred, valid_mask=None, chunk_size=4, num_threads=4, color_map=cmap, verbose=args.verbose,
        )  # [n, h, w, 3] uint8
        write_video_from_numpy(colored_np, output_dir / f"{video_path.stem}_{cmap}.mp4", fps=output_fps,
                               crf=23, preset="medium", verbose=args.verbose)

        if args.save_sbs and i_cmap == 0:
            rgb = (pipe_out.input_rgb * 255).astype(np.uint8)  # [N, 3, H, W]
            concat = concatenate_videos_horizontally(rgb, colored_np.transpose(0, 3, 1, 2), gap=10)
            concat = np.clip(concat, 0, 255).astype(np.uint8).transpose(0, 2, 3, 1)
            write_video_from_numpy(concat, output_dir / f"{video_path.stem}_rgbd.mp4", fps=output_fps,
                                   crf=23, preset="medium", verbose=args.verbose)


def run_eval(args, settings) -> None:
    """AbsRel/δ1 over a data_split manifest set.  Writes
    ``<output_dir>/eval_<dataset>.csv`` with one affine-aligned metric row
    per sequence plus a MEAN row, and prints the means."""
    from .eval import DEFAULT_SPLIT_DIR, evaluate_dataset

    if os.path.isdir(args.eval_dataset):
        split_dir = args.eval_dataset
        dataset = Path(args.eval_dataset).name
    else:
        split_dir = os.path.join(DEFAULT_SPLIT_DIR, args.eval_dataset)
        dataset = args.eval_dataset
    if not args.eval_data_root:
        raise SystemExit("--eval requires --eval-data-root <frames dir>")

    pipe = _load(args, settings)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    csv_path = str(output_dir / f"eval_{dataset}.csv")
    means = evaluate_dataset(
        pipe, split_dir=split_dir, data_root=args.eval_data_root, dataset=dataset, processing_res=settings.res,
        max_sequences=args.eval_max_sequences, csv_path=csv_path, depth_scale=args.eval_depth_scale,
        dilations=list(settings.dilations), cap_dilation=settings.cap_dilation,
        snippet_lengths=list(settings.snippet_lengths), init_infer_steps=list(settings.init_infer_steps),
        strides=list(settings.strides), refine_step=settings.refine_step,
        refine_snippet_len=settings.refine_snippet_len, refine_start_dilation=settings.refine_start_dilation,
        seed=settings.seed, verbose=settings.verbose, max_vae_bs=settings.max_vae_bs,
        merge_in_latent=settings.merge_in_latent, refine_in_latent=settings.refine_in_latent,
        turbo_refine=settings.turbo_refine,
    )
    logging.info("eval %s means: %s (per-sequence rows in %s)", dataset, means, csv_path)
    print(json.dumps({"dataset": dataset, **means}))


def run_relight(args, settings) -> None:
    """Each fg clip relit over each bg clip: R, G and B side by side in one
    uint8 video at the working 720x640, 30 fps unless ``--fps``."""
    from .io.pretrained_relight import load_relight_pipeline
    from .io.video import enumerate_videos, write_video_from_numpy
    from .parallel.multihost import shard_work
    from .pipelines import rollingimg as ri

    logging.info("Loading relight checkpoint from %s", args.checkpoint)
    pipe = load_relight_pipeline(args.checkpoint, dtype=settings.dtype, snippet_batch=settings.snippet_batch,
                                 quantize=args.quantize, device=args.device)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    fg_videos = shard_work(enumerate_videos(args.input_fg_video))
    bg_videos = enumerate_videos(args.input_bg_video)
    prompts = {k: getattr(args, k) for k in ("prompt", "a_prompt", "n_prompt") if getattr(args, k) is not None}
    # --frame-count 0 means unset: the pipeline's own 253-frame cap holds
    frames = {"frame_count": settings.frame_count} if settings.frame_count > 0 else {}
    for fg in map(Path, fg_videos):
        for bg in map(Path, bg_videos):
            out = pipe(
                input_fg_video_path=fg, input_bg_video_path=bg, start_frame=settings.start_frame,
                dilations=list(settings.dilations), cap_dilation=settings.cap_dilation,
                snippet_lengths=list(settings.snippet_lengths), strides=list(settings.strides),
                resample_method=settings.resample_method,
                seed=settings.seed if settings.seed is not None else ri.DEFAULT_SEED, init_mode=args.init_mode,
                verbose=settings.verbose, max_vae_bs=settings.max_vae_bs, keep_snippets=False,
                turbo=args.turbo_relight, **frames, **prompts,
            )
            combined = np.concatenate([out.R_pred, out.G_pred, out.B_pred], axis=1)
            combined = np.clip(combined * 255, 0, 255).astype(np.uint8).transpose(0, 2, 3, 1)
            # one output per (fg, bg) pair: a bare fg stem would overwrite earlier backgrounds
            stem = fg.stem if len(bg_videos) == 1 else f"{fg.stem}_{bg.stem}"
            write_video_from_numpy(combined, output_dir / f"{stem}_rgb.mp4",
                                   fps=args.output_fps if args.output_fps > 0 else 30, verbose=settings.verbose)
    logging.info("Finished. Saved to %s", output_dir)


def main(argv=None) -> None:
    from .parallel.multihost import initialize_distributed

    logging.basicConfig(level=logging.INFO)
    args, settings = resolve_args(argv)
    # under torchrun: join the group (gloo for --device cpu or ranks sharing a card)
    initialize_distributed(device=args.device)
    logging.info("arguments: %s", settings)
    if args.attn_backend and args.attn_backend != "auto":
        # read by ops.attention.dot_product_attention on every call
        os.environ["ROLLINGDEPTH_ATTN"] = args.attn_backend
    if args.eval_dataset:
        run_eval(args, settings)
    elif args.input_fg_video and args.input_bg_video:
        run_relight(args, settings)
    elif args.input_video:
        run_depth(args, settings)
    else:
        raise SystemExit("Provide -i for depth estimation, -fi/-bi for relighting, "
                         "or --eval for accuracy evaluation.")


if __name__ == "__main__":
    main()
