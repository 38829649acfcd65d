"""Device time of one work chunk of each loop of the pipeline, at a preset's shapes.

    python -m rollingdepth_torch.tools.chunk_times [--preset fast|fast1024|full|paper] [--res R] [--iters 2]

Builds the full-width pipeline with seeded random weights
(``utils/synthetic.py``) in the preset's dtype and times, with CUDA events
after a warm-up, one UNet call on ``snippet_batch`` windows of 3 frames,
one VAE encode and one VAE decode of ``max_vae_bs`` frames, at 16:9 frames
of the preset's resolution (or ``--res``); the UNet call again with every
attention on the plain PyTorch path (``ROLLINGDEPTH_ATTN=xla``), which
shows what the attention kernels give a chunk.  A call's time is about
these times by the chunk counts of ``last_chunks`` plus the co-alignment
solve, which is how ``PERF.md`` predicts a preset before running it.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..utils.device import card_name


def plain_attention_ms(fn, iters: int) -> float:
    from .bench_flash_variants import cuda_ms

    os.environ["ROLLINGDEPTH_ATTN"] = "xla"
    try:
        return cuda_ms(fn, iters, warmup=1)
    finally:
        del os.environ["ROLLINGDEPTH_ATTN"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="fast", choices=["fast", "fast1024", "full", "paper"])
    ap.add_argument("--res", type=int, default=None, help="the frames' long side (default: the preset's)")
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chunk_times: no CUDA device", file=sys.stderr)
        return 2
    from ..io.pretrained import DTYPE_MAP
    from ..utils.presets import resolve_preset
    from ..utils.synthetic import random_depth_pipeline
    from .bench_flash_variants import cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    settings = resolve_preset(args.preset)
    dtype = DTYPE_MAP[settings.dtype]
    width = args.res or settings.res
    height = width * 9 // 16
    smi = card_name()
    pipe, _ = random_depth_pipeline("cuda", dtype, seed=0, snippet_batch=settings.snippet_batch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    h, w, bs = height // 8, width // 8, settings.max_vae_bs
    with torch.no_grad():
        x = torch.randn((settings.snippet_batch, 3, h, w, 8), generator=gen, device="cuda").to(dtype)
        z = torch.randn((bs, h, w, 4), generator=gen, device="cuda").to(dtype)
        frames = torch.randn((bs, height, width, 3), generator=gen, device="cuda").to(dtype)
        result = {
            "preset": args.preset, "res": [height, width], "dtype": str(dtype).split(".")[-1], "card": smi,
            "unet_chunk_ms": cuda_ms(lambda: pipe.unet(x, 999, pipe.empty_text_embed), args.iters, warmup=1),
            "unet_chunk_plain_attention_ms": plain_attention_ms(
                lambda: pipe.unet(x, 999, pipe.empty_text_embed), args.iters),
            "encode_chunk_ms": cuda_ms(lambda: pipe.vae.encode_mean(frames), args.iters, warmup=1),
            "decode_chunk_ms": cuda_ms(lambda: pipe.vae.decode(z), args.iters, warmup=1),
            "snippet_batch": settings.snippet_batch, "max_vae_bs": bs,
        }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
