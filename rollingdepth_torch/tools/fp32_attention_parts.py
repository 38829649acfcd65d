"""Where one fp32 attention call's device time goes: the split pre-pass and the 3xTF32 kernel.

    python -m rollingdepth_torch.tools.fp32_attention_parts

At the paper preset's two fp32 shapes at res 768 (K1 max-free at
[8, 15552, 5, 64], K3 at [4, 5184, 1, 512]), on seeded random inputs: the
wrapper's time with CUDA events after a warm-up, then the device time of
each kernel it launches (``split_tf32``, ``split_tf32_vt``, the attention
kernel) per call, under ``torch.profiler``; five calls each.  Prints one
JSON line a shape with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.device import card_name

SHAPES = (("flash_attention_nomax", (8, 15552, 5, 64)), ("flash_attention_wide", (4, 5184, 1, 512)))
ITERS = 5


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("fp32_attention_parts: no CUDA device", file=sys.stderr)
        return 2
    from ..ops import flash_attention as fa
    from .bench_flash_variants import cuda_ms

    smi = card_name()
    for name, shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        fn = getattr(fa, name)
        ms = cuda_ms(lambda: fn(q, k, v), ITERS)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn(q, k, v)
            torch.cuda.synchronize()
        parts = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = e.name[:100]
                parts[key] = parts.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / ITERS
        print(json.dumps({"kernel": name, "shape": list(shape), "dtype": "float32", "ms": ms,
                          "device_ms_by_kernel": parts, "card": smi}), flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
