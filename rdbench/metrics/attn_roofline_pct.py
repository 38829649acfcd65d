"""attn_roofline_pct (%): the flash attention kernels' share of their roofline.

The least time the window's counted attention needs (QK^T and PV of the
self-attention over at least 256 tokens at the true head width,
``rdbench/counts``) at the peak matmul rate of the served dtype, over the
device time of the kernels that do it (``ops/flash_attention.py``,
``csrc/flash_attn.cu``): every kernel whose name matches ``KERNELS``.
"""

import re

KERNELS = re.compile(r"(^|\W)(flash_fwd_\w+|split_tf32\w*)")


def read(ctx):
    kernel_s = sum(s for n, s in ctx["trace"]["kernel_s"].items() if KERNELS.search(n))
    flops = ctx["counts"].get("attn_flops", 0.0)
    if kernel_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / ctx["peak_flops"] / kernel_s
