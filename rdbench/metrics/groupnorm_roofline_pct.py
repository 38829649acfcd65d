"""groupnorm_roofline_pct (%): the GroupNorm pair's share of its roofline.

The least time the window's GroupNorms need (each input read once and
output written once, with weight and bias, in the served dtype,
``rdbench/counts``) at the HBM rate, over the device time of the pair's
kernels (``ops/group_norm.py``, ``csrc/group_norm.cu``): every kernel
whose name matches ``KERNELS``.
"""

import re

KERNELS = re.compile(r"(^|\W)gn_(stats|merge|apply)\b")


def read(ctx):
    kernel_s = sum(s for n, s in ctx["trace"]["kernel_s"].items() if KERNELS.search(n))
    nbytes = ctx["counts"].get("gn_bytes", 0.0)
    if kernel_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / ctx["peak_bytes_per_s"] / kernel_s
