"""mfu_pct (%): the whole clip's model operations over the window at the peak rate.

Every matmul, convolution and attention product of the window's clips
(``rdbench/counts``: encode, each window's UNet steps, decode, and
refinement where the call refines) over the window's wall time at the peak
matmul rate of the served dtype.  It bounds every kernel's gain: a kernel
taken off the path leaves its roofline silent, this one still reads.
"""


def read(ctx):
    flops = ctx["counts"].get("flops", 0.0)
    if flops <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops / ctx["peak_flops"] / ctx["window_s"]
