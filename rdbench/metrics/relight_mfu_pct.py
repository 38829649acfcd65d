"""relight_mfu_pct (%): a relight clip's model operations over the window at the peak rate.

``mfu_pct``'s reading: every matmul, convolution and attention product of
the window's clips (``rdbench/counts`` through the relight builder's
``clip_counts``: the fg and bg encodes, the text tower, the base UNet's
t2i steps, the 12-channel UNet's window steps, the decodes) over the
window's wall time at the peak matmul rate of the served dtype.  Nothing
in a cell whose builder is not the relight one (its ``PHASES`` name no
``relight_unet``).
"""

from .mfu_pct import read as read_mfu


def read(ctx):
    if "relight_unet" not in ctx["phases"]:
        return None
    return read_mfu(ctx)
