"""relight_attn_roofline_pct (%): the flash attention kernels' share of their roofline in a relight clip.

``attn_roofline_pct``'s reading at the relight shapes: the window's
counted self-attention (over at least 256 tokens, at the true head width:
40, 80 and 160 in both SD1.5 UNets, 512 in the VAE; ``rdbench/counts``)
at the peak matmul rate over the device time of the flash kernels.  The
kernels pad d = 40 to 64, 80 to 128 and 160 to 256, so the padding reads
as lost share.  Nothing in a cell whose builder is not the relight one
(its ``PHASES`` name no ``relight_unet``).
"""

from .attn_roofline_pct import read as read_roofline


def read(ctx):
    if "relight_unet" not in ctx["phases"]:
        return None
    return read_roofline(ctx)
