"""relight_t2i_s (s a clip): the relight init: the prompt pair and the base UNet's t2i init.

The phases the relight builder lists under ``relight_t2i`` (``PHASES``:
``init``), read as ``unet_s`` reads its phases: host clock with the
phases' card syncs on (the traced run), the mean over the window's clips.
Nothing where a clip lacks one of them (another builder's cell).
"""

from .unet_s import read as read_phases


def read(ctx):
    phases = ctx["phases"].get("relight_t2i")
    if not phases or not all(p in c["timings"] for c in ctx["clips"] for p in phases):
        return None
    return read_phases(dict(ctx, phases={"unet": phases}))
