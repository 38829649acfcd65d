"""relight_unet_s (s a clip): the relight windows' denoise through the 12-channel UNet.

The phases the relight builder lists under ``relight_unet`` (``PHASES``:
``snippet_infer``, the IC-Light UNet's calls and their DPM++ SDE steps),
read as ``unet_s`` reads its phases: host clock with the phases' card
syncs on (the traced run), the mean over the window's clips.  Nothing
where a clip lacks one of them (a pipeline that ran the denoise and the
decode in one phase).
"""

from .unet_s import read as read_phases


def read(ctx):
    phases = ctx["phases"].get("relight_unet")
    if not phases or not all(p in c["timings"] for c in ctx["clips"] for p in phases):
        return None
    return read_phases(dict(ctx, phases={"unet": phases}))
