"""relight_vae_s (s a clip): the relight phases that run the VAE alone.

The phases the relight builder lists under ``relight_vae`` (``PHASES``:
``encode``, the fg and bg frames, and ``decode``, every window frame),
read as ``vae_s`` reads its phases: host clock with the phases' card syncs
on (the traced run), the mean over the window's clips.  Nothing where a
clip lacks one of them (a pipeline that ran the decode inside the
denoise's phase).
"""

from .vae_s import read as read_phases


def read(ctx):
    phases = ctx["phases"].get("relight_vae")
    if not phases or not all(p in c["timings"] for c in ctx["clips"] for p in phases):
        return None
    return read_phases(dict(ctx, phases={"vae": phases}))
