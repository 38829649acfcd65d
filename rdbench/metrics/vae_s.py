"""vae_s (s a clip): the phases that run the VAE alone.

The phases the cell's builder lists under ``vae`` (``PHASES``; depth:
``encode`` and ``decode``).  Host clock with the phases' card syncs on
(the traced run); the mean over the window's clips.
"""


def read(ctx):
    phases, clips = ctx["phases"].get("vae"), ctx["clips"]
    if not phases or not clips:
        return None
    return sum(c["timings"].get(p, 0.0) for c in clips for p in phases) / len(clips)
