"""unet_s (s a clip): the phases that run the UNet (and its scheduler).

The phases the cell's builder lists under ``unet`` (``PHASES``; depth:
``snippet_infer``, the windows' denoise, and ``refine``).  Host clock with
the phases' card syncs on (the traced run); the mean over the window's
clips.
"""


def read(ctx):
    phases, clips = ctx["phases"].get("unet"), ctx["clips"]
    if not phases or not clips:
        return None
    return sum(c["timings"].get(p, 0.0) for c in clips for p in phases) / len(clips)
