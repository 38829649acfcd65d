"""coalign_s (s a clip): the co-alignment solve and merge (``aligner.py``).

The phases the cell's builder lists under ``coalign`` (``PHASES``; depth:
``coalign``), host clock with the phases' card syncs on (the traced run);
the mean over the window's clips.
"""


def read(ctx):
    phases, clips = ctx["phases"].get("coalign"), ctx["clips"]
    if not phases or not clips or not any(p in c["timings"] for c in clips for p in phases):
        return None
    return sum(c["timings"].get(p, 0.0) for c in clips for p in phases) / len(clips)
