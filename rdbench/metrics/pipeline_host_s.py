"""pipeline_host_s (s a clip): the entry's wall time minus its phases.

What the pipelines do on the host outside their phase spans (window
building, the fetch of the output, the upload), from
``PhaseTimer.last_timings`` with the phases' card syncs on (the traced
run); the mean over the window's clips.
"""


def read(ctx):
    clips = ctx["clips"]
    if not clips:
        return None
    return sum(c["entry_s"] - sum(c["timings"].values()) for c in clips) / len(clips)
