"""device_idle_pct (%): the share of the traced window with no kernel running.

One minus the union of the kernels' intervals over the window's length,
from the profiler's device events (``rdbench/trace.py``).
"""


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
