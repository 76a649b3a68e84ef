"""Median wait at the front door: the engine's ``t_admit - t_submit``
stamps (the server's clock) over the window's admitted requests."""
import statistics


def read(t):
    waits = [r.t_admit - r.t_submit for r in t["requests"]
             if r.t_admit is not None and r.t_submit is not None]
    if not waits:
        return None
    return 1e3 * statistics.median(waits)
