"""Device time of a decode step: timing events around the engine's
``_decode_step`` call, summed over the window's steps, over their
number."""


def read(t):
    ticks = t["decode"]
    if not ticks:
        return None
    return sum(d["ms"] for d in ticks) / len(ticks)
