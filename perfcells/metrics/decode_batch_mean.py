"""Rows each decode tick advanced: tokens that decode ticks generated in
the window over the decode ticks (the engine's active rows, read by the
benchmark's span around ``_decode_step``)."""


def read(t):
    ticks = t["decode"]
    if not ticks:
        return None
    return sum(len(d["contexts"]) for d in ticks) / len(ticks)
