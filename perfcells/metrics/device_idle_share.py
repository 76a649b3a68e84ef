"""Share of the profiled stretch in which no kernel, copy or fill ran on
the device (the union of device activity in the trace, against the
stretch from its first event to its last)."""


def read(t):
    s = t["stretch"]
    if not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
