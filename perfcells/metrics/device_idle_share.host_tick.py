"""Share of the profiled stretch in which the device idled while the host
did the tick's bookkeeping: the program's idle seconds put down to the
spans of ``program_spans.HOST_TICK`` (or to no span), over the
stretch's length."""
from perfcells.program_spans import HOST_TICK


def read(t):
    idle = (t.get("program") or {}).get("idle_by_span")
    window = t["stretch"].get("window_s")
    if idle is None or not window:
        return None
    return 100.0 * sum(idle.get(k, 0.0) for k in HOST_TICK) / window
