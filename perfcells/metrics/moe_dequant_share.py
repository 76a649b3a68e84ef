"""Share of decode-step device time spent in ``layers.materialize`` (the
experts' dequantize): timing events around each call inside a decode
step over the steps' own events."""


def read(t):
    ticks = t["decode"]
    total = sum(d["ms"] for d in ticks)
    dequant = sum(d["dequant_ms"] for d in ticks)
    if not total or not dequant:
        return None
    return 100.0 * dequant / total
