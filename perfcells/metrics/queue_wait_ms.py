"""Median wait in the front door's queue: the program's ``request.queue``
spans (a request's submission to the start of the prefill that admits
it) over the window's requests."""
import statistics


def read(t):
    rids = {r.rid for r in t["requests"]}
    waits = [s["t1"] - s["t0"] for s in (t.get("program") or {}).get(
        "spans", []) if s["name"] == "request.queue"
        and s["attrs"]["rid"] in rids]
    if not waits:
        return None
    return 1e3 * statistics.median(waits)
