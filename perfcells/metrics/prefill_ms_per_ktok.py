"""Device time of the window's prefill calls (timing events around the
engine's ``_prefill_step``) per 1000 prompt tokens they took (each
admitted prompt's unshared part; bucket padding is not counted)."""


def read(t):
    calls = t["prefill"]
    tokens = sum(n for p in calls for _, n in p["spans"])
    if not tokens:
        return None
    return sum(p["ms"] for p in calls) / (tokens / 1000.0)
