"""Share of the engine's device time that went to prefill calls: timing
events around ``_prefill_step`` against those and the ones around
``_decode_step``, over the window's calls."""


def read(t):
    prefill = sum(p["ms"] for p in t["prefill"])
    decode = sum(d["ms"] for d in t["decode"])
    if not prefill + decode:
        return None
    return 100.0 * prefill / (prefill + decode)
