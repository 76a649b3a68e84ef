"""Share of the prompt tokens admitted in the window that prefill
skipped because their pages were resident: each admission's prefill
start, which is what the engine adds to ``prefix_tokens_saved``, over
its whole prompt (recorded by the span around ``_prefill_batch``)."""


def read(t):
    total = sum(start + n for start, n in t["admitted"])
    if not total:
        return None
    return 100.0 * sum(start for start, _ in t["admitted"]) / total
