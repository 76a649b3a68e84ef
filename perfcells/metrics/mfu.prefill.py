"""The prefill calls' share of the H100's bfloat16 peak: the model
operations of the prompt tokens they took (bucket padding and padding
rows are no model work), over their device time times 989 TFLOP/s."""
from perfcells import costs


def read(t):
    calls = t["prefill"]
    seconds = sum(p["ms"] for p in calls) / 1e3
    if not seconds:
        return None
    flops = sum(costs.prefill_flops(t["arch"], start, n)
                for p in calls for start, n in p["spans"])
    return 100.0 * flops / (seconds * costs.PEAK_BF16_FLOPS)
