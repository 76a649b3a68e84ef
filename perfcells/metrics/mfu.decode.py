"""The decode steps' share of the H100's bfloat16 peak: the model
operations of every active row of the window's decode steps (matmuls
through the weights a token uses, the LM head, attention over its
context), over the steps' device time times 989 TFLOP/s."""
from perfcells import costs


def read(t):
    ticks = t["decode"]
    seconds = sum(d["ms"] for d in ticks) / 1e3
    if not seconds:
        return None
    flops = sum(costs.token_flops(t["arch"], c)
                for d in ticks for c in d["contexts"])
    return 100.0 * flops / (seconds * costs.PEAK_BF16_FLOPS)
