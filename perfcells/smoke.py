"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests:
the cell's own configuration and mix with every width and count shrunk.
No number of such a run is a device number."""
from __future__ import annotations

import copy
import json

from perfcells import harness, traffic

SMALL_ARCH = {
    # capacity_factor = n_experts / top_k: an expert can take every token
    # of its group, so no token is dropped, as in the reference
    "moe": dict(n_layers=2, d_model=64, vocab=128, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=96, n_experts=8, top_k=4, expert_d_ff=96,
                capacity_factor=2.0),
    "dense": dict(n_layers=2, d_model=64, vocab=128, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128),
}
SMALL_MIX = {
    "olmoe-1b-7b.chat-decode": dict(
        clients=4, max_batch=4, block=4,
        prompt={"dist": "lognormal", "median": 40, "sigma": 0.6,
                "min": 16, "max": 128},
        output={"dist": "uniform", "min": 4, "max": 16}),
    "nemotron-4-15b.shared-doc-decode": dict(
        clients=4, max_batch=4, block=4, shared_prefix=64, prefix_chunk=32,
        prompt={"dist": "uniform", "min": 4, "max": 24},
        output={"dist": "uniform", "min": 4, "max": 16}),
    "nemotron-4-15b.long-prompt": dict(
        clients=2, max_batch=2, block=2,
        prompt={"dist": "loguniform", "min": 32, "max": 192},
        output={"dist": "uniform", "min": 2, "max": 8}),
}


# olmoe-1b-7b under the chat mix is no cell of the benchmark (PERF.md,
# Open questions), so its small cell borrows the metric lists of the
# decode cell and adds the experts' dequantize share
MOE_CELL = "olmoe-1b-7b.chat-decode"
MOE_LIKE = "nemotron-4-15b.shared-doc-decode"
MOE_DEQUANT = {"name": "moe_dequant_share", "unit": "%", "better": "lower",
               "source": "program_span", "layer": "model",
               "moves": "tokens_per_s"}


def small_cell(name: str, limit: float = 1.0) -> harness.Cell:
    """``name`` at a small size. Its weights are drawn wider than the
    configuration's (std 0.1), so that at 64 wide the logits spread as
    a full-width model's do, and every finished request is compared."""
    if name == MOE_CELL:
        e2e, per_layer = harness.cell_metrics(harness.load_benchmark(),
                                              MOE_LIKE)
        config = json.loads(
            (harness.HERE / "configs/olmoe-1b-7b.json").read_text())
        per_layer = [m for m in per_layer if m["name"] != "prefix_hit_share"]
        cell = harness.Cell(name, config, traffic.load("chat"), {}, e2e,
                            per_layer + [MOE_DEQUANT])
    else:
        cell = copy.deepcopy(harness.load_cell(name))
    cell.config.update(SMALL_ARCH[cell.config["family"]], init_std=0.1)
    cell.mix.update(SMALL_MIX[name], compare_requests=1000)
    cell.limits = {"logit_gap": limit}
    return cell
