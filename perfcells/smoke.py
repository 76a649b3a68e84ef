"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests:
the cell's own configuration and mix with every width and count shrunk
(the widths are the family's ``SMALL``).
No number of such a run is a device number."""
from __future__ import annotations

import copy
import json

from perfcells import families, harness, traffic

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


def small_mix(name: str, mix: dict) -> dict:
    """What cell ``name`` changes in its mix ``mix`` at the small size:
    its ``SMALL_MIX`` entry, or, for a cell without one, the mix's own
    length distributions a sixteenth as long (prompts 4-192, answers
    2-16 tokens), at most 4 clients and a shared prefix of at most 64."""
    if name in SMALL_MIX:
        return SMALL_MIX[name]
    n = min(4, int(mix["clients"]))

    def shrunk(dist, lo, hi):
        out = dict(dist)
        for key in ("min", "max", "median"):
            if key in dist:
                out[key] = min(hi, max(lo, int(dist[key]) // 16))
        out["max"] = max(out["max"], out["min"])
        return out

    out = dict(clients=n, max_batch=n, block=min(n, int(mix["block"])),
               prompt=shrunk(mix["prompt"], 4, 192),
               output=shrunk(mix["output"], 2, 16))
    if mix.get("shared_prefix"):
        out.update(shared_prefix=min(64, int(mix["shared_prefix"])),
                   prefix_chunk=32)
    return out


def shrink(cell: harness.Cell, limit: float = 1.0) -> harness.Cell:
    """``cell`` at the small size, in place: its family's ``SMALL``
    widths, drawn wider (std 0.1), so that at 64 wide the logits spread
    as a full-width model's do, its mix by ``small_mix``, and every
    finished request compared."""
    cell.config.update(families.load(cell.config["family"]).SMALL,
                       init_std=0.1)
    cell.mix.update(small_mix(cell.name, cell.mix), compare_requests=1000)
    cell.limits = {"logit_gap": limit}
    return cell


def small_cell(name: str, limit: float = 1.0) -> harness.Cell:
    """Cell ``name`` of ``BENCHMARK.json`` (or ``MOE_CELL``) at the small
    size (``shrink``)."""
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
    return shrink(cell, limit)
