#!/usr/bin/env python3
"""Time the serving ticks of two checkouts in turns on one NVIDIA GPU.

    python3 tools/serve_tick_ab.py OTHER [--pairs 5]
        # OTHER: e.g. build/parent, a git archive of the parent commit

Each turn is a fresh process in one checkout. It builds (or loads) that
checkout's kernels and, through that checkout's own ``chip_smoke.serve``,
serves chip_smoke's (c) run once as a warm-up, then (c) again (full-width
qwen1.5-0.5b, seeded random weights, 4-bit SAMD weights, bf16 KV, 16
greedy requests of 32 new tokens) and the bf16 target with no SAMD
weights (phase e's plain decode run). The turns come in pairs whose
first side alternates (OTHER, this, this, OTHER, OTHER, ...), so drift
over the call falls on both sides alike. Each turn prints its summaries;
the last line is one JSON object with every turn's decode tick median
and mean and tokens/s, and each side's median over its turns. Card only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURN_TIMEOUT_S = 900

# one turn, run from the root of a checkout
CHILD = r'''
import json, sys, torch
sys.path[:0] = ["src", "."]
import chip_smoke as cs
from repro_torch.kernels import ops
from repro_torch.quant.config import QuantConfig

dev = torch.device("cuda", 0)
torch.zeros(1, device=dev)  # the CUDA context, before serve reads its stats
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ops.build_kernels()
packed = {cs.SPLITK, cs.TILE, cs.DECODE}
out = {}
for name, expect, kw in (
        ("warm-up", packed, dict(quant=QuantConfig(bits=4))),
        ("(c) 4-bit, bf16 KV", packed, dict(quant=QuantConfig(bits=4))),
        ("bf16 target, plain", {cs.DECODE}, {})):
    eng, summary, _ = cs.serve(name, dev, expect, **kw)
    out[name] = {k: summary[k] for k in (
        "decode_tick_ms_median", "decode_tick_ms_mean", "tokens_per_s",
        "decode_ticks")}
    del eng
    torch.cuda.empty_cache()
print("TURN " + json.dumps(out), flush=True)
'''


def turn(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=checkout,
                          capture_output=True, text=True,
                          timeout=TURN_TIMEOUT_S)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stdout.write(proc.stderr[-4000:])
        raise SystemExit(f"a turn in {checkout} exited {proc.returncode}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    return json.loads(line[-1][len("TURN "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path,
                    help="root of the other checkout (with chip_smoke.py)")
    ap.add_argument("--pairs", type=int, default=5,
                    help="pairs of turns (default 5)")
    args = ap.parse_args()
    order = [side for i in range(args.pairs)
             for side in (("other", "this") if i % 2 == 0
                          else ("this", "other"))]
    trees = {"this": ROOT, "other": args.other.resolve()}
    for tree in trees.values():
        if not (tree / "chip_smoke.py").is_file():
            raise SystemExit(f"no chip_smoke.py in {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    turns = []
    for side in order:
        print(f"-- turn: {side} ({trees[side]})", flush=True)
        turns.append(dict(side=side, **turn(trees[side])))
    runs = [run for run in turns[0] if run != "side"]
    medians = {side: {run: statistics.median(
        t[run]["decode_tick_ms_median"] for t in turns if t["side"] == side)
        for run in runs} for side in trees}
    print(json.dumps({"card": card, "order": order, "turns": turns,
                      "tick_ms_median_of_turns": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
