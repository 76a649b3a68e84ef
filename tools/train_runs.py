#!/usr/bin/env python3
"""Run phase (j) of chip_smoke.py alone on one NVIDIA GPU.

    python3 tools/train_runs.py
    python3 tools/train_runs.py --sweep 1e-4:0 3e-4:5 3e-3:5  # lr:warmup

Builds the kernels, then ``chip_smoke.run_training``: full-width
qwen1.5-0.5b trained 20 steps (its step time, tokens/s, model-FLOPs
share and peak memory), the step's numerics on the card against the
CPU, checkpoint and resume through ``launch.train.main``, and the
trained model served 4-bit through the kernels. Prints the card's name
and power limit, the phase's lines and one JSON line of its summary. A
quick way to try a change to phase (j) before a whole ``chip_smoke.py``
run. ``--sweep`` runs only phase (j)'s training (20 steps from the same
seeded weights and batches) once for each lr:warmup pair and prints
each run's losses and median step time, to choose (j)'s lr and warm-up.
Card only.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", nargs="+", metavar="LR:WARMUP")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi()
    print(card, flush=True)
    if args.sweep:
        from repro_torch.configs.archs import QWEN15_05B

        for pair in args.sweep:
            lr, warmup = pair.split(":")
            _, rows = cs.train_run(
                QWEN15_05B, cs.seeded_params(QWEN15_05B, dev), dev,
                cs.TRAIN_STEPS, cs.TRAIN_BATCH, cs.TRAIN_SEQ, float(lr),
                int(warmup))
            losses = [r[0] for r in rows]
            print(json.dumps({
                "lr": float(lr), "warmup": int(warmup), "losses": losses,
                "first5_mean": sum(losses[:5]) / 5,
                "last5_mean": sum(losses[-5:]) / 5,
                "grad_norms": [r[1] for r in rows],
                "step_ms_median": sorted(r[3] for r in rows[1:])[
                    len(rows) // 2 - 1]}), flush=True)
        return 0
    ops.build_kernels()
    training, counts = cs.run_training(dev, card)
    print(json.dumps({"training": training, "launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
