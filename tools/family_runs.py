#!/usr/bin/env python3
"""Run phase (i) of chip_smoke.py alone, at chosen depths, on one NVIDIA
GPU.

    python3 tools/family_runs.py                 # 2, 2 and 6 layers
    python3 tools/family_runs.py 16 32 81        # full depth

Builds the kernels, then ``chip_smoke.run_families``: decode attention
at olmoe-1b-7b's and nemotron-4-15b's shapes, and olmoe-1b-7b, rwkv6-3b
and zamba2-7b at full width with the given numbers of layers, each
serving (c)'s 16 requests with phase (i)'s checks and timings. Prints
the card's name and power limit, each run's lines, and one JSON line of
the runs' summaries and kernel entries. A quick way to try a change to
phase (i) before a whole ``chip_smoke.py`` run. Card only.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_LAYERS = (2, 2, 6)


def main() -> int:
    if not torch.cuda.is_available():
        print("family_runs: no CUDA device", file=sys.stderr)
        return 2
    layers = tuple(map(int, sys.argv[1:])) or DEFAULT_LAYERS
    if len(layers) != 3:
        print("family_runs: give three depths or none", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    ops.build_kernels()
    gen = torch.Generator(device=dev).manual_seed(0)
    families, entries = cs.run_families(dev, cs.Timer(dev), gen,
                                        cs.LaunchLog(), layers)
    print(json.dumps({"families": families, "kernels": entries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
