#!/usr/bin/env python3
"""Run phases (k) and (l) of chip_smoke.py alone on one NVIDIA GPU.

    python3 tools/words64_dist_runs.py

Builds the kernels and makes (f)'s five samd_conv1d outputs through the
fused 32-bit kernel (the signals of ``chip_smoke.conv1d_signal``), then
``chip_smoke.run_words64`` (the 64-bit SAMD words against those outputs,
a float64 convolution, their 32-bit counterparts and the CPU) and
``chip_smoke.run_distributed`` (two DTensor train steps of full-width
qwen1.5-0.5b on an NCCL group of one rank against the plain step, the
compressed all-reduce, a sharded checkpoint restore). Prints the card's
name and power limit, the phases' lines and one JSON line of their
summaries. A quick way to try a change to (k) or (l) before a whole
``chip_smoke.py`` run. Card only.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("words64_dist_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.nvidia_smi()
    print(card, flush=True)
    ops.build_kernels()
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for case in cs.CONV1D_CASES:
        x, k, plan = cs.conv1d_signal(dev, gen, *case)
        results[case] = (x.cpu(), k.cpu(), ops.samd_conv1d(x, k, plan).cpu())
    words64 = cs.run_words64(dev, cs.Timer(dev), results)
    distributed = cs.run_distributed(dev)
    print(card)
    print(json.dumps({"words64": words64, "distributed": distributed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
