#!/usr/bin/env python3
"""Time samd_matmul's split rule against the one it replaced, on one NVIDIA
GPU.

    python3 tools/split_rule_ab.py

qwen3-14b's wg and wu (K 5120, N 17408: 544 output tiles of the split-K
launcher) at decode, M = 8, 4-bit, each 40 layers of seeded random
weights: the 40 launches captured in one CUDA graph and replayed
(``chip_smoke.graph_ms``), under the half-target rule (no split once the
output tiles reach half the launcher's ``BLOCK_TARGET``) and the current
one (``NO_SPLIT_TILES``), in turns (old, new, new, old). Prints the
card's name and power limit, then one JSON line: each weight's splits
under both rules and its device ms a launch in every turn. Card only.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LAYERS, M, K, N = 40, 8, 5120, 17408
ORDER = ("old", "new", "new", "old")


def main() -> int:
    if not torch.cuda.is_available():
        print("split_rule_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.quant.config import QuantConfig
    from repro_torch.quant.packing import pack_weights

    current = mm.split_k

    def half_target(m, n, k, vpw):
        fn = mm.launcher_for(m)
        bn, bm = mm.BLOCK[fn]
        if 2 * mm._cdiv(n, bn) * mm._cdiv(m, bm) >= mm.BLOCK_TARGET[fn]:
            return 1, max(1, mm._cdiv(mm._cdiv(k, vpw), mm.STEP_WORDS))
        return current(m, n, k, vpw)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = QuantConfig(bits=4)
    ops.build_kernels()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    out = {}
    for name in ("wg", "wu"):
        ws = [pack_weights(torch.randn(K, N, generator=gen, device=dev)
                           * 0.02, cfg) for _ in range(LAYERS)]
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)

        def run():
            return [ops.samd_matmul(x, packed, scale, K, cfg)
                    for packed, scale in ws]

        t = {"old": [], "new": []}
        for who in ORDER:
            mm.split_k = half_target if who == "old" else current
            try:
                t[who].append(chip_smoke.graph_ms(run) / LAYERS)
            finally:
                mm.split_k = current
        vpw = cfg.values_per_word
        out[name] = dict(k=K, n=N, m=M,
                         old_splits=half_target(M, N, K, vpw)[0],
                         new_splits=current(M, N, K, vpw)[0],
                         old_ms=t["old"], new_ms=t["new"])
        del ws
    print(json.dumps({"card": card, "order": ORDER, "split_rule": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
