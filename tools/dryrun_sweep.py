"""Run the multi-pod dry-run's cells in parallel processes.

``python -m repro_torch.launch.dryrun --all --both-meshes`` traces the 80
cells one after another in one process. This script runs the same cells,
one ``python -m repro_torch.launch.dryrun --arch A --shape S [--multi-pod]``
process each, ``--jobs`` at a time (the slowest cells first), every
result appended to one JSONL file, and prints the dry-run's summary line
over them. Extra arguments go to every cell's command.

  python3 tools/dryrun_sweep.py --out dryrun.jsonl --jobs 6 -- --device cpu
  python3 tools/dryrun_sweep.py --out q4.jsonl --shapes decode_32k -- \\
      --quant-bits 4 --kv-bits 8

Each cell's log is written beside the JSONL file (``<out>.<cell>.log``).
Exits 1 if a cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# recurrent scans (a Python loop over chunks) and the largest model first
SLOW = ("rwkv6-3b", "zamba2-7b", "arctic-480b")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("extra", nargs="*",
                    help="arguments for every cell (after --)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS, SHAPES

    cells = [(a, s, mp) for a in (args.archs or ARCHS)
             for s in (args.shapes or SHAPES) for mp in (False, True)]
    cells.sort(key=lambda c: (c[0] not in SLOW, c[1] != "train_4k"))
    out = Path(args.out).resolve()
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(cell):
        arch, shape, mp = cell
        tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out), *args.extra]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        with open(f"{out}.{tag}.log", "w") as log:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT).returncode
        print(f"{tag}: rc {rc}, {time.time() - t0:.1f} s", flush=True)
        return rc

    t0 = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        rcs = list(pool.map(run, cells))
    results = [json.loads(line) for line in out.read_text().splitlines()]
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    failed = sum(1 for r in results if r["status"] == "FAILED")
    failed += len(cells) - len(results)  # a cell that wrote no line
    print(f"sweep of {len(cells)} cells, {args.jobs} jobs: "
          f"{time.time() - t0:.1f} s")
    print(f"\n==== dry-run: {ok} ok / {sk} skipped / {failed} FAILED ====")
    return 1 if failed or any(rcs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
