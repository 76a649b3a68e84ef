"""The control of a cell's check, and the program's own readings beside
it, over several seeds in one process.

    python3 perfcells/control.py --workload <cell> --seeds 1,2,3 --seconds 51

For each seed it runs the cell as ``run.py`` does (a window of
``--seconds``), then puts the reference in the program's place computed
one step below the configuration's precision (``fp8``: float8 e4m3
activations and keys and values) and reads, at each position of the same
compared prompts and served tokens, the gap of the token that the control
puts first, below the float32 reference's best. ``bf16`` reads what the
configuration's own precision does in the reference's hands. One JSON
line a seed: the program's widest gap and each control's. The
benchmark's own runs do not run it. Needs a card, as ``run.py`` does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PRECISIONS = ("fp8", "bf16")     # the control, and the configuration's own


def control_readings(cell, run, precisions, device) -> dict:
    """{precision: the widest gap, under the run's float32 reference
    logits, of the tokens that ``precision``'s reference puts first at
    the run's compared positions}, and under ``<precision>.mean`` the
    mean gap over those positions."""
    from perfcells import harness

    shared = int(cell.mix.get("shared_prefix", 0))
    out = {}
    for p in precisions:
        ctrl = harness.reference_logits(cell.config, run.seed, device,
                                        run.checked, shared, p)
        gaps = harness.logit_gaps(run.logits,
                                  [lg.argmax(dim=-1).cpu() for lg in ctrl])
        out[p] = max(float(g.max()) for g in gaps if len(g))
        out[f"{p}.mean"] = mean_gap(gaps)
    return out


def mean_gap(gaps) -> float:
    n = sum(len(g) for g in gaps)
    return sum(float(g.sum()) for g in gaps) / n if n else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfcells":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfcells import harness

    if not torch.cuda.is_available():
        print("perfcells: the control needs a CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = harness.run_cell(cell, seed, args.seconds, False, "cuda", t)
        row = {"workload": args.workload, "seed": seed,
               "program": run.result["check"]["logit_gap"]["value"],
               "program.mean": mean_gap(run.gaps),
               "compared_tokens": run.result["check"]["compared_tokens"]
               ["value"], "failed": run.result["failed"]}
        row.update(control_readings(cell, run, PRECISIONS, "cuda"))
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
