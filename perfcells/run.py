"""Run one cell of the benchmark once and print its result line.

    python3 perfcells/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1> [--dump FILE]

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. The run needs
an NVIDIA card: without one it exits 1 and prints no result. It prints the
numbers its check compared, each beside its limit, as the last lines of
standard error, and one JSON object as the last line of standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own nvcc cache is ``build/repro_torch``)."""
    cache = ROOT / "build" / "perfcells"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def _loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None,
                    help="also write the run's timings, trace summary and "
                         "per-request gaps to this JSON file")
    args = ap.parse_args(argv)
    _cache_dirs()
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfcells":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfcells import harness

    cell = harness.load_cell(args.workload)
    chips = 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfcells: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    bad = _loaded_forbidden()
    if bad:
        print(f"perfcells: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    if args.dump:
        harness.dump(run, args.dump)
    for name, c in run.result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(run.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
