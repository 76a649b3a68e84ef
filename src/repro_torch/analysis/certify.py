"""Repo-wide lane-safety certification sweep.

Certifies every configuration the repo ships, as the reference's
``repro.analysis.certify`` does:

* the paper's VGG-B evaluation grid: ``bits`` in {2, 4, 8} x
  signed/unsigned x every reduction depth of ``configs/vggb.py`` (3x3
  kernels, K = 9 * C_in), through the ``samd_conv2d`` / ``samd_matmul``
  storage contracts and, where a 3-tap packed-domain plan fits a 32-bit
  word, the whole ConvPlan pipeline at the paper's ``conv_lane_width``;
* the serving rows of ``BENCH_serving.json``: each row name maps through
  ``SERVING_VARIANTS`` (the port's copy of the variant table of
  ``benchmarks/bench_serving.py``) to the weight and draft quantization
  it served, checked at the bench model's reduction depths.

Exit status 0 iff every verdict is ``safe``; ``--json`` prints the whole
verdict list (one object per certified tuple).

Run:  PYTHONPATH=src python -m repro_torch.analysis.certify [--json] \\
          [--bench BENCH_serving.json]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import contracts
from repro_torch.analysis.lanes import Verdict
from repro_torch.configs.vggb import VGGB_LAYERS
from repro_torch.core.conv import ConvPlan
from repro_torch.core.samd import SAMDFormat, conv_lane_width
from repro_torch.quant.config import QuantConfig

BITS_SWEEP = (2, 4, 8)
CONV_TAPS = 3  # the paper's 3x3 kernels, row-major: 3 taps per word

# (row suffix, quantization it served) of the serving benchmark's rows:
# weight bits and the speculative draft's bits where the row sets them
SERVING_VARIANTS = [
    ("per_row_bf16", {}),
    ("paged_fused_bf16", {}),
    ("paged_bf16", {}),
    ("ragged_ring_bf16", {}),
    ("paged_fused_b4", dict(bits=4)),
    ("paged_b4", dict(bits=4)),
    ("paged_fused_burst_bf16", {}),
    ("spec_k2_bf16", dict(draft_bits=8)),
    ("spec_k4_bf16", dict(draft_bits=8)),
]
FULL_ONLY_VARIANTS = [
    ("paged_b8", dict(bits=8)),
    ("paged_fused_int8kv", dict(bits=8, kv_bits=8)),
]
# the benchmark's smoke model (benchmarks/bench_serving.py ``_cfg``)
BENCH_ARCH = dict(n_layers=2, d_model=128, vocab=512, n_heads=4,
                  n_kv_heads=4, head_dim=32, d_ff=256)


def _entry(name: str, verdict: Verdict) -> dict:
    d = verdict.to_dict()
    d["config"] = name
    return d


def certify_vggb() -> list[dict]:
    """bits x signedness x VGG-B reduction depths, plus the packed-domain
    ConvPlan certificate of each format."""
    out = []
    depths = sorted({9 * c_in for _, c_in, *_ in VGGB_LAYERS})
    for bits in BITS_SWEEP:
        cfg = QuantConfig(bits=bits)
        for signed in (True, False):
            sig = "s" if signed else "u"
            for _, c_in, *_ in sorted({(n, c) for n, c, *_ in VGGB_LAYERS}):
                v = contracts.check_conv2d_config(cfg, 3, 3, c_in,
                                                  signed=signed)
                out.append(_entry(f"vggb/conv2d_b{bits}{sig}_cin{c_in}", v))
            for k in depths:
                v = contracts.check_matmul_config(cfg, k, signed=signed)
                out.append(_entry(f"vggb/matmul_b{bits}{sig}_k{k}", v))
            # packed-domain: paper Fig. 14 loop, lane width from Table 2
            lane = conv_lane_width(bits, CONV_TAPS, signed)
            if CONV_TAPS * lane <= 32:
                plan = ConvPlan(SAMDFormat(bits, lane, signed), CONV_TAPS)
                v = contracts.check_conv_plan(plan)
                out.append(_entry(f"vggb/convplan_b{bits}{sig}", v))
    return out


def bench_template():
    """The TensorSpec template of the serving benchmark's model."""
    from repro_torch.configs.archs import smoke_config
    from repro_torch.models.model import build_template

    return build_template(smoke_config("qwen1.5-0.5b").scaled(**BENCH_ARCH))


def certify_serving(bench_path: Path) -> list[dict]:
    """Every quantized row of the serving benchmark's artifact at the
    bench model's reduction depths."""
    rows = json.load(open(bench_path))["rows"]
    table = dict(SERVING_VARIANTS) | dict(FULL_ONLY_VARIANTS)
    depths = contracts.model_reduction_depths(bench_template())
    out = []
    for row in rows:
        suffix = row["name"].split("/", 1)[-1]
        spec = table.get(suffix)
        if spec is None:
            continue  # acceptance-check rows (prefix share etc.): bf16
        configs = []
        if spec.get("bits"):
            configs.append(("weights", QuantConfig(bits=spec["bits"])))
        if spec.get("draft_bits"):
            configs.append(("draft", QuantConfig(bits=spec["draft_bits"])))
        for role, cfg in configs:
            for k in depths:
                v = contracts.check_matmul_config(cfg, k)
                out.append(_entry(f"serving/{suffix}/{role}_k{k}", v))
    return out


def run(bench_path: Path) -> tuple[list[dict], int]:
    entries = certify_vggb()
    if bench_path.exists():
        entries += certify_serving(bench_path)
    else:
        print(f"certify: {bench_path} missing, serving sweep skipped",
              file=sys.stderr)
    failures = sum(1 for e in entries if e["status"] != "safe")
    return entries, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", type=Path, default=Path("BENCH_serving.json"),
                    help="serving benchmark artifact to map rows from")
    ap.add_argument("--json", action="store_true", help="dump verdicts")
    args = ap.parse_args(argv)

    entries, failures = run(args.bench)
    if args.json:
        json.dump(entries, sys.stdout, indent=1)
        print()
    else:
        for e in entries:
            if e["status"] != "safe":
                print(f"UNSAFE {e['config']}: {e['detail']}")
        print(f"certify: {len(entries)} configurations checked, "
              f"{failures} unsafe")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
