#!/usr/bin/env python3
"""Where the paged-attention kernel's time goes, by ablation, on one GPU.

    python3 tools/attention_ablation.py      # from the repository root

Builds copies of ``src/repro_torch/kernels/csrc/paged_attention.cu`` with
one part taken out (everything: the launch alone; the page loop; the
scoring of the staged pages, their copies kept; the exps; the merge
across the cluster) or with another depth of the copy ring, pages a
step, register cap or block size, and times each against the intact
kernel as device time: 24 layers' launches (seeded pools, one per layer,
at the serving path's mid-run positions) in a CUDA graph, replayed. The
ablated copies compute wrong results: only their times mean anything.
Then times the intact kernel at every split count from 1 to 8 on both
paths (one row a stream; the tensor-core path) against the plan's, and a
one-element ``add_`` the same way (the floor of a kernel in a graph).
Needs nvcc and a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.quant.packing import pack_int8_lanes  # noqa: E402

KERNEL_START = ("  const Layout lay(PACKED, RING, ps, dh, R, n_pp, S, RT, "
                "splits);\n  int* table")
PAGES = "const int n = max(0, min(n_live, j0 + per) - j0);"
SCORE = "const int nkeys = min(STEP_PAGES, j1 - c0) * ps;"
# without the split merge each rank stores its own partial result: no
# stores into other blocks' shared memory, no cluster barrier
MERGE = [("  if (splits > 1) cluster_arrive_relaxed();", ""),
         ("  if (splits > 1) cluster_wait();", ""),
         ("    if (splits == 1) {", "    if (true) {"),
         ("  if (splits == 1) return;", "  return;")]
STAGES = "constexpr int STAGES = 3;"
STEP = "constexpr int STEP_PAGES = 2;"
BOUNDS = "constexpr int BLOCKS_PER_SM = 4;"
THREADS = "constexpr int THREADS = 128;"
ABLATIONS = {
    "launch_only": [(KERNEL_START, "  if (n_pp >= 0) return;\n"
                     + KERNEL_START)],
    "no_pages": [(PAGES, "const int n = 0;")],
    "no_scoring": [(SCORE, "const int nkeys = 0;")],
    "no_cluster_merge": MERGE,
    "stages_2": [(STAGES, "constexpr int STAGES = 2;")],
    "stages_4": [(STAGES, "constexpr int STAGES = 4;")],
    "step_pages_1": [(STEP, "constexpr int STEP_PAGES = 1;")],
    "step_pages_4": [(STEP, "constexpr int STEP_PAGES = 4;")],
    "no_exps": [("__expf(", "(1.f + ")],
    "regs_uncapped": [(BOUNDS, "constexpr int BLOCKS_PER_SM = 1;")],
    "threads_256": [(THREADS, "constexpr int THREADS = 256;"),
                    (BOUNDS, "constexpr int BLOCKS_PER_SM = 2;")],
}
LAYERS, B, N_PP, PS = 24, 8, 32, 16
# the serving workload's mid-run positions (chip_smoke.mid_positions)
POSITIONS = [154, 264, 136, 83, 198, 254, 199, 135]
# (label, kv-heads, G, dh, S, packed): qwen1.5-0.5b's decode and run A's
# and run B's verify, and qwen3-14b's decode
CASES = [("decode bf16", 16, 1, 64, 1, False),
         ("decode int8", 16, 1, 64, 1, True),
         ("verify S=5 bf16", 16, 1, 64, 5, False),
         ("verify S=3 int8", 16, 1, 64, 3, True),
         ("qwen3-14b decode bf16", 8, 5, 128, 1, False),
         ("qwen3-14b verify S=3 bf16", 8, 5, 128, 3, False)]


def ablated(name, edits):
    """The source with ``edits`` made, written beside the build."""
    src = pa.KERNEL.source.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "attention_ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    return out


def build(name, out):
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(out / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def graph_ms(fn, reps=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def case_inputs(dev, gen, hkv, g, dh, s, packed):
    """q, positions, one page table and LAYERS pools of their own."""
    pt = torch.full((B, N_PP), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(B * N_PP, generator=gen, device=dev).int()
    for i, p in enumerate(POSITIONS):
        own = (p + s - 1) // PS + 1
        pt[i, :own] = perm[i * N_PP:i * N_PP + own]
    shape = (B * N_PP, PS, hkv, dh)
    pools = []
    for _ in range(LAYERS):
        if packed:
            kv = torch.randint(-127, 128, (2,) + shape, generator=gen,
                               device=dev).to(torch.int8)
            sc = {n: torch.rand(shape[:3], generator=gen, device=dev) * 0.02
                  for n in ("k_scale", "v_scale")}
            pools.append((pack_int8_lanes(kv[0]), pack_int8_lanes(kv[1]),
                          sc))
        else:
            kv = torch.randn((2,) + shape, generator=gen,
                             device=dev).to(torch.bfloat16)
            pools.append((kv[0], kv[1], {}))
    base = torch.tensor(POSITIONS, dtype=torch.int32, device=dev)
    if s == 1:
        q = torch.randn(B, hkv * g, dh, generator=gen, device=dev)
        return q.to(torch.bfloat16), base, pt, pools
    q = torch.randn(B, s, hkv * g, dh, generator=gen, device=dev)
    pos = base[:, None] + torch.arange(s, device=dev, dtype=torch.int32)
    return q.to(torch.bfloat16), pos, pt, pools


def run(q, pos, pt, pools):
    fn = (ops.paged_decode_attention if q.dim() == 3
          else ops.paged_verify_attention)
    return lambda: [fn(q, k, v, pt, pos, **sc) for k, v, sc in pools]


def with_library(lib, fn):
    """``fn`` with the attention launchers bound to ``lib``."""
    def call():
        saved = pa.KERNEL._fns
        pa.KERNEL._fns = {name: getattr(lib, name)
                          for name in pa.KERNEL.functions}
        try:
            return fn()
        finally:
            pa.KERNEL._fns = saved
    return call


def with_plan(fn, **fields):
    """``fn`` with fields of the plan (splits, rt) replaced."""
    def call():
        plan = pa.attention_plan
        pa.attention_plan = lambda *a: plan(*a)._replace(**fields)
        try:
            return fn()
        finally:
            pa.attention_plan = plan
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_ablation: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sources = {name: ablated(name, edits)
               for name, edits in ABLATIONS.items()}
    procs = {name: build(name, out) for name, out in sources.items()}
    pa.KERNEL.lib()
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(
            str(_build.BUILD_DIR / "attention_ablation" / f"{name}.so"))
        for fn, argtypes in pa.KERNEL.functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    one = torch.zeros(1, device=dev)
    floor = graph_ms(lambda: [one.add_(1) for _ in range(LAYERS)]) / LAYERS
    print(json.dumps({"one_element_add_ms": round(floor, 5)}), flush=True)
    for label, hkv, g, dh, s, packed in CASES:
        q, pos, pt, pools = case_inputs(dev, gen, hkv, g, dh, s, packed)
        intact = run(q, pos, pt, pools)
        plan = pa.attention_plan(B, hkv, s * g, dh, N_PP, PS, s, 0, packed)
        row = {"intact": graph_ms(intact) / LAYERS}
        for name, lib in libs.items():
            print(f"  {label}: {name}", flush=True)
            row[name] = graph_ms(with_library(lib, intact)) / LAYERS
        row["intact_again"] = graph_ms(intact) / LAYERS
        by_plan = {
            f"rt={rt} splits={k}": round(graph_ms(with_plan(
                intact, rt=rt, splits=k)) / LAYERS, 5)
            for rt in (1, pa.MMA_ROWS) if rt == 1 or dh in pa.MMA_HEAD_DIMS
            for k in range(1, 9)}
        print(json.dumps({"case": label, "plan": plan._asdict(),
                          **{k: round(v, 5) for k, v in row.items()},
                          "by_plan": by_plan}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
