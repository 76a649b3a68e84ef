#!/usr/bin/env python3
"""Where the fused samd_conv1d kernel's time goes, by ablation, on one GPU.

    python3 tools/conv1d_ablation.py      # from the repository root

Builds copies of ``src/repro_torch/kernels/csrc/samd_conv.cu`` with parts
of the fused kernel taken out and times each against the intact kernel
on chip_smoke.py's signal (3,211,264 values, 3 taps; the four plans with
int64 x, and the 4-bit signed plan with int8 x), as device time of one
call with L2 cold (``chip_smoke.cold_graph_ms``: calls over copies of the
inputs captured in one CUDA graph). The parts:

- ``launch_only``: every block returns at once;
- ``loads_only``: each tile's values and halo come into shared memory,
  nothing is computed or stored;
- ``loads_stores``: loads and the 16-byte stores of the outputs, with no
  packing, no products and no lane extraction;
- ``no_products``: no packing and no products (the epilogue extracts
  its lanes from whatever shared memory holds);
- ``intact``.

Then the intact kernel at several tile sizes (chunks a tile, as
``conv1d_plan`` makes them with ``C1D_TILE_CHUNKS`` rebound: a row names
the tile it got, which the byte budget may cut) and counts of persistent
blocks an SM (``C1D_BLOCKS_PER_SM`` rebound), and the chunk launcher with
its staged stores against the same kernel storing each thread's lanes
straight to device memory (the first version's pattern). Ablated copies compute wrong results: only their times mean
anything. Needs nvcc and a CUDA device.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    CONV1D_CASES, CONV1D_N, CONV1D_TAPS, L2_BYTES, cold_graph_ms, copies,
    nvidia_smi,
)
from repro_torch.core.conv import (  # noqa: E402
    make_plan, pack_conv_kernel, pack_conv_operand,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import samd_conv as sc  # noqa: E402

STOP = "  if (a.n >= 0) return;  // ablation\n"
KERNEL_START = "  const Conv1dSmem lay(a.tile_chunks, a.lanes, (int)sizeof(T));\n"
PRODUCTS = ("    for (int i = tid; i < a.tile_chunks; i += C1D_THREADS)\n"
            "      prods[i + 1] = chunk_product(")
HALO = "    if (tid == C1D_THREADS - 1)\n      prods[0] = chunk_product("
NO_PRODUCTS = [(PRODUCTS, PRODUCTS.replace("i < a.tile_chunks", "i < 0")),
               (HALO, HALO.replace("tid == C1D_THREADS - 1", "tid < 0"))]
OUTPUTS = "    for (int v = tid; 4 * v < count; v += C1D_THREADS) {"
LANE = "uint32_t val = (uint32_t)product_lane(prods[c + 1], t, a.L, sg);"
TAIL = ("        if (t < tl)\n"
        "          val += (uint32_t)product_lane(prods[c], t + a.lanes, a.L, "
        "sg);\n")
STAGE = "      staged[tid * out_lanes + t] = product_lane(p, t, L, sg);"
STORE = ("  const int count = (left < CHUNK_THREADS ? (int)left : "
         "CHUNK_THREADS) *")
VARIANTS = {
    "launch_only": [(KERNEL_START, STOP + KERNEL_START)],
    "loads_only": NO_PRODUCTS + [(OUTPUTS, OUTPUTS.replace("< count",
                                                           "< 0"))],
    "loads_stores": NO_PRODUCTS + [(LANE, "uint32_t val = t;"),
                                   (TAIL, "")],
    "no_products": NO_PRODUCTS,
    "chunks_unstaged": [
        (STAGE, "      out[(c0 + tid) * out_lanes + t] = "
                "product_lane(p, t, L, sg);"),
        (STORE, "  const int count = 0 *")],
}
TILES = (128, 256, 512, 1024, 2048)
BLOCKS_PER_SM = (1, 2, 3, 4, 6, 8)


def build(name, edits):
    src = sc.KERNEL.source.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer has {old!r} "
                             "once")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"conv1d_{name}.cu").write_text(src)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out / f"conv1d_{name}.so"), str(out / f"conv1d_{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out / f"conv1d_{name}.so"


def bind(lib, fn):
    f = getattr(ctypes.CDLL(str(lib)), fn)
    f.argtypes = sc.KERNEL.functions[fn]
    f.restype = ctypes.c_int
    return f


@contextlib.contextmanager
def plan_constants(**values):
    """``conv1d_plan`` with module constants of ``samd_conv`` rebound
    (e.g. ``C1D_TILE_CHUNKS=256``) for the body of the ``with``."""
    old = {name: getattr(sc, name) for name in values}
    for name, v in values.items():
        setattr(sc, name, v)
    sc.conv1d_plan.cache_clear()
    try:
        yield
    finally:
        for name, v in old.items():
            setattr(sc, name, v)
        sc.conv1d_plan.cache_clear()


def fused_call(fn, x, k, plan):
    def call():
        _, out, args = sc.conv1d_launch_args(x, k, plan)
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out
    return call


def chunks_call(fn, xw, kw, plan):
    def call():
        nc, lanes = xw.shape[0], plan.out_lanes_per_chunk
        out = torch.empty((nc, lanes), dtype=torch.int32, device=xw.device)
        err = fn(xw.data_ptr(), kw.data_ptr(), out.data_ptr(), nc,
                 plan.fmt.lane_width, lanes, int(plan.fmt.signed),
                 _build.stream_handle(xw))
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("conv1d_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {nvidia_smi()}", flush=True)
    sc.KERNEL.lib()  # the intact kernel, built by the port's own rule
    started = {name: build(name, edits) for name, edits in VARIANTS.items()}
    libs = {"intact": sc.KERNEL.library}
    for name, (proc, lib) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = lib
    fused = {name: bind(lib, sc.CONV1D) for name, lib in libs.items()
             if not name.startswith("chunks")}
    gen = torch.Generator(device=dev).manual_seed(0)
    for bits, signed, dtype in CONV1D_CASES:
        lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                  else (0, (1 << bits) - 1))
        x = torch.randint(lo, hi + 1, (CONV1D_N,), generator=gen,
                          device=dev).to(dtype)
        k = torch.randint(lo, hi + 1, (CONV1D_TAPS,), generator=gen,
                          device=dev)
        plan = make_plan(bits, CONV1D_TAPS, signed)
        n_bytes = (x.numel() * x.element_size() + k.numel() * 8
                   + (x.numel() + CONV1D_TAPS - 1) * 4)
        xk = copies(x, k)
        row = {"case": f"{bits}-bit signed={signed} {str(dtype)[6:]} x",
               "bound_ms": n_bytes / 3.35e12 * 1e3}
        for name, fn in fused.items():
            row[name] = cold_graph_ms(
                lambda i, fn=fn: fused_call(fn, *xk(i), plan), n_bytes)
        intact = fused["intact"]
        row["tile"] = sc.conv1d_plan(x.numel(), plan, dtype).tile_chunks
        for tile in TILES:
            with plan_constants(C1D_TILE_CHUNKS=tile):
                got = sc.conv1d_plan(x.numel(), plan, dtype).tile_chunks
                row.setdefault(f"tile_{got}", cold_graph_ms(
                    lambda i: fused_call(intact, *xk(i), plan), n_bytes))
        for bps in BLOCKS_PER_SM:
            with plan_constants(C1D_BLOCKS_PER_SM=bps):
                row[f"blocks_per_sm_{bps}"] = cold_graph_ms(
                    lambda i: fused_call(intact, *xk(i), plan), n_bytes)
        if dtype == torch.int64:
            xw = pack_conv_operand(x, plan)
            kw = pack_conv_kernel(k, plan)
            nc = xw.shape[0]
            c_bytes = nc * 4 + 4 + nc * plan.out_lanes_per_chunk * 4
            xw_i = copies(xw)
            for key, name in (("chunks_staged", "intact"),
                              ("chunks_unstaged", "chunks_unstaged")):
                fn = bind(libs[name], sc.CHUNKS)
                row[key] = cold_graph_ms(
                    lambda i, fn=fn: chunks_call(fn, *xw_i(i), kw, plan),
                    c_bytes)
            row["chunks_bound_ms"] = c_bytes / 3.35e12 * 1e3
        print(json.dumps({key: (round(v, 5) if isinstance(v, float) else v)
                          for key, v in row.items()}), flush=True)
    print(f"L2 cold: copies of the inputs whose traffic between two uses "
          f"of one copy is at least 2 x {L2_BYTES} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
