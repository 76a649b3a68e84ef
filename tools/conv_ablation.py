#!/usr/bin/env python3
"""Where the samd_conv2d kernel's time goes, by ablation, on one GPU.

    python3 tools/conv_ablation.py      # from the repository root

Builds copies of ``src/repro_torch/kernels/csrc/samd_conv.cu`` with one
part of the K-step loop taken out (the MMAs, the code unpack, the x tile
loads, or all three) and times each against the intact kernel on VGG-B
layers at 4 bits (f32 x, and conv3_1 with bf16 x), as device time of one
call in a CUDA graph. The ablated
copies compute wrong results: only their times mean anything. Also prints
the device time of the pre-pass and of the GEMM kernel of each call, from
``torch.profiler``, and first times conv1_1 through both conv2d launchers
(im2col, the rule's, and direct). Needs nvcc and a CUDA device.
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

from repro_torch.configs.vggb import VGGB_LAYERS  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import samd_conv as sc  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.quant.packing import pack_conv_weights  # noqa: E402

MMA = ('"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
       '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"')
NO_MMA = ('"add.f32 %0, %0, %0;\\n add.f32 %1, %1, %1;\\n '
          'add.f32 %2, %2, %2;\\n add.f32 %3, %3, %3;\\n '
          '// %4 %5 %6 %7 %8 %9\\n"')
UNPACK = "for (int l = 0; l < VPW / LG; ++l)"
NO_UNPACK = "for (int l = 0; l < 1; ++l)"
LOAD = "const bool ok = a_row[it] < rows_left;"
NO_LOAD = "const bool ok = false;"
ABLATIONS = {
    "no_mma": [(MMA, NO_MMA)],
    "no_unpack": [(UNPACK, NO_UNPACK)],
    "no_x_loads": [(LOAD, NO_LOAD)],
    "none_of_the_three": [(MMA, NO_MMA), (UNPACK, NO_UNPACK),
                          (LOAD, NO_LOAD)],
}
CASES = [("conv1_1", torch.float32), ("conv1_2", torch.float32),
         ("conv2_2", torch.float32), ("conv3_1", torch.float32),
         ("conv3_1", torch.bfloat16), ("conv4_2", torch.float32),
         ("conv5_1", torch.float32)]


def build(name, edits):
    src = sc.KERNEL.source.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
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


def call(lib, x, packed, scale, cfg):
    """One conv through ``lib``'s launchers, with the wrapper's arguments."""
    plan, out, _ws, args = sc.conv2d_launch_args(x, packed, scale, cfg)
    fn = getattr(lib, plan.launcher)
    fn.argtypes = sc._CONV2D_ARGS
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err:
        raise RuntimeError(f"launch failed ({err})")
    return out


def by_launcher(launcher, x, packed, scale, cfg):
    """One conv through the intact kernel's ``launcher``, whatever
    ``conv2d_plan`` would pick."""
    plan, out, _ws, args = sc.conv2d_launch_args(x, packed, scale, cfg,
                                                 launcher=launcher)
    sc.KERNEL.launch(plan.launcher, *args)
    return out


def compare_launchers(dev, gen, layer):
    """conv1_1 (3 channels) through both launchers at 2, 4 and 8 bits, f32
    x, device time in turns (im2col, direct, direct, im2col); both held
    against the plain version."""
    name, c_in, c_out, h, w = layer
    for bits in (2, 4, 8):
        cfg = QuantConfig(bits=bits)
        x = torch.randn(c_in, h, w, generator=gen, device=dev)
        packed, scale = pack_conv_weights(
            torch.randn(3, 3, c_in, c_out, generator=gen, device=dev), cfg)
        plain = sc.samd_conv2d_plain(x, packed, scale, cfg)
        row = {"im2col_ms": [], "direct_ms": []}
        for launcher in (sc.IM2COL, sc.DIRECT):
            got = by_launcher(launcher, x, packed, scale, cfg)
            err = ((got - plain).abs().max() / plain.abs().max()).item()
            if err > 1e-4:
                raise SystemExit(f"{name} {bits}-bit {launcher}: {err}")
        for launcher in (sc.IM2COL, sc.DIRECT, sc.DIRECT, sc.IM2COL):
            key = "im2col_ms" if launcher == sc.IM2COL else "direct_ms"
            row[key].append(graph_ms(
                lambda: by_launcher(launcher, x, packed, scale, cfg)))
        print(json.dumps({"layer": name, "x": "float32", "bits": bits,
                          "launchers": {k: [round(t, 5) for t in v]
                                        for k, v in row.items()}}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_ablation: no CUDA device", file=sys.stderr)
        return 2
    procs = {name: build(name, edits) for name, edits in ABLATIONS.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(
            str(_build.BUILD_DIR / "ablation" / f"{name}.so"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    layers = {lay[0]: lay for lay in VGGB_LAYERS}
    compare_launchers(dev, gen, layers["conv1_1"])
    cfg = QuantConfig(bits=4)
    for name, dtype in CASES:
        _, c_in, c_out, h, w = layers[name]
        x = torch.randn(c_in, h, w, generator=gen, device=dev).to(dtype)
        packed, scale = pack_conv_weights(
            torch.randn(3, 3, c_in, c_out, generator=gen, device=dev), cfg)
        row = {"intact": graph_ms(lambda: ops.samd_conv2d(x, packed, scale,
                                                          cfg))}
        for abl, lib in libs.items():
            row[abl] = graph_ms(lambda: call(lib, x, packed, scale, cfg))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ops.samd_conv2d(x, packed, scale, cfg)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                kind = ("pre_pass_ms" if "_x_kernel" in ev.key
                        else "gemm_ms")
                row[kind] = ev.device_time_total / ev.count / 1e3
        print(json.dumps({"layer": name, "x": str(dtype)[6:], "bits": 4,
                          **{k: round(v, 5) for k, v in row.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
