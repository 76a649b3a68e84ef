"""Multi-pod dry-run (the port of ``repro/launch/dryrun.py``): trace
every (arch x shape) cell on the production meshes and report its
analytic roofline, the collective bytes each rank sends and each rank's
memory.

The reference lowers and compiles each cell on 512 fake host devices.
The port runs the cell's step once, eagerly, as rank 0 of a fake
process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks
(:func:`fake_world`), with every tensor a fake tensor (shapes and
dtypes, no data, no memory) placed as a DTensor by the sharding rules:
each op runs on rank 0's shard, and each collective DTensor issues
returns at once and is counted (``hlo_analysis.CollectiveCounter``).
``--device`` names the mesh's device (``cuda``, the default, or
``cpu``); no kernel runs either way. On a ``cpu`` mesh DTensor replaces
an all-to-all by an all-gather and a chunk, so the card's collective
kinds come from ``--device cuda``.

Usage (``-m repro_torch.launch.dryrun`` with ``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--quant-bits 4]
  python -m repro_torch.launch.dryrun --all --both-meshes --out r.jsonl \
      --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, RunConfig, get_arch
from repro_torch.distributed.sharding import (
    P, cache_pspecs, data_pspec, distribute, param_pspecs, placements,
)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.analytic_costs import cell_cost
from repro_torch.launch.hlo_analysis import (
    HBM_BW, HBM_BYTES, CollectiveCounter, Roofline, model_flops,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import QuantizedTensor
from repro_torch.models.model import build_template, set_activation_sharding
from repro_torch.models.quantize import quantized_spec_tree
from repro_torch.models.spec import (
    TensorSpec, map_specs, param_count, shape_dtype_from_spec,
)
from repro_torch.optim import adamw_init
from repro_torch.quant.config import QuantConfig
from repro_torch.tree import tree_leaves, tree_map


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (its collectives move nothing and return at once), destroyed
    on exit. Refuses to start beside another process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def active_params(cfg) -> int:
    """Parameter count with only top_k of n_experts active (for 6·N·D)."""
    tmpl = build_template(cfg)
    total = param_count(tmpl)
    if cfg.family != "moe":
        return total
    expert = 0

    def add(sp: TensorSpec):
        nonlocal expert
        if "experts" in (sp.axes or ()):
            expert += math.prod(sp.shape)

    map_specs(add, tmpl)
    return total - expert + expert * cfg.top_k // cfg.n_experts


def _fake(tree, device: str):
    """An empty tensor of each meta tensor's shape and dtype on
    ``device`` (fake under the caller's FakeTensorMode), QuantizedTensor
    leaves' words and scales included."""

    def make(t):
        if isinstance(t, QuantizedTensor):
            return dataclasses.replace(t, packed=make(t.packed),
                                       scale=make(t.scale))
        return torch.empty(t.shape, dtype=t.dtype, device=device)

    return tree_map(make, tree)


def _batch_placed(batch: dict, mesh, global_batch: int) -> dict:
    """Each batch tensor split over the data axes on its batch dim."""
    bspec = data_pspec(global_batch, mesh)
    return {k: distribute(v, placements(
        P(bspec[0], *([None] * (v.ndim - 1))), mesh))
        for k, v in batch.items()}


@contextlib.contextmanager
def _propagation_apart():
    """DTensor learns an op's output shape by running the op once on
    global-shape fake tensors, under the fake mode it finds active: the
    dry-run's own. Within this scope it runs them under a fake mode of
    their own, so that the collective counter, which counts only the
    ops of the fake mode it was entered under, sees only the ops on this
    rank's shards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached
    shadow = FakeTensorMode()

    def apart(self, op_schema):
        with shadow:
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = apart
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _tensors(tree) -> list:
    """The tensors of a tree, a QuantizedTensor's words and scales
    included."""
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, QuantizedTensor):
            out += [t.packed, t.scale]
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _local_bytes(tensors) -> int:
    """Bytes of this rank's shards of ``tensors``."""
    from repro_torch.distributed.dtensor import is_dtensor

    return sum((t.to_local() if is_dtensor(t) else t).nbytes
               for t in tensors)


def _trace(cfg, shape, run, mesh, mode, template, param_meta, specs,
           seq_shard_acts, device, kv_bits):
    """Place the cell's fake inputs on ``mesh`` and run its step once
    under the collective counter: (the memory dict, the counter)."""
    qcfg = run.quant
    pspec_tree = param_pspecs(template, mesh,
                              qcfg if qcfg.enabled else None, mode=mode)
    params = distribute(_fake(param_meta, device),
                        placements(pspec_tree, mesh))
    bspec = data_pspec(shape.global_batch, mesh)
    if seq_shard_acts and shape.kind in ("train", "prefill"):
        # Megatron-SP: residual stream sharded on 'model' over sequence
        set_activation_sharding(placements(
            P(bspec[0], "model", None), mesh))
    else:
        set_activation_sharding(None)
    if shape.kind == "train":
        step = steps_mod.make_train_step(cfg, run)
        args = (params, adamw_init(params),
                _batch_placed(_fake(specs["batch"], device), mesh,
                              shape.global_batch))
    else:
        cache = distribute(
            _fake(specs["cache"], device),
            placements(cache_pspecs(cfg, shape, mesh, kv_bits=kv_bits),
                       mesh))
        if shape.kind == "prefill":
            step = steps_mod.make_prefill_step(cfg, run)
            args = (params, _batch_placed(_fake(specs["batch"], device),
                                          mesh, shape.global_batch),
                    cache)
        else:  # decode, the ring's last column
            step = steps_mod.make_serve_step(cfg, run)
            tokens = _batch_placed(
                {"t": _fake(specs["tokens"], device)}, mesh,
                shape.global_batch)["t"]
            args = (params, tokens, cache, shape.seq_len - 1)
    counter = CollectiveCounter()
    inputs = _tensors(args)
    counter.hold(inputs)
    try:
        with _propagation_apart(), counter:
            outputs = step(*args)
    finally:
        set_activation_sharding(None)
    arg_bytes = _local_bytes(inputs)
    ids = {id(t) for t in inputs}
    outs = _tensors(outputs)
    memory = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": _local_bytes(outs),
        "temp_size_in_bytes": counter.peak_bytes - arg_bytes,
        # outputs that are inputs: caches written in place
        "alias_size_in_bytes": _local_bytes(
            [t for t in outs if id(t) in ids]),
    }
    return memory, counter


def lower_cell(
    arch_name: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    quant_bits: int | None = None,
    kv_bits: int | None = None,
    remat: str = "none",
    seq_shard_acts: bool = False,
    mode_override: str | None = None,
    verbose: bool = True,
    device: str = "cuda",
):
    """Trace one cell (no compile: the step runs once on fake tensors of
    a fake group; see the module's docstring). Returns a result dict (or
    raises)."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        return {
            "cell": f"{arch_name}/{shape_name}",
            "status": "skipped",
            "reason": "full-attention arch; long_500k needs sub-quadratic "
                      "attention (DESIGN.md §Arch-applicability)",
        }
    chips = 512 if multi_pod else 256
    if not cfg.uses_attention:
        # no KV cache to quantize (the reference passes kv_bits on, and
        # its cell_cost then divides by the head_dim 0 of an
        # attention-free arch)
        kv_bits = None
    qcfg = (
        QuantConfig(bits=quant_bits)
        if quant_bits and shape.kind != "train"
        else QuantConfig(enabled=False)
    )
    run = RunConfig(arch=cfg, shape=shape, quant=qcfg, remat=remat)
    # train + prefill amortize FSDP weight gathers over a full sequence of
    # compute; decode is latency-bound and uses 1D model sharding so each
    # weight byte is read exactly once per step
    mode = mode_override or ("serve" if shape.kind == "decode" else "train")
    template = build_template(cfg)
    if qcfg.enabled:
        param_meta = quantized_spec_tree(template, qcfg)
    else:
        param_meta = shape_dtype_from_spec(template)
    specs = steps_mod.input_specs(cfg, shape, kv_bits=kv_bits)

    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with fake_world(chips):
        # the mesh reads its own (real) rank tensor: made before the
        # fake mode
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        with FakeTensorMode():
            memory, counter = _trace(cfg, shape, run, mesh, mode, template,
                                     param_meta, specs, seq_shard_acts,
                                     device, kv_bits)
    t_trace = time.time() - t0
    memory["per_device_total_bytes"] = (memory["argument_size_in_bytes"]
                                        + memory["temp_size_in_bytes"])
    memory["fits_80gb_hbm"] = bool(
        memory["per_device_total_bytes"] < HBM_BYTES)

    coll = counter.stats()
    # analytic model (the roofline's source, as in the reference)
    acost = cell_cost(cfg, shape, quant_bits if qcfg.enabled else None,
                      kv_bits=kv_bits)
    roof = Roofline(
        acost.flops / chips,
        acost.hbm_bytes / chips,
        float(coll.total_bytes),
        chips,
    )
    n_active = active_params(cfg)
    tokens = (
        shape.global_batch * shape.seq_len
        if shape.kind != "decode"
        else shape.global_batch
    )
    mf = model_flops(n_active, tokens, shape.kind)

    result = {
        "cell": f"{arch_name}/{shape_name}",
        "status": "ok",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "device": device,
        "quant_bits": quant_bits if qcfg.enabled else None,
        "kv_bits": kv_bits,
        "seq_shard_acts": bool(seq_shard_acts),
        "sharding_mode": mode,
        "trace_s": round(t_trace, 1),
        "flops": acost.flops,
        "hbm_bytes": acost.hbm_bytes,
        "weight_bytes": acost.weight_bytes,
        "cache_bytes": acost.cache_bytes,
        "flop_counter_flops_dev": counter.flops,
        "collective_bytes": roof.collective_bytes,
        "collectives": coll.bytes_by_kind,
        "collective_counts": coll.count_by_kind,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "dominant": roof.dominant,
        "model_flops": mf,
        "useful_flop_frac": mf / acost.flops if acost.flops else 0.0,
        "memory_analysis": memory,
    }
    # HBM traffic lower bound: args read once, outputs written once,
    # temps written+read
    lb = (memory["argument_size_in_bytes"] + memory["output_size_in_bytes"]
          + 2 * memory["temp_size_in_bytes"])
    result["memory_lb_s"] = lb / HBM_BW
    if verbose:
        print(f"== {result['cell']} mesh={result['mesh']} "
              f"quant={result['quant_bits']} device={device} ==")
        print(f"  trace {t_trace:.1f}s")
        print(f"  memory_analysis: {result['memory_analysis']}")
        print(f"  analytic/chip: flops={roof.flops:.3e} "
              f"bytes={roof.hbm_bytes:.3e} coll={roof.collective_bytes:.3e}"
              f"  (flop counter, this rank: {counter.flops:.3e})")
        print(f"  collectives: {coll.bytes_by_kind} {coll.count_by_kind}")
        print(f"  roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"-> {roof.dominant}-bound")
        print(f"  MODEL_FLOPS/ANALYTIC = {result['useful_flop_frac']:.3f}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant-bits", type=int, default=None)
    ap.add_argument("--kv-bits", type=int, default=None,
                    help="int8 KV cache (decode cells)")
    ap.add_argument("--seq-shard-acts", action="store_true",
                    help="sequence-parallel activation sharding "
                         "(train/prefill cells)")
    ap.add_argument("--mode-override", default=None,
                    choices=("train", "serve"),
                    help="force FSDP ('train') or 1-D model ('serve') "
                         "weight sharding regardless of the cell kind")
    ap.add_argument("--remat", default="block",
                    help="'block' (default, needed for 4k-seq training "
                         "memory) or 'none'; applies to train cells only")
    ap.add_argument("--out", default=None, help="write JSONL results here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device type (no kernel runs)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    results = []
    failed = 0
    for arch, shp in cells:
        for mp in meshes:
            try:
                r = lower_cell(
                    arch, shp, multi_pod=mp,
                    quant_bits=args.quant_bits, kv_bits=args.kv_bits,
                    seq_shard_acts=args.seq_shard_acts, remat=args.remat,
                    mode_override=args.mode_override, device=args.device,
                )
            except Exception as e:  # a failure here is a bug in the system
                traceback.print_exc()
                r = {
                    "cell": f"{arch}/{shp}",
                    "mesh": "2x16x16" if mp else "16x16",
                    "status": "FAILED",
                    "error": f"{type(e).__name__}: {e}",
                }
                failed += 1
            results.append(r)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
            gc.collect()  # keep host RSS bounded across 80 cells

    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n==== dry-run: {ok} ok / {sk} skipped / {failed} FAILED ====")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
