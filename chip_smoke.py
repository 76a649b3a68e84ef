#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, any failure exits non-zero:
  (a) build every CUDA kernel of ``src/repro_torch/kernels/csrc`` with nvcc
      for sm_90a, one process per source, all at once;
  (b) hold each kernel against its plain PyTorch version on the card at the
      serving path's shapes (stated tolerances below), and check that the
      matmul kernel unpacks the packed codes exactly;
  (c) serve full-width qwen1.5-0.5b (24 layers, seeded random weights,
      4-bit SAMD weights through the kernel route) with ``ServingEngine``:
      16 greedy requests, prompts of 32-256 tokens, 32 new tokens each,
      once with bf16 KV and once with packed int8 KV; every request must
      finish untruncated, every kernel must have launched, and the model's
      logits on a small input must agree with the same model run through
      the kernels' plain versions on the CPU;
  (d) time each kernel at its decode shape beside its plain version, the
      one PyTorch call that computes the same function (``library_ms``, a
      yardstick the port never calls) and its bound: the larger of its
      bytes over 3.35 TB/s and its operations over 989 TFLOP/s (H100 SXM
      HBM3 and dense bf16 peaks).

The last three lines are the card's name and power limit from nvidia-smi,
one JSON object with every kernel's numbers, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, the script exits non-zero with
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# kernel vs plain on the card: both accumulate in f32 and round the output
# to bf16 (8 significant bits), in different orders, so they may land one
# or two bf16 rounding steps apart: rtol = atol = 1e-2 of the output scale
BF16_TOL = 1e-2
# full model through the kernels vs through the plain versions on the CPU:
# 24 bf16 layers of such differences: 5e-2 of the largest logit
MODEL_TOL = 5e-2
SERVE = dict(max_batch=8, max_len=512, page_size=16)
N_REQUESTS, MAX_TOKENS = 16, 32
MATMUL_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024)]
DECODE_LINEARS = [("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                  ("attn", "wo"), ("mlp", "wg"), ("mlp", "wu"),
                  ("mlp", "wd")]


def log(*args):
    print(*args, flush=True)


class Timer:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls, from CUDA
    events around the whole run (after warm-up calls)."""

    def __init__(self, device):
        self.device = device

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def max_err(got, want, tol):
    """Max |got - want|, raising if any element is outside
    atol + rtol * |want| with atol = tol * max|want|, rtol = tol."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = tol * want.abs().max() + tol * want.abs()
    if not torch.isfinite(got).all() or (err > limit).any():
        raise AssertionError(
            f"mismatch: max err {err.max().item():.4g}, "
            f"scale {want.abs().max().item():.4g}")
    return err.max().item()


# -- (b) kernels against their plain versions --------------------------------

def check_samd_matmul(dev, gen):
    from repro_torch.core import samd
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.quant.config import QuantConfig
    from repro_torch.quant.packing import pack_weights, unpack_weights

    worst, n = 0.0, 0
    for bits in (2, 4, 8):
        for spacer in ("temporary", "permanent"):
            cfg = QuantConfig(bits=bits, spacer=spacer)
            for k, nn in MATMUL_SHAPES:
                w = torch.randn(k, nn, generator=gen, device=dev)
                for signed in (True, False):
                    if signed:
                        packed, scale = pack_weights(w, cfg)
                    else:
                        codes = torch.randint(0, 2 ** bits, (nn, k),
                                              generator=gen, device=dev)
                        fmt = samd.SAMDFormat(bits, cfg.lane_width, False)
                        packed = samd.pack(codes, fmt).t().contiguous()
                        scale = torch.rand(1, nn, generator=gen,
                                           device=dev) * 0.1
                    for m in (8, 1024):
                        x = torch.randn(m, k, generator=gen, device=dev)
                        x = x.to(torch.bfloat16)
                        got = ops.samd_matmul(x, packed, scale, k, cfg,
                                              signed=signed)
                        want = mm.samd_matmul_plain(x, packed, scale, k,
                                                    cfg, signed=signed)
                        worst = max(worst, max_err(got, want, BF16_TOL))
                        n += 1
            # exact unpack: one-hot rows and unit scales read codes back
            k = 1024
            packed, _ = pack_weights(
                torch.randn(k, 64, generator=gen, device=dev), cfg)
            rows = torch.randint(0, k, (8,), generator=gen, device=dev)
            x = torch.zeros(8, k, dtype=torch.bfloat16, device=dev)
            x[torch.arange(8, device=dev), rows] = 1
            got = ops.samd_matmul(x, packed, torch.ones(64, device=dev), k,
                                  cfg)
            codes = unpack_weights(packed, k, cfg)[rows]
            if not torch.equal(got.float(), codes.float()):
                raise AssertionError(f"codes not exact at {bits}/{spacer}")
    log(f"  samd_matmul: {n} cases within tolerance, codes exact; "
        f"max |kernel - plain| = {worst:.4g}")
    return worst


def paged_case(dev, gen, b, hkv, g, dh, ps, n_pp, packed, lens):
    """q, pools and a page table: slot i owns ceil((lens[i]+1)/ps) distinct
    random pages followed by -1, at position lens[i]; lens[i] < 0 makes
    slot i empty (row all -1)."""
    n_pages = b * n_pp
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    pt = torch.full((b, n_pp), -1, dtype=torch.int32, device=dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    for i, ln in enumerate(lens):
        if ln < 0:
            continue
        own = ln // ps + 1
        pt[i, :own] = perm[i * n_pp:i * n_pp + own]
        pos[i] = ln
    q = torch.randn(b, hkv * g, dh, generator=gen, device=dev)
    q = q.to(torch.bfloat16)
    shape = (n_pages, ps, hkv, dh)
    if packed:
        from repro_torch.quant.packing import pack_int8_lanes

        def pool():
            v = torch.randint(-127, 128, shape, generator=gen, device=dev)
            return pack_int8_lanes(v.to(torch.int8))

        def scale():
            return torch.rand(shape[:3], generator=gen, device=dev) * 0.02

        return (q, pool(), pool(), pt, pos), dict(k_scale=scale(),
                                                  v_scale=scale())
    kv = torch.randn((2,) + shape, generator=gen, device=dev)
    kv = kv.to(torch.bfloat16)
    return (q, kv[0], kv[1], pt, pos), {}


def check_paged_attention(dev, gen):
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    """Returns the max |kernel - plain| of each pool format, keyed by
    "bf16" and "int8", over its G = 1 and G = 4 cases."""
    worst = {}
    for packed in (False, True):
        fmt = "int8" if packed else "bf16"
        worst[fmt] = 0.0
        for hkv, g in ((16, 1), (4, 4)):
            lens = [40, -1, 255, 16, 15, 300, 0, 511]  # slot 1 is empty
            args, kw = paged_case(dev, gen, 8, hkv, g, 64, 16, 32, packed,
                                  lens)
            got = ops.paged_decode_attention(*args, **kw)
            want = pa.paged_decode_attention_plain(*args, **kw)
            worst[fmt] = max(worst[fmt], max_err(got, want, BF16_TOL))
            if not (got[1] == 0).all():
                raise AssertionError("an empty slot must emit zeros")
        log(f"  paged_decode_attention ({fmt} KV): G = 1 and 4 within "
            f"tolerance, empty slot exact zeros; max |kernel - plain| = "
            f"{worst[fmt]:.4g}")
    return worst


# -- (c) serving -------------------------------------------------------------

def workload(seed):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, 151936,
                                               size=int(rng.integers(32, 257))
                                               ).astype(np.int32),
                    max_tokens=MAX_TOKENS)
            for i in range(N_REQUESTS)]


def serve(cfg, kv_bits, dev, seed=0):
    """Serve the workload; returns (engine, summary dict, launch counts)."""
    from repro_torch.kernels import ops
    from repro_torch.quant.config import QuantConfig
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    eng = ServingEngine(cfg, None, quant=QuantConfig(bits=4, kv_bits=kv_bits),
                        seed=seed, device=dev, **SERVE)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t0
    for r in workload(seed + 1):
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    decode_ms, ticks = [], 0
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        prefills = eng.stats["prefill_calls"]
        t = time.perf_counter()
        eng.step()  # ends in a host sync (the sampled ids)
        if eng.stats["prefill_calls"] == prefills:
            decode_ms.append((time.perf_counter() - t) * 1e3)
        ticks += 1
        if ticks > 2000:
            raise AssertionError("engine made no progress")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    done = eng.finished
    if len(done) != N_REQUESTS:
        raise AssertionError(f"{len(done)} of {N_REQUESTS} finished")
    for r in done:
        if r.error or r.truncated or len(r.generated) != MAX_TOKENS:
            raise AssertionError(f"request {r.rid}: error={r.error} "
                                 f"truncated={r.truncated} "
                                 f"n={len(r.generated)}")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.rid}: token out of range")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} never launched ({counts})")
    gen_tokens = sum(len(r.generated) for r in done)
    summary = dict(
        kv="int8" if kv_bits else "bf16", init_s=round(t_init, 3),
        serve_s=round(wall, 3), ticks=ticks, decode_ticks=len(decode_ms),
        decode_tick_ms_median=round(float(np.median(decode_ms)), 3),
        decode_tick_ms_mean=round(float(np.mean(decode_ms)), 3),
        tokens_per_s=round(gen_tokens / wall, 1),
        prefill_calls=eng.stats["prefill_calls"],
        peak_mem_gib=round(torch.cuda.max_memory_allocated(dev) / 2**30, 2),
        launches=counts)
    log(f"  serve ({summary['kv']} KV): " + json.dumps(summary))
    return eng, summary, counts


def check_model_against_plain(eng, dev):
    """Logits of a 24-token prefill (gather attention) and a fused decode
    token, through the kernels on the card and through the plain versions
    on the CPU, for the engine's own weights and KV format."""
    from repro_torch.models.layers import QuantizedTensor
    from repro_torch.models.model import forward, init_paged_cache

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        if isinstance(tree, QuantizedTensor):
            return QuantizedTensor(tree.packed.cpu(), tree.scale.cpu(),
                                   tree.orig_shape, tree.axis, tree.cfg)
        return tree.cpu()

    cfg, ps = eng.cfg, eng.page_size
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, size=(2, 24))
    pos = np.where(np.arange(24)[None] < np.array([[24], [19]]),
                   np.arange(24)[None], -1)
    pt = np.array([[3, 1], [0, 2]], np.int32)
    dec = rng.integers(0, cfg.vocab, size=(2, 1))
    dpos = np.array([[24], [19]])
    out = {}
    for device, params in ((dev, eng.params), ("cpu", to_cpu(eng.params))):
        cache = init_paged_cache(cfg, 4, ps, kv_bits=eng._kv_bits,
                                 device=device)
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in dict(toks=toks, pos=pos, pt=pt, dec=dec,
                              dpos=dpos).items()}
        pre = forward(params, t["toks"], cfg, positions=t["pos"],
                      cache=cache, page_table=t["pt"], page_size=ps)
        nxt = forward(params, t["dec"], cfg, positions=t["dpos"],
                      cache=cache, page_table=t["pt"], page_size=ps,
                      paged_attn="fused")
        valid = t["pos"] >= 0
        out[device] = (pre[valid].float().cpu(), nxt.float().cpu())
    errs = [max_err(a, b, MODEL_TOL) for a, b in zip(out[dev], out["cpu"])]
    for a in out[dev]:
        if a.shape[-1] != cfg.vocab:
            raise AssertionError(f"logits shape {tuple(a.shape)}")
    log(f"  full-width logits, kernels on the card vs plain on the CPU: "
        f"max err prefill {errs[0]:.4g}, decode {errs[1]:.4g} "
        f"(scale {out['cpu'][0].abs().max().item():.4g})")


# -- (d) timing at decode shapes ---------------------------------------------

def time_samd_matmul(eng, dev, timer):
    """Per-launch times over the 24 layers' weights of each decode linear
    (M = max_batch), so the weights come from HBM as in a decode tick."""
    from repro_torch.kernels import samd_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.quant.packing import dequant_weights

    m = eng.max_batch
    rows, tot = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                         bytes=0.0, ops=0.0)
    for part, name in DECODE_LINEARS:
        ws = [blk[part][name] for blk in eng.params["blocks"]]
        k, nn = ws[0].orig_shape
        cfg = ws[0].cfg
        x = torch.randn(m, k, device=dev).to(torch.bfloat16)
        dense = [dequant_weights(w.packed, w.scale, k, cfg) for w in ws]
        nl = len(ws)

        def run(fn):
            return lambda: [fn(w) for w in ws]

        kern = timer(run(lambda w: ops.samd_matmul(x, w.packed, w.scale, k,
                                                   cfg))) / nl
        plain = timer(run(lambda w: mm.samd_matmul_plain(
            x, w.packed, w.scale, k, cfg)), iters=3) / nl
        lib = timer(lambda: [torch.matmul(x, d) for d in dense]) / nl
        n_bytes = (x.numel() * 2 + ws[0].packed.numel() * 4
                   + ws[0].scale.numel() * 4 + m * nn * 2)
        n_ops = 2 * m * k * nn
        b_ms, by = bound_ms(n_bytes, n_ops)
        rows.append(dict(linear=name, m=m, k=k, n=nn, ms=kern,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=by))
        for key, v in (("ms", kern), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b_ms), ("bytes", n_bytes),
                       ("ops", n_ops)):
            tot[key] += v
        del dense
    kv = "int8" if eng._kv_bits else "bf16"
    for r in rows:
        log(f"  samd_matmul decode ({kv} KV run) " + json.dumps(
            {k: (round(v, 5) if isinstance(v, float) else v)
             for k, v in r.items()}))
    n = len(rows)
    return {k: v / n for k, v in tot.items()}


def time_samd_matmul_prefill(eng, dev, timer):
    """The same linears at a prefill shape (M = 1024 rows), layer 0."""
    from repro_torch.kernels import ops

    for part, name in DECODE_LINEARS:
        w = eng.params["blocks"][0][part][name]
        k, nn = w.orig_shape
        x = torch.randn(1024, k, device=dev).to(torch.bfloat16)
        ms = timer(lambda: ops.samd_matmul(x, w.packed, w.scale, k, w.cfg),
                   iters=10)
        dense = torch.randn(k, nn, device=dev).to(torch.bfloat16)
        lib = timer(lambda: torch.matmul(x, dense), iters=10)
        tflops = 2 * 1024 * k * nn / ms / 1e9
        log(f"  samd_matmul prefill M=1024 {name} {k}x{nn}: {ms:.4f} ms "
            f"({tflops:.2f} TFLOP/s); dense bf16 torch.matmul "
            f"{lib:.4f} ms")


def time_paged_attention(eng, dev, timer, packed, gen):
    """Decode attention of 8 slots at the workload's mid-run positions over
    every layer's pools (page table width 32, as the engine's pow2 table
    takes it for positions up to 288 + 32)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.quant.packing import unpack_int8_lanes

    cfg, ps = eng.cfg, eng.page_size
    b, n_pp = eng.max_batch, 32
    lens = [int(len(r.prompt)) + MAX_TOKENS // 2 for r in workload(1)[:b]]
    args, kw = paged_case(dev, gen, b, cfg.n_kv_heads, 1, cfg.head_dim, ps,
                          n_pp, packed, lens)
    q, _, _, pt, pos = args
    layers = eng.cache["layers"]
    for lay in layers:  # realistic values in the pools the timing reads
        for key, t in zip(("k", "v"), args[1:3]):
            lay[key][: t.shape[0]].copy_(t)
        for key, t in kw.items():
            lay[key][: t.shape[0]].copy_(t)

    def attn(fn):
        return lambda: [fn(q, lay["k"], lay["v"], pt, pos,
                           k_scale=lay.get("k_scale"),
                           v_scale=lay.get("v_scale")) for lay in layers]

    nl = len(layers)
    kern = timer(attn(ops.paged_decode_attention)) / nl
    plain = timer(attn(pa.paged_decode_attention_plain), iters=3) / nl
    # library yardstick: SDPA over a dense KV gathered beforehand
    length = n_pp * ps
    safe = pt.clamp(min=0).long()
    dense = []
    for lay in layers:
        kk, vv = lay["k"][safe], lay["v"][safe]
        if packed:
            kk = unpack_int8_lanes(kk) * lay["k_scale"][safe][..., None]
            vv = unpack_int8_lanes(vv) * lay["v_scale"][safe][..., None]
        dense.append(tuple(
            t.reshape(b, length, cfg.n_kv_heads, cfg.head_dim)
            .transpose(1, 2).to(torch.bfloat16).contiguous()
            for t in (kk, vv)))
    offs = torch.arange(length, device=dev)
    mask = ((offs[None] <= pos[:, None].long())
            & torch.repeat_interleave(pt >= 0, ps, dim=1))[:, None, None]
    qd = q[:, :, None]
    lib = timer(lambda: [torch.nn.functional.scaled_dot_product_attention(
        qd, kk, vv, attn_mask=mask) for kk, vv in dense]) / nl
    del dense
    tokens = int((pos + 1).sum().item())  # keys the slots' queries read
    per_tok = cfg.n_kv_heads * cfg.head_dim
    kv_bytes = 2 * tokens * (per_tok + 4 * cfg.n_kv_heads if packed
                             else 2 * per_tok)
    n_bytes = (kv_bytes + 2 * q.numel() * 2 + pt.numel() * 4
               + pos.numel() * 4)
    n_ops = 4 * tokens * cfg.n_heads * cfg.head_dim
    b_ms, by = bound_ms(n_bytes, n_ops)
    row = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
               bound_by=by, bytes=n_bytes, ops=n_ops, keys=tokens)
    log(f"  paged_decode_attention ({'int8' if packed else 'bf16'} KV) "
        + json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                      for k, v in row.items()}))
    return row


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.archs import QWEN15_05B
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)

    log("(a) build")
    t0 = time.perf_counter()
    ops.build_kernels()
    log(f"  built {[k.name for k in ops.KERNELS]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in ops.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    log("(b) kernels against their plain versions")
    err_mm = check_samd_matmul(dev, gen)
    err_pa = check_paged_attention(dev, gen)

    log("(c) serve full-width qwen1.5-0.5b, 4-bit SAMD weights")
    runs = {}
    for kv_bits in (None, 8):
        eng, summary, counts = serve(QWEN15_05B, kv_bits, dev)
        check_model_against_plain(eng, dev)
        runs[kv_bits] = (eng, summary, counts)

    log("(d) kernel times at decode shapes "
        f"(card: {card})")
    def entry(name, source, replaces, launches, err, t, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "shape": shape}

    # one entry per kernel per serving run, with that run's own launch
    # count and timed on that run's own weights and pools
    kernels = []
    for kv_bits, fmt in ((None, "bf16"), (8, "int8")):
        eng, _, counts = runs[kv_bits]
        mm = time_samd_matmul(eng, dev, timer)
        mm["bound_by"] = bound_ms(mm["bytes"], mm["ops"])[1]
        kernels.append(entry(
            f"samd_matmul ({fmt} KV run)",
            "src/repro_torch/kernels/csrc/samd_matmul.cu",
            "src/repro/kernels/samd_matmul.py:123", counts["samd_matmul"],
            err_mm, mm, "decode M=8, mean per launch over "
            "wq,wk,wv,wo,wg,wu,wd of 24 layers, 4-bit"))
        pa_t = time_paged_attention(eng, dev, timer, kv_bits == 8, gen)
        kernels.append(entry(
            f"paged_decode_attention ({fmt} KV)",
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:294",
            counts["paged_attention"], err_pa[fmt], pa_t,
            "decode B=8 H=Hkv=16 dh=64 ps=16 n_pp=32, per layer"))
    time_samd_matmul_prefill(runs[None][0], dev, timer)
    log("serving: " + json.dumps([runs[k][1] for k in (None, 8)]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
