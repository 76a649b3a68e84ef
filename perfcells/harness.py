"""One run of one cell: set-up, the measured window, the metrics, the check
of what the window served against the plain reference, and the result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a
configuration (``configs/<name>.json``) under a traffic mix
(``traffic/<name>.json``), with the limit of its check in
``limits/<cell>.json``. Per-layer metrics are readers in
``metrics/<name>.py``. Nothing here names a cell, a mix or a metric.

The window drives the program's front door: ``AsyncServer`` (FIFO, no
deadline) over ``ServingEngine``, paged KV, greedy. ``clients`` closed-loop
clients send the mix's requests in order, each its next one when its
previous one has finished; the window opens with the first send.

A traced run (``--trace 1``) also turns the program's own recorder
(``repro_torch.tracing``) on from just before the server starts to the
window's end; its records, with the profiled stretch's events, reach the
per-layer readers as ``t["program"]``.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfcells import families
from perfcells import reference as reference_mod
from perfcells import traffic as traffic_mod
from perfcells import weights as weights_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REQUEST_POOL = 4096          # requests generated for a run
FIRST_TOKEN_WAIT_S = 120.0   # after the window, for first tokens still due
PROFILE_S = 10.0             # the profiled stretch closes the window:
PROFILE_SHARE = 0.3          # this long, at most this share of it


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list          # metric entries of BENCHMARK.json
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = traffic_mod.load(work["traffic"], HERE / "traffic")
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return Cell(name, config, mix, limits, *cell_metrics(bench, name))


def cell_metrics(bench: dict, name: str) -> tuple:
    """(end-to-end, per-layer) metric entries that cell ``name`` reports."""

    def mine(m):
        return name in m.get("workloads", [name])

    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def arch_config(config: dict):
    """The program's ``ArchConfig``: every key of ``config`` that is one
    of its fields."""
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    fields -= {"name", "scan_layers"}
    return ArchConfig(name=config["name"], scan_layers=False,
                      **{k: v for k, v in config.items() if k in fields})


def quant_config(config: dict):
    from repro_torch.quant.config import QuantConfig

    q = config["quant"]
    return QuantConfig(bits=q["bits"], spacer=q["spacer"],
                       quantize_embeddings=q["quantize_embeddings"],
                       kv_bits=8 if q["kv"] == "int8" else None)


def engine_max_len(config: dict, mix: dict) -> int:
    ps = config["serving"]["page_size"]
    return -(-traffic_mod.max_len(mix) // ps) * ps


def serving_engine(config: dict, mix: dict, seed: int, device, params,
                   quant=None):
    """The program's engine over ``params`` with the cell's serving
    settings; ``quant`` (``quant_config``) packs them, None takes them
    as they are (packed already, or bfloat16)."""
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(
        arch_config(config), params, quant=quant,
        max_batch=mix["max_batch"], max_len=engine_max_len(config, mix),
        page_size=config["serving"]["page_size"],
        seed=traffic_mod.sub_seed(seed, "engine") & 0x7FFFFFFF,
        temperature=config["serving"]["temperature"],
        prefix_sharing=mix["prefix_sharing"],
        prefix_retain=mix["prefix_retain"] or None, device=device)


def default_build_engine(config: dict, mix: dict, seed: int, device):
    """The engine over the seed's weights, drawn whole and packed by the
    engine; the unquantized weights are freed once it has packed them."""
    made = weights_mod.make(config, seed, device)
    params = weights_mod.program_params(config, made, device)
    eng = serving_engine(config, mix, seed, device, params,
                         quant_config(config))
    del made, params
    gc.collect()
    return eng


def build_engine(config: dict, mix: dict, seed: int, device):
    """The engine over the seed's weights: the family's ``build_engine``
    where its file has one, else ``default_build_engine``."""
    family = families.load(config["family"])
    build = getattr(family, "build_engine", default_build_engine)
    return build(config, mix, seed, device)


def warm_up(eng, mix: dict, prefix: np.ndarray, seed: int, vocab: int):
    """Fill the shared prefix's pages (in chunks of ``prefix_chunk``
    tokens) and run one prefill of every bucket the mix reaches, each
    with every slot taken, then a few decode ticks of the full batch."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(traffic_mod.sub_seed(seed, "warm-up"))
    if len(prefix):
        chunk = int(mix.get("prefix_chunk", 0)) or len(prefix)
        for end in range(chunk, len(prefix) + 1, chunk):
            eng.submit(Request(rid=-1, prompt=prefix[:end], max_tokens=1))
            eng.run_to_completion()
    for length in traffic_mod.warmup_prompt_lengths(mix):
        for j in range(mix["max_batch"]):
            own = rng.integers(1, vocab, size=length).astype(np.int32)
            prompt = np.concatenate([prefix, own])
            eng.submit(Request(rid=-2 - j, prompt=prompt, max_tokens=3))
        eng.run_to_completion()
    eng.finished.clear()


@dataclasses.dataclass
class Sent:
    """A request as its client saw it."""

    req: traffic_mod.Req
    t_send: float
    times: list = dataclasses.field(default_factory=list)
    request: object = None          # the engine's Request
    refused: Optional[str] = None
    done: bool = False


async def _serve(server, reqs, clients: int, seconds: float, clock,
                 spans=None, wait_first: bool = False):
    """Run the window; returns (t0, t1, every request sent in it)."""
    from repro_torch.serving.server import RejectedRequest

    sent: list[Sent] = []
    cursor = iter(reqs)

    async def client():
        while clock() < t1:
            r = next(cursor)
            rec = Sent(r, clock())
            sent.append(rec)
            try:
                stream = server.submit(r.prompt, max_tokens=r.max_tokens,
                                       rid=r.index)
            except RejectedRequest as rej:
                rec.refused = rej.code
                continue
            rec.request = stream.request
            async for _ in stream:
                rec.times.append(clock())
            rec.done = True

    await server.start()
    t0 = clock()
    t1 = t0 + seconds
    if spans is not None:
        spans.open_window(t1)
    tasks = [asyncio.create_task(client()) for _ in range(clients)]
    await asyncio.sleep(max(0.0, t1 - clock()))
    if spans is not None:
        spans.window = False
    deadline = clock() + FIRST_TOKEN_WAIT_S
    while wait_first and clock() < deadline and any(
            not s.times and s.refused is None and not s.done for s in sent):
        await asyncio.sleep(0.01)
    await server.stop(drain=False)
    if spans is not None:
        await asyncio.to_thread(spans.end_stretch)
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return t0, t1, sent


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile over every value (inf counts)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    if v[hi] == math.inf:
        return math.inf if pos > lo or v[lo] == math.inf else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def end_to_end(sent: list, t0: float, t1: float) -> dict:
    """Every end-to-end metric the harness knows, over the window: all
    tokens received in it over its length; every gap between a request's
    consecutive tokens that ends in it; every request's wait from send to
    first token (one that failed counts as never answered)."""
    tokens = [t for s in sent for t in s.times if t0 <= t <= t1]
    gaps = [b - a for s in sent for a, b in zip(s.times, s.times[1:])
            if t0 <= b <= t1]
    ttft = [(s.times[0] - s.t_send) if s.times and not failed(s)
            else math.inf for s in sent]
    return {
        "tokens_per_s": len(tokens) / (t1 - t0),
        "tpot_p95_ms": percentile(gaps, 95) * 1e3,
        "ttft_p50_ms": percentile(ttft, 50) * 1e3,
        "ttft_p85_ms": percentile(ttft, 85) * 1e3,
    }


def failed(s: Sent) -> bool:
    r = s.request
    return (s.refused is not None
            or (r is not None and (r.error is not None or r.truncated)))


def sample_for_check(sent: list, n: int, seed: int) -> list:
    """The finished requests to compare: the longest-served one and a
    seeded draw of the others, ``n`` in all."""
    done = [s for s in sent if s.done and not failed(s)
            and len(s.request.generated) == s.req.max_tokens]
    if not done:
        return []
    done.sort(key=lambda s: (-s.req.max_tokens, s.req.index))
    rng = np.random.default_rng(traffic_mod.sub_seed(seed, "check"))
    picks = rng.permutation(len(done) - 1)[:n - 1] + 1
    rest = [done[i] for i in sorted(picks)]
    return [done[0]] + rest


def reference_logits(config: dict, seed: int, device, checked: list,
                     shared: int, precision: str = "f32") -> list:
    """Per compared request, the reference's (computed in ``precision``)
    float32 logits [served tokens, vocab] at each served token's
    position: the prompt's last, then each served token but the last."""
    dev_tokens = []
    for s in checked:
        seq = np.concatenate([s.req.prompt,
                              np.asarray(s.request.generated[:-1], np.int32)])
        dev_tokens.append(torch.as_tensor(seq.astype(np.int64), device=device))
    segments, rows = [], []
    prefix = None
    if shared:
        prefix = reference_mod.Segment(dev_tokens[0][:shared])
        segments.append(prefix)
    for s, toks in zip(checked, dev_tokens):
        seg = reference_mod.Segment(toks[shared:], offset=shared,
                                    prefix=prefix)
        segments.append(seg)
        first = len(s.req.prompt) - shared - 1
        rows.append((seg, torch.arange(first, len(toks) - shared,
                                       device=device)))
    ref = reference_mod.Reference(config, seed, device, precision=precision)
    return ref.logits(segments, rows)


def logit_gaps(logits: list, tokens: list) -> list:
    """Per request, the gap by which each chosen token's logit lies below
    the best logit at its position."""
    out = []
    for lg, tok in zip(logits, tokens):
        tok = torch.as_tensor(np.asarray(tok, np.int64), device=lg.device)
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, tok[:, None])[:, 0]).cpu())
    return out


def load_metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfcells_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a run hands back: the result line and the numbers behind it."""

    result: dict
    sent: list
    checked: list
    gaps: list
    details: dict             # timings, trace summary, set-up phases
    logits: list              # the reference's, per compared request
    seed: int


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault=None) -> Run:
    """Set up, serve the window, free the program, check, report.
    ``fault(eng)``, if given, breaks the engine before the window (the
    tests' planted faults)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.server import AsyncServer

    device = torch.device(device)
    on_card = device.type == "cuda"
    config, mix = cell.config, cell.mix
    clock = time.perf_counter
    phases = {"start": clock() - t_start}

    def phase(name):
        if on_card:
            torch.cuda.synchronize()
        phases[name] = clock() - t_start - sum(phases.values())

    if on_card:
        ops.build_kernels()
        torch.cuda.reset_peak_memory_stats()
    phase("kernels")
    eng = build_engine(config, mix, seed, device)
    phase("weights_and_packing")
    prefix = traffic_mod.shared_prefix(mix, seed, config["vocab"])
    warm_up(eng, mix, prefix, seed, config["vocab"])
    phase("warm_up")
    reqs = traffic_mod.requests(mix, seed, config["vocab"], REQUEST_POOL)
    phase("traffic")
    if fault is not None:
        fault(eng)
    server = AsyncServer(eng, policy="fifo", max_queue=mix["clients"],
                         default_slo_s=None, clock=clock)
    spans = None
    stats0 = dict(eng.stats)
    loop = asyncio.new_event_loop()
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    loop.set_default_executor(pool)
    try:
        if trace:
            from repro_torch import tracing

            from perfcells.spans import Spans

            spans = Spans(eng, config, device, clock,
                          -min(PROFILE_S, PROFILE_SHARE * seconds), 0.0)
            tracing.enable(clock)
        wait_first = any(m["name"].startswith("ttft")
                         for m in cell.end_to_end)
        t0, t1, sent = loop.run_until_complete(_serve(
            server, reqs, mix["clients"], seconds, clock, spans, wait_first))
    finally:
        if spans is not None:
            spans.close()
            tracing.disable()
        loop.close()
        pool.shutdown(wait=True)
    program = (tracing.collect(spans.stretch.events) if spans is not None
               else None)
    setup_s = t0 - t_start
    stats = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    timings = spans.timings() if spans is not None else None
    stretch = None
    if spans is not None and spans.stretch.events is not None:
        from perfcells import profiling

        stretch = profiling.summarize(spans.stretch.events)
    launches = dict(spans.launches) if spans is not None else {}
    del server, eng, spans
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    window = [s for s in sent if s.t_send <= t1]
    n_failed = sum(failed(s) for s in window)
    checked = sample_for_check(window, int(mix["compare_requests"]), seed)
    logits = (reference_logits(config, seed, device, checked, len(prefix))
              if checked else [])
    gaps = logit_gaps(logits, [s.request.generated for s in checked])
    max_gap = max((float(g.max()) for g in gaps if len(g)), default=math.inf)
    limit = float(cell.limits["logit_gap"])
    compared = sum(len(g) for g in gaps)
    check = {
        "logit_gap": {"value": max_gap, "limit": limit},
        "failed": {"value": n_failed, "limit": 0},
        "compared_tokens": {"value": compared, "limit": 1},
    }
    e2e = end_to_end(window, t0, t1)
    e2e["setup_s"] = setup_s
    finite = all(math.isfinite(e2e[m["name"]]) for m in cell.end_to_end)
    correct = (max_gap <= limit and n_failed == 0 and compared >= 1
               and finite)
    if trace:
        trace_data = {
            "arch": config, "stats": stats, "stretch": stretch or {},
            "launches": launches, "t0": t0, "t1": t1,
            "requests": [s.request for s in window if s.request is not None],
            "program": program, **timings,
        }
        metrics = {}
        for m in cell.per_layer:
            v = load_metric_reader(m["name"])(trace_data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if math.isfinite(e2e[m["name"]])}
    result = {
        "correct": bool(correct),
        "attempted": len(window),
        "failed": n_failed,
        "metrics": metrics,
        "device": device_info(device, peak),
    }
    if trace and stretch:
        result["device"]["busy_s"] = stretch["busy_s"]
        result["device"]["window_s"] = stretch["window_s"]
        result["breakdown"] = {"device_ops": stretch["device_ops"],
                               "idle_gaps": stretch["idle_gaps"]}
    result["check"] = check
    return Run(result, sent, checked, gaps,
               {"timings": timings, "stretch": stretch, "launches": launches,
                "stats": stats, "e2e": e2e, "setup_phases": phases,
                "program": program},
               logits, seed)


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def dump(run: Run, path) -> None:
    """Write what lies behind a run's result line, for a reader."""
    out = dict(run.details)
    out["result"] = run.result
    out["checked"] = [
        {"index": s.req.index, "prompt": len(s.req.prompt),
         "served": len(s.request.generated),
         "max_gap": float(g.max()) if len(g) else None,
         "gaps_over_0.01": int((g > 0.01).sum())}
        for s, g in zip(run.checked, run.gaps)]
    out["sent"] = [
        {"index": s.req.index, "prompt": len(s.req.prompt),
         "max_tokens": s.req.max_tokens, "t_send": s.t_send,
         "n": len(s.times), "first": s.times[0] if s.times else None,
         "last": s.times[-1] if s.times else None,
         "failed": failed(s)} for s in run.sent]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out, default=float))
