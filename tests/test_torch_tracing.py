"""The port's recorder (``repro_torch.tracing``) over the serving path on
the CPU: off by default and then recording nothing; on, the tick's
phases nest under the server's tick (through the worker thread's copied
context), one span a decode step and a prefill call, each request's
queue wait under the prefill that admitted it, the padding counters;
under the CPU profiler the spans pair with their annotations; the idle
time of a device trace goes to the innermost span."""
import asyncio
import time
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.serving import AsyncServer  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

# wide enough that the feed-forward weights are SAMD-packed
WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.collect()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tracing.collect()
    torch.set_num_threads(n)


def _engine(**kw):
    return ServingEngine(smoke_config("qwen1.5-0.5b").scaled(**WIDE), None,
                         quant=QuantConfig(bits=4), max_batch=4, max_len=64,
                         page_size=8, device="cpu", clock=time.perf_counter,
                         **kw)


def _work(seed, n=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 256, size=int(rng.integers(4, 30))),
             int(rng.integers(3, 9))) for _ in range(n)]


def _serve(eng, work):
    server = AsyncServer(eng, policy="fifo", max_queue=len(work),
                         clock=time.perf_counter)

    async def main():
        await server.start()
        streams = [server.submit(p, max_tokens=m, rid=i)
                   for i, (p, m) in enumerate(work)]
        for s in streams:
            await asyncio.wait_for(s.collect(), 60)
        await server.stop()

    asyncio.run(main())


def test_off_by_default_records_nothing():
    assert tracing.on is False
    assert tracing.span("engine.step") is tracing.NO_SPAN
    assert not tracing.NO_SPAN
    eng = _engine()
    _serve(eng, _work(0, 4))
    assert eng.stats["decode_steps"] > 0
    assert tracing.collect() == {}


@pytest.mark.parametrize("speculative", [0, 2])
def test_spans_nest_under_the_tick_and_match_the_counters(speculative):
    eng = _engine(speculative=speculative)
    before = dict(eng.stats)
    tracing.enable(time.perf_counter)
    work = _work(1)
    _serve(eng, work)
    out = tracing.collect()
    assert tracing.on is False and tracing.collect() == {}
    spans = out["spans"]
    by_id = {s["id"]: s for s in spans}

    def ancestors(s):
        while s["parent"] is not None:
            s = by_id[s["parent"]]
            yield s["name"]

    named = {}
    for s in spans:
        named.setdefault(s["name"], []).append(s)
        assert s["t0"] <= s["t1"]
    for name in ("engine.prefill", "engine.decode", "engine.sync",
                 "engine.admit", "engine.advance", "engine.grant_pages"):
        assert named[name]
        for s in named[name]:
            assert "engine.step" in ancestors(s), (name, s)
    # the step ran on the worker thread, under the tick that awaited it
    assert all(by_id[s["parent"]]["name"] == "server.tick"
               for s in named["engine.step"])
    delta = {k: eng.stats[k] - before[k] for k in eng.stats}
    assert len(named["engine.decode"]) == delta["decode_steps"]
    assert len(named["engine.prefill"]) == delta["prefill_calls"]
    assert all(s["attrs"]["speculative"] == bool(speculative)
               for s in named["engine.decode"])
    # one queue wait a request, under the prefill that admitted it
    waits = named["request.queue"]
    assert sorted(s["attrs"]["rid"] for s in waits) == list(range(len(work)))
    for s in waits:
        parent = by_id[s["parent"]]
        assert parent["name"] == "engine.prefill"
        assert s["attrs"]["rid"] in parent["attrs"]["rids"]
        assert s["t1"] == parent["t0"] and s["t0"] <= s["t1"]
    # the padding counters are the prefill spans' rows x bucket
    pre = [s["attrs"] for s in named["engine.prefill"]]
    assert delta["prefill_tokens_computed"] == sum(
        a["rows"] * a["bucket"] for a in pre)
    assert delta["prefill_tokens_real"] == sum(a["real"] for a in pre)
    assert delta["prefill_tokens_real"] + delta["prefix_tokens_saved"] == sum(
        len(p) for p, _ in work)
    assert sum(s["attrs"]["tokens"] for s in named["server.publish"]) == sum(
        m for _, m in work)
    launchers = {c["key"][0] for c in out["counts"]}
    assert "samd_matmul_splitk_launch" in launchers
    assert "samd_matmul_tile_launch" in launchers
    assert ("paged_decode_attention_launch" in launchers) != bool(speculative)


def test_spans_pair_with_their_annotations_under_the_profiler():
    eng = _engine()
    acts = [torch.profiler.ProfilerActivity.CPU]
    for seed in (2, 3):  # the first session warms the profiler's paths
        tracing.enable(eng.clock)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        for i, (p, m) in enumerate(_work(seed)):
            eng.submit(Request(rid=i, prompt=p.astype(np.int32),
                               max_tokens=m))
        eng.run_to_completion()
        prof.stop()
        out = tracing.collect(prof.profiler.kineto_results.events())
    timed = [s for s in out["spans"] if s["name"] != "request.queue"]
    assert out["clock_paired"] == len(timed)
    assert out["clock_residual_ns"] < 100_000
    assert "idle_by_span" not in out  # no device activity on the CPU


class _Event(types.SimpleNamespace):
    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def device_type(self):
        return self.dev

    def is_user_annotation(self):
        return self.ann


def test_idle_time_goes_to_the_innermost_span():
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    rec = tracing.Recorder(lambda: 0.0, False)
    spans = []
    for name, t0, t1 in (("engine.step", 50, 450),
                         ("engine.decode", 120, 320)):
        s = tracing.Span(rec, name)
        s.t0, s.t1 = t0 * 1e-9, t1 * 1e-9
        spans.append(s)
    # the trace's clock runs 1000 ns ahead of the spans'
    events = [
        _Event(n="op", s=1000, d=500, dev=cpu, ann=False),
        _Event(n="engine.step", s=1050, d=400, dev=cpu, ann=True),
        _Event(n="engine.decode", s=1120, d=200, dev=cpu, ann=True),
        _Event(n="k1", s=1100, d=100, dev=gpu, ann=False),
        _Event(n="k2", s=1300, d=100, dev=gpu, ann=False),
        _Event(n="engine.decode", s=1090, d=400, dev=gpu, ann=True),
    ]
    idle = tracing._idle_by_span(events, spans, 1000)
    assert idle == pytest.approx({"none": 100e-9, "engine.step": 100e-9,
                                  "engine.decode": 100e-9})
    # the spans placed on the trace by an offset found from annotations
    assert tracing._clock_offset(spans, events) == {
        "clock_offset_ns": 1000, "clock_residual_ns": 0, "clock_paired": 2}
