"""Port parity: the async front door and what the engine gives it.

The reference (``repro.serving``) and the port run the same raw weights
(carried over through numpy, as in ``tests/test_torch_serving.py``) and
the same requests, each engine and server given a counting clock (0, 1,
2, ... one step a call). Schedules depend only on lengths and prompt
tokens, so the clock is read at the same points in both packages and
every stamp, counter, rejection detail and snapshot value must be EQUAL
to the reference's. Tokens agree by ``test_torch_serving``'s near-tie
rule: identical, or parting first where the reference's own top-1/top-2
logit margin is under 1e-2 of its largest logit.

Port-only checks: the step in a worker thread (``step_in_thread=True``)
gives what the inline step gives, an exception in the step leaves the
serve task, and ``reset()`` leaves an engine that serves as a fresh one.
The admission-time lane-safety check (``verify=True``) accepts and
refuses the same quantizations in both packages.
"""
import asyncio
import dataclasses
import time
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_serving import (  # noqa: E402
    PORT_STATS, WIDE, _assert_greedy_parity, _pair, _port, _workload,
    shared_stats,
)

from repro.analysis import LaneSafetyError as JLaneSafetyError  # noqa: E402
from repro.analysis import contracts as j_contracts  # noqa: E402
from repro.models.layers import QuantizedTensor as JQuantizedTensor  # noqa
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.quant.packing import pack_weights as j_pack_weights  # noqa: E402
from repro.serving import AsyncServer as JAsyncServer  # noqa: E402
from repro.serving import RejectedRequest as JRejectedRequest  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis.lanes import NEEDS_SPACER  # noqa: E402
from repro_torch.analysis.lanes import LaneSafetyError  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.models.layers import QuantizedTensor  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.quant.packing import pack_weights  # noqa: E402
from repro_torch.serving import AsyncServer  # noqa: E402
from repro_torch.serving import RejectedRequest  # noqa: E402
from repro_torch.serving import Request  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.metrics import parse_prometheus  # noqa: E402

ARCH = "qwen1.5-0.5b"
STAMPS = ("t_submit", "t_admit", "t_first_token", "t_retire")
# the counters of the per-row path, which these ragged runs never take
PER_ROW = ("per_row_prefill_calls", "per_row_forward_calls")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # JAX's CPU thread pool and torch's OpenMP threads oversubscribe the
    # cores when both run in one process; these shapes are tiny anyway
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ticks:
    """A clock that reads 0, 1, 2, ... one step a call."""

    def __init__(self):
        self.n = -1

    def __call__(self):
        self.n += 1
        return float(self.n)


def _ref_stats(jeng):
    """The reference engine's stats (``PER_ROW`` reads 0 in these runs)."""
    assert all(jeng.stats[k] == 0 for k in PER_ROW)
    return dict(jeng.stats)


def _ref_snapshot(jserver):
    """The reference server's snapshot text, ``PER_ROW``'s lines
    included (the port's engine counts them too)."""
    text = jserver.metrics_snapshot()
    assert all(f"samd_engine_{k}_total" in text for k in PER_ROW)
    return text


def _shared_snapshot(text, eng):
    """The port's snapshot text less its ``PORT_STATS`` counters, after
    checking that it gives them at the engine's values."""
    port = {f"samd_engine_{k}_total": eng.stats[k] for k in PORT_STATS}
    kept = []
    for line in text.splitlines():
        words = line.split()
        name = words[2] if line.startswith("# TYPE") else words[0]
        if name in port:
            assert line.startswith("#") or float(words[1]) == port[name]
            continue
        kept.append(line)
    assert len(kept) == len(text.splitlines()) - 2 * len(port)
    return "\n".join(kept) + "\n"


def _record(reqs):
    return {r.rid: (tuple(getattr(r, s) for s in STAMPS), r.error,
                    r.truncated, len(r.generated)) for r in reqs}


# -- the engine's stamps ------------------------------------------------------
def _mixed_work():
    # a one-token request retires at its prefill (the done-at-admit stamp)
    return _workload(2) + [(np.arange(9) * 5 % 256, 1)]


def _rejection_work():
    # over-long prompt, a request the pool cannot hold under reserve
    # admission, two that the tick budget cuts, one over the queue bound
    return [(np.arange(40) % 256, 4), (np.arange(10) % 256, 30),
            (np.arange(5) % 256, 8), (np.arange(6) % 256, 8),
            (np.arange(7) % 256, 8)]


SCENARIOS = {
    "mixed": (dict(max_batch=4, max_len=64, page_size=8), _mixed_work, None),
    "rejections": (dict(max_batch=1, max_len=32, page_size=8, num_pages=3,
                        max_queue=4), _rejection_work, 3),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_to_completion_stamps_equal_reference(scenario):
    """Every stamp site (submit, a rejection, admission, first token,
    done at prefill, retirement, the tick budget's stragglers) reads the
    clock at the same point of the same schedule in both engines."""
    kw, work_fn, max_ticks = SCENARIOS[scenario]
    work = work_fn()
    jeng, teng = _pair(ARCH, None, **kw)
    jeng.clock, teng.clock = _Ticks(), _Ticks()
    records, outs = [], []
    for eng, req_cls in ((jeng, JRequest), (teng, Request)):
        for i, (prompt, max_tokens) in enumerate(work):
            eng.submit(req_cls(rid=i, prompt=np.asarray(prompt),
                               max_tokens=max_tokens))
        done = (eng.run_to_completion(max_ticks=max_ticks) if max_ticks
                else eng.run_to_completion())
        assert len(done) == len(work)
        records.append(_record(done))
        outs.append({r.rid: list(r.generated) for r in done})
    assert records[1] == records[0]
    assert shared_stats(teng, jeng) == _ref_stats(jeng)
    for stamps, error, _, _ in records[1].values():
        assert stamps[0] is not None and stamps[3] is not None
        if error is None:
            assert stamps[0] <= stamps[1] <= stamps[2] <= stamps[3]
    if scenario == "mixed":
        assert all(err is None for _, err, _, _ in records[1].values())
        _assert_greedy_parity(jeng, outs[0], outs[1], work)
    else:
        errors = [err for _, err, _, _ in records[1].values()]
        assert sum(e == "tick budget exhausted" for e in errors) == 2


# -- the front door -----------------------------------------------------------
SERVER_ENGINE = dict(max_batch=2, max_len=64, page_size=8, num_pages=6)
SERVER = dict(policy="slo", max_queue=3, capacity_tokens_per_s=10.0)
# (prompt, max_tokens, slo_s, expected outcome)
SPECS = [
    (np.arange(9) * 3 % 256, 6, None, "ok"),
    (np.arange(64) % 256, 4, None, "infeasible"),        # >= max_len
    (np.arange(10) * 7 % 256, 50, None, "infeasible"),   # 8 pages > 6
    (np.arange(7) * 11 % 256, 5, 0.5, "slo"),            # behind backlog
    (np.arange(12) * 13 % 256, 3, 1e6, "ok"),
    (np.arange(5) * 17 % 256, 1, None, "ok"),            # one token
    (np.arange(6) * 19 % 256, 4, None, "queue_full"),    # 3 waiting
]


async def _drive(server, rejected_cls):
    """Every submit before ``start()``, then serve and drain. Returns
    ({rid: streamed tokens}, [(rid, code, detail)])."""
    streams, rejects = {}, []
    for rid, (prompt, max_tokens, slo_s, _) in enumerate(SPECS):
        try:
            streams[rid] = server.submit(prompt, max_tokens, slo_s=slo_s,
                                         rid=rid)
        except rejected_cls as rej:
            rejects.append((rid, rej.code, rej.detail))
    await server.start()
    toks = await asyncio.wait_for(
        asyncio.gather(*(s.collect() for s in streams.values())), 600)
    await server.stop()
    for s in streams.values():
        assert s.request.error is None and not s.request.truncated
    return dict(zip(streams, toks)), rejects


def _serve(server, rejected_cls):
    streamed, rejects = asyncio.run(_drive(server, rejected_cls))
    for req in server.finished:
        assert streamed[req.rid] == list(req.generated)
    return streamed, rejects


def test_server_counters_rejections_and_snapshot_equal_reference():
    """step_in_thread=False, every submit before start(): the same
    admissions, the same refusals with the same codes and details
    (queue_full, both infeasible cases, slo; the slo detail prints the
    analytic price), the same counters, stamps and snapshot text, and
    streams equal to each request's generated tokens."""
    jeng, teng = _pair(ARCH, None, **SERVER_ENGINE)
    results = []
    for eng, server_cls, rej_cls in ((jeng, JAsyncServer, JRejectedRequest),
                                     (teng, AsyncServer, RejectedRequest)):
        server = server_cls(eng, clock=_Ticks(), step_in_thread=False,
                            **SERVER)
        streamed, rejects = _serve(server, rej_cls)
        results.append((server, streamed, rejects))
    (jserver, jtoks, jrej), (server, toks, rej) = results
    assert rej == jrej
    assert [code for _, code, _ in rej] == [
        s[3] for s in SPECS if s[3] != "ok"]
    assert server.counters == jserver.counters
    assert server.counters["completed"] == len(toks) == 3
    assert server.counters["deadline_missed"] == 0
    assert _record(server.finished) == _record(jserver.finished)
    text = server.metrics_snapshot()
    assert _shared_snapshot(text, teng) == _ref_snapshot(jserver)
    snap = parse_prometheus(text)
    for k, v in server.counters.items():
        assert snap[f"samd_server_{k}_total"] == v
    assert server.summary() == jserver.summary()
    work = [(SPECS[rid][0], SPECS[rid][1]) for rid in sorted(toks)]
    _assert_greedy_parity(
        jeng, {i: jtoks[rid] for i, rid in enumerate(sorted(toks))},
        {i: toks[rid] for i, rid in enumerate(sorted(toks))}, work)


def test_step_in_a_thread_serves_what_the_inline_step_serves():
    """The same requests served with the tick in a worker thread and
    inline, on one engine (``reset()`` between): the same tokens,
    counters and stamps (the loop waits for each step, so the clock is
    read in the same order)."""
    eng = _port(ARCH, None, **SERVER_ENGINE)
    runs = []
    for in_thread in (False, True):
        eng.reset()
        server = AsyncServer(eng, clock=_Ticks(), step_in_thread=in_thread,
                             **SERVER)
        streamed, rejects = _serve(server, RejectedRequest)
        runs.append((streamed, rejects, dict(server.counters),
                     _record(server.finished)))
    assert runs[1] == runs[0]


@pytest.mark.parametrize("in_thread", [False, True])
def test_an_exception_in_the_step_leaves_the_serve_task(in_thread):
    eng = _port(ARCH, None, **SERVER_ENGINE)
    step = eng.step
    calls = []

    def failing_step():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return step()

    eng.step = failing_step
    server = AsyncServer(eng, step_in_thread=in_thread, max_queue=4)

    async def run():
        server.submit(np.arange(6), 5)
        await server.start()
        await asyncio.wait_for(server.stop(), 600)

    with pytest.raises(RuntimeError, match="step failed"):
        asyncio.run(run())
    assert len(calls) == 2


# -- reset ------------------------------------------------------------------
def test_reset_serves_as_a_fresh_engine():
    kw = dict(max_batch=2, max_len=64, page_size=8, prefix_retain=2)
    work = _workload(4, n=5)
    jeng, teng = _pair(ARCH, None, **kw)

    def serve(eng, req_cls):
        for i, (prompt, max_tokens) in enumerate(work):
            eng.submit(req_cls(rid=i, prompt=np.asarray(prompt),
                               max_tokens=max_tokens))
        return {r.rid: list(r.generated) for r in eng.run_to_completion()}

    first = serve(teng, Request)
    stats = dict(teng.stats)
    teng.reset()
    assert not teng.queue and not teng.finished
    assert teng.slots == [None] * teng.max_batch and not teng.active.any()
    assert teng._allocator.free_pages == teng.num_pages
    assert teng._allocator.reserved == 0 == teng._allocator.retained_pages
    assert (teng.page_table == -1).all() and not teng._prefix_index
    assert set(teng.stats.values()) == {0}
    assert serve(teng, Request) == first and teng.stats == stats
    fresh = _port(ARCH, None, **kw)
    assert serve(fresh, Request) == first and fresh.stats == stats
    want = serve(jeng, JRequest)
    jeng.reset()
    assert serve(jeng, JRequest) == want
    assert _ref_stats(jeng) == shared_stats(teng, jeng)
    _assert_greedy_parity(jeng, want, first, work)


# -- verify=True --------------------------------------------------------------
K = 4608


def _stand_in(pkg, qcfg, draft):
    """An object with what ``_verify_lane_safety`` reads: a packed [K, 8]
    leaf as the target's weights, or as a speculative draft's under a
    bf16 target (the reference's own engine test does the same)."""
    w = np.random.default_rng(0).normal(size=(K, 8)).astype(np.float32)
    if pkg == "ref":
        packed, scale = j_pack_weights(w, qcfg)
        leaf = JQuantizedTensor(packed, scale, (K, 8), 0, qcfg)
        off = JQuantConfig(enabled=False)
    else:
        packed, scale = pack_weights(torch.from_numpy(w), qcfg)
        leaf = QuantizedTensor(packed, scale, (K, 8), 0, qcfg)
        off = QuantConfig(enabled=False)
    if draft:
        return types.SimpleNamespace(quant=off, params={}, speculative=2,
                                     draft_quant=qcfg,
                                     _draft_params={"w": [leaf]})
    return types.SimpleNamespace(quant=qcfg, params={"w": [leaf]},
                                 speculative=0)


def _outcome(fn, errors):
    try:
        fn()
    except errors as e:
        return "refused", str(e)
    return "accepted", None


@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("spacer", ["temporary", "permanent"])
def test_verify_accepts_and_refuses_what_the_reference_does(
        spacer, draft, monkeypatch):
    """Every quantization the port expresses (bits 1-16, both spacers):
    the same verdict in both packages' admission checks, for the target
    and for a draft. Then with each package's matmul check made to find
    depth K unsafe, both refuse, with the same message."""
    for bits in range(1, 17):
        j = _outcome(lambda: JServingEngine._verify_lane_safety(_stand_in(
            "ref", JQuantConfig(bits=bits, spacer=spacer), draft)),
            JLaneSafetyError)
        t = _outcome(lambda: ServingEngine._verify_lane_safety(_stand_in(
            "port", QuantConfig(bits=bits, spacer=spacer), draft)),
            LaneSafetyError)
        assert t == j == ("accepted", None), bits
    for mod in (j_contracts, contracts):
        real = mod.check_matmul_config

        def check(cfg, k, _real=real, **kw):
            v = _real(cfg, k, **kw)
            return (dataclasses.replace(v, status=NEEDS_SPACER,
                                        detail="refused at this depth")
                    if k == K else v)

        monkeypatch.setattr(mod, "check_matmul_config", check)
    j = _outcome(lambda: JServingEngine._verify_lane_safety(_stand_in(
        "ref", JQuantConfig(bits=4, spacer=spacer), draft)),
        JLaneSafetyError)
    t = _outcome(lambda: ServingEngine._verify_lane_safety(_stand_in(
        "port", QuantConfig(bits=4, spacer=spacer), draft)),
        LaneSafetyError)
    assert t == j and t[0] == "refused"


@pytest.mark.parametrize("spacer", ["temporary", "permanent"])
def test_matmul_check_refuses_no_depth_the_port_expresses(spacer):
    """No (bits, K) without ``act_bits`` is refused by either package's
    own matmul check, at any depth: both certify lanes that only store
    codes, whose safety does not depend on K. Both refuse only with
    ``act_bits`` set (the f32 accumulator's exactness under quantized
    activations), and then both admissions refuse the same depth with
    the same message."""
    for bits in range(1, 17):
        for k in (1, 7, K, 2 ** 24 + 1, 2 ** 30):
            for signed in (True, False):
                j = j_contracts.check_matmul_config(
                    JQuantConfig(bits=bits, spacer=spacer), k, signed=signed)
                t = contracts.check_matmul_config(
                    QuantConfig(bits=bits, spacer=spacer), k, signed=signed)
                assert t.ok and j.ok and t.status == j.status, (bits, k)
    # what the reference's check does refuse, both admissions refuse
    # through the same stand-in
    verdict, msg = _outcome(lambda: JServingEngine._verify_lane_safety(
        _stand_in("ref", JQuantConfig(bits=8, act_bits=8, spacer=spacer),
                  False)), JLaneSafetyError)
    assert verdict == "refused" and f"K={K}" in msg
    assert _outcome(lambda: ServingEngine._verify_lane_safety(_stand_in(
        "port", QuantConfig(bits=8, act_bits=8, spacer=spacer), False)),
        LaneSafetyError) == (verdict, msg)


def test_verify_refuses_in_the_constructor(monkeypatch):
    """An engine whose packed weights hold an unsafe depth does not come
    up (target, or a separately packed draft); ``verify=False`` does, and
    a quantized target's own draft is checked once."""
    # wide enough that the linears are packed (at least 2^16 values)
    cfg = smoke_config(ARCH).scaled(**WIDE)
    depths = {cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim}
    seen = []
    real = contracts.check_matmul_config

    def check(qcfg, k, **kw):
        seen.append((qcfg.bits, k))
        v = real(qcfg, k, **kw)
        return (dataclasses.replace(v, status=NEEDS_SPACER)
                if k == cfg.d_ff and qcfg.bits == 8 else v)

    monkeypatch.setattr(contracts, "check_matmul_config", check)
    kw = dict(max_batch=2, max_len=32, page_size=8, device="cpu")
    with pytest.raises(LaneSafetyError):
        ServingEngine(cfg, None, quant=QuantConfig(bits=8), **kw)
    with pytest.raises(LaneSafetyError):
        ServingEngine(cfg, None, speculative=2,
                      draft_quant=QuantConfig(bits=8), **kw)
    ServingEngine(cfg, None, quant=QuantConfig(bits=8), verify=False, **kw)
    seen.clear()
    ServingEngine(cfg, None, quant=QuantConfig(bits=4), speculative=2, **kw)
    assert sorted(seen) == sorted((4, k) for k in depths)
    seen.clear()
    eng = ServingEngine(cfg, None, **kw)  # bf16, no draft: nothing to check
    assert seen == [] and eng.clock is time.monotonic
    assert eng.kv_mode == "paged"
    ticks = _Ticks()
    assert ServingEngine(cfg, None, clock=ticks, **kw).clock is ticks
