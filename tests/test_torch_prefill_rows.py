"""The admission prefill's shape: a row per request it admits.

A busy engine (``max_batch`` 4, slots decoding) admits 4, then 1, then 2
requests as slots free, on the paged pool with prefix sharing, on the
ring, with ``speculative=2`` and for the MoE family. Each batched
prefill computes exactly the admitted rows: the ``engine.prefill``
span's ``rows`` is the requests it admitted and
``prefill_tokens_computed`` grows by rows x bucket. Every request's
greedy tokens are those of the JAX reference engine, which prefills all
``max_batch`` rows at the same bucket, up to the near-tie rule of
``test_torch_serving`` (for MoE, at the logits the reference engine
sampled from, as in ``test_torch_family_serving``); the stats match
where the schedule is the same. The dense modes' tokens are also
exactly those of ``decode_mode="per_row"`` (one exact-length prefill a
request). MoE's are not: a row's expert capacity is taken over its whole
bucket, padding included, so an exact-length prefill routes otherwise.
"""
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_family_serving import (  # noqa: E402
    _assert_engine_parity, _record_sampling,
)
from test_torch_serving import (  # noqa: E402
    _assert_greedy_parity, _port, _raw, _serve, shared_stats,
)

from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402

ENGINE = dict(max_batch=4, max_len=64, page_size=8)
# (arch, engine options, whether a prefill's logits are free of its
# bucket); speculative output is held against the reference's plain
# decode (as in test_torch_speculative), whose schedule, and so whose
# stats, differ
MODES = {
    "paged_prefix": ("qwen1.5-0.5b", dict(prefix_retain=4), True),
    "ring": ("qwen1.5-0.5b", dict(kv_mode="ring"), True),
    "speculative": ("qwen1.5-0.5b", dict(speculative=2), True),
    "moe": ("olmoe-1b-7b", {}, False),
}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.collect()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tracing.collect()
    torch.set_num_threads(n)


def _work():
    """Seven requests over one 16-token document (two pages) and a
    suffix each: the first wave fills the 4 slots; the 2-token answer
    frees one slot after a tick, the two 8-token answers free two
    together, and the long ones keep decoding meanwhile."""
    rng = np.random.default_rng(11)
    doc = rng.integers(1, 256, size=16)
    answers = (2, 8, 8, 24, 16, 6, 6)
    return [(np.concatenate([doc, rng.integers(1, 256, size=n)]), m)
            for n, m in zip((3, 9, 14, 20, 5, 11, 17), answers)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefill_computes_the_rows_it_admits(mode, monkeypatch):
    arch, kw, bucket_free = MODES[mode]
    work = _work()
    jcfg, raw = _raw(arch, 1)
    plain = {k: v for k, v in kw.items() if k != "speculative"}
    jeng = JServingEngine(jcfg, raw, quant=JQuantConfig(
        bits=4, backend="pallas"), **ENGINE, **plain)
    teng = _port(arch, None, **ENGINE, **kw)
    admitted = []
    inner = teng._prefill_batch

    def prefill_batch(slots, reqs, effs, starts):
        admitted.append((len(reqs), int(teng.active.sum())))
        return inner(slots, reqs, effs, starts)

    teng._prefill_batch = prefill_batch
    before = dict(teng.stats)
    tracing.enable(time.perf_counter)
    got = _serve(teng, Request, work)
    spans = [s["attrs"] for s in tracing.collect()["spans"]
             if s["name"] == "engine.prefill"]
    assert [a["rows"] for a in spans] == [n for n, _ in admitted]
    assert all(a["rows"] == len(a["rids"]) for a in spans)
    assert sorted({n for n, _ in admitted}) == [1, 2, ENGINE["max_batch"]]
    # the 1- and 2-request admissions come while other slots decode
    assert all(busy > 0 for n, busy in admitted[1:])
    delta = {k: teng.stats[k] - before[k] for k in teng.stats}
    assert delta["prefill_calls"] == len(spans)
    assert delta["prefill_tokens_computed"] == sum(
        a["rows"] * a["bucket"] for a in spans)
    assert delta["prefill_tokens_real"] == sum(a["real"] for a in spans)
    if mode == "paged_prefix":
        assert teng.stats["prefix_hits"] > 0
        assert any(a["shared"] > 0 for a in spans)
    if bucket_free:
        per_row = _port(arch, None, decode_mode="per_row", **ENGINE)
        assert _serve(per_row, Request, work) == got
        want = _serve(jeng, JRequest, work)
        _assert_greedy_parity(jeng, want, got, work)
    else:
        seen = _record_sampling(monkeypatch, jeng)
        want = _serve(jeng, JRequest, work)
        _assert_engine_parity(jeng, seen, want, got, work)
    if not teng.speculative:
        assert shared_stats(teng, jeng) == dict(jeng.stats)
