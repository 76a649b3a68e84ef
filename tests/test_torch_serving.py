"""Port parity: the serving engine, its page allocator and its sampler.

Greedy serving with the same weights and requests through
``repro.serving.ServingEngine`` (``QuantConfig(bits=4,
backend="pallas")``, bf16 and ``kv_bits=8`` KV) and the port's engine
(the same config through the kernel route, on the CPU so the kernels'
plain versions run) must give the same tokens. Random weights leave
near-ties among the logits, and the two packages round bf16 at slightly
different places, so a token may differ where the reference's own top-1
and top-2 logits are closer than the stated logit tolerance (the one
``test_torch_model`` holds the forward to); the test checks exactly
that at the first differing token of each request, and that most
requests match end to end. Schedules (admissions, grants, preemptions,
forks) depend only on lengths and prompt tokens, so the engines' stats
must agree exactly.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_from_spec as j_init  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.serving import PageAllocator as JPageAllocator  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.launch.steps import sample_tokens  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.serving.engine import PageAllocator  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

LOGIT_TOL = 1e-2  # relative to the largest logit, as in test_torch_model
WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)
# the port's counters the reference's engine does not keep: the prompt
# tokens batched prefills took, and the rows x bucket they computed
PORT_STATS = ("prefill_tokens_real", "prefill_tokens_computed")


def shared_stats(teng, jeng) -> dict:
    """The port's counters that the reference keeps too, after checking
    that the port keeps those and ``PORT_STATS`` alone, and that a
    prefill computed at least the tokens it took."""
    st = teng.stats
    assert set(st) == set(jeng.stats) | set(PORT_STATS)
    assert 0 <= st["prefill_tokens_real"] <= st["prefill_tokens_computed"]
    assert (st["prefill_tokens_computed"] > 0) == (st["prefill_calls"] > 0)
    return {k: st[k] for k in jeng.stats}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # JAX's CPU thread pool and torch's OpenMP threads oversubscribe the
    # cores when both run in one process; these shapes are tiny anyway
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _raw(arch, seed):
    jcfg = j_smoke_config(arch).scaled(**WIDE)
    return jcfg, j_init(j_build_template(jcfg), jax.random.PRNGKey(seed))


def _port(arch, kv_bits, seed=1, **engine_kw):
    """The port's engine on the raw weights of ``_raw(arch, seed)``."""
    raw = _raw(arch, seed)[1]
    return ServingEngine(
        smoke_config(arch).scaled(**WIDE),
        params_from_numpy(jax.tree.map(np.asarray, raw), device="cpu"),
        quant=QuantConfig(bits=4, kv_bits=kv_bits), device="cpu",
        **engine_kw)


def _pair(arch, kv_bits, seed=1, **engine_kw):
    """(reference engine, port engine) on identical raw weights."""
    jcfg, raw = _raw(arch, seed)
    jeng = JServingEngine(
        jcfg, raw, quant=JQuantConfig(bits=4, backend="pallas",
                                      kv_bits=kv_bits), **engine_kw)
    return jeng, _port(arch, kv_bits, seed, **engine_kw)


def _serve(eng, req_cls, work):
    for i, (prompt, max_tokens) in enumerate(work):
        eng.submit(req_cls(rid=i, prompt=np.asarray(prompt),
                           max_tokens=max_tokens))
    done = eng.run_to_completion()
    assert all(r.error is None and not r.truncated for r in done)
    return {r.rid: list(r.generated) for r in done}


def _assert_greedy_parity(jeng, want, got, work):
    """Token-identical, except from a first differing token where the
    reference's top-1/top-2 margin is under the logit tolerance."""
    assert want.keys() == got.keys()
    identical = 0
    for rid, (prompt, _) in enumerate(work):
        a, b = want[rid], got[rid]
        assert len(a) == len(b)
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            identical += 1
            continue
        toks = np.concatenate([np.asarray(prompt), a[:j]]).astype(np.int32)
        logits, _, _ = j_forward(jeng.params, jnp.asarray(toks[None]),
                                 jeng.cfg)
        lf = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(lf)[-2:]
        margin = top2[1] - top2[0]
        assert margin <= LOGIT_TOL * np.abs(lf).max(), (rid, j, margin)
    assert identical * 2 >= len(work), (identical, len(work))


def _workload(seed, n=6, lo=3, hi=40, vocab=256):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(lo, hi))),
             int(rng.integers(4, 12))) for _ in range(n)]


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-14b"])
def test_greedy_serving_matches_jax_engine(arch, kv_bits):
    jeng, teng = _pair(arch, kv_bits, max_batch=4, max_len=64, page_size=8)
    work = _workload(2)
    want = _serve(jeng, JRequest, work)
    got = _serve(teng, Request, work)
    _assert_greedy_parity(jeng, want, got, work)
    assert shared_stats(teng, jeng) == dict(jeng.stats)
    assert teng.stats["prefill_calls"] > 1 and teng.stats["page_grants"] > 0


def test_optimistic_preemption_matches_jax_engine():
    """A pool too small for the batch under optimistic admission: both
    engines preempt the same requests at the same ticks and every
    request still completes untruncated."""
    kw = dict(max_batch=2, max_len=64, page_size=8, num_pages=6,
              admission="optimistic", prefix_sharing=False)
    jeng, teng = _pair("qwen1.5-0.5b", None, **kw)
    work = [((np.arange(12) + 17 * i) % 256, 20) for i in range(3)]
    want = _serve(jeng, JRequest, work)
    got = _serve(teng, Request, work)
    assert teng.stats["preemptions"] > 0
    assert shared_stats(teng, jeng) == dict(jeng.stats)
    _assert_greedy_parity(jeng, want, got, work)
    roomy = _port("qwen1.5-0.5b", None, max_batch=2, max_len=64,
                  page_size=8, prefix_sharing=False)
    assert _serve(roomy, Request, work) == got


def test_cow_prefix_fork_matches_jax_engine():
    """A follower arriving while its donor is mid-decode maps the donor's
    resident prefix page and copy-on-write forks the partial tail block;
    with ``prefix_retain`` the retired donor's indexed pages park in the
    LRU pool, a repeat of its prompt revives them, and two long prompts
    that outgrow the free list evict (and deregister) them again. Forks,
    hits, retained hits, tokens, the retained pages and the prefix index
    match the reference; every request's tokens match a fresh engine and
    the donor's are uncorrupted."""
    common = (np.arange(44) * 5 + 1) % 256
    long_a = (np.arange(60) * 3 + 2) % 256
    long_b = (np.arange(60) * 7 + 5) % 256
    jeng, teng = _pair("qwen1.5-0.5b", 8, max_batch=2, max_len=64,
                       page_size=16, prefix_retain=3)
    outs, retained = [], []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.submit(req(rid=0, prompt=common, max_tokens=12))
        eng.step()
        eng.step()  # donor mid-decode: its pages are resident and indexed
        eng.submit(req(rid=1, prompt=common[:20].copy(), max_tokens=6))
        eng.run_to_completion()
        eng.submit(req(rid=2, prompt=common.copy(), max_tokens=12))
        eng.run_to_completion()
        retained.append(list(eng._allocator._retained))
        assert common[:16].astype(np.int32).tobytes() in eng._prefix_index
        eng.submit(req(rid=3, prompt=long_a, max_tokens=3))
        eng.submit(req(rid=4, prompt=long_b, max_tokens=3))
        outs.append({r.rid: r.generated for r in eng.run_to_completion()})
    assert teng.stats["cow_forks"] >= 1 and teng.stats["prefix_hits"] >= 1
    assert teng.stats["retained_hits"] >= 1
    assert shared_stats(teng, jeng) == dict(jeng.stats)
    assert retained[0] == retained[1] and len(retained[1]) == 3
    # the long prompts took all 8 pages: the donor's retained pages were
    # evicted and its blocks left the prefix index
    assert common[:16].astype(np.int32).tobytes() not in teng._prefix_index
    assert list(teng._allocator._retained) == list(jeng._allocator._retained)
    assert teng._prefix_index == jeng._prefix_index
    work = [(common, 12), (common[:20], 6), (common, 12), (long_a, 3),
            (long_b, 3)]
    _assert_greedy_parity(jeng, outs[0], outs[1], work)
    assert (teng._allocator.free_pages + teng._allocator.retained_pages
            == teng.num_pages)
    for rid, (prompt, mt) in enumerate(work):
        fresh = _port("qwen1.5-0.5b", 8, max_batch=2, max_len=64,
                      page_size=16)
        assert _serve(fresh, Request, [(prompt, mt)])[0] == outs[1][rid]


def test_rejections_and_tick_budget_match_jax_engine():
    """Over-long prompts, an infeasible request under reserve admission,
    the queue bound and the tick budget retire requests with the same
    errors in both engines."""
    kw = dict(max_batch=1, max_len=32, page_size=8, num_pages=3,
              max_queue=4)
    results = []
    for eng, req in zip(_pair("qwen1.5-0.5b", None, **kw),
                        (JRequest, Request)):
        reqs = [req(rid=0, prompt=np.arange(40) % 256, max_tokens=4),
                req(rid=1, prompt=np.arange(10) % 256, max_tokens=30),
                req(rid=2, prompt=np.arange(5) % 256, max_tokens=8),
                req(rid=3, prompt=np.arange(6) % 256, max_tokens=8),
                req(rid=4, prompt=np.arange(7) % 256, max_tokens=8)]
        for r in reqs:
            eng.submit(r)
        done = eng.run_to_completion(max_ticks=3)
        results.append(sorted((r.rid, r.error, len(r.generated))
                              for r in done))
        stats = eng.stats
    assert results[0] == results[1]
    errors = {rid: err for rid, err, _ in results[1]}
    assert errors[0].startswith("prompt length")
    assert errors[1].startswith("request needs")
    assert errors[4].startswith("queue full")
    assert errors[2] == errors[3] == "tick budget exhausted"
    assert stats["tick_budget_exhausted"] == 2


class _Holder:
    def __init__(self, pages, reserved):
        self.pages, self.reserved = pages, reserved


@settings(max_examples=40, deadline=None)
@given(num_pages=st.integers(1, 24), retain_limit=st.integers(0, 6),
       n_ops=st.integers(1, 80), seed=st.integers(0, 2**16))
def test_page_allocator_matches_reference(num_pages, retain_limit, n_ops,
                                          seed):
    """Random interleaved alloc / share / claim / release (with and
    without retention) / revive / cancel sequences drive the reference
    allocator and the port's; every return value, refcount, free list,
    retention order and eviction must agree, and the pool invariants of
    ``tests/test_page_allocator.py`` hold throughout."""
    rng = np.random.default_rng(seed)
    ref = JPageAllocator(num_pages, retain_limit=retain_limit)
    port = PageAllocator(num_pages, retain_limit=retain_limit)
    ref_ev, port_ev = [], []
    ref.on_evict, port.on_evict = ref_ev.extend, port_ev.extend
    holders: list[_Holder] = []

    def both(fn, *args, **kw):
        a = getattr(ref, fn)(*args, **kw)
        b = getattr(port, fn)(*args, **kw)
        assert a == b, (fn, a, b)
        return b

    for _ in range(n_ops):
        op = int(rng.integers(0, 7))
        h = holders[int(rng.integers(len(holders)))] if holders else None
        if op == 0:
            n, res = int(rng.integers(0, 4)), int(rng.integers(0, 3))
            pages = both("alloc", n, reserve=res)
            if pages is not None:
                holders.append(_Holder(list(pages), res))
        elif op == 1 and h and h.pages:
            page = h.pages[int(rng.integers(len(h.pages)))]
            both("share", page)
            holders[int(rng.integers(len(holders)))].pages.append(page)
        elif op == 2 and h and h.reserved:
            h.pages += both("claim_reserved", 1)
            h.reserved -= 1
        elif op in (3, 4) and h:
            holders.remove(h)
            both("release", h.pages, retain=(op == 4))
            if h.reserved:
                both("cancel_reservation", h.reserved)
        elif op == 5 and port.retained_pages and port.available > 0:
            # a revive within what the reservations leave, as in the
            # engine: there the alloc after a revive fails when it dug
            # into other requests' reservations, and the revive is undone
            page = list(port._retained)[int(rng.integers(
                port.retained_pages))]
            both("revive", page)
            holders.append(_Holder([page], 0))
        elif op == 6 and h and h.reserved:
            both("cancel_reservation", 1)
            h.reserved -= 1
        assert port._free == ref._free
        assert list(port._retained) == list(ref._retained)
        np.testing.assert_array_equal(port.refcount, ref.refcount)
        assert port_ev == ref_ev
        assert (port.reserved, port.available, port.held_pages) == (
            ref.reserved, ref.available, ref.held_pages)
        # invariants: refcounts >= 0; every page exactly one of free,
        # retained, held; reservations covered by free + retained pages
        assert (port.refcount >= 0).all()
        assert (port.free_pages + port.retained_pages + port.held_pages
                == num_pages)
        assert not set(port._free) & set(np.nonzero(port.refcount)[0])
        assert 0 <= port.reserved <= port.free_pages + port.retained_pages


def test_greedy_sampling_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]],
                          dtype=torch.bfloat16)
    got = sample_tokens(logits, None, 0.0)
    assert got.tolist() == [1, 0]
    assert got.tolist() == np.asarray(
        jnp.argmax(jnp.asarray([[0.0, 2.0, 2.0, 1.0], [5.0] * 4]), -1)
    ).tolist()


def test_temperature_sampling_distribution_and_seed():
    """Gumbel-max at temperature T samples softmax(logits / T): the
    empirical frequencies of 40k draws match it (5 sigma), and a fixed
    generator seed reproduces the draws."""
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5])
    temp = 0.7
    rows = logits.expand(40_000, 5)
    gen = torch.Generator().manual_seed(3)
    draws = sample_tokens(rows, gen, temp)
    freq = torch.bincount(draws.long(), minlength=5).double() / len(draws)
    p = torch.softmax(logits.double() / temp, dim=0)
    sigma = (p * (1 - p) / len(draws)).sqrt()
    assert ((freq - p).abs() <= 5 * sigma).all(), (freq, p)
    again = sample_tokens(rows, torch.Generator().manual_seed(3), temp)
    assert torch.equal(draws, again)


def test_temperature_serving_is_reproducible_from_seed():
    cfg = smoke_config("qwen1.5-0.5b")
    work = _workload(5, n=4, hi=20, vocab=cfg.vocab)
    outs = []
    for _ in range(2):
        eng = ServingEngine(cfg, None, quant=QuantConfig(bits=4), seed=11,
                            temperature=0.8, max_batch=2, max_len=32,
                            page_size=8, device="cpu")
        outs.append(_serve(eng, Request, work))
    assert outs[0] == outs[1]
