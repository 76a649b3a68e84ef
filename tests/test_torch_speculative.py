"""Port parity: self-speculative decoding (the accept rule, the draft and
verify steps, and the engine's ``speculative=K`` path).

The reference is the JAX package on the same numpy inputs and raw
weights. Speculative greedy output is held against PLAIN greedy decode
(the JAX engine's and the port's), never against the JAX speculative
engine's tokens: that engine fails its own eos test
(``tests/test_speculative.py::test_spec_respects_eos_mid_accepted_run``).
Its schedule statistics (ticks, drafts proposed and accepted) are
compared with the port's.

Tolerances: logits in bf16 agree to a few bf16 rounding steps, 1e-2 of
the largest logit (as in ``test_torch_model``); greedy tokens may differ
only from a first token where the reference's own top-1/top-2 margin is
under that tolerance. The sampled accept rule is checked empirically
against the target distribution at 5 standard deviations.
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
from repro.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_from_spec as j_init  # noqa: E402
from repro.models import init_paged_cache as j_init_paged_cache  # noqa: E402
from repro.models import quantize_params as j_quantize_params  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from repro_torch.models.model import init_paged_cache  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from test_torch_serving import shared_stats  # noqa: E402

LOGIT_TOL = 1e-2
WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)
ENGINE = dict(max_batch=4, max_len=64, page_size=8)
SPEC_STATS = ("spec_ticks", "draft_proposed", "draft_accepted")
# the target's weights and KV: bf16 (with the engine's default 4-bit
# draft) or 4-bit SAMD with packed int8 KV (its own draft)
TARGETS = {
    "bf16": (None, None),
    "b4_int8kv": (JQuantConfig(bits=4, backend="pallas", kv_bits=8),
                  QuantConfig(bits=4, kv_bits=8)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # JAX's CPU thread pool and torch's OpenMP threads oversubscribe the
    # cores when both run in one process; these shapes are tiny anyway
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _raw(arch="qwen1.5-0.5b", seed=1):
    jcfg = j_smoke_config(arch).scaled(**WIDE)
    return jcfg, j_init(j_build_template(jcfg), jax.random.PRNGKey(seed))


def _jax_engine(target, **kw):
    jcfg, raw = _raw()
    return JServingEngine(jcfg, raw, quant=TARGETS[target][0],
                          **{**ENGINE, **kw})


def _port_engine(target="bf16", **kw):
    raw = _raw()[1]
    return ServingEngine(
        smoke_config("qwen1.5-0.5b").scaled(**WIDE),
        params_from_numpy(jax.tree.map(np.asarray, raw), device="cpu"),
        quant=TARGETS[target][1], device="cpu", **{**ENGINE, **kw})


def _serve(eng, req_cls, work):
    for i, (prompt, max_tokens) in enumerate(work):
        eng.submit(req_cls(rid=i, prompt=np.asarray(prompt),
                           max_tokens=max_tokens))
    done = eng.run_to_completion()
    assert all(r.error is None and not r.truncated for r in done)
    return {r.rid: list(r.generated) for r in done}


def _workload(seed, n=6, lo=3, hi=40):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=int(rng.integers(lo, hi))),
             int(rng.integers(4, 12))) for _ in range(n)]


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
        assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(lf).max(), (rid, j)
    assert identical * 2 >= len(work), (identical, len(work))


@functools.lru_cache(maxsize=None)
def _jax_plain(target):
    """(engine, tokens) of the JAX engine's plain greedy decode."""
    eng = _jax_engine(target)
    return eng, _serve(eng, JRequest, _workload(2, lo=9, hi=17))


# ---------------------------------------------------------------------------
# the accept rule
# ---------------------------------------------------------------------------

_j_accept = jax.jit(jsteps.speculative_accept)


def _ref_accept(tgt_rows, draft_rows, spec_lens):
    """Pure-python greedy accept: the longest draft prefix within budget
    that matches the target argmax chain, then one correction."""
    out = []
    for tgt, drafts, budget in zip(tgt_rows, draft_rows, spec_lens):
        n = 0
        for j in range(1, len(drafts) + 1):
            if j > budget or drafts[j - 1] != tgt[j - 1]:
                break
            n += 1
        out.append((n, list(tgt[: n + 1])))
    return out


@settings(max_examples=40, deadline=None)
@given(k=st.integers(1, 5), ties=st.booleans(), seed=st.integers(0, 2**16))
def test_greedy_accept_matches_jax(k, ties, seed):
    """The same logits through the reference's and the port's accept rule
    give the same tokens and accept lengths: one-hot target chains,
    drafts agreeing for a random prefix, garbage logits past each budget
    and (``ties``) logits with exact ties, where both take the first
    maximum."""
    rng = np.random.default_rng(seed)
    b, vocab = 6, 7  # one batch shape: the reference compiles per shape
    tgt = rng.integers(0, vocab, size=(b, k + 1))
    drafts = np.where(rng.random((b, k)) < 0.6, tgt[:, :k],
                      rng.integers(0, vocab, (b, k))).astype(np.int32)
    spec_len = rng.integers(0, k + 1, size=b).astype(np.int32)
    logits = np.full((b, k + 1, vocab), -5.0, np.float32)
    np.put_along_axis(logits, tgt[..., None], 5.0, axis=-1)
    if ties:  # a second maximum after the first one
        np.put_along_axis(logits, np.minimum(tgt + 1, vocab - 1)[..., None],
                          5.0, axis=-1)
    for i in range(b):
        logits[i, spec_len[i] + 1:] = rng.normal(size=(k - spec_len[i],
                                                       vocab))
    jout, jn = _j_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(logits[:, :k]),
        jnp.asarray(spec_len), jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.asarray(np.arange(b), np.int32))
    out, n_acc = steps.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(logits[:, :k]), torch.from_numpy(spec_len), None,
        0.0)
    assert out.dtype == n_acc.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
    if not ties:
        for i, (n_ref, emit) in enumerate(_ref_accept(
                tgt.tolist(), drafts.tolist(), spec_len.tolist())):
            assert int(n_acc[i]) == n_ref <= spec_len[i]
            assert out[i, :n_ref + 1].tolist() == emit


def test_sampled_accept_keeps_the_target_distribution():
    """Rejection sampling: a draft token d ~ p_d accepted with probability
    min(1, p_t(d) / p_d(d)), else a resample from (p_t - p_d)+, emits
    tokens distributed as p_t; with no draft budget the bonus sample
    alone is p_t. 60k rows each, within 5 sigma of p_t, and a fixed
    generator seed reproduces every draw."""
    n, temp = 60_000, 0.8
    lt = torch.tensor([[1.0, 0.2, -0.5, 1.5, 0.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0]])  # [K+1 = 2, V = 5]
    ld = torch.tensor([[0.0, 1.2, 0.3, 0.5, -1.0]])  # [K = 1, V]
    pt = torch.softmax(lt[0].double() / temp, dim=0)
    pd = torch.softmax(ld[0] / temp, dim=0)
    logits = lt.expand(n, 2, 5)
    dlogits = ld.expand(n, 1, 5)

    def run(seed, budget):
        gen = torch.Generator().manual_seed(seed)
        drafts = torch.multinomial(pd, n, replacement=True,
                                   generator=gen)[:, None].int()
        spec = torch.full((n,), budget, dtype=torch.int32)
        return steps.speculative_accept(logits, drafts, dlogits, spec, gen,
                                        temp)

    sigma = (pt * (1 - pt) / n).sqrt()
    for budget in (1, 0):
        out, n_acc = run(5, budget)
        freq = torch.bincount(out[:, 0].long(), minlength=5).double() / n
        assert ((freq - pt).abs() <= 5 * sigma).all(), (budget, freq, pt)
        again, n_again = run(5, budget)
        assert torch.equal(out, again) and torch.equal(n_acc, n_again)
    out, n_acc = run(5, 1)
    rate = n_acc.double().mean()
    want = torch.minimum(pd.double(), pt).sum()  # P(accept) = sum min
    assert abs(rate - want) <= 5 * (want * (1 - want) / n).sqrt()


# ---------------------------------------------------------------------------
# the draft and verify steps
# ---------------------------------------------------------------------------

def _step_case(arch, kv_bits):
    """Both packages' 4-bit target (its own draft) and paged caches after
    the same ragged prefill of three slots; slot 2 is inactive."""
    jcfg, raw = _raw(arch)
    cfg = smoke_config(arch).scaled(**WIDE)
    template = j_build_template(jcfg)
    qcfg = JQuantConfig(bits=4, backend="pallas", kv_bits=kv_bits)
    # jitted, as the reference's engine quantizes (eager JAX is slower)
    jq = jax.jit(lambda r: j_quantize_params(r, template, qcfg))(raw)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    rng = np.random.default_rng(4)
    ps, n_pages = 8, 12
    pt = np.array([[3, 7, 1, 9], [5, 0, 2, -1], [-1, -1, -1, -1]], np.int32)
    lens = np.array([14, 7, 0])
    toks = rng.integers(0, 256, size=(3, 16)).astype(np.int32)
    pos = np.where(np.arange(16)[None] < lens[:, None], np.arange(16)[None],
                   -1).astype(np.int32)
    jc = j_init_paged_cache(jcfg, n_pages, ps, kv_bits=kv_bits)
    tc = init_paged_cache(cfg, n_pages, ps, kv_bits=kv_bits, device="cpu")
    _, jc, _ = j_forward(jq, jnp.asarray(toks), jcfg,
                         positions=jnp.asarray(pos), cache=jc,
                         page_table=jnp.asarray(pt), page_size=ps)
    forward(tq, torch.from_numpy(toks).long(), cfg,
            positions=torch.from_numpy(pos).long(), cache=tc,
            page_table=torch.from_numpy(pt), page_size=ps)
    last = rng.integers(0, 256, size=(3, 1)).astype(np.int32)
    return jcfg, cfg, jq, tq, jc, tc, pt, lens.astype(np.int32), last


def _pools(cache, n_pages, dequant):
    """Every layer's K and V pools as f32 numpy over the first
    ``n_pages`` pages (the port's scratch page left out)."""
    out = []
    for layer in cache["layers"]:
        for name in ("k", "v"):
            pool = layer[name][:n_pages]
            if isinstance(pool, torch.Tensor):
                pool = pool.float() if pool.is_floating_point() else pool
            pool = np.asarray(pool)
            if dequant:
                words = pool.astype(np.uint32)
                lanes = np.stack([(words >> (8 * i)) & 0xFF
                                  for i in range(4)], -1).astype(np.int8)
                pool = lanes.reshape(pool.shape[:-1] + (-1,)).astype(
                    np.float32) * np.asarray(
                        layer[name + "_scale"])[:n_pages][..., None]
            out.append(np.asarray(pool, np.float32))
    return out


@pytest.mark.parametrize("arch,kv_bits", [("qwen1.5-0.5b", 8),
                                          ("qwen3-14b", None)])
def test_draft_and_verify_steps_match_jax(arch, kv_bits):
    """K = 3 drafts per slot over a prefilled pool, then the verify with
    per-slot budgets [3, 1, 0] (slot 2 inactive): draft tokens and
    logits, the verify's consumed tokens and accept lengths, and the
    pool after the verify's write (nothing written past a budget) match
    the reference; the draft leaves the pool untouched."""
    k, max_len, ps, n_pages = 3, 64, 8, 12
    jcfg, cfg, jq, tq, jc, tc, pt, lens, last = _step_case(arch, kv_bits)
    run = RunConfig(arch=jcfg, shape=ShapeConfig("serve", max_len, 3,
                                                 "decode"))
    zero = jnp.float32(0.0)
    jd_tok, jd_lg = jax.jit(jsteps.make_draft_step(jcfg, run, ps, k))(
        jq, jnp.asarray(last), jc, jnp.asarray(lens), jnp.asarray(pt),
        jax.random.PRNGKey(0), zero)
    before = _pools(tc, n_pages, False)
    d_tok, d_lg = steps.make_draft_step(cfg, max_len, ps, k)(
        tq, torch.from_numpy(last).long(), tc, torch.from_numpy(lens),
        torch.from_numpy(pt), None, 0.0)
    for a, b in zip(before, _pools(tc, n_pages, False)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(d_tok.numpy(), np.asarray(jd_tok))
    jl = np.asarray(jd_lg, np.float32)
    np.testing.assert_allclose(d_lg.float().numpy(), jl, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * np.abs(jl).max())

    spec_len = np.array([3, 1, 0], np.int32)
    active = np.array([True, True, False])
    jout, jn, jc2 = jax.jit(
        jsteps.make_speculative_verify_step(jcfg, run, ps, k))(
        jq, jnp.asarray(last), jd_tok, jd_lg, jc, jnp.asarray(lens),
        jnp.asarray(active), jnp.asarray(pt), jnp.asarray(spec_len),
        jax.random.PRNGKey(0), zero)
    out, n_acc = steps.make_speculative_verify_step(cfg, max_len, ps, k)(
        tq, torch.from_numpy(last).long(),
        torch.from_numpy(np.array(jd_tok)),
        torch.from_numpy(np.asarray(jd_lg, np.float32)).to(torch.bfloat16),
        tc, torch.from_numpy(lens), torch.from_numpy(active),
        torch.from_numpy(pt), torch.from_numpy(spec_len), None, 0.0)
    jout, jn = np.asarray(jout), np.asarray(jn)
    np.testing.assert_array_equal(n_acc.numpy(), jn)
    for i in range(3):
        np.testing.assert_array_equal(out[i, :jn[i] + 1].numpy(),
                                      jout[i, :jn[i] + 1])
    assert (out[2] == -1).all() and n_acc[2] == 0
    for a, b in zip(_pools(tc, n_pages, kv_bits == 8),
                    _pools(jc2, n_pages, kv_bits == 8)):
        np.testing.assert_allclose(a, b, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL * np.abs(b).max())
        # the same (token, head) entries written
        np.testing.assert_array_equal((a != 0).any(-1), (b != 0).any(-1))


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_draft_forward_fused_matches_gather(kv_bits):
    """The draft's attention through the decode kernel's ring fold equals
    the dense reference (the pool gathered up to ``pool_bound`` and
    concatenated with the ring), over K forwards that fill the ring."""
    _, cfg, _, tq, _, tc, pt, lens, last = _step_case("qwen3-14b", kv_bits)
    pos = torch.from_numpy(lens).long()
    outs = {}
    for mode in ("fused", "gather"):
        ring = init_cache(cfg, 3, 3, device="cpu")
        cur, lgs = torch.from_numpy(last).long(), []
        for j in range(3):
            lg = forward(tq, cur, cfg, positions=(pos + j)[:, None],
                         cache=ring, cache_index=j,
                         page_table=torch.from_numpy(pt), page_size=8,
                         paged_attn=mode, pool_cache=tc,
                         pool_bound=pos - 1)
            lgs.append(lg[:, -1].float())
            cur = (torch.arange(3)[:, None] * 11 + j) % 256  # fixed inputs
        outs[mode] = torch.stack(lgs, 1)
        assert (ring["layers"][0]["pos"] == pos[:, None]
                + torch.arange(3)).all()
    want = outs["gather"]
    torch.testing.assert_close(outs["fused"], want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL * want.abs().max().item())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _record_ticks(eng):
    """Wrap the JAX engine's speculative step to log each tick's
    (spec_len, out, n_acc, None)."""
    log, step = [], eng._spec_step

    def logged(*args):
        res = step(*args)
        log.append((np.array(args[7]), np.array(res[0]), np.array(res[1]),
                    None))
        return res

    eng._spec_step = logged
    return log


def _record_port_ticks(eng):
    """Wrap the port engine's verify step to log each tick's (spec_len,
    out, n_acc, draft logits)."""
    log, verify = [], eng._verify_step

    def logged(params, tokens, draft_tok, draft_lg, cache, pos, active,
               table, spec, gen, temp):
        res = verify(params, tokens, draft_tok, draft_lg, cache, pos, active,
                     table, spec, gen, temp)
        log.append((np.array(spec), np.array(res[0]), np.array(res[1]),
                    draft_lg.float().numpy()))
        return res

    eng._verify_step = logged
    return log


@pytest.mark.parametrize("target,k", [("bf16", 2), ("bf16", 4),
                                      ("b4_int8kv", 2)])
def test_speculative_serving_matches_jax(target, k):
    """Mixed-length greedy serving: the port's speculative tokens equal
    the JAX engine's plain greedy decode (near-tie rule), and the port's
    speculative schedule (ticks, drafts proposed and accepted) equals the
    JAX speculative engine's, tick by tick, up to the first tick where
    they part: an emitted token that differs is a target near-tie (the
    greedy parity check shows it), and accept lengths that differ under
    the same tokens come from a draft near-tie (the draft's top-1/top-2
    margin is under the logit tolerance; its logits match the
    reference's, ``test_draft_and_verify_steps_match_jax``)."""
    work = _workload(2, lo=9, hi=17)
    jplain, want = _jax_plain(target)
    jspec = _jax_engine(target, speculative=k)
    jlog = _record_ticks(jspec)
    _serve(jspec, JRequest, work)
    teng = _port_engine(target, speculative=k)
    tlog = _record_port_ticks(teng)
    got = _serve(teng, Request, work)
    _assert_greedy_parity(jplain, want, got, work)
    assert teng.stats["spec_ticks"] > 0 and teng.stats["draft_accepted"] > 0
    for (jspec_len, jout, jn, _), (tspec_len, tout, tn, tdl) in zip(jlog,
                                                                     tlog):
        np.testing.assert_array_equal(tspec_len, jspec_len)
        if any((jout[i, :n + 1] != tout[i, :n + 1]).any()
               for i, n in enumerate(np.minimum(jn, tn))):
            return
        split = np.nonzero(jn != tn)[0]
        if split.size:
            i = split[0]
            lf = tdl[i, min(jn[i], tn[i])]
            top2 = np.sort(lf)[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(lf).max()
            return
    assert shared_stats(teng, jspec) == dict(jspec.stats)


@functools.lru_cache(maxsize=None)
def _plain_run(prompt: tuple, max_tokens: int):
    eng = _port_engine()
    return _serve(eng, Request, [(np.asarray(prompt), max_tokens)])[0]


def test_spec_respects_eos_mid_accepted_run():
    """An eos inside an accepted run stops consumption there: the output
    is plain greedy decode cut at the eos."""
    for pseed in range(8):
        prompt = (np.arange(9) * 5 + 2 + 31 * pseed) % 256
        ref = _plain_run(tuple(prompt), 8)
        idx = next((i for i in range(2, len(ref)) if ref[i] not in ref[:i]),
                   None)
        if idx is not None:
            break
    assert idx is not None, "no prompt with a mid-run first occurrence"
    eos = ref[idx]
    for k in (2, 4):
        eng = _port_engine(speculative=k)
        eng.submit(Request(rid=0, prompt=prompt.copy(), max_tokens=8,
                           eos_id=eos))
        got = eng.run_to_completion()[0].generated
        assert got == ref[:idx + 1], (k, got, ref)
        assert eng.stats["draft_accepted"] <= eng.stats["draft_proposed"]


def test_spec_preemption_completes_untruncated():
    """Pool pressure mid-speculation under optimistic admission: the
    youngest slot is preempted and recompute-resumed, lookahead never
    preempts, and every request completes in full with plain greedy's
    tokens."""
    work = [((np.arange(12) + 17 * i) % 256, 20) for i in range(3)]
    kw = dict(max_batch=2, page_size=8, prefix_sharing=False)
    eng = _port_engine(speculative=2, num_pages=6, admission="optimistic",
                       **kw)
    pressured = _serve(eng, Request, work)
    assert eng.stats["preemptions"] > 0 and eng.stats["oop_retired"] == 0
    assert all(len(v) == 20 for v in pressured.values())
    assert pressured == _serve(_port_engine(**kw), Request, work)


def test_cow_fork_inside_speculatively_written_block():
    """A follower forks a page written by the donor's accepted speculative
    runs (kept across the donor's retirement by LRU retention): the fork
    copies exactly the accepted tokens' KV, so the follower decodes as a
    fresh plain engine does."""
    prompt = (np.arange(12) * 3 + 5) % 256
    eng = _port_engine(page_size=8, speculative=2, prefix_retain=8)
    eng.submit(Request(rid=0, prompt=prompt, max_tokens=16))
    done0 = eng.run_to_completion()
    assert eng.stats["draft_accepted"] > 0
    written = np.concatenate(
        [prompt, np.asarray(done0[0].generated[:-1], np.int32)])
    follow = written[:20].copy()  # ends inside retained block 2
    eng.submit(Request(rid=1, prompt=follow, max_tokens=4))
    done = {r.rid: r.generated for r in eng.run_to_completion()}
    assert eng.stats["cow_forks"] >= 1, eng.stats
    assert eng.stats["retained_hits"] >= 2, eng.stats
    assert done[1] == _plain_run(tuple(follow), 4)
    assert done0[0].generated == _plain_run(tuple(prompt), 16)


def test_spec_multi_turn_continuation_shares_decoded_pages():
    """Blocks completed by accepted runs enter the prefix index: a
    follow-up extending the donor's prompt + generation maps them (via
    retention) instead of re-prefilling them."""
    prompt = (np.arange(10) * 7 + 1) % 256
    eng = _port_engine(page_size=8, speculative=2, prefix_retain=8)
    eng.submit(Request(rid=0, prompt=prompt, max_tokens=12))
    done0 = eng.run_to_completion()
    written = np.concatenate(
        [prompt, np.asarray(done0[0].generated[:-1], np.int32)])
    follow = np.asarray(list(written[:16]) + [7, 9], np.int32)
    eng.submit(Request(rid=1, prompt=follow, max_tokens=4))
    got = {r.rid: r.generated for r in eng.run_to_completion()}
    assert eng.stats["prefix_hits"] >= 2, eng.stats
    assert eng.stats["retained_hits"] >= 2, eng.stats
    assert got[1] == _plain_run(tuple(follow), 4)


def test_spec_zero_keeps_single_token_path(monkeypatch):
    """speculative=0 (the default) never reaches the speculative
    machinery."""
    def boom(*a, **kw):
        raise AssertionError("speculative path reached")

    monkeypatch.setattr(ServingEngine, "_step_speculative", boom)
    monkeypatch.setattr(ServingEngine, "_spec_lens", boom)
    eng = _port_engine()
    _serve(eng, Request, _workload(3, n=3))
    assert eng.speculative == 0 and not hasattr(eng, "_verify_step")
    assert all(eng.stats[key] == 0 for key in SPEC_STATS)
    assert eng.stats["decode_steps"] > 0
    with pytest.raises(ValueError, match="speculative"):
        _port_engine(speculative=-1)


def test_quantized_target_takes_no_draft_quant():
    """A quantized target is its own draft: a ``draft_quant`` given with
    it is refused, not ignored."""
    eng = _port_engine("b4_int8kv", speculative=2)
    assert eng._draft_params is eng.params
    assert eng.draft_quant == eng.quant
    with pytest.raises(ValueError, match="draft_quant"):
        _port_engine("b4_int8kv", speculative=2,
                     draft_quant=QuantConfig(bits=8))


def test_full_precision_draft_accepts_everything():
    """Oracle: a draft sharing the bf16 target's weights proposes exactly
    what greedy verify picks."""
    eng = _port_engine(speculative=2, draft_quant=QuantConfig(enabled=False))
    got = _serve(eng, Request, _workload(2))
    assert eng._draft_params is eng.params
    assert eng.stats["draft_accepted"] == eng.stats["draft_proposed"] > 0
    assert got == _serve(_port_engine(), Request, _workload(2))


def test_sampled_speculative_serving_is_reproducible():
    """Temperature > 0 verifies by rejection sampling from the engine's
    generator: a fixed seed reproduces every token, and the oracle draft
    gets drafts accepted."""
    outs = []
    for _ in range(2):
        eng = _port_engine(speculative=2, temperature=0.7, seed=7,
                           draft_quant=QuantConfig(enabled=False))
        outs.append(_serve(eng, Request, _workload(5, n=4)))
        assert eng.stats["draft_accepted"] > 0
    assert outs[0] == outs[1]
    assert all(0 <= t < 256 for toks in outs[0].values() for t in toks)


def test_cache_write_and_ring_layout():
    """The draft ring: bf16 k/v and int32 positions at -1, written in
    place at a scalar column."""
    cfg = smoke_config("qwen3-14b")
    ring = init_cache(cfg, 2, 3, device="cpu")["layers"][0]
    assert ring["k"].shape == (2, 3, cfg.n_kv_heads, cfg.head_dim)
    assert ring["k"].dtype == torch.bfloat16
    assert (ring["pos"] == -1).all() and ring["pos"].dtype == torch.int32
    L._cache_write(ring["pos"], torch.tensor([[7], [9]]), 1)
    assert ring["pos"].tolist() == [[-1, 7, -1], [-1, 9, -1]]
