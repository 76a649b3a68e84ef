"""Port parity: serving the MoE, sq_relu, RWKV6 and hybrid Mamba2 families.

Greedy serving with the same weights (4-bit SAMD, the kernel route) and
requests through ``repro.serving.ServingEngine`` and the port's engine
(on the CPU, so the kernels' plain versions run): olmoe and nemotron
smoke configs on the paged pool, rwkv6 and zamba2 on the ring, which
``kv_mode="auto"`` picks for them. The recurrent runs admit more
requests than slots, so a slot is reused and its state row must be
reset at admission; their decode stays one ragged step a tick (no
per-row forwards), as ``tests/test_serving.py`` holds the reference.

Tokens may part only where the reference's own top-1 / top-2 logit
margin is under the logit tolerance (``_assert_greedy_parity`` of
``test_torch_serving``), and schedules depend only on lengths, so the
engines' stats must agree exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis.lanes import LaneSafetyError as JLaneSafetyError  # noqa
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.analysis.lanes import LaneSafetyError  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_serving import LOGIT_TOL  # noqa: E402
from test_torch_serving import _assert_greedy_parity  # noqa: E402
from test_torch_serving import _pair, _port, _serve, _workload  # noqa: E402
from test_torch_serving import shared_stats  # noqa: E402


j_speculative_accept = j_steps.speculative_accept
j_sample_tokens = j_steps.sample_tokens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a speculative tick's counters follow its accepted runs, which change
# where a near-tie lets the two packages' tokens part
SPEC_STATS = ("decode_steps", "spec_ticks", "draft_proposed",
              "draft_accepted")


def _serve_both(arch, work, kv_bits=None, monkeypatch=None, **kw):
    """Serve ``work`` on both engines; tokens and stats must agree. With
    ``monkeypatch`` (MoE), a token may part only at a near-tie of the
    logits the reference's engine itself sampled from
    (``_assert_engine_parity``); otherwise at a near-tie of a full
    forward of the prefix (``_assert_greedy_parity``)."""
    jeng, teng = _pair(arch, kv_bits, **kw)
    assert teng.kv_mode == jeng.kv_mode
    seen = _record_sampling(monkeypatch, jeng) if monkeypatch else None
    want = _serve(jeng, JRequest, work)
    got = _serve(teng, Request, work)
    if seen is None:
        _assert_greedy_parity(jeng, want, got, work)
    else:
        _assert_engine_parity(jeng, seen, want, got, work)
    port = shared_stats(teng, jeng)
    keys = [k for k in port
            if want == got or not teng.speculative or k not in SPEC_STATS]
    assert {k: port[k] for k in keys} == {k: jeng.stats[k] for k in keys}
    return jeng, teng


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "nemotron-4-15b"])
def test_paged_families_serve_like_jax(arch):
    """MoE (routed experts dequantized, attention G = 1) and sq_relu
    with GQA, on the paged pool with batched prefills of ragged
    prompts."""
    work = _workload(4, n=5, lo=3, hi=30)
    _, teng = _serve_both(arch, work, max_batch=4, max_len=48, page_size=8)
    assert teng.kv_mode == "paged"
    assert teng.stats["prefill_calls"] >= 1
    assert teng.stats["per_row_forward_calls"] == 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_recurrent_families_serve_like_jax(arch):
    """Two admission waves over two slots: the ring, one per-slot
    prefill per request, one ragged decode step a tick."""
    work = _workload(5, n=4, lo=3, hi=24)
    _, teng = _serve_both(arch, work, max_batch=2, max_len=48)
    assert teng.kv_mode == "ring" and not teng._batched_prefill
    st = teng.stats
    assert st["per_row_prefill_calls"] == len(work)
    assert st["prefill_calls"] == 0
    assert st["per_row_forward_calls"] == 0
    assert st["decode_steps"] > 0


def test_reused_slot_starts_from_a_clean_state():
    """A request served in a slot another request used gives the tokens
    it gives on a fresh engine: admission resets the recurrent state and
    the shared attention's ring."""
    work = _workload(6, n=3, lo=4, hi=20)
    busy = _port("zamba2-7b", None, max_batch=1, max_len=48)
    got = _serve(busy, Request, work)
    for rid, item in enumerate(work):
        fresh = _port("zamba2-7b", None, max_batch=1, max_len=48)
        assert _serve(fresh, Request, [item])[0] == got[rid]


def test_lane_safety_covers_the_experts():
    """``verify=True`` certifies the packed experts' depths too: with
    8-bit codes and 8-bit activations, f32 sums are exact to depth 1024,
    so experts of d_ff 2048 (w_down's depth; every other linear is 256
    deep) are refused with the reference's verdict."""
    over = dict(d_model=256, head_dim=64, vocab=256, expert_d_ff=2048)
    with pytest.raises(JLaneSafetyError) as want:
        JServingEngine(j_smoke_config("olmoe-1b-7b").scaled(**over), None,
                       quant=JQuantConfig(bits=8, act_bits=8), max_batch=1,
                       max_len=16)
    with pytest.raises(LaneSafetyError) as got:
        ServingEngine(smoke_config("olmoe-1b-7b").scaled(**over), None,
                      quant=QuantConfig(bits=8, act_bits=8), max_batch=1,
                      max_len=16, device="cpu")
    assert got.value.verdict.to_dict() == want.value.verdict.to_dict()
    assert got.value.verdict.depth == 2048


def _record_sampling(monkeypatch, jeng):
    """Record what the reference engine's decode and speculative ticks
    sample from: a list of (token position, rid, logits row), one per
    slot and emitted position, the logits taken inside its jitted steps
    by ``jax.debug.callback``. A decode row sampled with ``fold`` = its
    position emits the token at fold + 1; a verify row m of a window at
    base emits base + 1 + m. Prefills' samples are not recorded."""
    raw, seen = [], []

    def sample(logits, key, temperature, fold=None):
        jax.debug.callback(lambda lg, f: raw.append(
            ("_ragged_step", np.asarray(lg, np.float32)[:, None],
             np.asarray(f) + 1)), logits, fold)
        return j_sample_tokens(logits, key, temperature, fold=fold)

    def accept(logits, draft_tok, draft_logits, spec_len, key, temperature,
               pos):
        jax.debug.callback(lambda lg, p: raw.append(
            ("_spec_step", np.asarray(lg, np.float32), np.asarray(p) + 1)),
            logits, pos)
        return j_speculative_accept(logits, draft_tok, draft_logits,
                                    spec_len, key, temperature, pos)

    monkeypatch.setattr(j_steps, "sample_tokens", sample)
    monkeypatch.setattr(j_steps, "speculative_accept", accept)

    def tagged(name, step):
        def run(*args):
            rids = [None if r is None else r.rid for r in jeng.slots]
            n0 = len(raw)
            out = step(*args)
            jax.effects_barrier()
            # a speculative tick's draft samples are not what it emits
            for kind, logits, first in raw[n0:]:
                if kind != name:
                    continue
                seen.extend((int(first[slot]) + m, rid, logits[slot, m])
                            for slot, rid in enumerate(rids)
                            if rid is not None
                            for m in range(logits.shape[1]))
            return out
        return run

    for name in ("_ragged_step", "_spec_step"):
        if hasattr(jeng, name):
            setattr(jeng, name, tagged(name, getattr(jeng, name)))
    return seen


def _assert_engine_parity(jeng, seen, want, got, work):
    """Token-identical, except from a first differing token j > 0 where
    the logits the reference engine sampled that token from (the last
    record of that request and position) have a top-1 / top-2 margin
    under ``LOGIT_TOL`` of their largest |value|; a differing first
    token (the prefill's) falls back to ``_assert_greedy_parity``."""
    assert want.keys() == got.keys()
    identical = 0
    for rid, (prompt, _) in enumerate(work):
        a, b = want[rid], got[rid]
        assert len(a) == len(b)
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            identical += 1
            continue
        if j == 0:
            _assert_greedy_parity(jeng, {0: a}, {0: b}, [(prompt, 0)])
            continue
        rows = [lg for pos, r, lg in seen
                if r == rid and pos == len(prompt) + j]
        assert rows, (rid, j)
        top2 = np.sort(rows[-1])[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(rows[-1]).max(), (
            rid, j, top2)
    assert identical * 2 >= len(work), (identical, len(work))
