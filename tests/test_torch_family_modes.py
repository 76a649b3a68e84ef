"""Port parity: the serving modes no other test runs for the MoE, RWKV6
and hybrid Mamba2 families, and MoE speculative decoding, each against
the reference engine on the same weights and requests (greedy tokens and
stats; the helpers of ``test_torch_family_serving``).

olmoe on the ring, with per-row decode, with gather attention, with int8
KV, with prefix sharing plus ``prefix_retain`` and with optimistic
preemption; rwkv6 with per-row decode; zamba2 with int8 KV; and olmoe
with ``speculative=2`` against the reference's speculative engine. The
MoE runs hold their tokens to the logits the reference engine itself
sampled from (``_assert_engine_parity``): its decode and verify steps
route each token in a group of the step's size, so a full forward of the
prefix (other groups, other capacity drops) is not what it sampled from.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_family_serving import _serve_both  # noqa: E402
from test_torch_serving import _workload  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shared_prefix_work(vocab=256):
    """Prompts behind a common 24-token prefix (three 8-token pages), and
    a repeat of the first prompt after the others."""
    rng = np.random.default_rng(8)
    common = rng.integers(0, vocab, size=24)
    work = [(np.concatenate([common, rng.integers(0, vocab, size=n)]), 6)
            for n in (3, 9, 14)]
    return work + [work[0]]


# The serving modes no other test runs for these families; each compares
# greedy tokens and stats with the reference engine (``_serve_both``).
MODE_CASES = {
    "olmoe-ring": ("olmoe-1b-7b", None, dict(kv_mode="ring")),
    "olmoe-per-row": ("olmoe-1b-7b", None, dict(decode_mode="per_row")),
    "olmoe-gather": ("olmoe-1b-7b", None, dict(paged_attn="gather")),
    "olmoe-int8-kv": ("olmoe-1b-7b", 8, {}),
    "olmoe-prefix-retain": ("olmoe-1b-7b", None, dict(prefix_retain=8)),
    "olmoe-optimistic": ("olmoe-1b-7b", None, dict(
        max_batch=2, num_pages=6, admission="optimistic",
        prefix_sharing=False)),
    "rwkv6-per-row": ("rwkv6-3b", None, dict(decode_mode="per_row",
                                             max_batch=2)),
    "zamba2-int8-kv": ("zamba2-7b", 8, dict(max_batch=2)),
}
# the reference's per-row path runs its forward op by op and its hybrid
# engine compiles long: these serve one request of (tokens) each
SHORT = {"olmoe-per-row": 2, "rwkv6-per-row": 2, "zamba2-int8-kv": 4}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_family_serving_modes_match_jax(monkeypatch, case):
    """Greedy tokens and stats against the reference engine (module
    doc)."""
    arch, kv_bits, over = MODE_CASES[case]
    kw = {**dict(max_batch=4, max_len=64, page_size=8), **over}
    if case == "olmoe-prefix-retain":
        work = _shared_prefix_work()
    elif case == "olmoe-optimistic":
        work = [((np.arange(12) + 17 * i) % 256, 20) for i in range(3)]
    elif case in SHORT:
        work = [(prompt, SHORT[case]) for prompt, _ in _workload(
            12, n=1, lo=3, hi=20)]
    else:
        work = _workload(12, n=5, lo=3, hi=30)
    moe = arch == "olmoe-1b-7b" and "per_row" not in over.values()
    jeng, teng = _serve_both(arch, work, kv_bits=kv_bits,
                             monkeypatch=monkeypatch if moe else None, **kw)
    st = teng.stats
    if case == "olmoe-prefix-retain":
        assert st["prefix_hits"] > 0
    if case == "olmoe-optimistic":
        assert st["preemptions"] > 0
    if "per-row" in case:
        assert st["per_row_forward_calls"] > 0
    if kv_bits == 8:
        assert teng._kv_bits == 8


def test_moe_speculative_matches_the_reference_speculative_engine(
        monkeypatch):
    """olmoe smoke with ``speculative=2`` (4-bit, its own draft) against
    the REFERENCE's speculative engine, not plain decode: a verify window
    of 3 tokens has a capacity of 1 token an expert
    (``moe_capacity``), so both packages' speculative tokens part from
    their plain greedy decode. A token may part from the reference's
    only where the reference's verify logits for that position have a
    top-1 / top-2 margin under the logit tolerance (``LOGIT_TOL`` of the
    row's largest logit); the stats must agree exactly, those of the
    speculative ticks (``SPEC_STATS``) where the tokens do."""
    kw = dict(max_batch=4, max_len=64, page_size=8, speculative=2)
    work = _workload(13, n=6, lo=3, hi=30)
    jeng, teng = _serve_both("olmoe-1b-7b", work,
                             monkeypatch=monkeypatch, **kw)
    assert teng.stats["spec_ticks"] > 0
    assert teng.stats["draft_proposed"] > 0
