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
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.lanes import LaneSafetyError as JLaneSafetyError  # noqa
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.analysis.lanes import LaneSafetyError  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_serving import _assert_greedy_parity  # noqa: E402
from test_torch_serving import _pair, _port, _serve, _workload  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_both(arch, work, **kw):
    jeng, teng = _pair(arch, None, **kw)
    assert teng.kv_mode == jeng.kv_mode
    want = _serve(jeng, JRequest, work)
    got = _serve(teng, Request, work)
    _assert_greedy_parity(jeng, want, got, work)
    assert teng.stats == {k: jeng.stats[k] for k in teng.stats}
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
