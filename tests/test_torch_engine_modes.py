"""Port parity: the serving engine's other modes.

The per-slot KV ring (``kv_mode="ring"``), the per-row reference path
(``decode_mode="per_row"``, which runs the ring) and the dense page
gather (``paged_attn="gather"``) serve the same greedy requests through
``repro.serving.ServingEngine`` and the port's engine (on the CPU, so
the kernels' plain versions run), with bf16 weights, 4-bit weights
(``backend="pallas"`` in the reference: the same per-channel product)
and a group-scaled 4-bit target (``group_size=32``: the reference's
dequantize-then-matmul route, ``backend="xla"``). Tokens must agree up
to the near-tie rule of ``test_torch_serving`` (a first differing token
only where the reference's top-1/top-2 margin is under 1e-2 of its
largest logit), and the stats, which depend only on lengths, must be
equal, the per-row and prefill counters included. The mode-resolution
errors must be the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_serving import (  # noqa: E402
    WIDE, _assert_greedy_parity, _raw, _serve, _workload, shared_stats,
)

from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

MODES = {
    "ring": dict(kv_mode="ring"),
    "per_row": dict(decode_mode="per_row"),
    "gather": dict(paged_attn="gather"),
}
# weights: (reference QuantConfig kwargs, port QuantConfig kwargs) or None
WEIGHTS = {
    "bf16": None,
    "b4": (dict(bits=4, backend="pallas"), dict(bits=4)),
    "b4g32": (dict(bits=4, group_size=32), dict(bits=4, group_size=32)),
}
ENGINE = dict(max_batch=3, max_len=64, page_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(arch, weights, kv_bits=None, seed=1, **engine_kw):
    """(reference engine, port engine) on the raw weights of ``_raw``."""
    jcfg, raw = _raw(arch, seed)
    qs = WEIGHTS[weights]
    jq = tq = None
    if qs is not None:
        jq = JQuantConfig(kv_bits=kv_bits, **qs[0])
        tq = QuantConfig(kv_bits=kv_bits, **qs[1])
    jeng = JServingEngine(jcfg, raw, quant=jq, **ENGINE, **engine_kw)
    teng = ServingEngine(
        smoke_config(arch).scaled(**WIDE),
        params_from_numpy(jax.tree.map(np.asarray, raw), device="cpu"),
        quant=tq, device="cpu", **ENGINE, **engine_kw)
    return jeng, teng


def _check(jeng, teng, work):
    want = _serve(jeng, JRequest, work)
    got = _serve(teng, Request, work)
    _assert_greedy_parity(jeng, want, got, work)
    assert shared_stats(teng, jeng) == dict(jeng.stats)
    assert (teng.kv_mode, teng.decode_mode, teng.paged_attn) == (
        jeng.kv_mode, jeng.decode_mode, jeng.paged_attn)


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_serves_the_jax_engines_tokens(mode, weights):
    jeng, teng = _engines("qwen1.5-0.5b", weights, **MODES[mode])
    work = _workload(3, n=4, hi=24)
    _check(jeng, teng, work)
    st = teng.stats
    if mode == "per_row":
        assert st["per_row_forward_calls"] > 0
        assert st["per_row_prefill_calls"] == len(work)
        assert st["decode_steps"] == st["prefill_calls"] == 0
    else:
        assert st["per_row_forward_calls"] == st["per_row_prefill_calls"] == 0
        assert st["decode_steps"] > 0 and st["prefill_calls"] > 0


def test_int8_ring_serves_the_jax_engines_tokens():
    """The ring with ``kv_bits=8``: int8 lanes and a per-(token,
    kv-head) scale, as the reference's ring keeps them."""
    jeng, teng = _engines("qwen3-14b", "b4", kv_bits=8, kv_mode="ring")
    assert teng.cache["layers"][0]["k"].dtype == torch.int8
    _check(jeng, teng, _workload(4, n=4, hi=30))


def test_quantized_lm_head_serves_the_jax_engines_tokens():
    """qwen3-14b's untied LM head packed (``quantize_embeddings``) on the
    paged fused path: the head runs through ``samd_matmul``."""
    jcfg, raw = _raw("qwen3-14b", 1)
    jq = JQuantConfig(bits=4, backend="pallas", quantize_embeddings=True)
    tq = QuantConfig(bits=4, quantize_embeddings=True)
    jeng = JServingEngine(jcfg, raw, quant=jq, **ENGINE)
    teng = ServingEngine(
        smoke_config("qwen3-14b").scaled(**WIDE),
        params_from_numpy(jax.tree.map(np.asarray, raw), device="cpu"),
        quant=tq, device="cpu", **ENGINE)
    assert type(teng.params["lm_head"]).__name__ == "QuantizedTensor"
    _check(jeng, teng, _workload(5, n=4, hi=30))


def test_ring_resets_a_reused_slot():
    """A slot's ring row is replaced at admission: a later request in a
    reused slot gives the tokens it gives alone."""
    work = _workload(6, n=4, hi=30)
    _, alone = _engines("qwen1.5-0.5b", "b4", kv_mode="ring")
    _, shared = _engines("qwen1.5-0.5b", "b4", kv_mode="ring")
    got_shared = _serve(shared, Request, work)
    got_alone = _serve(alone, Request, work[-1:])
    assert got_shared[len(work) - 1] == got_alone[0]


@pytest.mark.parametrize("kw", [
    dict(kv_mode="ring", speculative=2),
    dict(decode_mode="per_row", kv_mode="paged"),
    dict(decode_mode="per_row", speculative=2),
])
def test_mode_errors_match_the_reference(kw):
    jcfg, raw = _raw("qwen1.5-0.5b", 1)
    with pytest.raises(ValueError) as jerr:
        JServingEngine(jcfg, raw, **ENGINE, **kw)
    with pytest.raises(ValueError) as terr:
        ServingEngine(smoke_config("qwen1.5-0.5b").scaled(**WIDE), None,
                      device="cpu", **ENGINE, **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw, want", [
    ({}, ("paged", "ragged")),
    (dict(decode_mode="per_row"), ("ring", "per_row")),
    (dict(kv_mode="ring"), ("ring", "ragged")),
])
def test_mode_resolution_matches_the_reference(kw, want):
    jcfg, raw = _raw("qwen1.5-0.5b", 1)
    jeng = JServingEngine(jcfg, raw, **ENGINE, **kw)
    teng = ServingEngine(smoke_config("qwen1.5-0.5b").scaled(**WIDE), None,
                         device="cpu", **ENGINE, **kw)
    assert (jeng.kv_mode, jeng.decode_mode) == want
    assert (teng.kv_mode, teng.decode_mode) == want
    assert teng.prefix_sharing == jeng.prefix_sharing
    assert teng.kv_cache_bytes() > 0


def test_unknown_mode_names_raise():
    cfg = smoke_config("qwen1.5-0.5b").scaled(**WIDE)
    for kw in (dict(kv_mode="pool"), dict(decode_mode="rows"),
               dict(paged_attn="dense")):
        with pytest.raises(ValueError):
            ServingEngine(cfg, None, device="cpu", **ENGINE, **kw)


def test_lockstep_ring_steps_match_the_reference():
    """The reference's lockstep ring steps (``make_prefill_step``: whole
    prompts into a fresh ring from column 0; ``make_serve_step``: decode
    at one position for every row) against the port's: the greedy ids
    are equal, and the ring's written K/V agree within bf16 rounding
    (1e-2 of their scale)."""
    import jax.numpy as jnp

    from repro.configs.base import RunConfig, ShapeConfig
    from repro.launch import steps as j_steps
    from repro.models.model import init_cache as j_init_cache
    from repro_torch.configs.base import RunConfig as TRunConfig
    from repro_torch.configs.base import ShapeConfig as TShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.model import init_cache

    jcfg, raw = _raw("qwen1.5-0.5b", 1)
    cfg = smoke_config("qwen1.5-0.5b").scaled(**WIDE)
    params = params_from_numpy(jax.tree.map(np.asarray, raw), "cpu")
    run = RunConfig(arch=jcfg, shape=ShapeConfig("s", 32, 2, "decode"))
    trun = TRunConfig(arch=cfg, shape=TShapeConfig("s", 32, 2, "decode"))
    toks = np.random.default_rng(3).integers(0, 256, size=(2, 9))
    jcache = j_init_cache(jcfg, 2, 32)
    cache = init_cache(cfg, 2, 32, device="cpu")
    jtok, jcache = j_steps.make_prefill_step(jcfg, run)(
        raw, {"tokens": jnp.asarray(toks, jnp.int32)}, jcache)
    tok, cache = steps.make_prefill_step(cfg, trun)(
        params, {"tokens": torch.from_numpy(toks).to(torch.int32)}, cache)
    assert tok.dtype == torch.int32
    assert tok.tolist() == np.asarray(jtok).tolist()
    for pos in (9, 10):
        jtok, jcache = j_steps.make_serve_step(jcfg, run)(
            raw, jtok[:, None], jcache, jnp.int32(pos))
        tok, cache = steps.make_serve_step(cfg, trun)(
            params, tok[:, None], cache, torch.tensor(pos, dtype=torch.int32))
        assert tok.tolist() == np.asarray(jtok).tolist()
    for jl, tl in zip(jcache["layers"], cache["layers"]):
        np.testing.assert_array_equal(tl["pos"].numpy(), np.asarray(jl["pos"]))
        want = np.asarray(jl["k"], np.float32)
        np.testing.assert_allclose(tl["k"].float().numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())
