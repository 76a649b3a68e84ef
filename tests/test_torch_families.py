"""Port parity: the reference's ten architectures through ``forward``.

Configs, templates and the forward of every family (dense with swiglu /
sq_relu / gelu, moe, rwkv6, hybrid_mamba2, and the vision arch's prefix
embeddings) against ``repro.models.forward`` on the same weights (the
reference's, carried over by ``models.convert.params_from_numpy``), bf16
and SAMD-packed 4-bit (the kernel route; at a width where every linear
is packed); the caches of the recurrent families across a prefill and two
decode ticks; and the paged cache's refusal of recurrent families.

Tolerances: the forward runs in bf16 in both packages, so logits agree to
a few bf16 rounding steps: rtol = atol = 1e-2 of the largest logit, as
``test_torch_model`` holds the dense forward. States carried in f32 are
held to the same relative tolerance. The port's prefill-then-decode
against its own full forward uses the reference test's tolerances
(``tests/test_models.py``: 1e-3 of the largest logit, 0.15 for MoE,
whose capacity routing differs between group sizes).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_from_spec as j_init  # noqa: E402
from repro.models import init_paged_cache as j_init_paged_cache  # noqa: E402
from repro.models import quantize_params as j_quantize_params  # noqa: E402
from repro.models.spec import TensorSpec as JTensorSpec  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro_torch.configs.archs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import QuantizedTensor  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402
from repro_torch.models.model import init_paged_cache  # noqa: E402
from repro_torch.models.spec import TensorSpec  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

LOGIT_TOL = 1e-2
NAMES = sorted(J_ARCHS)
# wide enough that every linear (>= 2^16 values) is SAMD-packed
WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=LOGIT_TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _models(name, bits=None, seed=0):
    over = WIDE if bits else {}
    jcfg = j_smoke_config(name).scaled(**over)
    cfg = smoke_config(name).scaled(**over)
    jt = j_build_template(jcfg)
    params = j_init(jt, jax.random.PRNGKey(seed))
    if bits:
        params = j_quantize_params(params, jt,
                                   JQuantConfig(bits=bits, backend="pallas"))
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def _spec_fields(tree):
    """Each spec's (shape, axes, dtype name, init, init_scale,
    quant_axis), in the template's nesting."""
    def one(sp):
        dtype = (np.dtype(sp.dtype).name if isinstance(sp, JTensorSpec)
                 else str(sp.dtype).removeprefix("torch."))
        return (tuple(sp.shape), tuple(sp.axes), dtype, sp.init,
                sp.init_scale, sp.quant_axis)

    if isinstance(tree, (TensorSpec, JTensorSpec)):
        return one(tree)
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return [_spec_fields(v) for v in tree]


@pytest.mark.parametrize("name", NAMES)
def test_configs_and_templates_equal_the_reference(name):
    """All ten archs, full width and smoke, field for field; the
    templates' shapes, axes, dtypes, init kinds and quant axes spec for
    spec (``quantize_params`` packs by them), both layouts."""
    assert sorted(ARCHS) == NAMES
    for jc, tc in ((j_get_arch(name), get_arch(name)),
                   (j_smoke_config(name), smoke_config(name))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.uses_attention == jc.uses_attention
    jc, tc = j_smoke_config(name), smoke_config(name)
    for stacked in (False, True):
        assert _spec_fields(build_template(tc, stacked=stacked)) == \
            _spec_fields(j_build_template(jc, stacked=stacked))
    # and at full width, unrolled (specs only, nothing is allocated)
    assert _spec_fields(build_template(get_arch(name))) == _spec_fields(
        j_build_template(j_get_arch(name), stacked=False))


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, bits):
    """Logits of a 20-token batch of two rows, no cache; llava with four
    prefix embeddings before the tokens; the MoE aux loss summed over
    the layers as the reference sums it."""
    jcfg, cfg, jp, tp = _models(name, bits)
    if bits:
        assert any(isinstance(w, QuantizedTensor)
                   for w in _leaves(tp["blocks"][0]))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 20)).astype(np.int32)
    pe = None
    if cfg.n_prefix_embeds:
        pe = rng.normal(size=(2, cfg.n_prefix_embeds, cfg.d_model))
        pe = pe.astype(np.float32)
    jl, _, jaux = j_forward(jp, jnp.asarray(toks), jcfg,
                            prefix_embeds=None if pe is None
                            else jnp.asarray(pe))
    tl, taux = forward(tp, torch.from_numpy(toks).long(), cfg,
                       prefix_embeds=None if pe is None
                       else torch.from_numpy(pe), return_aux=True)
    assert tl.shape == (2, 20 + cfg.n_prefix_embeds, cfg.vocab)
    _close(tl.float().numpy(), jl)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
    assert (float(taux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_full_forward(name):
    """The port's prefill of T-1 tokens into ``init_cache`` then one
    decode token equals its full forward's last logits (the reference's
    ``test_decode_consistency``, its tolerances)."""
    cfg = smoke_config(name)
    tp = _models(name)[3]
    b, t = 2, 33
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(b, t))).long()
    full = forward(tp, toks, cfg)
    cache = init_cache(cfg, b, t, device="cpu")
    forward(tp, toks[:, :t - 1], cfg, cache=cache, cache_index=0)
    dec = forward(tp, toks[:, t - 1:], cfg,
                  positions=torch.full((b, 1), t - 1), cache=cache,
                  cache_index=t - 1)
    a, d = full[:, -1].float(), dec[:, 0].float()
    rel = float((a - d).abs().max() / (a.abs().max() + 1e-9))
    assert rel < (0.15 if cfg.family == "moe" else 1e-3), rel


def _leaves(tree):
    """Leaves of nested dicts (in sorted key order, as jax.tree.leaves)
    and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-7b"])
def test_recurrent_cache_over_two_decode_ticks_matches_jax(name, bits):
    """A ragged prefill (each row its own length, written through
    per-row prefills as the engine admits) then two decode ticks at
    per-row positions (``cache_index`` a [B] vector, which the hybrid's
    shared attention writes its ring at): logits after each tick and
    every cache leaf after the second agree with the reference, so the
    port writes its state in place and loses none of it."""
    jcfg, cfg, jp, tp = _models(name, bits)
    rng = np.random.default_rng(11)
    b, max_len, lens = 3, 48, [21, 9, 14]
    jc = j_init_cache(jcfg, b, max_len)
    tc = init_cache(cfg, b, max_len, device="cpu")
    for row, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab, size=(1, n)).astype(np.int32)
        jrow = jax.tree.map(lambda c: c[row:row + 1], jc)
        jl, jrow, _ = j_forward(jp, jnp.asarray(toks), jcfg, cache=jrow,
                                cache_index=0)
        jc = jax.tree.map(lambda c, r: c.at[row:row + 1].set(r), jc, jrow)
        trow = jax.tree.map(lambda c: c[row:row + 1], tc)
        tl = forward(tp, torch.from_numpy(toks).long(), cfg, cache=trow,
                     cache_index=0)
        _close(tl.float().numpy(), jl)
    pos = np.array(lens)
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
        jl, jc, _ = j_forward(jp, jnp.asarray(toks), jcfg,
                              positions=jnp.asarray(pos[:, None]),
                              cache=jc, cache_index=jnp.asarray(pos))
        tl = forward(tp, torch.from_numpy(toks).long(), cfg,
                     positions=torch.from_numpy(pos[:, None]).long(),
                     cache=tc, cache_index=torch.from_numpy(pos).long())
        _close(tl.float().numpy(), jl)
        pos = pos + 1
    jleaves, tleaves = _leaves(jc), _leaves(tc)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t.float().numpy(), np.asarray(j, np.float32))


def test_recurrent_caches_have_the_reference_layout():
    for name in ("rwkv6-3b", "zamba2-7b", "olmoe-1b-7b"):
        jc = j_init_cache(j_smoke_config(name), 2, 16)
        tc = init_cache(smoke_config(name), 2, 16, device="cpu")
        shapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)), jc)
        got = jax.tree.map(lambda x: (tuple(x.shape),
                                      str(x.dtype).split(".")[-1]), tc)
        assert got == shapes, name
    hybrid = init_cache(smoke_config("zamba2-7b"), 2, 16, device="cpu")
    assert [("attn_kv" in layer) for layer in hybrid["layers"]] == [
        False, True, False, True]


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-7b"])
def test_paged_cache_refuses_recurrent_families(name):
    """``init_paged_cache`` and ``kv_mode="paged"`` refuse a recurrent
    family with the reference's text; ``"auto"`` resolves to the ring."""
    jcfg, cfg = j_smoke_config(name), smoke_config(name)
    with pytest.raises(ValueError) as want:
        j_init_paged_cache(jcfg, 8, 8)
    with pytest.raises(ValueError) as got:
        init_paged_cache(cfg, 8, 8, device="cpu")
    assert str(got.value) == str(want.value)
    from repro.serving import ServingEngine as JServingEngine

    with pytest.raises(ValueError) as want:
        JServingEngine(jcfg, None, kv_mode="paged", max_batch=2,
                       max_len=16)
    with pytest.raises(ValueError) as got:
        ServingEngine(cfg, None, kv_mode="paged", max_batch=2, max_len=16,
                      device="cpu")
    assert str(got.value) == str(want.value)
    eng = ServingEngine(cfg, None, max_batch=2, max_len=16, device="cpu")
    assert eng.kv_mode == "ring" and not eng._batched_prefill
    assert eng.kv_cache_bytes() == sum(
        x.nbytes for x in jax.tree.leaves(j_init_cache(jcfg, 2, 16)))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_paged_prefill_of_ragged_rows_matches_jax(capacity_factor):
    """A bucket-padded prefill of rows of different lengths through a
    page table, then a fused decode token: the padding tokens route and
    take capacity exactly as in the reference (groups are per row over
    the bucket), also with a capacity below demand."""
    over = dict(capacity_factor=capacity_factor, moe_group_tokens=16)
    jcfg = j_smoke_config("olmoe-1b-7b").scaled(**WIDE, **over)
    cfg = smoke_config("olmoe-1b-7b").scaled(**WIDE, **over)
    jt = j_build_template(jcfg)
    jp = j_quantize_params(j_init(jt, jax.random.PRNGKey(2)), jt,
                           JQuantConfig(bits=4, backend="pallas"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    ps, n_pages = 8, 12
    pt = np.array([[3, 7, 1, 9], [5, 0, 2, -1]], np.int32)
    toks = rng.integers(0, 256, size=(2, 32)).astype(np.int32)
    lens = np.array([29, 11])
    t_idx = np.arange(32)[None]
    pos = np.where(t_idx < lens[:, None], t_idx, -1).astype(np.int32)
    jc = j_init_paged_cache(jcfg, n_pages, ps)
    tc = init_paged_cache(cfg, n_pages, ps, device="cpu")
    jl, jc, _ = j_forward(jp, jnp.asarray(toks), jcfg,
                          positions=jnp.asarray(pos), cache=jc,
                          page_table=jnp.asarray(pt), page_size=ps)
    tl = forward(tp, torch.from_numpy(toks).long(), cfg,
                 positions=torch.from_numpy(pos).long(), cache=tc,
                 page_table=torch.from_numpy(pt), page_size=ps)
    valid = pos >= 0
    _close(tl.float().numpy()[valid], np.asarray(jl, np.float32)[valid])
    dec = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
    dpos = lens[:, None].astype(np.int32)
    jd, _, _ = j_forward(jp, jnp.asarray(dec), jcfg,
                         positions=jnp.asarray(dpos), cache=jc,
                         page_table=jnp.asarray(pt), page_size=ps,
                         paged_attn="fused")
    td = forward(tp, torch.from_numpy(dec).long(), cfg,
                 positions=torch.from_numpy(dpos).long(), cache=tc,
                 page_table=torch.from_numpy(pt), page_size=ps,
                 paged_attn="fused")
    _close(td.float().numpy(), jd)


def test_stacked_layout_converts_for_every_family():
    """The reference's scan-over-layers layout (bf16) unstacks into the
    port's list of layers: the logits equal the reference's unrolled
    forward on the same layers (``repro.models.unstack_blocks``)."""
    from repro.models.model import unstack_blocks as j_unstack_blocks

    for name in ("olmoe-1b-7b", "rwkv6-3b", "zamba2-7b"):
        jcfg = j_smoke_config(name)
        raw = j_init(j_build_template(jcfg, stacked=True),
                     jax.random.PRNGKey(3))
        tp = params_from_numpy(jax.tree.map(np.asarray, raw), device="cpu")
        assert isinstance(tp["blocks"], list)
        assert len(tp["blocks"]) == jcfg.n_layers
        unrolled = dict(raw, blocks=j_unstack_blocks(raw["blocks"],
                                                     jcfg.n_layers))
        toks = np.random.default_rng(3).integers(0, 128, size=(1, 12))
        want, _, _ = j_forward(unrolled, jnp.asarray(toks, jnp.int32), jcfg)
        got = forward(tp, torch.from_numpy(toks).long(), smoke_config(name))
        _close(got.float().numpy(), want)
