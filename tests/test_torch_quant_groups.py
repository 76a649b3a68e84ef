"""Port parity: the rest of QuantConfig and the stacked layer layout.

Group scales (``group_size``): the same f32 weights (numpy, seeded) pack
to bit-identical words and equal scales in both packages, and dequantize
allclose (1e-6 relative: the same f32 products, rounded once to the
output dtype). A group-scaled linear runs the reference's
dequantize-then-matmul route (allclose at bf16 rounding, 1e-2 of the
output scale), and ``ops.samd_matmul`` refuses one as the reference's
kernel does. ``quantize_embeddings`` packs an untied LM head bit for bit;
``convert`` carries ``group_size``, ``act_bits`` and
``quantize_embeddings`` across. The reference's stacked scan-over-layers
tree gives the unrolled tree's logits through the port (1e-2 of the
largest logit, the model tolerance of ``test_torch_model``); a packed
leaf of a stacked tree is served by neither package, and both raise
ValueError.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models.model import build_template as j_build_template  # noqa
from repro.models.model import forward as j_forward  # noqa: E402
from repro.models.quantize import quantize_params as j_quantize  # noqa
from repro.models.spec import init_from_spec as j_init  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.quant import packing as j_packing  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.layers import QuantizedTensor  # noqa: E402
from repro_torch.models.layers import apply_linear, materialize  # noqa
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.models.model import forward, unstack_blocks  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.models.quantize import quantized_spec_tree  # noqa: E402
from repro_torch.quant import packing  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.quant.quantizer import quantize_symmetric  # noqa: E402

WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)
LOGIT_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(a):
    return np.asarray(a).view(np.int32)


def _weight(k, n, seed):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 0.05


# -- group scales ------------------------------------------------------------
@pytest.mark.parametrize("spacer", ["temporary", "permanent"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("group", [32, 64])
def test_group_scales_pack_bit_identical(group, bits, spacer):
    w = _weight(256, 48, seed=bits * group)
    jcfg = JQuantConfig(bits=bits, spacer=spacer, group_size=group)
    cfg = QuantConfig(bits=bits, spacer=spacer, group_size=group)
    jp, js = j_packing.pack_weights(jnp.asarray(w), jcfg)
    tp, ts = packing.pack_weights(torch.from_numpy(w), cfg)
    assert tuple(ts.shape) == (256 // group, 48) == tuple(js.shape)
    np.testing.assert_array_equal(tp.numpy(), _words(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = j_packing.dequant_weights(jp, js, 256, jcfg, dtype=jnp.float32)
    td = packing.dequant_weights(tp, ts, 256, cfg, dtype=torch.float32)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=0)


def test_group_scales_pack_in_column_pieces():
    """Columns pack ``_PACK_COLUMNS`` at a time: the pieces join to the
    reference's words and scales."""
    w = _weight(128, 3 * packing._PACK_COLUMNS // 2, seed=3)
    for g in (None, 32):
        jp, js = j_packing.pack_weights(jnp.asarray(w), JQuantConfig(
            bits=4, group_size=g))
        tp, ts = packing.pack_weights(torch.from_numpy(w), QuantConfig(
            bits=4, group_size=g))
        np.testing.assert_array_equal(tp.numpy(), _words(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_symmetric_refuses_a_group_that_does_not_divide():
    w = torch.from_numpy(_weight(96, 4, seed=1))
    with pytest.raises(ValueError, match="group_size"):
        quantize_symmetric(w, 4, axis=0, group_size=64)
    with pytest.raises(ValueError, match="group_size"):
        from repro.quant.quantizer import quantize_symmetric as jq
        jq(jnp.asarray(w.numpy()), 4, axis=0, group_size=64)


def test_grouped_linear_runs_the_dequantize_route():
    w = _weight(256, 40, seed=5)
    x = np.random.default_rng(6).standard_normal((3, 256)).astype(
        np.float32)
    jcfg, cfg = JQuantConfig(bits=4, group_size=64), QuantConfig(
        bits=4, group_size=64)
    jp, js = j_packing.pack_weights(jnp.asarray(w), jcfg)
    want = np.asarray(j_packing.qmatmul(
        jnp.asarray(x, jnp.bfloat16), jp, js, 256, jcfg), np.float32)
    tp, ts = packing.pack_weights(torch.from_numpy(w), cfg)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = packing.qmatmul(xt, tp, ts, 256, cfg).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())
    with pytest.raises(NotImplementedError):
        ops.samd_matmul(xt, tp, ts, 256, cfg)
    with pytest.raises(NotImplementedError):
        from repro.kernels import ops as j_ops
        j_ops.samd_matmul(jnp.asarray(x, jnp.bfloat16), jp, js, 256, jcfg)


def test_materialize_gives_the_reference_dense_weight():
    """A 3D packed weight (the branch ``apply_linear`` materializes)."""
    w = _weight(64 * 6, 80, seed=9).reshape(6, 64, 80)
    for g in (None, 16):
        jcfg = JQuantConfig(bits=4, group_size=g)
        cfg = QuantConfig(bits=4, group_size=g)
        w2 = np.moveaxis(w, 1, 0).reshape(64, -1)
        jp, js = j_packing.pack_weights(jnp.asarray(w2), jcfg)
        from repro.models.layers import QuantizedTensor as JQT
        from repro.models.layers import materialize as j_materialize
        jd = j_materialize(JQT(jp, js, w.shape, 1, jcfg), jnp.float32)
        qt = QuantizedTensor(torch.from_numpy(_words(jp).copy()),
                             torch.from_numpy(np.asarray(js).copy()),
                             w.shape, 1, cfg)
        td = materialize(qt, torch.float32)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=0)
        x = torch.randn(2, 64, dtype=torch.float32)
        np.testing.assert_array_equal(apply_linear(qt, x).numpy(),
                                      torch.matmul(x, td).numpy())


# -- quantized LM head ------------------------------------------------------
def _tree_pair(arch, seed=0, stacked=False):
    jcfg = j_smoke_config(arch).scaled(**WIDE)
    jt = j_build_template(jcfg, stacked=stacked)
    raw = j_init(jt, jax.random.PRNGKey(seed))
    return jcfg, jt, raw


@pytest.mark.parametrize("group", [None, 64])
def test_quantize_embeddings_packs_the_lm_head_bit_identical(group):
    jcfg, jt, raw = _tree_pair("qwen3-14b")
    cfg = smoke_config("qwen3-14b").scaled(**WIDE)
    for qe in (False, True):
        jq = JQuantConfig(bits=4, quantize_embeddings=qe, group_size=group)
        tq = QuantConfig(bits=4, quantize_embeddings=qe, group_size=group)
        jp = j_quantize(raw, jt, jq)
        tp = quantize_params(
            convert.params_from_numpy(jax.tree.map(np.asarray, raw), "cpu"),
            build_template(cfg), tq)
        head = tp["lm_head"]
        assert isinstance(head, QuantizedTensor) == qe
        assert hasattr(jp["lm_head"], "packed") == qe
        if qe:
            np.testing.assert_array_equal(head.packed.numpy(),
                                          _words(jp["lm_head"].packed))
            np.testing.assert_array_equal(head.scale.numpy(),
                                          np.asarray(jp["lm_head"].scale))
        assert not isinstance(tp["embed"], QuantizedTensor)
        shapes = quantized_spec_tree(build_template(cfg), tq)
        if qe:
            assert tuple(shapes["lm_head"].packed.shape) == tuple(
                head.packed.shape)
            assert tuple(shapes["lm_head"].scale.shape) == tuple(
                head.scale.shape)


# -- convert -----------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(bits=4, group_size=32),
    dict(bits=8, act_bits=8),
    dict(bits=2, quantize_embeddings=True, spacer="permanent"),
    dict(bits=4, backend="pallas", kv_bits=8, group_size=128, act_bits=4),
])
def test_convert_carries_every_quant_field(kw):
    jq = JQuantConfig(**kw)
    tq = convert.quant_config(jq)
    for field in ("bits", "enabled", "spacer", "group_size",
                  "quantize_embeddings", "act_bits", "kv_bits"):
        assert getattr(tq, field) == getattr(jq, field), field


def test_convert_carries_a_grouped_packed_tree():
    jcfg, jt, raw = _tree_pair("qwen1.5-0.5b")
    jp = j_quantize(raw, jt, JQuantConfig(bits=4, group_size=64))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    wq = tp["blocks"][0]["attn"]["wq"]
    assert wq.cfg.group_size == 64 and tuple(wq.scale.shape) == (4, 256)
    toks = np.random.default_rng(2).integers(0, 256, size=(2, 9))
    want = np.asarray(j_forward(jp, jnp.asarray(toks), jcfg)[0], np.float32)
    got = forward(tp, torch.from_numpy(toks), smoke_config(
        "qwen1.5-0.5b").scaled(**WIDE)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


# -- the stacked layout -------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-14b"])
def test_stacked_tree_gives_the_unrolled_logits(arch):
    jcfg, jt, raw = _tree_pair(arch, seed=4, stacked=True)
    cfg = smoke_config(arch).scaled(**WIDE)
    toks = np.random.default_rng(1).integers(0, 256, size=(2, 11))
    want = np.asarray(j_forward(raw, jnp.asarray(toks), jcfg)[0],
                      np.float32)
    tree = convert.params_from_numpy(jax.tree.map(np.asarray, raw), "cpu")
    assert isinstance(tree["blocks"], list) and len(tree["blocks"]) == 2
    got = forward(tree, torch.from_numpy(toks), cfg).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    # the stacked tree itself, as build_template(stacked=True) lays it
    # out: unstack_blocks slices it (views) and gives the same logits
    stacked = jax.tree.map(lambda *xs: torch.stack(xs), *tree["blocks"])
    spec = build_template(cfg, stacked=True)["blocks"]["attn"]["wq"]
    assert tuple(stacked["attn"]["wq"].shape) == spec.shape
    again = forward(dict(tree, blocks=unstack_blocks(stacked, 2)),
                    torch.from_numpy(toks), cfg).float().numpy()
    np.testing.assert_array_equal(again, got)


def test_stacked_packed_leaf_is_refused_by_both():
    """``quantize_params`` packs a stacked leaf [L, K, N] as [K/vpw, L*N]
    (layer-major columns). The reference's scan slices axis 0 of its
    words and scale, whose lengths are not L, and raises ValueError; the
    port raises ValueError too, in ``convert`` and in
    ``unstack_blocks``."""
    jcfg, jt, raw = _tree_pair("qwen1.5-0.5b", stacked=True)
    jq = JQuantConfig(bits=4)
    jp = j_quantize(raw, jt, jq)
    wq = jp["blocks"]["attn"]["wq"]
    assert tuple(wq.packed.shape) == (32, 2 * 256)
    toks = jnp.zeros((1, 4), jnp.int32)
    with pytest.raises(ValueError):
        j_forward(jp, toks, jcfg)
    with pytest.raises(ValueError, match="leading"):
        convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cfg = smoke_config("qwen1.5-0.5b").scaled(**WIDE)
    flat = convert.params_from_numpy(jax.tree.map(np.asarray, raw), "cpu")
    stacked = quantize_params(
        dict(flat, blocks=_stack_raw(raw)), build_template(cfg, stacked=True),
        QuantConfig(bits=4))
    np.testing.assert_array_equal(
        stacked["blocks"]["attn"]["wq"].packed.numpy(), _words(wq.packed))
    with pytest.raises(ValueError, match="leading"):
        unstack_blocks(stacked["blocks"], 2)


def _stack_raw(raw):
    """The reference's stacked ``blocks`` as torch tensors (no unstack)."""
    return jax.tree.map(
        lambda a: convert.tensor_from_numpy(np.asarray(a), "cpu"),
        raw["blocks"])
