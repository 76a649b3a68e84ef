"""Port parity: the MoE block, the sq_relu / gelu MLPs and the packing of
3D expert weights.

The same seeded weights and activations go through
``repro.models.layers.moe_block`` / ``mlp_block`` and the port's.

Tolerances: bf16 activations and weights, as the model runs them, so the
outputs agree to a few bf16 rounding steps: rtol = atol = 1e-2 of the
largest value (``test_torch_model``'s logit tolerance). The aux loss is
f32 arithmetic on the same probabilities: rtol 1e-5. The routing is
compared exactly (expert ids in slot order): an expert set may differ
only where the reference's own top-k / top-(k+1) router-probability
margin is under 1e-5 (a near-tie that f32 summation order can flip); the
margin is reported. Packing is bit-identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import init_from_spec as j_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import quantize_params as j_quantize_params  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import QuantizedTensor  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402

TOL = 1e-2
AUX_RTOL = 1e-5
ROUTER_TIE = 1e-5
# experts wide enough to be SAMD-packed (E * D * F >= 2^16)
WIDE = dict(d_model=256, head_dim=64, vocab=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _moe(arch, bits=None, seed=0, **over):
    """(reference cfg, port cfg, reference moe params, port moe params)
    of layer 0 of ``arch``'s smoke config scaled by ``over``."""
    jcfg = j_smoke_config(arch).scaled(**over)
    cfg = smoke_config(arch).scaled(**over)
    jt = j_build_template(jcfg)
    raw = j_init(jt, jax.random.PRNGKey(seed))
    if bits:
        raw = j_quantize_params(raw, jt, JQuantConfig(bits=bits,
                                                      backend="pallas"))
    jp = raw["blocks"][0]["moe"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


def _routes(jcfg, cfg, jp, tp, x):
    """Each package's (probs, top-k expert ids) of the block's router."""
    e, k = cfg.n_experts, cfg.top_k
    jxn = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jp["ln"], jcfg.norm_eps)
    jprobs = jax.nn.softmax(jnp.einsum(
        "btd,de->bte", jxn.astype(jnp.float32),
        jp["router"].astype(jnp.float32)), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, k)
    txn = L.rms_norm(torch.from_numpy(x).bfloat16(), tp["ln"], cfg.norm_eps)
    tprobs = torch.softmax(torch.einsum(
        "btd,de->bte", txn.float(), tp["router"].float()), dim=-1)
    _, tidx = L.top_k_lower_first(tprobs, k)
    assert tidx.shape[-1] == k and jprobs.shape[-1] == e
    return np.asarray(jprobs), np.asarray(jidx), tidx.numpy()


def _check_routes(jprobs, jidx, tidx, k):
    """Expert ids equal, or a differing token's reference margin between
    its k-th and (k+1)-th probability under ROUTER_TIE; returns the
    margins of the differing tokens."""
    margins = []
    for pos in zip(*np.nonzero((jidx != tidx).any(-1))):
        srt = np.sort(jprobs[pos])[::-1]
        margin = float(srt[k - 1] - srt[k]) if k < len(srt) else 0.0
        assert margin < ROUTER_TIE, (pos, margin, jidx[pos], tidx[pos])
        margins.append(margin)
    return margins


def _run(jcfg, cfg, jp, tp, x, group_tokens):
    jout, jaux = JL.moe_block(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                              group_tokens=group_tokens)
    tout, taux = L.moe_block(tp, torch.from_numpy(x).bfloat16(), cfg,
                             group_tokens=group_tokens)
    _close(tout.float().numpy(), jout)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    return tout, taux


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_block_matches_jax(arch, bits):
    """olmoe's smoke config (top-4 of 8, swiglu experts) and arctic's
    (top-2 of 8 with the dense residual MLP), bf16 and 4-bit experts,
    two groups a row."""
    jcfg, cfg, jp, tp = _moe(arch, bits, **(WIDE if bits else {}))
    if bits:
        assert isinstance(tp["w_up"], QuantizedTensor)
        assert tp["w_up"].packed.shape[1] == cfg.n_experts * cfg.expert_d_ff
    assert ("dense" in tp) == (arch == "arctic-480b")
    x = np.random.default_rng(1).normal(size=(2, 32, cfg.d_model))
    x = x.astype(np.float32)
    _run(jcfg, cfg, jp, tp, x, group_tokens=16)
    probs, jidx, tidx = _routes(jcfg, cfg, jp, tp, x)
    _check_routes(probs, jidx, tidx, cfg.top_k)


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5])
def test_moe_capacity_below_demand_matches_jax(capacity_factor):
    """A capacity under the tokens routed to an expert drops tokens in
    the reference's order (slot 0's choices first, in token order)."""
    jcfg, cfg, jp, tp = _moe("olmoe-1b-7b", capacity_factor=capacity_factor)
    gt = 32
    cap = L.moe_capacity(gt, cfg.n_experts, cfg.top_k, capacity_factor)
    assert cap == JL.moe_capacity(gt, cfg.n_experts, cfg.top_k,
                                  capacity_factor)
    x = np.random.default_rng(2).normal(size=(2, 64, cfg.d_model))
    x = x.astype(np.float32)
    _, jidx, _ = _routes(jcfg, cfg, jp, tp, x)
    # some expert in some group gets more tokens than it can take
    demand = max(np.bincount(jidx[b, g:g + gt].ravel(),
                             minlength=cfg.n_experts).max()
                 for b in range(2) for g in (0, gt))
    assert demand > cap
    _run(jcfg, cfg, jp, tp, x, group_tokens=gt)


@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_moe_tied_router_matches_jax(tie):
    """Equal router probabilities: a zero router ties every expert, and
    duplicated router columns tie experts in pairs; ties go to the lower
    expert id in both packages, so routing and output agree."""
    jcfg, cfg, jp, tp = _moe("olmoe-1b-7b")
    router = np.array(jp["router"], np.float32)
    if tie == "all":
        router = 0 * router
    else:
        router[:, 1::2] = router[:, 0::2]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.default_rng(3).normal(size=(2, 16, cfg.d_model))
    x = x.astype(np.float32)
    _run(jcfg, cfg, jp, tp, x, group_tokens=16)
    probs, jidx, tidx = _routes(jcfg, cfg, jp, tp, x)
    np.testing.assert_array_equal(tidx, jidx)
    if tie == "all":
        assert (tidx == np.arange(cfg.top_k)).all()


def test_top_k_orders_ties_lower_index_first():
    rng = np.random.default_rng(4)
    probs = rng.integers(0, 4, size=(64, 16)).astype(np.float32)
    for k in (1, 3, 8, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = L.top_k_lower_first(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_expert_packing_is_bit_identical(arch):
    """``quantize_params`` packs 3D experts [E, D, F] along axis 1 into
    [ceil(D / vpw), E * F] words as the reference does, bit for bit."""
    jcfg = j_smoke_config(arch).scaled(**WIDE)
    cfg = smoke_config(arch).scaled(**WIDE)
    raw = j_init(j_build_template(jcfg), jax.random.PRNGKey(5))
    jq = j_quantize_params(raw, j_build_template(jcfg),
                           JQuantConfig(bits=4))
    tq = quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, raw), device="cpu"),
        build_template(cfg), QuantConfig(bits=4))
    for name in ("w_up", "w_down", "w_gate"):
        if name not in jq["blocks"][0]["moe"]:
            continue
        for layer in range(cfg.n_layers):
            want = jq["blocks"][layer]["moe"][name]
            got = tq["blocks"][layer]["moe"][name]
            assert got.orig_shape == want.orig_shape and got.axis == 1
            np.testing.assert_array_equal(
                got.packed.numpy(), np.asarray(want.packed).view(np.int32))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale))
            np.testing.assert_array_equal(
                L.materialize(got).float().numpy(),
                np.asarray(JL.materialize(want), np.float32))


@pytest.mark.parametrize("bits", [None, 4])
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "musicgen-medium"])
def test_mlp_activations_match_jax(arch, bits):
    """sq_relu (nemotron) and gelu (musicgen, jax.nn.gelu's tanh form),
    bf16 and 4-bit weights; neither has a gate projection."""
    over = dict(d_model=256, d_ff=512) if bits else {}
    jcfg = j_smoke_config(arch).scaled(**over)
    cfg = smoke_config(arch).scaled(**over)
    jt = j_build_template(jcfg)
    raw = j_init(jt, jax.random.PRNGKey(6))
    if bits:
        raw = j_quantize_params(raw, jt, JQuantConfig(bits=bits,
                                                      backend="pallas"))
    jp = raw["blocks"][0]["mlp"]
    assert "wg" not in jp
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(7).normal(size=(2, 9, cfg.d_model))
    x = x.astype(np.float32)
    want = JL.mlp_block(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got = L.mlp_block(tp, torch.from_numpy(x).bfloat16(), cfg)
    _close(got.float().numpy(), want)
