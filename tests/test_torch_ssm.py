"""Port parity: the recurrent mixers (Mamba2's SSD, RWKV6's WKV6).

The same seeded numpy inputs go through ``repro.models.ssm`` and
``repro_torch.models.ssm``.

Tolerances: the chunk scans run in f32 in both packages and against the
exact sequential recurrence (the reference test's own check), atol
2e-4 as in ``tests/test_ssm_chunked.py``; port against reference, where
only the einsums' summation order differs, rtol = atol = 1e-5 of the
largest value. The blocks take bf16 activations and bf16 weights, as
the model runs them, so their outputs agree to a few bf16 rounding
steps: rtol = atol = 1e-2 of the largest value (as
``test_torch_model``'s logits); their f32 states likewise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import init_from_spec as j_init  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

BLOCK_TOL = 1e-2
SCAN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # JAX's CPU thread pool and torch's OpenMP threads oversubscribe the
    # cores when both run in one process; these shapes are tiny anyway
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _both(fn_j, fn_t, *arrays, **kw):
    """Run the reference and the port on the same numpy arrays."""
    want = fn_j(*map(jnp.asarray, arrays), **kw)
    got = fn_t(*map(torch.from_numpy, arrays), **kw)
    return got, want


def _ssd_inputs(seed, b, t, h, p, n, loga_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, p)).astype(np.float32),
            rng.normal(size=(b, t, n)).astype(np.float32),
            rng.normal(size=(b, t, n)).astype(np.float32),
            (-np.abs(rng.normal(size=(b, t, h))) * loga_scale).astype(
                np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


def _wkv_inputs(seed, b, t, h, k, v, logw=None):
    rng = np.random.default_rng(seed)
    lw = (-np.abs(rng.normal(size=(b, t, h, k))) if logw is None
          else np.full((b, t, h, k), logw))
    return (rng.normal(size=(b, t, h, k)).astype(np.float32),
            rng.normal(size=(b, t, h, k)).astype(np.float32),
            rng.normal(size=(b, t, h, v)).astype(np.float32),
            lw.astype(np.float32),
            rng.normal(size=(h, k)).astype(np.float32),
            rng.normal(size=(b, h, k, v)).astype(np.float32))


def _ssd_sequential(xdt, bm, cm, loga, s0):
    s = s0.copy()
    ys = np.zeros(xdt.shape, np.float32)
    for t in range(xdt.shape[1]):
        s = s * np.exp(loga[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", xdt[:, t], bm[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", s, cm[:, t])
    return ys, s


def _wkv_sequential(r, k, v, logw, u, s0):
    s = s0.copy()
    ys = np.zeros(v.shape, np.float32)
    w = np.exp(logw)
    for t in range(r.shape[1]):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t],
                             s + u[None, :, :, None] * kv)
        s = s * w[:, t][..., None] + kv
    return ys, s


@pytest.mark.parametrize("t", [32, 5 * 32, 160])
def test_ssd_chunked_matches_jax(t):
    args = _ssd_inputs(t, 2, t, 3, 4, 5)
    (ys, s1), (jys, js1) = _both(JS.ssd_chunked, S.ssd_chunked, *args,
                                 chunk=32)
    _close(ys, jys, SCAN_TOL)
    _close(s1, js1, SCAN_TOL)
    ys_ref, s_ref = _ssd_sequential(*args)
    np.testing.assert_allclose(ys.numpy(), ys_ref, atol=2e-4)
    np.testing.assert_allclose(s1.numpy(), s_ref, atol=2e-4)


@pytest.mark.parametrize("t", [32, 70, 128])
def test_wkv6_chunked_matches_jax(t):
    args = _wkv_inputs(t, 2, t, 3, 4, 4)
    (ys, s1), (jys, js1) = _both(JS.wkv6_chunked, S.wkv6_chunked, *args,
                                 chunk=32)
    _close(ys, jys, SCAN_TOL)
    _close(s1, js1, SCAN_TOL)
    ys_ref, s_ref = _wkv_sequential(*args)
    np.testing.assert_allclose(ys.numpy(), ys_ref, atol=2e-4)
    np.testing.assert_allclose(s1.numpy(), s_ref, atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), chunk=st.sampled_from([8, 16, 32]))
def test_chunk_size_invariance(seed, chunk):
    """Neither scan's result depends on the chunk size (zero initial
    state, as the reference's property test)."""
    xdt, bm, cm, loga, s0 = _ssd_inputs(seed % 1000, 1, 64, 2, 3, 4)
    args = tuple(map(torch.from_numpy, (xdt, bm, cm, loga, 0 * s0)))
    ys_a, s_a = S.ssd_chunked(*args, chunk=chunk)
    ys_b, s_b = S.ssd_chunked(*args, chunk=64)
    np.testing.assert_allclose(ys_a.numpy(), ys_b.numpy(), atol=2e-4)
    np.testing.assert_allclose(s_a.numpy(), s_b.numpy(), atol=2e-4)
    r, k, v, logw, u, s0 = map(torch.from_numpy,
                               _wkv_inputs(seed % 1000, 1, 64, 2, 4, 4))
    ys_a, s_a = S.wkv6_chunked(r, k, v, logw, u, 0 * s0, chunk=chunk)
    ys_b, s_b = S.wkv6_chunked(r, k, v, logw, u, 0 * s0, chunk=64)
    np.testing.assert_allclose(ys_a.numpy(), ys_b.numpy(), atol=2e-4)
    np.testing.assert_allclose(s_a.numpy(), s_b.numpy(), atol=2e-4)


@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_decay_extremes_give_no_nan(scan):
    """Near-total decay: every exponent of the chunked forms is <= 0 and
    the masked ones are exp(-inf), so outputs stay finite and the port
    still matches the reference (``tests/test_ssm_chunked.py``'s
    check, for both scans)."""
    if scan == "wkv6":
        args = _wkv_inputs(0, 1, 64, 1, 4, 4, logw=-40.0)
        got, want = _both(JS.wkv6_chunked, S.wkv6_chunked, *args, chunk=16)
    else:
        args = _ssd_inputs(0, 1, 64, 2, 3, 4, loga_scale=1e4)
        got, want = _both(JS.ssd_chunked, S.ssd_chunked, *args, chunk=16)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, SCAN_TOL)


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d_matches_jax(with_prev):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    prev = rng.normal(size=(2, 6, 3)).astype(np.float32)
    want = JS._causal_conv1d(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(prev, jnp.bfloat16)
                             if with_prev else None)
    got = S._causal_conv1d(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w).bfloat16(),
                           torch.from_numpy(prev).bfloat16()
                           if with_prev else None)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(wt, np.float32))


def _block(arch, name, seed=0):
    """One layer's parameters of ``arch``'s smoke config in both
    packages: the reference's init plus seeded N(0, 0.1) noise on every
    leaf, so the zero-initialised ones (token-shift mixes, the bonus,
    dt_bias) take part too."""
    jcfg = j_smoke_config(arch)
    raw = j_init(j_build_template(jcfg), jax.random.PRNGKey(seed))
    p = raw["blocks"][0]
    for key in name:
        p = p[key]
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: (a.astype(jnp.float32) + 0.1 * rng.normal(
            size=a.shape)).astype(a.dtype), p)
    return jcfg, smoke_config(arch), p, params_from_numpy(
        jax.tree.map(np.asarray, p), device="cpu")


def _state(seed, shapes):
    """A seeded random state of the given leaf shapes (numpy f32)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=shape) * 0.5).astype(np.float32)
            for k, shape in shapes.items()}


def _compare_block(fn_j, fn_t, jcfg, cfg, jp, tp, x, state):
    """Run a block in both packages on bf16 x and the numpy ``state``
    (cast to each state leaf's dtype), compare output and new state."""
    jst = tst = None
    if state is not None:
        jst = {k: jnp.asarray(v, jnp.bfloat16 if k == "conv" else
                              jnp.float32) for k, v in state.items()}
        tst = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "conv"
                                         else torch.float32)
               for k, v in state.items()}
    jy, jnew = fn_j(jp, jnp.asarray(x, jnp.bfloat16), jcfg, jst)
    ty, tnew = fn_t(tp, torch.from_numpy(x).bfloat16(), cfg, tst)
    _close(ty.float().numpy(), jy, BLOCK_TOL)
    assert tnew.keys() == jnew.keys()
    for k in jnew:
        assert tnew[k].dtype == {"conv": torch.bfloat16}.get(k, torch.float32)
        _close(tnew[k].float().numpy(), np.asarray(jnew[k], np.float32),
               BLOCK_TOL)


@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("t", [1, 20, 130])
def test_mamba2_block_matches_jax(t, stateful):
    jcfg, cfg, jp, tp = _block("zamba2-7b", ("m",))
    _, n_heads, conv_dim = S.mamba2_dims(cfg)
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)).astype(
        np.float32)
    state = _state(t, {
        "conv": (2, conv_dim, cfg.ssm_conv - 1),
        "ssd": (2, n_heads, cfg.ssm_head_dim, cfg.ssm_state)}
    ) if stateful or t == 1 else None
    _compare_block(JS.mamba2_block, S.mamba2_block, jcfg, cfg, jp, tp, x,
                   state)


@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("t", [1, 40])
def test_rwkv6_time_mix_matches_jax(t, stateful):
    jcfg, cfg, jp, tp = _block("rwkv6-3b", ("tm",))
    h, hd = S.rwkv6_dims(cfg)
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)).astype(
        np.float32)
    state = _state(t, {
        "wkv": (2, h, hd, hd), "shift_tm": (2, cfg.d_model)}
    ) if stateful or t == 1 else None
    _compare_block(JS.rwkv6_time_mix, S.rwkv6_time_mix, jcfg, cfg, jp, tp,
                   x, state)


@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("t", [1, 40])
def test_rwkv6_channel_mix_matches_jax(t, stateful):
    jcfg, cfg, jp, tp = _block("rwkv6-3b", ("cm",))
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)).astype(
        np.float32)
    state = _state(t, {"shift_cm": (2, cfg.d_model)}
                   ) if stateful or t == 1 else None
    _compare_block(JS.rwkv6_channel_mix, S.rwkv6_channel_mix, jcfg, cfg,
                   jp, tp, x, state)


def test_dims_equal_the_reference():
    from repro.configs import get_arch as j_get_arch
    from repro_torch.configs.archs import get_arch

    for arch in ("zamba2-7b", "rwkv6-3b"):
        for smoke in (False, True):
            jc = j_smoke_config(arch) if smoke else j_get_arch(arch)
            tc = smoke_config(arch) if smoke else get_arch(arch)
            assert S.mamba2_dims(tc) == JS.mamba2_dims(jc)
            assert S.rwkv6_dims(tc) == JS.rwkv6_dims(jc)
