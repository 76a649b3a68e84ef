"""Port parity: the dense decoder forward over the paged KV pool.

The same weights (the reference's, SAMD-packed 4-bit with the kernel
route, carried over by ``models.convert.params_from_numpy``) and the same
tokens go through ``repro.models.forward`` and
``repro_torch.models.model.forward``: a bucket-padded prefill of two
ragged rows through a page table, then one decode token per row with
fused and with gather attention, each with bf16 and with packed int8 KV.

Tolerances: the forward runs in bf16 in both packages (the reference
casts the embedding to bf16), so logits agree to a few bf16 rounding
steps: atol = rtol = 1e-2 relative to the largest logit (2.5 steps of
2^-8; the largest difference seen is ~4e-4 of it). Where the point is
the algorithm (attention, norms, rope), inputs are f32 and rtol = atol =
1e-5. Pool writes are compared exactly.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import build_template as j_build_template  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_from_spec as j_init  # noqa: E402
from repro.models import init_paged_cache as j_init_paged_cache  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import quantize_params as j_quantize_params  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import QuantizedTensor  # noqa: E402
from repro_torch.models.model import copy_paged_page  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.models.model import init_paged_cache  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402

LOGIT_TOL = 1e-2
# wide enough that every linear (>= 2^16 values) is SAMD-packed
WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab=256)
# qwen1.5: G = 1 (MHA, qkv bias); qwen3: G = 4 (GQA, qk_norm)
ARCHS = ["qwen1.5-0.5b", "qwen3-14b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # JAX's CPU thread pool and torch's OpenMP threads oversubscribe the
    # cores when both run in one process; these shapes are tiny anyway
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, kv_bits, seed=0):
    jcfg = j_smoke_config(arch).scaled(**WIDE)
    cfg = smoke_config(arch).scaled(**WIDE)
    jt = j_build_template(jcfg)
    raw = j_init(jt, jax.random.PRNGKey(seed))
    jq = j_quantize_params(
        raw, jt, JQuantConfig(bits=4, backend="pallas", kv_bits=kv_bits))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    assert isinstance(tq["blocks"][0]["attn"]["wq"], QuantizedTensor)
    assert tq["blocks"][0]["attn"]["wq"].cfg == QuantConfig(
        bits=4, kv_bits=kv_bits)
    return jcfg, cfg, jq, tq


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = LOGIT_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=tol)


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_forward_matches_jax(arch, kv_bits):
    jcfg, cfg, jq, tq = _models(arch, kv_bits)
    rng = np.random.default_rng(1)
    ps, n_pages = 8, 12
    pt = np.array([[3, 7, 1, -1], [5, 0, -1, -1]], np.int32)
    toks = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    lens = np.array([13, 9])
    t_idx = np.arange(16)[None]
    pos = np.where(t_idx < lens[:, None], t_idx, -1).astype(np.int32)
    jc = j_init_paged_cache(jcfg, n_pages, ps, kv_bits=kv_bits)
    tc = init_paged_cache(cfg, n_pages, ps, kv_bits=kv_bits, device="cpu")
    jl, jc, _ = j_forward(jq, jnp.asarray(toks), jcfg,
                          positions=jnp.asarray(pos), cache=jc,
                          page_table=jnp.asarray(pt), page_size=ps)
    tl = forward(tq, torch.from_numpy(toks).long(), cfg,
                 positions=torch.from_numpy(pos).long(), cache=tc,
                 page_table=torch.from_numpy(pt), page_size=ps)
    valid = pos >= 0
    _close(tl.float().numpy()[valid], np.asarray(jl, np.float32)[valid])

    dec = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
    dpos = lens[:, None].astype(np.int32)
    outs = {}
    for mode in ("fused", "gather"):
        jd, _, _ = j_forward(jq, jnp.asarray(dec), jcfg,
                             positions=jnp.asarray(dpos), cache=jc,
                             page_table=jnp.asarray(pt), page_size=ps,
                             paged_attn=mode)
        td = forward(tq, torch.from_numpy(dec).long(), cfg,
                     positions=torch.from_numpy(dpos).long(),
                     cache=copy.deepcopy(tc),
                     page_table=torch.from_numpy(pt), page_size=ps,
                     paged_attn=mode)
        _close(td.float().numpy(), np.asarray(jd, np.float32))
        outs[mode] = td.float().numpy()
    _close(outs["fused"], outs["gather"])


@pytest.mark.parametrize("sq,chunk", [(12, 32), (40, 16)])
def test_attention_f32_matches_jax(sq, chunk):
    """Causal GQA attention with masked (negative) key positions, one
    chunk and several query chunks, in f32."""
    rng = np.random.default_rng(sq)
    b, h, hkv, dh, sk = 2, 4, 2, 16, 24
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    q_pos = rng.integers(-1, sk, size=(b, sq)).astype(np.int32)
    k_pos = np.where(rng.random((b, sk)) < 0.8, np.arange(sk), -1)
    k_pos = k_pos.astype(np.int32)
    want = JL.attention(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)),
                        chunk=chunk)
    got = L.attention(*(torch.from_numpy(a) for a in (q, k, v, q_pos,
                                                       k_pos)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_norm_and_rope_f32_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = np.array([[0, 3, 17, 200, 511], [1, 2, 3, 4, 5]], np.int32)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    js, jcs = JL.rope_tables(jnp.asarray(pos), 16, 1e6)
    ts, tcs = L.rope_tables(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), atol=1e-5)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), ts, tcs).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), js, jcs)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_paged_write_gather_and_fork_match_jax(packed):
    """Scatter through a page table (invalid positions dropped, -1 pages
    skipped), the dense per-row gather, and the COW page copy."""
    rng = np.random.default_rng(int(packed))
    n_pages, ps, hkv, dh = 6, 4, 2, 8
    pt = np.array([[2, 4, -1], [0, -1, -1]], np.int32)
    pos = np.array([[0, 1, 5, 6, -1], [2, 3, 4, 9, -1]], np.int32)
    val = rng.normal(size=(2, 5, hkv, dh)).astype(np.float32)
    if packed:
        val = rng.integers(-127, 128, size=(2, 5, hkv, dh // 4)).astype(
            np.int32)
        pool = np.zeros((n_pages, ps, hkv, dh // 4), np.int32)
    else:
        pool = np.zeros((n_pages, ps, hkv, dh), np.float32)
    want = JL._paged_write(jnp.asarray(pool), jnp.asarray(val),
                           jnp.asarray(pt), jnp.asarray(pos), ps)
    # the port's pools carry one more page: the scratch page that takes
    # the writes the reference drops
    got = torch.from_numpy(np.concatenate([pool, pool[:1]]))
    L._paged_write(got, torch.from_numpy(val), torch.from_numpy(pt),
                   torch.from_numpy(pos), ps)
    np.testing.assert_array_equal(got.numpy()[:n_pages], np.asarray(want))
    gathered = L._paged_gather(got, torch.from_numpy(pt), ps)
    np.testing.assert_array_equal(
        gathered.numpy(),
        np.asarray(JL._paged_gather(want, jnp.asarray(pt), ps)))
    np.testing.assert_array_equal(
        L._paged_key_positions(torch.from_numpy(pt), ps).numpy(),
        np.asarray(JL._paged_key_positions(jnp.asarray(pt), ps)))
    cache = {"layers": [{"k": got, "v": got.clone()}]}
    copy_paged_page(cache, 2, 5)
    np.testing.assert_array_equal(cache["layers"][0]["k"][5].numpy(),
                                  np.asarray(want)[2])
