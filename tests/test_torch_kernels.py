"""Port parity: the plain PyTorch version of each kernel matches the JAX
Pallas kernel body (run in the Pallas interpreter). The CUDA kernels are
held against the plain versions on a card by ``test_torch_cuda.py``.

Tolerances: with f32 activations / pools both sides compute in f32 and
differ only in summation order, so rtol=1e-5 and atol=1e-5 times the
largest output magnitude (a K=1024 sum of values ~10 carries ~1e-5
absolute f32 rounding). With bf16 inputs the outputs are
rounded to bf16 (8 significant bits), so one rounding step apart is
2^-8 relative: rtol=atol=2e-2 relative to the output's magnitude.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import samd as jsamd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.quant import pack_weights as j_pack_weights  # noqa: E402
from repro.quant.packing import pack_int8_lanes as j_pack_int8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import samd_matmul as mm  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402

BF16_TOL = 2e-2


def _to_torch_words(words) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words).view(np.int32).copy())


def _matmul_case(m, k, n, bits, spacer, signed, seed):
    """(x f32, words uint32, scale f32) for a packed-weight matmul; signed
    cases quantize a random weight, unsigned cases pack random
    non-negative codes (lanes with no sign bit)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jcfg = JQuantConfig(bits=bits, spacer=spacer)
    if signed:
        words, scale = j_pack_weights(
            jnp.asarray(rng.normal(size=(k, n)).astype(np.float32)), jcfg)
    else:
        codes = rng.integers(0, 2 ** bits, size=(n, k)).astype(np.int32)
        fmt = jsamd.SAMDFormat(bits, jcfg.lane_width, signed=False)
        words = jnp.moveaxis(jsamd.pack(jnp.asarray(codes), fmt), -1, 0)
        scale = jnp.asarray(rng.uniform(0.01, 0.1, size=(1, n)),
                            jnp.float32)
    return x, np.array(words), np.array(scale), jcfg


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("spacer", ["temporary", "permanent"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 64), (5, 203, 40)])
def test_samd_matmul_plain_matches_pallas_kernel(m, k, n, bits, spacer,
                                                 signed):
    """Ragged K (203; 1024 at 4-bit permanent is 170 words + 4 lanes),
    non-power-of-two vpw (10, 6, 3) and unsigned lanes; f32 activations
    so the comparison is of the algorithm."""
    x, words, scale, jcfg = _matmul_case(m, k, n, bits, spacer, signed,
                                         seed=bits * 31 + k)
    want = jops.samd_matmul(jnp.asarray(x), jnp.asarray(words),
                            jnp.asarray(scale), k, jcfg, signed=signed,
                            backend="interpret", verify=False)
    got = ops.samd_matmul(torch.from_numpy(x), _to_torch_words(words),
                          torch.from_numpy(scale), k,
                          QuantConfig(bits=bits, spacer=spacer),
                          signed=signed)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_samd_matmul_plain_bf16_and_lead_dims():
    """bf16 activations with leading batch dims, K = 2816 (the wd shape:
    352 words at 4-bit temporary)."""
    x, words, scale, jcfg = _matmul_case(6, 2816, 32, 4, "temporary", True,
                                         seed=5)
    xb = jnp.asarray(x, jnp.bfloat16).reshape(2, 3, 2816)
    want = np.asarray(jops.samd_matmul(
        xb, jnp.asarray(words), jnp.asarray(scale), 2816, jcfg,
        backend="interpret", verify=False), np.float32)
    got = ops.samd_matmul(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        _to_torch_words(words), torch.from_numpy(scale), 2816,
        QuantConfig(bits=4))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 32)
    tol = BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=tol)


@pytest.mark.parametrize("bits,signed", [(10, True), (12, True), (16, True),
                                         (9, False), (12, False),
                                         (16, False)])
def test_samd_matmul_plain_bf16_wide_codes_match_reference(bits, signed):
    """bf16 x with codes that bf16 cannot hold exactly (signed over 9
    bits, unsigned over 8): the reference casts the codes to x's dtype
    (``codes.astype(x.dtype)``), as the port's CUDA kernel does, and so
    must the plain version; within 1e-3 of the output scale of the xla
    lowering."""
    x, words, scale, jcfg = _matmul_case(8, 256, 64, bits, "temporary",
                                         signed, seed=bits + 7 * signed)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jops.samd_matmul(
        xb, jnp.asarray(words), jnp.asarray(scale), 256, jcfg,
        signed=signed, backend="xla", verify=False), np.float32)
    got = ops.samd_matmul(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        _to_torch_words(words), torch.from_numpy(scale), 256,
        QuantConfig(bits=bits), signed=signed)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-3 * np.abs(want).max(), err


def _paged_case(b, hkv, g, dh, ps, n_pp, packed, dtype, seed):
    """Random pools and a ragged page table: each slot owns a prefix of
    distinct pages with -1 holes after it, and slot 1 owns nothing (all
    -1, the empty slot). Positions land mid-page."""
    rng = np.random.default_rng(seed)
    p = b * n_pp + 1
    q = rng.normal(size=(b, hkv * g, dh)).astype(np.float32)
    perm = rng.permutation(p)
    pt = np.full((b, n_pp), -1, np.int32)
    pos = np.zeros(b, np.int32)
    for i in range(b):
        if i == 1:
            continue
        n_own = 1 + (i % n_pp)
        pt[i, :n_own] = perm[i * n_pp:i * n_pp + n_own]
        pos[i] = (n_own - 1) * ps + int(rng.integers(0, ps))
    if packed:
        kq = rng.integers(-127, 128, size=(p, ps, hkv, dh)).astype(np.int8)
        vq = rng.integers(-127, 128, size=(p, ps, hkv, dh)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, size=(p, ps, hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=(p, ps, hkv)).astype(np.float32)
        pools = (np.asarray(j_pack_int8(jnp.asarray(kq))),
                 np.asarray(j_pack_int8(jnp.asarray(vq))), ks, vs)
    else:
        kv = rng.normal(size=(2, p, ps, hkv, dh)).astype(np.float32)
        pools = (kv[0], kv[1], None, None)
    return q, pools, pt, pos, dtype


def _run_both(q, pools, pt, pos, dtype):
    kp, vp, ks, vs = pools
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    packed = ks is not None

    def jarr(a):
        return jnp.asarray(a) if packed else jnp.asarray(a, jd)

    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q, jd), jarr(kp), jarr(vp), jnp.asarray(pt),
        jnp.asarray(pos),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        interpret=True), np.float32)

    def tarr(a):
        if packed:
            return _to_torch_words(a)
        return torch.from_numpy(a).to(td)

    got = ops.paged_decode_attention(
        torch.from_numpy(q).to(td), tarr(kp), tarr(vp),
        torch.from_numpy(pt), torch.from_numpy(pos),
        k_scale=None if ks is None else torch.from_numpy(ks),
        v_scale=None if vs is None else torch.from_numpy(vs))
    return got.float().numpy(), want


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_attention_plain_matches_pallas_kernel(g, packed):
    """Ragged page tables with -1 pages, an empty slot, GQA G in {1, 4};
    f32 pools (packed pools dequantize to f32 in both)."""
    case = _paged_case(b=4, hkv=2, g=g, dh=16, ps=8, n_pp=3, packed=packed,
                       dtype="f32", seed=g + 10 * packed)
    got, want = _run_both(*case)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[1] == 0).all(), "a slot with no valid key emits zeros"


def test_paged_attention_plain_bf16_pools():
    case = _paged_case(b=3, hkv=2, g=2, dh=32, ps=4, n_pp=4, packed=False,
                       dtype="bf16", seed=3)
    got, want = _run_both(*case)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    assert (got[1] == 0).all()


def _ring(b, r, hkv, dh, seed):
    """A draft ring [B, R, Hkv, dh] whose slot i has its first i % (R+1)
    entries written (slot 0: none, so it keeps its pool-only state)."""
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(2, b, r, hkv, dh)).astype(np.float32)
    epos = np.full((b, r), -1, np.int32)
    for i in range(b):
        n = i % (r + 1)
        epos[i, :n] = 40 + np.arange(n)
    return kv[0], kv[1], epos


# packed pools hold int8 lanes, so bf16 is a case of bf16 pools only
POOL_DTYPES = [(False, "f32"), (True, "f32"), (False, "bf16")]


@pytest.mark.parametrize("packed,dtype", POOL_DTYPES)
@pytest.mark.parametrize("g", [1, 4])
def test_ring_fold_plain_matches_jax_lowering(g, packed, dtype):
    """The draft's decode: pool pages read up to ``q_pos`` (ragged tables
    with -1 pages, an empty slot), then the ring folded in with entries
    at -1 skipped. Against the reference's jnp lowering, which is where
    the reference computes the fold."""
    q, (kp, vp, ks, vs), pt, pos, _ = _paged_case(
        b=5, hkv=2, g=g, dh=16, ps=8, n_pp=3, packed=packed, dtype=dtype,
        seed=20 + g + 2 * packed)
    ek, ev, epos = _ring(5, 3, 2, 16, seed=g)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32

    def jarr(a):
        return jnp.asarray(a) if packed else jnp.asarray(a, jd)

    def tarr(a):
        return _to_torch_words(a) if packed else torch.from_numpy(a).to(td)

    scales = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    want = np.asarray(jpa.paged_decode_attention_xla(
        jnp.asarray(q, jd), jarr(kp), jarr(vp), jnp.asarray(pt),
        jnp.asarray(pos), extra_k=jnp.asarray(ek, jd),
        extra_v=jnp.asarray(ev, jd), extra_pos=jnp.asarray(epos),
        **{k: jnp.asarray(v) for k, v in scales.items()}), np.float32)
    got = ops.paged_decode_attention(
        torch.from_numpy(q).to(td), tarr(kp), tarr(vp), torch.from_numpy(pt),
        torch.from_numpy(pos), extra_k=torch.from_numpy(ek).to(td),
        extra_v=torch.from_numpy(ev).to(td),
        extra_pos=torch.from_numpy(epos),
        **{k: torch.from_numpy(v) for k, v in scales.items()})
    got = got.float().numpy()
    tol = BF16_TOL if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # slot 1 has no page but ring entries: the ring alone; a slot with
    # neither would emit zeros
    assert np.abs(got[1]).max() > 0


def _verify_case(b, s, hkv, g, dh, ps, n_pp, packed, seed):
    """A verify block as the engine makes it: slot i sits at position
    base_i with a draft budget spec_i, so its rows are base_i..base_i +
    spec_i and -1 after; its table holds the pages covering that window
    and -1 after. Slot 1 is inactive (table all -1), slot 2 has every
    row at -1 but pages, and windows cross page boundaries, so a row
    meets pages whose keys are all past its position."""
    rng = np.random.default_rng(seed)
    q, pools, _, _, _ = _paged_case(b, hkv, g * s, dh, ps, n_pp, packed,
                                    "f32", seed)
    q = q.reshape(b, hkv, g, s, dh).transpose(0, 3, 1, 2, 4).reshape(
        b, s, hkv * g, dh).copy()
    p = pools[0].shape[0]
    perm = rng.permutation(p)
    pt = np.full((b, n_pp), -1, np.int32)
    q_pos = np.full((b, s), -1, np.int32)
    for i in range(b):
        spec = int(rng.integers(0, s))
        base = int(rng.integers(0, n_pp * ps - spec))
        if i == 1:
            continue
        own = (base + spec) // ps + 1
        pt[i, :own] = perm[i * n_pp:i * n_pp + own]
        if i != 2:
            q_pos[i, :spec + 1] = base + np.arange(spec + 1)
    return q, pools, pt, q_pos


@pytest.mark.parametrize("packed,dtype", POOL_DTYPES)
@pytest.mark.parametrize("g,s", [(1, 2), (1, 5), (4, 3)])
def test_verify_attention_plain_matches_pallas_kernel(g, s, packed, dtype):
    """Multi-query verify: S queries per slot with positions at -1 past
    each slot's budget; ragged tables, an empty slot and a slot whose
    rows are all -1 emit exact zeros on those rows."""
    q, (kp, vp, ks, vs), pt, q_pos = _verify_case(
        b=5, s=s, hkv=2, g=g, dh=16, ps=4, n_pp=4, packed=packed,
        seed=30 + 7 * g + s + packed)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32

    def jarr(a):
        return jnp.asarray(a) if packed else jnp.asarray(a, jd)

    def tarr(a):
        return _to_torch_words(a) if packed else torch.from_numpy(a).to(td)

    scales = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    want = np.asarray(jops.paged_verify_attention(
        jnp.asarray(q, jd), jarr(kp), jarr(vp), jnp.asarray(pt),
        jnp.asarray(q_pos), interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()}), np.float32)
    got = ops.paged_verify_attention(
        torch.from_numpy(q).to(td), tarr(kp), tarr(vp), torch.from_numpy(pt),
        torch.from_numpy(q_pos),
        **{k: torch.from_numpy(v) for k, v in scales.items()})
    got = got.float().numpy()
    tol = BF16_TOL if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    dead = q_pos < 0
    assert (got[dead] == 0).all() and (got[1] == 0).all()
    assert (got[~dead] != 0).any(axis=-1).all()


def test_launch_counts_are_per_launcher():
    """One counter per exported launcher, not per source: the decode,
    ring-fold and verify launchers of one .cu file count apart."""
    counts = ops.launch_counts()
    assert set(counts) == {
        "samd_matmul_splitk_launch", "samd_matmul_tile_launch",
        "paged_decode_attention_launch",
        "paged_decode_ring_attention_launch",
        "paged_verify_attention_launch", "samd_conv2d_launch",
        "samd_conv2d_im2col_launch", "samd_conv_chunks_launch",
        "samd_conv1d_launch"}
    k = pa.KERNEL
    saved = dict(k.launches)
    try:
        k.launches["paged_verify_attention_launch"] += 3
        now = ops.launch_counts()
        assert now["paged_verify_attention_launch"] == (
            counts["paged_verify_attention_launch"] + 3)
        assert now["paged_decode_attention_launch"] == (
            counts["paged_decode_attention_launch"])
        ops.reset_launch_counts()
        assert set(ops.launch_counts().values()) == {0}
        with pytest.raises(KeyError, match="no launcher"):
            k.launch("paged_attention_launch")
    finally:
        k.launches = saved


def test_matmul_launcher_rule():
    """M at or under SPLITK_MAX_M takes the split-K launcher, more the
    tile launcher; the two count apart."""
    assert mm.SPLITK_MAX_M == 32
    for m in (1, 8, 16, 17, 24, 32):
        assert mm.launcher_for(m) == mm.SPLITK == "samd_matmul_splitk_launch"
    for m in (33, 40, 64, 256, 1024, 2048):
        assert mm.launcher_for(m) == mm.TILE == "samd_matmul_tile_launch"
    assert set(mm.KERNEL.launches) == {mm.SPLITK, mm.TILE}


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 8, 24, 32, 33, 256, 1024])
@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 2816), (2816, 1024),
                                 (203, 70), (5120, 17408), (17408, 5120),
                                 (5120, 151936)])
def test_matmul_split_rule(m, k, n, bits):
    """Every split keeps at least one K-step of 16 words and together they
    cover K exactly once, in at most 8 splits (one cluster); no split
    where the output tiles reach the launcher's ``NO_SPLIT_TILES`` (the
    split-K launcher's whole block target, the tile launcher's half), and
    a split-K launch under it with steps to spare splits (qwen3-14b's wg
    and wu, 544 tiles, among them); the main path's decode shapes (4-
    and 8-bit weights) run at least 132 blocks (2-bit K = 1024 has only
    4 K-steps of 16 words: 128)."""
    vpw = 32 // bits
    splits, per = mm.split_k(m, n, k, vpw)
    steps = max(1, math.ceil(math.ceil(k / vpw) / mm.STEP_WORDS))
    assert 1 <= splits <= mm.MAX_SPLITS and per >= 1
    assert (splits - 1) * per < steps <= splits * per
    fn = mm.launcher_for(m)
    bn, bm = mm.BLOCK[fn]
    tiles = -(-n // bn) * -(-m // bm)
    if tiles >= mm.NO_SPLIT_TILES[fn]:
        assert splits == 1
    elif fn == mm.SPLITK and steps > 1:
        assert splits > 1
    if m == 8 and k >= 1024 and bits in (4, 8):
        assert tiles * splits >= mm.NUM_SMS


@pytest.mark.parametrize("k", [203, 1024, 2816])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("spacer", ["temporary", "permanent"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_matmul_check_matches_reference(bits, spacer, signed, k):
    """The port's matmul lane-safety verdict equals the reference's."""
    from repro.analysis import check_matmul_config as j_check
    from repro_torch.analysis.contracts import check_matmul_config

    want = j_check(JQuantConfig(bits=bits, spacer=spacer), k, signed=signed)
    got = check_matmul_config(QuantConfig(bits=bits, spacer=spacer), k,
                              signed=signed)
    assert (got.ok, got.status, got.detail) == (want.ok, want.status,
                                                 want.detail)


def test_matmul_entry_point_runs_the_check(monkeypatch):
    """ops.samd_matmul refuses what the check refuses, before any work."""
    from repro_torch.analysis.contracts import check_matmul_config
    from repro_torch.analysis.lanes import LaneSafetyError

    def refuse(cfg, k, *, signed=True):
        return dataclasses.replace(
            check_matmul_config(cfg, k, signed=signed), status="overflow",
            detail="refused")

    monkeypatch.setattr(ops, "check_matmul_config", refuse)
    ops._verify_matmul.cache_clear()  # verdicts are cached per config
    x = torch.zeros((2, 8))
    try:
        with pytest.raises(LaneSafetyError):
            ops.samd_matmul(x, torch.zeros((2, 4), dtype=torch.int32),
                            torch.ones(4), 8, QuantConfig(bits=4))
    finally:
        ops._verify_matmul.cache_clear()


def test_kernel_entry_points_refuse_other_devices():
    """No silent plain route: only a CPU tensor takes the plain version."""
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.samd_matmul(x, torch.zeros((2, 4), dtype=torch.int32), None, 8,
                        QuantConfig(bits=4))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(mm.KERNEL, "_lib", None)
    monkeypatch.setattr(type(mm.KERNEL), "library",
                        property(lambda self: tmp_path / "absent.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mm.KERNEL.lib()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("rows", [1, 2, 3, 5, 15, 20, 144])
@pytest.mark.parametrize("b,hkv,n_pp", [(8, 16, 32), (8, 8, 32), (1, 1, 3),
                                        (64, 16, 32), (3, 2, 0)])
def test_attention_split_rule(b, hkv, rows, dh, n_pp, packed):
    """The attention plan: at most 8 splits (one cluster) and never more
    than the table's columns; the tensor-core path for several rows at
    dh = 64 or 128, one row a stream otherwise; row blocks that cover
    the rows with none empty; the blocks within one wave of resident
    blocks (where one split allows it) and no split left unused below
    that; and a pure function of the shapes."""
    plan = pa.attention_plan(b, hkv, rows, dh, n_pp, 16, rows, 0, packed)
    assert 1 <= plan.splits <= pa.MAX_SPLITS
    assert plan.splits <= max(1, n_pp)
    mma = rows > 1 and dh in pa.MMA_HEAD_DIMS
    assert plan.rt == (pa.MMA_ROWS if mma else 1)
    per_block = pa.MMA_ROWS if mma else pa.THREADS // (dh // 8)
    assert (plan.row_blocks - 1) * per_block < rows <= (
        plan.row_blocks * per_block)
    smem = pa.block_smem(plan.rt, dh, 16, n_pp, rows, 0, packed)
    assert smem <= 232448  # what one block may have
    per_sm = min(pa.BLOCKS_PER_SM, pa.SMEM_PER_SM // (smem + 1024))
    resident = int(pa.WAVE_FILL * per_sm * pa.NUM_SMS)
    blocks = b * hkv * plan.row_blocks
    if plan.splits > 1:
        assert blocks * plan.splits <= resident
    if plan.splits < min(pa.MAX_SPLITS, n_pp):
        assert blocks * (plan.splits + 1) > resident
    pa.attention_plan.cache_clear()
    assert pa.attention_plan(b, hkv, rows, dh, n_pp, 16, rows, 0,
                             packed) == plan


def test_attention_plan_at_the_serving_shapes():
    """qwen1.5-0.5b's decode and ring fold (8 slots x 16 kv-heads, one
    row) split 3 ways on CUDA cores, its verifies 3 ways on the tensor
    cores; qwen3-14b's decode and verify (8 kv-heads, G = 5, dh = 128) 4
    ways on the tensor cores, every row of a (slot, kv-head) in one
    block."""
    assert pa.attention_plan(8, 16, 1, 64, 32, 16, 1, 0, False) == (3, 1, 1)
    assert pa.attention_plan(8, 16, 1, 64, 32, 16, 1, 0, True) == (3, 1, 1)
    assert pa.attention_plan(8, 16, 1, 64, 32, 16, 1, 4, False) == (3, 1, 1)
    assert pa.attention_plan(8, 16, 5, 64, 32, 16, 5, 0, False) == (3, 16, 1)
    assert pa.attention_plan(8, 16, 3, 64, 32, 16, 3, 0, True) == (3, 16, 1)
    assert pa.attention_plan(8, 8, 5, 128, 32, 16, 1, 0, False) == (4, 16, 1)
    assert pa.attention_plan(8, 8, 15, 128, 32, 16, 3, 0, False) == (
        4, 16, 1)


def _launch_args(monkeypatch):
    """The CUDA wrappers' launches, recorded instead of made: each
    (launcher, its int arguments)."""
    calls = []
    monkeypatch.setattr(pa, "_launch", lambda q, fn, *args: calls.append(
        (fn, [a for a in args if isinstance(a, int)])))
    monkeypatch.setattr(pa, "stream_handle", lambda t: 0)
    return calls


def test_wrappers_pass_the_plan_of_the_shapes(monkeypatch):
    """The wrappers take the split from shapes alone: other positions and
    another table of the same shapes launch with the same arguments,
    ending in the plan's (splits, rt)."""
    calls = _launch_args(monkeypatch)
    for seed in (1, 2):
        q, (kp, vp, _, _), pt, pos, _ = _paged_case(
            b=4, hkv=2, g=4, dh=16, ps=8, n_pp=3, packed=False, dtype="f32",
            seed=seed)
        args = (torch.from_numpy(q).bfloat16(),
                torch.from_numpy(kp).bfloat16(),
                torch.from_numpy(vp).bfloat16(), torch.from_numpy(pt),
                torch.from_numpy(pos + seed))
        pa.paged_decode_attention_cuda(*args)
        ek, ev, epos = _ring(4, 3, 2, 16, seed=seed)
        pa.paged_decode_attention_cuda(
            *args, extra_k=torch.from_numpy(ek).bfloat16(),
            extra_v=torch.from_numpy(ev).bfloat16(),
            extra_pos=torch.from_numpy(epos + seed))
        vq, (kp, vp, _, _), pt, q_pos = _verify_case(
            b=4, s=3, hkv=2, g=4, dh=16, ps=8, n_pp=3, packed=False,
            seed=seed)
        pa.paged_verify_attention_cuda(
            torch.from_numpy(vq).bfloat16(), torch.from_numpy(kp).bfloat16(),
            torch.from_numpy(vp).bfloat16(), torch.from_numpy(pt),
            torch.from_numpy(q_pos))
    assert [fn for fn, _ in calls] == [
        "paged_decode_attention_launch",
        "paged_decode_ring_attention_launch",
        "paged_verify_attention_launch"] * 2
    assert calls[:3] == calls[3:]
    # (..., splits, rt, stream)
    decode, ring, verify = (ints[-3:-1] for _, ints in calls[:3])
    assert decode == list(pa.attention_plan(4, 2, 4, 16, 3, 8, 1, 0,
                                            False)[:2])
    assert ring == list(pa.attention_plan(4, 2, 4, 16, 3, 8, 1, 3,
                                          False)[:2])
    assert verify == list(pa.attention_plan(4, 2, 12, 16, 3, 8, 3, 0,
                                            False)[:2])


def test_attention_wrappers_refuse_head_dims_the_kernel_does_not_take(
        monkeypatch):
    _launch_args(monkeypatch)
    q = torch.zeros((2, 4, 24), dtype=torch.bfloat16)
    pool = torch.zeros((4, 4, 2, 24), dtype=torch.bfloat16)
    pt = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention_cuda(q, pool, pool, pt,
                                       torch.zeros(2, dtype=torch.int32))


def _split_everywhere(q, pools, pt, pos, **extra):
    """The plain page loop cut at every page boundary, its states and
    their rank-order merge as the output."""
    kp, vp, ks, vs = pools
    states = pa.paged_attention_states(
        q, kp, vp, pt, pos, tuple(range(pt.shape[1] + 1)), k_scale=ks,
        v_scale=vs, **extra)
    return states, pa.finish_state(pa.merge_states(states), q.shape,
                                   q.dtype)


def _torch_pools(pools):
    kp, vp, ks, vs = pools
    if ks is None:
        return (torch.from_numpy(kp), torch.from_numpy(vp), None, None)
    return (_to_torch_words(kp), _to_torch_words(vp), torch.from_numpy(ks),
            torch.from_numpy(vs))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("ring", [False, True])
def test_split_decode_merges_to_the_unsplit_loop(ring, g, packed):
    """Decode (and the draft's ring fold, folded into the last split) cut
    at every page boundary and merged in rank order equals the unsplit
    plain loop and the JAX reference; the empty slot, whose every split
    is empty, emits exact zeros."""
    q, pools, pt, pos, _ = _paged_case(b=5, hkv=2, g=g, dh=16, ps=4,
                                       n_pp=4, packed=packed, dtype="f32",
                                       seed=40 + g + 2 * packed)
    tq, tpools = torch.from_numpy(q), _torch_pools(pools)
    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(pos)
    scales = {} if pools[2] is None else dict(k_scale=pools[2],
                                              v_scale=pools[3])
    extra, jextra = {}, {}
    if ring:
        ek, ev, epos = _ring(5, 3, 2, 16, seed=g)
        extra = dict(extra_k=torch.from_numpy(ek),
                     extra_v=torch.from_numpy(ev),
                     extra_pos=torch.from_numpy(epos))
        jextra = dict(extra_k=jnp.asarray(ek), extra_v=jnp.asarray(ev),
                      extra_pos=jnp.asarray(epos))
    states, merged = _split_everywhere(tq, tpools, tpt, tpos, **extra)
    assert len(states) == 4
    unsplit = pa.paged_decode_attention_plain(
        tq, *tpools[:2], tpt, tpos, k_scale=tpools[2], v_scale=tpools[3],
        **extra)
    want = np.asarray(jpa.paged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(pt), jnp.asarray(pos), **jextra,
        **{k: jnp.asarray(v) for k, v in scales.items()}), np.float32)
    np.testing.assert_allclose(merged.numpy(), unsplit.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(merged.numpy(), want, rtol=1e-5, atol=1e-5)
    if not ring:  # slot 1: no page, so every split is empty
        assert all((m[1] == -1e30).all() and (l_sum[1] == 0).all()
                   for m, l_sum, _ in states)
        assert (merged[1] == 0).all()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("g,s", [(1, 5), (4, 3)])
def test_split_verify_merges_to_the_unsplit_loop(g, s, packed):
    """The verify cut at every page boundary and merged in rank order
    equals the unsplit plain loop and the JAX reference. Splits whose
    keys all lie past a row's position (m = -1e30, l > 0: exp(0) terms)
    occur and drop out; rows at -1 add no mass in any split; the
    inactive slot and rows at -1 emit exact zeros."""
    q, pools, pt, q_pos = _verify_case(b=5, s=s, hkv=2, g=g, dh=16, ps=4,
                                       n_pp=4, packed=packed,
                                       seed=50 + g + s + packed)
    # slot 4: rows in the first page, the last query three pages on, so
    # the later splits hold only keys past the early rows
    pt[4] = np.arange(4) + 16
    q_pos[4] = -1
    q_pos[4, :2] = [1, 2]
    q_pos[4, s - 1] = 13
    tq, tpools = torch.from_numpy(q), _torch_pools(pools)
    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(q_pos)
    states, merged = _split_everywhere(tq, tpools, tpt, tpos)
    unsplit = pa.paged_verify_attention_plain(
        tq, *tpools[:2], tpt, tpos, k_scale=tpools[2], v_scale=tpools[3])
    scales = {} if pools[2] is None else dict(k_scale=pools[2],
                                              v_scale=pools[3])
    want = np.asarray(jops.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(pt), jnp.asarray(q_pos), interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()}), np.float32)
    np.testing.assert_allclose(merged.numpy(), unsplit.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(merged.numpy(), want, rtol=1e-5, atol=1e-5)
    live = tpos >= 0
    masked_split = [((m == -1e30) & (l_sum > 0))[..., 0][live].any()
                    for m, l_sum, _ in states]
    assert any(masked_split), "no split with every key masked for a row"
    dead = ~live
    assert all((l_sum[dead] == 0).all() for _, l_sum, _ in states)
    out = merged.numpy()
    assert (out[q_pos < 0] == 0).all() and (out[1] == 0).all()
    assert (out[q_pos >= 0] != 0).any(axis=-1).all()


def test_merge_of_one_state_is_that_state():
    gen = torch.Generator().manual_seed(0)
    m = torch.randn(2, 3, generator=gen)
    l_sum = torch.rand(2, 3, generator=gen)
    acc = torch.randn(2, 3, 4, generator=gen)
    got = pa.merge_states([(m, l_sum, acc)])
    assert all(torch.equal(a, b) for a, b in zip(got, (m, l_sum, acc)))
