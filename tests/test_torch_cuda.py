"""The CUDA kernels of repro_torch against their plain PyTorch versions.

Tests marked ``cuda`` need an NVIDIA GPU and skip without one (a CUDA
kernel has no CPU mode); on a card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it also runs
where only the port is installed.

Tolerance: kernel and plain version both accumulate in f32 and round the
output to bf16 (8 significant bits) in different orders, so they may be
a rounding step or two apart: rtol = atol = 2e-2 of the output scale.
Packed codes read back through the matmul are compared exactly, and two
matmul calls on the same inputs must agree bit for bit, and so must two
conv calls. The conv kernel with f32 x splits x into two bf16 terms
(|x - hi - lo| <= 2^-17 |x|) and sums their exact products in f32 in
another order than its plain version: rtol = atol = 1e-4 of the output
scale. The conv-chunks kernel is integer work and is compared bit for
bit.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.archs import smoke_config  # noqa: E402
from repro_torch.core import conv, overflow, samd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import samd_conv as sc  # noqa: E402
from repro_torch.kernels import samd_matmul as mm  # noqa: E402
from repro_torch.models.model import forward, init_paged_cache  # noqa: E402
from repro_torch.models.quantize import quantize_params  # noqa: E402
from repro_torch.models.model import build_template  # noqa: E402
from repro_torch.models.spec import init_from_spec  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402
from repro_torch.quant.packing import (  # noqa: E402
    pack_conv_weights, pack_int8_lanes, pack_weights, unpack_weights,
)

TOL = 2e-2
CONV_F32_TOL = 1e-4


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, tol=TOL):
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    gen = torch.Generator().manual_seed(0)
    cfg = QuantConfig(bits=4)
    packed, scale = pack_weights(torch.randn(40, 8, generator=gen), cfg)
    x = torch.randn(3, 40, generator=gen)
    before = ops.launch_counts()
    out = ops.samd_matmul(x, packed, scale, 40, cfg)
    _close(out, mm.samd_matmul_plain(x, packed, scale, 40, cfg), 1e-6)
    args, kw = _paged_inputs("cpu", gen, 3, 2, 2, 16, 4, 3, False)
    ring = _ring_inputs("cpu", gen, 3, 4, 2, 16)
    _close(ops.paged_decode_attention(*args, **kw, **ring),
           pa.paged_decode_attention_plain(*args, **kw, **ring), 1e-6)
    vargs, vkw = _verify_inputs("cpu", gen, 3, 2, 2, 2, 16, 4, 3, True)
    _close(ops.paged_verify_attention(*vargs, **vkw),
           pa.paged_verify_attention_plain(*vargs, **vkw), 1e-6)
    assert ops.launch_counts() == before


def _matmul_inputs(dev, gen, m, k, n, cfg, signed):
    """Signed cases quantize a random weight, unsigned cases pack random
    non-negative codes (lanes with no sign bit)."""
    if signed:
        packed, scale = pack_weights(
            torch.randn(k, n, generator=gen, device=dev), cfg)
    else:
        codes = torch.randint(0, 2 ** cfg.bits, (n, k), generator=gen,
                              device=dev)
        fmt = samd.SAMDFormat(cfg.bits, cfg.lane_width, signed=False)
        packed = samd.pack(codes, fmt).t().contiguous()
        scale = torch.rand(1, n, generator=gen, device=dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    return x, packed, scale


def _moved(before, after):
    return {fn for fn in after if after[fn] != before[fn]}


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits,spacer", [(2, "temporary"), (2, "permanent"),
                                         (4, "temporary"), (4, "permanent"),
                                         (8, "temporary"), (8, "permanent")])
@pytest.mark.parametrize("k,n", [(1024, 96), (2816, 70), (203, 70),
                                 (203, 64)])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 17, 24, 32, 33, 40, 300,
                               1024])
def test_samd_matmul_kernel_matches_plain(cuda, m, k, n, bits, spacer,
                                          signed):
    """Ragged K and N (K = 203 and N = 70 are not 16-byte aligned: the
    kernel's narrow copies), non-power-of-two vpw, unsigned lanes, M on
    both sides of the split-K / tile switch (32); exactly the launcher
    of ``launcher_for(m)`` runs, once."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + bits)
    cfg = QuantConfig(bits=bits, spacer=spacer)
    x, packed, scale = _matmul_inputs(cuda, gen, m, k, n, cfg, signed)
    before = ops.launch_counts()
    got = ops.samd_matmul(x, packed, scale, k, cfg, signed=signed)
    after = ops.launch_counts()
    fn = mm.launcher_for(m)
    assert _moved(before, after) == {fn}
    assert after[fn] == before[fn] + 1
    _close(got, mm.samd_matmul_plain(x, packed, scale, k, cfg,
                                     signed=signed))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 1024])
def test_samd_matmul_gives_fake_tensors_their_shape_only(cuda, m):
    """Fake CUDA tensors (a dry-run's trace) through ``ops.samd_matmul``
    get a fake output of the kernel's shape and dtype on the card, and
    no launch is made or counted; the same call on real tensors then
    launches once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    gen = torch.Generator(device=cuda).manual_seed(m)
    cfg = QuantConfig(bits=4)
    x, packed, scale = _matmul_inputs(cuda, gen, m, 1024, 96, cfg, True)
    before = ops.launch_counts()
    with FakeTensorMode() as mode:
        fx, fp, fs = (mode.from_tensor(t) for t in (x, packed, scale))
        out = ops.samd_matmul(fx, fp, fs, 1024, cfg)
        assert (out.shape, out.dtype, out.device) == (
            (m, 96), torch.bfloat16, x.device)
    assert ops.launch_counts() == before
    ops.samd_matmul(x, packed, scale, 1024, cfg)
    assert _moved(before, ops.launch_counts()) == {mm.launcher_for(m)}


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits,spacer", [(9, "temporary"), (10, "temporary"),
                                         (12, "permanent"), (16, "temporary"),
                                         (16, "permanent")])
@pytest.mark.parametrize("m", [8, 24, 33, 1024])
def test_samd_matmul_kernel_matches_plain_at_wide_codes(cuda, m, bits,
                                                        spacer, signed):
    """Codes of 9-16 bits, which bf16 holds exactly only up to 8 unsigned
    / 9 signed bits: the kernel and the plain version both round them as
    the reference's ``codes.astype(x.dtype)``, through either launcher."""
    gen = torch.Generator(device=cuda).manual_seed(m + bits)
    cfg = QuantConfig(bits=bits, spacer=spacer)
    x, packed, scale = _matmul_inputs(cuda, gen, m, 1024, 96, cfg, signed)
    got = ops.samd_matmul(x, packed, scale, 1024, cfg, signed=signed)
    _close(got, mm.samd_matmul_plain(x, packed, scale, 1024, cfg,
                                     signed=signed))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("bits,spacer", [(4, "permanent"), (2, "temporary"),
                                         (8, "temporary")])
def test_samd_matmul_kernel_reads_codes_exactly(cuda, bits, spacer, m):
    """One-hot rows of x with unit scales read the codes back bit for bit
    through either launcher (M = 8 split-K, M = 1024 tile)."""
    cfg = QuantConfig(bits=bits, spacer=spacer)
    k = 1024
    packed, _ = pack_weights(torch.randn(k, 64, device=cuda), cfg)
    rows = torch.randperm(k, device=cuda)[:m]
    x = torch.zeros(m, k, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(m, device=cuda), rows] = 1
    got = ops.samd_matmul(x, packed, torch.ones(64, device=cuda), k, cfg)
    want = unpack_weights(packed, k, cfg)[rows]
    assert torch.equal(got.float(), want.float())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 1024, 1024), (8, 2816, 1024),
                                   (24, 1024, 2816), (256, 1024, 1024),
                                   (1024, 1024, 2816)])
def test_samd_matmul_kernel_is_deterministic(cuda, m, k, n):
    """Two calls on the same inputs give bit-identical outputs, with K
    split across blocks (fixed-order sum of the partials) and without."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    cfg = QuantConfig(bits=4)
    x, packed, scale = _matmul_inputs(cuda, gen, m, k, n, cfg, True)
    a = ops.samd_matmul(x, packed, scale, k, cfg)
    b = ops.samd_matmul(x, packed, scale, k, cfg)
    assert torch.equal(a, b)
    _close(a, mm.samd_matmul_plain(x, packed, scale, k, cfg))


@pytest.mark.cuda
def test_samd_matmul_kernel_refuses_what_it_does_not_take(cuda):
    cfg = QuantConfig(bits=4)
    packed, scale = pack_weights(torch.randn(64, 8, device=cuda), cfg)
    with pytest.raises(TypeError):
        ops.samd_matmul(torch.randn(2, 64, device=cuda), packed, scale, 64,
                        cfg)


def _paged_inputs(dev, gen, b, hkv, g, dh, ps, n_pp, packed):
    n_pages = b * n_pp
    perm = torch.randperm(n_pages, generator=gen, device=dev).int()
    pt = torch.full((b, n_pp), -1, dtype=torch.int32, device=dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    for i in range(b):
        if i == 1:
            continue  # the empty slot
        ln = int(torch.randint(0, n_pp * ps, (1,), generator=gen,
                               device=dev))
        pt[i, :ln // ps + 1] = perm[i * n_pp:i * n_pp + ln // ps + 1]
        pos[i] = ln
    q = torch.randn(b, hkv * g, dh, generator=gen, device=dev)
    shape = (n_pages, ps, hkv, dh)
    if packed:
        def pool():
            v = torch.randint(-127, 128, shape, generator=gen, device=dev)
            return pack_int8_lanes(v.to(torch.int8))

        kw = {n: torch.rand(shape[:3], generator=gen, device=dev) * 0.02
              for n in ("k_scale", "v_scale")}
        return (q.to(torch.bfloat16), pool(), pool(), pt, pos), kw
    kv = torch.randn((2,) + shape, generator=gen, device=dev)
    kv = kv.to(torch.bfloat16)
    return (q.to(torch.bfloat16), kv[0], kv[1], pt, pos), {}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hkv,g,dh,ps", [(16, 1, 64, 16), (4, 4, 64, 16),
                                         (2, 2, 128, 8)])
def test_paged_attention_kernel_matches_plain(cuda, hkv, g, dh, ps, packed):
    gen = torch.Generator(device=cuda).manual_seed(hkv * g + packed)
    args, kw = _paged_inputs(cuda, gen, 6, hkv, g, dh, ps, 5, packed)
    before = ops.launch_counts()
    got = ops.paged_decode_attention(*args, **kw)
    after = ops.launch_counts()
    assert after["paged_decode_attention_launch"] == (
        before["paged_decode_attention_launch"] + 1)
    assert after["paged_decode_ring_attention_launch"] == (
        before["paged_decode_ring_attention_launch"])
    _close(got, pa.paged_decode_attention_plain(*args, **kw))
    assert (got[1] == 0).all(), "a slot with no valid key emits zeros"


def _ring_inputs(dev, gen, b, r, hkv, dh):
    """The draft ring: slot i has its first i % (r + 1) entries written
    (slot 0 none), the rest at -1."""
    kv = torch.randn((2, b, r, hkv, dh), generator=gen, device=dev)
    epos = torch.full((b, r), -1, dtype=torch.int32, device=dev)
    for i in range(b):
        n = i % (r + 1)
        epos[i, :n] = 500 + torch.arange(n, dtype=torch.int32, device=dev)
    return dict(extra_k=kv[0].to(torch.bfloat16),
                extra_v=kv[1].to(torch.bfloat16), extra_pos=epos)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hkv,g,dh,ps,r", [(16, 1, 64, 16, 4),
                                           (4, 4, 64, 16, 2),
                                           (2, 2, 128, 8, 12)])
def test_ring_fold_kernel_matches_plain(cuda, hkv, g, dh, ps, r, packed):
    """The decode kernel with the draft ring folded in after the pages;
    r = 12 > ps = 8 stages more ring entries than a page holds. Slot 1
    (no page) attends to its ring alone; slot 0 (no ring entry) keeps
    its pool-only result."""
    gen = torch.Generator(device=cuda).manual_seed(hkv * g + r + packed)
    b = 6
    args, kw = _paged_inputs(cuda, gen, b, hkv, g, dh, ps, 5, packed)
    ring = _ring_inputs(cuda, gen, b, r, hkv, dh)
    before = ops.launch_counts()
    got = ops.paged_decode_attention(*args, **kw, **ring)
    after = ops.launch_counts()
    assert after["paged_decode_ring_attention_launch"] == (
        before["paged_decode_ring_attention_launch"] + 1)
    assert after["paged_decode_attention_launch"] == (
        before["paged_decode_attention_launch"])
    _close(got, pa.paged_decode_attention_plain(*args, **kw, **ring))
    _close(got[0], ops.paged_decode_attention(*args, **kw)[0])
    assert (got[1] != 0).any()
    none = dict(ring, extra_pos=torch.full_like(ring["extra_pos"], -1))
    empty = ops.paged_decode_attention(*args, **kw, **none)
    assert (empty[1] == 0).all(), "no page and no ring entry emits zeros"


def _verify_inputs(dev, gen, b, s, hkv, g, dh, ps, n_pp, packed):
    """A verify block as the engine makes it: slot i at position base_i
    with draft budget spec_i has rows base_i..base_i + spec_i, then -1,
    and the pages covering that window, then -1. Slot 1 is inactive
    (table all -1) and slot 2 has pages but every row at -1."""
    (q, kp, vp, _, _), kw = _paged_inputs(dev, gen, b, hkv, g * s, dh, ps,
                                          n_pp, packed)
    q = q.reshape(b, hkv, g, s, dh).permute(0, 3, 1, 2, 4).reshape(
        b, s, hkv * g, dh).contiguous()
    perm = torch.randperm(kp.shape[0], generator=gen, device=dev).int()
    pt = torch.full((b, n_pp), -1, dtype=torch.int32, device=dev)
    q_pos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for i in range(b):
        spec = int(torch.randint(0, s, (1,), generator=gen, device=dev))
        base = int(torch.randint(0, n_pp * ps - spec, (1,), generator=gen,
                                 device=dev))
        if i == 1:
            continue
        own = (base + spec) // ps + 1
        pt[i, :own] = perm[i * n_pp:i * n_pp + own]
        if i != 2:
            q_pos[i, :spec + 1] = base + torch.arange(
                spec + 1, dtype=torch.int32, device=dev)
    return (q, kp, vp, pt, q_pos), kw


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s,hkv,g,dh,ps", [(2, 16, 1, 64, 16),
                                           (5, 16, 1, 64, 16),
                                           (5, 4, 4, 64, 16),
                                           (3, 8, 5, 128, 16)])
def test_verify_kernel_matches_plain(cuda, s, hkv, g, dh, ps, packed):
    """Rows at -1, an inactive slot and a slot with every row at -1 come
    out as exact zeros; (3, 8, 5, 128) is qwen3-14b's GQA at S = 3."""
    gen = torch.Generator(device=cuda).manual_seed(s * hkv + g + packed)
    args, kw = _verify_inputs(cuda, gen, 8, s, hkv, g, dh, ps, 32, packed)
    before = ops.launch_counts()["paged_verify_attention_launch"]
    got = ops.paged_verify_attention(*args, **kw)
    assert ops.launch_counts()["paged_verify_attention_launch"] == before + 1
    _close(got, pa.paged_verify_attention_plain(*args, **kw))
    dead = args[4] < 0
    assert (got[dead] == 0).all() and (got[1] == 0).all()
    assert (got[~dead] != 0).any(dim=-1).all()


@pytest.mark.cuda
def test_verify_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    args, kw = _verify_inputs(cuda, gen, 3, 2, 2, 1, 64, 16, 2, False)
    q, kp, vp, pt, q_pos = args
    with pytest.raises(TypeError):
        ops.paged_verify_attention(q.float(), kp, vp, pt, q_pos)
    with pytest.raises(ValueError):
        ops.paged_verify_attention(q, kp, vp, pt, q_pos[:, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_attention_kernels_are_deterministic(cuda, packed):
    """Decode, ring fold and verify at the serving path's shapes (their
    KV split over a cluster, merged in rank order): two calls agree bit
    for bit."""
    gen = torch.Generator(device=cuda).manual_seed(7 + packed)
    args, kw = _paged_inputs(cuda, gen, 8, 16, 1, 64, 16, 32, packed)
    ring = _ring_inputs(cuda, gen, 8, 4, 16, 64)
    vargs, vkw = _verify_inputs(cuda, gen, 8, 5, 16, 1, 64, 16, 32, packed)
    for fn, a, k in ((ops.paged_decode_attention, args, kw),
                     (ops.paged_decode_attention, args, dict(kw, **ring)),
                     (ops.paged_verify_attention, vargs, vkw)):
        assert torch.equal(fn(*a, **k), fn(*a, **k))


def _slots(cuda, gen, lens, hkv, g, dh, ps, n_pp, packed):
    """Decode inputs whose slot i sits at position lens[i] and owns the
    pages up to it (lens[i] < 0: an inactive slot)."""
    (q, kp, vp, _, _), kw = _paged_inputs(cuda, gen, len(lens), hkv, g, dh,
                                          ps, n_pp, packed)
    pt = torch.full((len(lens), n_pp), -1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(len(lens), dtype=torch.int32, device=cuda)
    perm = torch.randperm(kp.shape[0], generator=gen, device=cuda).int()
    for i, ln in enumerate(lens):
        if ln >= 0:
            pt[i, :ln // ps + 1] = perm[i * n_pp:i * n_pp + ln // ps + 1]
            pos[i] = ln
    return (q, kp, vp, pt, pos), kw


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("lens,hkv", [
    ([0, 0, -1, 0], 4),               # one key a slot
    ([511, 511, 500, 496], 4),        # every page of n_pp = 32 live
    ([3], 1),                         # one live page, 8 splits
    ([17, -1, 40], 1)])               # fewer live pages than splits
def test_paged_attention_kernel_split_edges(cuda, lens, hkv, packed):
    """The KV split at its edges: slots with one key, slots whose every
    page of a 32-page table is live, and more splits than live pages
    (the plan gives one (slot, kv-head) 8 ranks, most of them with no
    page); against the plain version, inactive slots exact zeros."""
    gen = torch.Generator(device=cuda).manual_seed(len(lens) + packed)
    args, kw = _slots(cuda, gen, lens, hkv, 1, 64, 16, 32, packed)
    plan = pa.attention_plan(len(lens), hkv, 1, 64, 32, 16, 1, 0, packed)
    assert plan.splits > 1
    got = ops.paged_decode_attention(*args, **kw)
    _close(got, pa.paged_decode_attention_plain(*args, **kw))
    for i, ln in enumerate(lens):
        assert (got[i] == 0).all() == (ln < 0)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_verify_kernel_rows_in_the_first_split(cuda, packed):
    """Verify rows whose keys all lie in the first split while the slot's
    last query reaches the last page: the later splits hold only keys
    masked for those rows (m = -1e30, l > 0) and must drop out of the
    merge; rows at -1 between them stay exact zeros."""
    gen = torch.Generator(device=cuda).manual_seed(11 + packed)
    s = 4
    (q, kp, vp, pt, _), kw = _slots(cuda, gen, [500, 300, -1], 4, 2 * s,
                                    64, 16, 32, packed)
    q = q.reshape(3, 4, 2, s, 64).permute(0, 3, 1, 2, 4).reshape(
        3, s, 8, 64).contiguous()
    q_pos = torch.tensor([[2, 3, -1, 500], [0, 17, 299, 300],
                          [-1, -1, -1, -1]], dtype=torch.int32, device=cuda)
    assert pa.attention_plan(3, 4, s * 2, 64, 32, 16, s, 0,
                             packed).splits > 1
    got = ops.paged_verify_attention(q, kp, vp, pt, q_pos, **kw)
    _close(got, pa.paged_verify_attention_plain(q, kp, vp, pt, q_pos, **kw))
    dead = q_pos < 0
    assert (got[dead] == 0).all()
    assert (got[~dead] != 0).any(dim=-1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_paged_attention_kernel_at_qwen3_14b_gqa(cuda, packed):
    """Decode at qwen3-14b's attention shape: 8 kv-heads, G = 5, dh = 128
    (five query rows a stream, 16 lanes a key row)."""
    gen = torch.Generator(device=cuda).manual_seed(5 + packed)
    args, kw = _paged_inputs(cuda, gen, 8, 8, 5, 128, 16, 32, packed)
    got = ops.paged_decode_attention(*args, **kw)
    _close(got, pa.paged_decode_attention_plain(*args, **kw))
    assert (got[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_speculative_serving_on_card_launches_every_kernel(cuda, kv_bits):
    """A speculative engine on the card (4-bit target, its own draft)
    drafts through the ring-fold launcher, verifies through the verify
    launcher (its linears, M = 4 x 4, through the split-K matmul; the
    prefill's 4 x 32 rows through the tile matmul), and serves every
    request in full."""
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = smoke_config("qwen3-14b").scaled(d_model=256, head_dim=64,
                                           d_ff=512, vocab=256)
    eng = ServingEngine(cfg, None, quant=QuantConfig(bits=4,
                                                     kv_bits=kv_bits),
                        max_batch=4, max_len=64, page_size=8,
                        speculative=3, device=cuda)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=(torch.arange(5 + 3 * i) * 7 + i)
                           .numpy() % 256, max_tokens=10))
    ops.reset_launch_counts()
    done = eng.run_to_completion()
    counts = ops.launch_counts()
    for fn in ("samd_matmul_splitk_launch", "samd_matmul_tile_launch",
               "paged_decode_ring_attention_launch",
               "paged_verify_attention_launch"):
        assert counts[fn] > 0, counts
    # every tick is a speculative one: the plain decode launcher idles
    assert counts["paged_decode_attention_launch"] == 0, counts
    assert eng.stats["spec_ticks"] > 0
    assert len(done) == 6
    assert all(r.error is None and not r.truncated
               and len(r.generated) == 10 for r in done)


@pytest.mark.cuda
def test_front_door_streams_a_direct_runs_tokens_from_a_pool_thread(
        cuda, monkeypatch):
    """``AsyncServer`` over a 4-bit engine on the card with the tick in a
    worker thread (``step_in_thread=True``): every stream carries the
    tokens a direct run of the same engine gives (``reset()`` between;
    the same batches form, so the same kernels run on the same shapes),
    the split-K (decode), tile (prefill) and decode-attention launchers
    run from the pool thread, and no plain version runs."""
    import asyncio

    from repro_torch.serving import AsyncServer, Request, ServingEngine

    cfg = smoke_config("qwen3-14b").scaled(d_model=256, head_dim=64,
                                           d_ff=512, vocab=256)
    eng = ServingEngine(cfg, None, quant=QuantConfig(bits=4), max_batch=4,
                        max_len=64, page_size=8, device=cuda)
    prompts = [(torch.arange(5 + 3 * i) * 7 + i).numpy() % 256
               for i in range(6)]
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_tokens=10))
    direct = {r.rid: r.generated for r in eng.run_to_completion()}
    eng.reset()

    def plain(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(mm, "samd_matmul_plain", plain)
    monkeypatch.setattr(pa, "paged_decode_attention_plain", plain)
    ops.reset_launch_counts()
    server = AsyncServer(eng, step_in_thread=True, max_queue=8)

    async def run():
        await server.start()
        streams = [server.submit(p, 10, rid=i) for i, p in enumerate(prompts)]
        outs = await asyncio.wait_for(
            asyncio.gather(*(s.collect() for s in streams)), 300)
        await asyncio.wait_for(server.stop(), 300)
        return outs

    outs = asyncio.run(run())
    counts = ops.launch_counts()
    assert dict(enumerate(outs)) == direct
    assert server.counters["completed"] == 6
    for fn in ("samd_matmul_splitk_launch", "samd_matmul_tile_launch",
               "paged_decode_attention_launch"):
        assert counts[fn] > 0, counts
    assert sum(counts.values()) == sum(
        counts[fn] for fn in ("samd_matmul_splitk_launch",
                              "samd_matmul_tile_launch",
                              "paged_decode_attention_launch")), counts
    for req in server.finished:
        assert (req.t_submit <= req.t_admit <= req.t_first_token
                <= req.t_retire)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_forward_on_card_matches_plain_on_cpu(cuda, kv_bits):
    """GQA smoke model, 4-bit weights: prefill then a fused decode token,
    through the kernels on the card and the plain versions on the CPU."""
    cfg = smoke_config("qwen3-14b").scaled(d_model=256, head_dim=64,
                                           d_ff=512, vocab=256)
    gen = torch.Generator().manual_seed(0)
    raw = init_from_spec(build_template(cfg), gen, device="cpu")
    params = quantize_params(raw, build_template(cfg),
                             QuantConfig(bits=4, kv_bits=kv_bits))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        if hasattr(tree, "packed"):
            return type(tree)(tree.packed.to(dev), tree.scale.to(dev),
                              tree.orig_shape, tree.axis, tree.cfg)
        return tree.to(dev)

    toks = torch.randint(0, 256, (2, 12), generator=gen)
    pos = torch.where(torch.arange(12)[None] < torch.tensor([[12], [7]]),
                      torch.arange(12)[None], -1)
    pt = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)
    dec = torch.randint(0, 256, (2, 1), generator=gen)
    dpos = torch.tensor([[12], [7]])
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = to(params, dev)
        cache = init_paged_cache(cfg, 4, 8, kv_bits=kv_bits, device=dev)
        pre = forward(p, toks.to(dev), cfg, positions=pos.to(dev),
                      cache=cache, page_table=pt.to(dev), page_size=8)
        nxt = forward(p, dec.to(dev), cfg, positions=dpos.to(dev),
                      cache=cache, page_table=pt.to(dev), page_size=8,
                      paged_attn="fused")
        outs.append((pre.cpu()[pos >= 0], nxt.cpu()))
    for a, b in zip(*outs):
        _close(a, b, 5e-2)


def test_cpu_conv_tensors_take_the_plain_version_and_launch_nothing():
    gen = torch.Generator().manual_seed(0)
    cfg = QuantConfig(bits=4)
    packed, scale = pack_conv_weights(torch.randn(3, 3, 5, 4, generator=gen),
                                      cfg)
    x = torch.randn(5, 6, 7, generator=gen)
    before = ops.launch_counts()
    _close(ops.samd_conv2d(x, packed, scale, cfg),
           sc.samd_conv2d_plain(x, packed, scale, cfg), 1e-6)
    plan = conv.make_plan(2, 3, True)
    xi = torch.randint(-2, 2, (50,), generator=gen)
    ki = torch.randint(-2, 2, (3,), generator=gen)
    assert torch.equal(ops.samd_conv1d(xi, ki, plan),
                       conv.samd_conv_full(xi, ki, plan))
    assert ops.launch_counts() == before


def _conv_weights(dev, gen, bits, spacer, c_in, c_out, signed, kh=3, kw=3):
    cfg = QuantConfig(bits=bits, spacer=spacer)
    if signed:
        return (*pack_conv_weights(
            torch.randn(kh, kw, c_in, c_out, generator=gen, device=dev),
            cfg), cfg)
    codes = torch.randint(0, 2 ** bits, (kh, kw, c_out, c_in), generator=gen,
                          device=dev)
    fmt = samd.SAMDFormat(bits, cfg.lane_width, signed=False)
    packed = samd.pack(codes, fmt).movedim(-1, 2).contiguous()
    scale = torch.rand(1, c_out, generator=gen, device=dev) + 0.5
    return packed, scale, cfg


def _conv_launcher(x, packed, cfg, padding):
    c_in, h, w = x.shape
    kh, kw, cw, c_out = packed.shape
    return sc.conv2d_plan(c_in, cw, h, w, kh, kw, c_out, padding,
                          cfg.values_per_word,
                          x.dtype == torch.bfloat16).launcher


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits,spacer", [(2, "temporary"), (4, "temporary"),
                                         (4, "permanent"), (8, "temporary"),
                                         (9, "temporary"), (10, "permanent"),
                                         (12, "temporary"), (16, "temporary"),
                                         (16, "permanent")])
@pytest.mark.parametrize("c_in,c_out,h,w,kh,kw,padding", [
    (3, 64, 20, 37, 3, 3, 1), (37, 70, 9, 33, 3, 3, 1),
    (19, 8, 5, 6, 3, 3, 0), (300, 70, 7, 7, 3, 3, 1),
    (37, 70, 9, 12, 1, 1, 0), (37, 70, 9, 12, 5, 3, 1)])
def test_samd_conv2d_kernel_matches_plain(cuda, c_in, c_out, h, w, kh, kw,
                                          padding, bits, spacer, signed,
                                          dtype):
    """conv1_1's C_in = 3 (the im2col launcher), ragged C_in, C_out and OW
    against the kernel's 128 x 64 tiles, a deep small layer whose K is
    split over a cluster (C_in 300 at 7 x 7), 1x1 and 5x3 kernels,
    padding 0 and 1, signed and unsigned lanes up to 16 bits (codes that
    bf16 cannot hold: rounded as the reference for bf16 x, split into two
    exact parts for f32 x), f32 and bf16 x; exactly the launcher of
    ``conv2d_plan`` runs."""
    gen = torch.Generator(device=cuda).manual_seed(c_in + bits + signed)
    packed, scale, cfg = _conv_weights(cuda, gen, bits, spacer, c_in, c_out,
                                       signed, kh, kw)
    x = torch.randn(c_in, h, w, generator=gen, device=cuda).to(dtype)
    before = ops.launch_counts()
    got = ops.samd_conv2d(x, packed, scale, cfg, padding=padding,
                          signed=signed)
    assert _moved(before, ops.launch_counts()) == {
        _conv_launcher(x, packed, cfg, padding)}
    want = sc.samd_conv2d_plain(x, packed, scale, cfg, padding=padding,
                                signed=signed)
    assert got.dtype == dtype and got.shape == want.shape
    _close(got, want, CONV_F32_TOL if dtype == torch.float32 else TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out,h,w", [(512, 512, 14, 14),
                                            (256, 512, 28, 28),
                                            (300, 70, 7, 7),
                                            (64, 128, 112, 112)])
def test_samd_conv2d_kernel_is_deterministic(cuda, c_in, c_out, h, w, dtype):
    """Two calls on the same inputs give bit-identical outputs, with K
    split over a cluster (conv5, conv4 and the deep small layer: partials
    summed in rank order) and without (conv2_1)."""
    gen = torch.Generator(device=cuda).manual_seed(c_in + h)
    packed, scale, cfg = _conv_weights(cuda, gen, 4, "temporary", c_in,
                                       c_out, True)
    x = torch.randn(c_in, h, w, generator=gen, device=cuda).to(dtype)
    a = ops.samd_conv2d(x, packed, scale, cfg)
    b = ops.samd_conv2d(x, packed, scale, cfg)
    assert torch.equal(a, b)
    _close(a, sc.samd_conv2d_plain(x, packed, scale, cfg),
           CONV_F32_TOL if dtype == torch.float32 else TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,bits,surplus", [(32, 4, 1), (64, 4, 1),
                                               (37, 4, 3), (3, 4, 1),
                                               (16, 16, 1)])
def test_samd_conv2d_kernel_takes_surplus_words(cuda, c_in, bits, surplus,
                                                dtype):
    """Packed weights with more words than C_in needs (random words past
    C_in, which meet zero channels): C_in 64 at 4 bits with 9 words adds a
    K-step per tap with f32 x, C_in 32 with 5 words moves to the im2col
    launcher, and 16-bit codes take them too; the kernel equals the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(c_in + surplus)
    packed, scale, cfg = _conv_weights(cuda, gen, bits, "temporary", c_in,
                                       70, True)
    extra = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 3, surplus, 70),
                          generator=gen, device=cuda, dtype=torch.int32)
    packed = torch.cat([packed, extra], dim=2)
    x = torch.randn(c_in, 9, 12, generator=gen, device=cuda).to(dtype)
    before = ops.launch_counts()
    got = ops.samd_conv2d(x, packed, scale, cfg)
    assert _moved(before, ops.launch_counts()) == {
        _conv_launcher(x, packed, cfg, 1)}
    _close(got, sc.samd_conv2d_plain(x, packed, scale, cfg),
           CONV_F32_TOL if dtype == torch.float32 else TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("forge", ["step_k", "steps", "splits"])
def test_samd_conv2d_kernel_refuses_a_plan_not_its_own(cuda, forge):
    """The kernel takes the plan's K-step only where it is the step it was
    compiled for, a step count only where it covers every word of every
    tap, and splits only where they divide the steps: anything else is a
    launch error, not a wrong result."""
    cfg = QuantConfig(bits=4)
    packed, scale = pack_conv_weights(torch.randn(3, 3, 37, 70, device=cuda),
                                      cfg)
    x = torch.randn(37, 9, 12, device=cuda)
    plan, _, _ws, args = sc.conv2d_launch_args(x, packed, scale, cfg)
    assert plan.steps == 18  # two steps of 4 words a tap for 5 words
    args = list(args)
    if forge == "step_k":
        args[-3] = 2 * plan.step_k
    elif forge == "steps":
        args[-2] = plan.steps - 9  # one step a tap: 4 of its 5 words
    else:
        args[-4] = next(d for d in range(2, 9) if plan.steps % d)
    with pytest.raises(RuntimeError, match="launch failed"):
        sc.KERNEL.launch(plan.launcher, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,signed", [(2, True), (3, True), (4, True),
                                         (4, False)])
def test_samd_conv1d_kernel_is_bit_exact(cuda, bits, signed):
    """The four plans of the conv slice: samd_conv1d (one fused launch)
    equals a direct integer convolution, and the chunk launcher's lanes
    equal the plain version's bit for bit (edge words included: top bit
    set, all ones)."""
    gen = torch.Generator(device=cuda).manual_seed(bits + signed)
    plan = conv.make_plan(bits, 3, signed)
    lo, hi = overflow.input_range(bits, signed)
    x = torch.randint(lo, hi + 1, (100_003,), generator=gen, device=cuda)
    k = torch.randint(lo, hi + 1, (3,), generator=gen, device=cuda)
    before = ops.launch_counts()
    got = ops.samd_conv1d(x, k, plan)
    assert _moved(before, ops.launch_counts()) == {"samd_conv1d_launch"}
    want = torch.nn.functional.conv1d(
        x.double()[None, None], k.flip(0).double()[None, None],
        padding=2)[0, 0]
    assert torch.equal(got.cpu(), want.round().int().cpu())
    edge = torch.tensor([0, 1, -1, -2 ** 31, 2 ** 31 - 1, -0x55555556,
                         0x55555555, -65536, 65535, -0x77777778],
                        dtype=torch.int32)
    words = torch.cat([edge.repeat_interleave(10),
                       torch.randint(-2 ** 31, 2 ** 31 - 1, (4096,),
                                     dtype=torch.int32)])
    for kw in edge:
        kw = kw.reshape(1)
        before = ops.launch_counts()
        assert torch.equal(
            sc.samd_conv_chunks_cuda(words.to(cuda), kw.to(cuda), plan).cpu(),
            sc.samd_conv_chunks_plain(words, kw, plan))
        assert _moved(before, ops.launch_counts()) == {
            "samd_conv_chunks_launch"}


def _max_taps(bits, signed):
    """The most taps a 32-bit plan of ``bits`` admits."""
    taps = 1
    while True:
        try:
            conv.make_plan(bits, taps + 1, signed)
        except ValueError:
            return taps
        taps += 1


CONV1D_CASES = [(bits, signed, taps)
                for bits, signed in [(2, True), (3, True), (4, True),
                                     (2, False), (4, False)]
                for taps in sorted({1, 2, 3, _max_taps(bits, signed)})]
CONV1D_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.int32,
                 torch.int64]


def _int_values(gen, dev, n, dtype, bound=1000):
    """Seeded integers of ``dtype`` within +-``bound`` (the dtype's range
    where narrower): mostly outside a plan's b bits, so packing
    truncates them."""
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -bound), min(info.max, bound) + 1,
                         (n,), generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CONV1D_DTYPES, ids=str)
@pytest.mark.parametrize("bits,signed,taps", CONV1D_CASES)
def test_samd_conv1d_fused_kernel_matches_plain(cuda, bits, signed, taps,
                                                dtype):
    """The fused launcher against ``samd_conv1d_plain`` bit for bit, one
    launch a call, at n = 1, lanes - 1, one tile +-1, 100,003 and
    3,211,264 (conv1_2's activations), on x[1:] (not 16-byte aligned)
    and x[::2] (strided), and with a kernel that is a view: every other
    element of a longer tensor, or one value expanded (stride 0)."""
    plan = conv.make_plan(bits, taps, signed)
    lanes = plan.lanes_per_chunk
    tile = sc.conv1d_plan(1, plan, dtype).tile_chunks * lanes
    gen = torch.Generator(device=cuda).manual_seed(bits * 100 + taps)
    k = _int_values(gen, cuda, taps, dtype, 9)
    for n in (1, lanes - 1, tile - 1, tile, tile + 1, 100_003, 3_211_264):
        x = _int_values(gen, cuda, n, dtype)
        before = ops.launch_counts()
        got = ops.samd_conv1d(x, k, plan)
        assert _moved(before, ops.launch_counts()) == {"samd_conv1d_launch"}
        assert got.shape == (n + taps - 1,) and got.dtype == torch.int32
        assert torch.equal(got, sc.samd_conv1d_plain(x, k, plan)), n
    xx = _int_values(gen, cuda, 2 * tile + 7, dtype)
    for view in (xx[1:], xx[::2]):
        assert torch.equal(ops.samd_conv1d(view, k, plan),
                           sc.samd_conv1d_plain(view.contiguous(), k, plan))
    kk = _int_values(gen, cuda, 2 * taps + 1, dtype, 9)
    for kv in (kk[::2][:taps], kk.as_strided((taps,), (0,), 1)):
        assert kv.stride(0) != 1
        assert torch.equal(ops.samd_conv1d(xx, kv, plan),
                           sc.samd_conv1d_plain(xx, kv.contiguous(), plan))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CONV1D_DTYPES, ids=str)
def test_samd_conv1d_fused_kernel_takes_every_lane_count(cuda, dtype):
    """One plan of each lane count a 32-bit word admits (1-32 lanes, the
    widest at 1 bit, where ``conv1d_plan`` shrinks the tile to fit its
    byte budget): the launcher takes the plan's tile and matches
    ``samd_conv1d_plain`` over three tiles and a ragged end."""
    plans = {}
    for bits, signed, taps in itertools.product(range(1, 33), (True, False),
                                                (1, 2, 3)):
        try:
            plan = conv.make_plan(bits, taps, signed)
        except ValueError:
            continue
        plans.setdefault(plan.lanes_per_chunk, plan)
    assert max(plans) == 32
    gen = torch.Generator(device=cuda).manual_seed(11)
    for lanes, plan in sorted(plans.items()):
        tile = sc.conv1d_plan(1, plan, dtype).tile_chunks * lanes
        x = _int_values(gen, cuda, 3 * tile + 5, dtype)
        k = _int_values(gen, cuda, plan.taps, dtype, 9)
        assert torch.equal(ops.samd_conv1d(x, k, plan),
                           sc.samd_conv1d_plain(x, k, plan)), lanes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CONV1D_DTYPES, ids=str)
def test_samd_conv1d_fused_kernel_at_edge_values(cuda, dtype):
    """x and k made of the chunk test's edge values (wrapped into the
    dtype) and the dtype's extremes, at every lane position of a chunk,
    through every plan of ``CONV1D_CASES``."""
    info = torch.iinfo(dtype)
    edge = torch.tensor([0, 1, -1, -2 ** 31, 2 ** 31 - 1, -0x55555556,
                         0x55555555, -65536, 65535, -0x77777778, info.min,
                         info.max, info.min + 1, info.max - 1],
                        dtype=torch.int64)
    vals = edge.to(dtype)
    x = torch.cat([vals.repeat_interleave(7), vals.repeat(5), vals]).to(cuda)
    for bits, signed, taps in CONV1D_CASES:
        plan = conv.make_plan(bits, taps, signed)
        for i in range(len(vals) - taps + 1):
            k = vals[i:i + taps].to(cuda)
            assert torch.equal(ops.samd_conv1d(x, k, plan),
                               sc.samd_conv1d_plain(x, k, plan))


@pytest.mark.cuda
def test_samd_conv1d_fused_kernel_in_a_cuda_graph(cuda):
    """One call captured in a CUDA graph replays to the eager result,
    and to the new result after x is rewritten in place."""
    plan = conv.make_plan(4, 3, True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _int_values(gen, cuda, 100_003, torch.int8)
    k = _int_values(gen, cuda, 3, torch.int8, 8)
    want = ops.samd_conv1d(x, k, plan)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.samd_conv1d(x, k, plan)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    with torch.cuda.graph(graph):
        out = ops.samd_conv1d(x, k, plan)
    assert _moved(before, ops.launch_counts()) == {"samd_conv1d_launch"}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    x.copy_(_int_values(gen, cuda, 100_003, torch.int8))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, sc.samd_conv1d_plain(x, k, plan))
    assert not torch.equal(out, want)


@pytest.mark.cuda
def test_conv_kernels_refuse_what_they_do_not_take(cuda):
    cfg = QuantConfig(bits=4)
    packed, scale = pack_conv_weights(torch.randn(3, 3, 8, 4, device=cuda),
                                      cfg)
    with pytest.raises(TypeError):
        ops.samd_conv2d(torch.randn(8, 5, 5, device=cuda).half(), packed,
                        scale, cfg)
    with pytest.raises(ValueError):
        ops.samd_conv2d(torch.randn(8, 5, 5, device=cuda), packed,
                        scale[:, :2], cfg)
    plan = conv.make_plan(2, 3, True)
    k = torch.ones(3, dtype=torch.int64, device=cuda)
    for dtype in (torch.float32, torch.bfloat16, torch.bool):
        with pytest.raises(TypeError):
            ops.samd_conv1d(torch.zeros(8, device=cuda).to(dtype), k, plan)
    with pytest.raises(TypeError):
        ops.samd_conv1d(torch.zeros(8, dtype=torch.int32, device=cuda),
                        k.float(), plan)
    with pytest.raises(ValueError):
        ops.samd_conv1d(torch.zeros(8, dtype=torch.int32, device=cuda),
                        k[:2], plan)
    with pytest.raises(ValueError):
        ops.samd_conv1d(torch.zeros(2, 8, dtype=torch.int32, device=cuda),
                        k, plan)
    with pytest.raises(TypeError):
        sc.samd_conv_chunks_cuda(torch.zeros(8, device=cuda),
                                 torch.zeros(1, dtype=torch.int32,
                                             device=cuda), plan)


# -- the engine's other modes, qwen3-14b's shapes, shared-memory budgets ----

@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(5120, 151936), (17408, 5120)])
def test_splitk_launcher_at_qwen3_14b_lm_head_and_wd(cuda, k, n):
    """qwen3-14b's packed LM head (K 5120, N 151936) and wd (K 17408,
    N 5120) at decode M = 8: the split-K launcher alone, within TOL of
    its plain version, bit-identical on a second call."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    cfg = QuantConfig(bits=4)
    packed, scale = pack_weights(
        torch.randn(k, n, generator=gen, device=cuda) * 0.02, cfg)
    x = torch.randn(8, k, generator=gen, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    got = ops.samd_matmul(x, packed, scale, k, cfg)
    counts = ops.launch_counts()
    assert counts["samd_matmul_splitk_launch"] == 1
    assert sum(counts.values()) == 1, counts
    assert torch.equal(got, ops.samd_matmul(x, packed, scale, k, cfg))
    _close(got, mm.samd_matmul_plain(x, packed, scale, k, cfg))


@pytest.mark.cuda
def test_smem_estimates_cover_each_launchers_own_bytes(cuda, tmp_path,
                                                       monkeypatch):
    """The shared-memory estimators of ``analysis.contracts`` give at
    least each kernel's own bytes (the source's query: the runtime's
    static bytes of the compiled kernel plus the dynamic bytes its
    launcher passes) and at most the H100's 227 KB, at every plan the
    launchers can take. The query counts at least ptxas's static shared
    memory from a fresh build's log, and gives the same bytes on the
    package's own (possibly cached) build, which has no log."""
    import re
    import types

    from repro_torch.analysis import contracts
    from repro_torch.core.samd import conv_format
    from repro_torch.kernels import _build

    with monkeypatch.context() as mp:
        mp.setattr(_build, "BUILD_DIR", tmp_path)
        fresh = [_build.Kernel(k.name, k.source.name, k.functions)
                 for k in (mm.KERNEL, sc.KERNEL)]
        _build.build_all(fresh)
        for k in fresh:
            k.lib()  # load the fresh libraries while BUILD_DIR points there
    kmm, kconv = fresh

    def static(kern, family):
        best, fn = 0, ""
        for line in kern.build_log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line and family in fn:
                got = re.search(r"(\d+) bytes smem", line)
                best = max(best, int(got.group(1)) if got else 0)
        return best

    def own(fresh_kern, kern, fn, *args):
        got = fresh_kern.query(fn, *args)
        assert got == kern.query(fn, *args), (fn, args)
        return got

    limit = contracts.SMEM_LIMIT_BYTES
    s_mm = static(kmm, "samd_mma_kernel")
    for fn, ms in ((mm.SPLITK, (1, 5, 8, 24, 32)), (mm.TILE, (33, 64, 1024))):
        for vpw in (1, 2, 3, 4, 5, 6, 8, 10, 16, 32):
            for m in ms:
                for splits in (1, 2, 8):
                    got = own(kmm, mm.KERNEL, "samd_matmul_smem_bytes",
                              int(fn == mm.TILE), m, vpw, splits)
                    est = contracts.matmul_smem_bytes(fn, m, vpw, splits)
                    assert s_mm <= got <= est <= limit, (
                        fn, m, vpw, splits, got, est)
    s_mma = static(kconv, "conv_mma_kernel")
    for bits in (2, 4, 8, 10, 16):
        cfg = QuantConfig(bits=bits)
        vpw = cfg.values_per_word
        for x_bf16 in (True, False):
            wide = bits > 9
            if wide and vpw > 3 and not x_bf16:
                continue
            for launcher in (sc.DIRECT, sc.IM2COL):
                plan = sc.conv2d_plan(64, -(-64 // vpw), 28, 28, 3, 3, 128,
                                      1, vpw, x_bf16, launcher)
                pre = static(kconv, "im2col_x_kernel" if launcher ==
                             sc.IM2COL else "stage_x_kernel")
                got = own(kconv, sc.KERNEL, "samd_conv2d_smem_bytes", vpw,
                          int(x_bf16), int(wide), int(launcher == sc.IM2COL))
                est = contracts.conv2d_smem_bytes(plan, vpw, wide)
                assert max(s_mma, pre) <= got <= est <= limit, (
                    bits, x_bf16, launcher)
    s_c1d = static(kconv, "samd_conv1d_kernel")
    for bits in (2, 3, 4):
        plan = conv.ConvPlan(conv_format(bits, 3, True), 3)
        for dtype, x_code in ((torch.int8, 0), (torch.int64, 4)):
            p = sc.conv1d_plan(1 << 20, plan, dtype)
            got = own(kconv, sc.KERNEL, "samd_conv1d_smem_bytes",
                      p.tile_chunks, p.lanes, x_code)
            est = contracts.conv1d_smem_bytes(
                types.SimpleNamespace(tile_chunks=p.tile_chunks,
                                      lanes=p.lanes), dtype.itemsize)
            assert s_c1d <= got <= est <= 48 * 1024, (bits, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [dict(kv_mode="ring"),
                                  dict(paged_attn="gather"),
                                  dict(decode_mode="per_row")],
                         ids=["ring", "gather", "per_row"])
def test_engine_modes_on_card_run_no_plain_version(cuda, monkeypatch, mode):
    """Ring, gather and per-row engines on the card (4-bit weights) with
    every plain version patched to raise: each serves every request in
    full through the split-K and tile launchers, launches no attention
    kernel, and gives the fused paged engine's tokens for most requests
    (attention runs in another order, so a near-tie may part)."""
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = smoke_config("qwen3-14b").scaled(d_model=256, head_dim=64,
                                           d_ff=512, vocab=256)
    prompts = [(torch.arange(5 + 3 * i) * 7 + i).numpy() % 256
               for i in range(6)]

    def run(**kw):
        eng = ServingEngine(cfg, None, quant=QuantConfig(bits=4),
                            max_batch=4, max_len=64, page_size=8,
                            device=cuda, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_tokens=10))
        return eng, {r.rid: r.generated for r in eng.run_to_completion()}

    _, fused = run()

    def plain(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((mm, "samd_matmul_plain"),
                      (pa, "paged_decode_attention_plain"),
                      (pa, "paged_verify_attention_plain")):
        monkeypatch.setattr(mod, name, plain)
    ops.reset_launch_counts()
    eng, got = run(**mode)
    counts = ops.launch_counts()
    assert counts["samd_matmul_splitk_launch"] > 0, counts
    if "decode_mode" not in mode:  # per-row prefills are prompt-long: M <= 32
        assert counts["samd_matmul_tile_launch"] > 0, counts
    assert sum(counts.values()) == (counts["samd_matmul_splitk_launch"]
                                    + counts["samd_matmul_tile_launch"])
    assert all(len(t) == 10 for t in got.values()) and len(got) == 6
    assert sum(got[i] == fused[i] for i in got) * 2 >= len(got)
    if "decode_mode" in mode:
        assert eng.stats["per_row_forward_calls"] > 0


# -- the other families (MoE, RWKV6, hybrid Mamba2) --------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hkv,g", [(16, 1), (8, 6)])
def test_paged_attention_kernel_at_olmoe_and_nemotron(cuda, hkv, g, packed):
    """Decode at olmoe-1b-7b's attention shape (16 heads, G = 1, dh =
    128: one query row a stream) and nemotron-4-15b's (8 kv-heads, G =
    6, dh = 128)."""
    gen = torch.Generator(device=cuda).manual_seed(11 + g + packed)
    args, kw = _paged_inputs(cuda, gen, 8, hkv, g, 128, 16, 32, packed)
    got = ops.paged_decode_attention(*args, **kw)
    _close(got, pa.paged_decode_attention_plain(*args, **kw))
    assert (got[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "rwkv6-3b", "zamba2-7b"])
def test_family_engines_on_card_run_no_plain_version(cuda, monkeypatch,
                                                     arch):
    """Smoke olmoe (paged), rwkv6 and zamba2 (ring) engines on the card,
    4-bit weights, every plain version patched to raise: each serves
    every request in full (more requests than slots) through the split-K
    and tile launchers, olmoe's decode attention through the paged
    kernel, the recurrent families with no attention kernel and no
    per-row forward."""
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = smoke_config(arch).scaled(d_model=256, head_dim=64, d_ff=512,
                                    vocab=256)

    def plain(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((mm, "samd_matmul_plain"),
                      (pa, "paged_decode_attention_plain"),
                      (pa, "paged_verify_attention_plain")):
        monkeypatch.setattr(mod, name, plain)
    eng = ServingEngine(cfg, None, quant=QuantConfig(bits=4), max_batch=2,
                        max_len=96, page_size=8, device=cuda)
    for i in range(5):
        eng.submit(Request(rid=i, prompt=(torch.arange(34 + 5 * i) * 7 + i)
                           .numpy() % 256, max_tokens=10))
    ops.reset_launch_counts()
    done = eng.run_to_completion()
    counts = ops.launch_counts()
    want = {"samd_matmul_splitk_launch", "samd_matmul_tile_launch"}
    if cfg.family == "moe":
        want.add("paged_decode_attention_launch")
        assert eng.kv_mode == "paged"
    else:
        assert eng.kv_mode == "ring"
        assert eng.stats["per_row_forward_calls"] == 0
    assert {fn for fn, c in counts.items() if c} == want, counts
    assert len(done) == 5
    assert all(r.error is None and not r.truncated
               and len(r.generated) == 10 for r in done)
