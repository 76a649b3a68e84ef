"""Port parity of the 64-bit SAMD words (the paper's own CPU
configuration): ``repro_torch`` against the JAX reference ``repro`` on the
same seeded numpy inputs, on the CPU, bit for bit.

The reference needs JAX's 64-bit mode for ``uint64`` words; it runs only
inside ``with jax.enable_x64(True):`` (``_x64``), so the mode does not
leak into other test files that share a worker process. The port holds a
64-bit word as int64 with the same bits, so words are compared as int64
bit patterns. Every lane function takes every pair of a set of edge
words (carries and borrows at the word's edges, all lane MSBs set), then
random pairs.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import codegen as jcodegen  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import overflow as joverflow  # noqa: E402
from repro.core import samd as jsamd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import codegen, conv, masks, overflow, samd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # JAX's CPU thread pool and torch's OpenMP threads oversubscribe the
    # cores when both run in one process; these shapes are tiny anyway
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x64():
    return jax.enable_x64(True)


def _t(a) -> torch.Tensor:
    """A numpy or JAX array as a torch tensor; uint64 words keep their
    bits as int64, uint32 words as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    """Words of either package as signed bit patterns of their width."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def _eq(got, want):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


EDGE64 = [0, 1, (1 << 64) - 1, 1 << 63, (1 << 63) - 1,
          0xAAAAAAAAAAAAAAAA, 0x5555555555555555, 0xFFFFFFFF00000000,
          0x00000000FFFFFFFF, 0x8000000080000000]


def _edge_words(fmt_msb: int, fmt_value_msb: int):
    return np.array(EDGE64 + [fmt_msb, fmt_value_msb,
                              fmt_msb | 1, ~fmt_msb & ((1 << 64) - 1)],
                    dtype=np.uint64)


def _pairs(fmt, seed, n_random=64):
    """Every pair of the edge words (with the format's lane MSBs), then
    random pairs, as uint64."""
    edge = _edge_words(fmt.msb_mask, fmt.value_msb_mask)
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 64, size=(2, n_random), dtype=np.uint64)
    a = np.concatenate([np.repeat(edge, len(edge)), rand[0]])
    b = np.concatenate([np.tile(edge, len(edge)), rand[1]])
    return a, b


# (kind, bits, signed): lanes from 2 to 64 bits wide, 1 to 32 a word;
# values over 32 bits take the reference's int32 truncations
FORMATS = [("dense", 2, True), ("dense", 4, False), ("dense", 7, True),
           ("dense", 16, True), ("perm", 3, True), ("perm", 7, False),
           ("perm", 31, True), ("scale", 4, True), ("scale", 5, False),
           ("scale", 20, True), ("scale", 16, False), ("perm", 40, True),
           ("dense", 64, False)]


def _fmts(kind, bits, signed):
    make = {"dense": samd.dense_format, "perm": samd.perm_format,
            "scale": samd.scale_format}[kind]
    jmake = {"dense": jsamd.dense_format, "perm": jsamd.perm_format,
             "scale": jsamd.scale_format}[kind]
    return make(bits, signed, 64), jmake(bits, signed, 64)


# -- masks and formats --------------------------------------------------------

@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("w", [1, 2, 3, 5, 8, 13, 16, 21, 32])
def test_masks_match_reference(w, word_bits):
    for name in ("msb_lane_mask", "lsb_lane_mask", "lane_mask",
                 "even_lane_mask", "odd_lane_mask"):
        assert getattr(masks, name)(w, word_bits) == getattr(jmasks, name)(
            w, word_bits), name
    for v in range(1, w + 1):
        assert masks.value_mask(v, w, word_bits) == jmasks.value_mask(
            v, w, word_bits)
    assert masks.full_mask(word_bits) == jmasks.full_mask(word_bits)


@pytest.mark.parametrize("kind,bits,signed", FORMATS)
def test_formats_match_reference(kind, bits, signed):
    fmt, jfmt = _fmts(kind, bits, signed)
    for name in ("lanes_per_word", "msb_mask", "value_msb_mask",
                 "value_bits_mask", "lane_bits_mask"):
        assert getattr(fmt, name) == getattr(jfmt, name), name
    assert fmt.dtype == samd.word_dtype(64) == torch.int64
    assert samd.word_dtype(32) == torch.int32
    with pytest.raises(ValueError):
        samd.word_dtype(16)


# -- pack and unpack ----------------------------------------------------------

@pytest.mark.parametrize("kind,bits,signed", FORMATS)
def test_pack_unpack_match_reference(kind, bits, signed):
    fmt, jfmt = _fmts(kind, bits, signed)
    rng = np.random.default_rng(bits)
    lo, hi = (-(1 << 31), 1 << 31)  # past the format: truncated alike
    vals = rng.integers(lo, hi, size=(3, 37)).astype(np.int64)
    vals[0, :6] = [0, -1, 1, (1 << 31) - 1, -(1 << 31), 1 << min(bits - 1, 31)]
    words = samd.pack(torch.from_numpy(vals), fmt)
    with _x64():
        jwords = jsamd.pack(jnp.asarray(vals), jfmt)
        _eq(words, jwords)
        a, _ = _pairs(jfmt, bits)
        for n in (1, fmt.lanes_per_word, 2 * fmt.lanes_per_word - 1):
            want = jsamd.unpack(jnp.asarray(a), jfmt, n)
            wide = jsamd.unpack_lanes_wide(jnp.asarray(a), jfmt, n)
            _eq(samd.unpack(_t(a), fmt, n), want)
            _eq(samd.unpack_lanes_wide(_t(a), fmt, n), wide)
        _eq(samd.unpack(words, fmt, 37),
            jsamd.unpack(jwords, jfmt, 37))


# -- lane-wise arithmetic -----------------------------------------------------

@pytest.mark.parametrize("kind,bits,signed", FORMATS)
@pytest.mark.parametrize("op", ["samd_add", "samd_sub", "samd_add_perm",
                                "samd_mul"])
def test_lane_arithmetic_matches_reference(op, kind, bits, signed):
    fmt, jfmt = _fmts(kind, bits, signed)
    a, b = _pairs(fmt, bits)
    got = getattr(samd, op)(_t(a), _t(b), fmt)
    with _x64():
        want = getattr(jsamd, op)(jnp.asarray(a), jnp.asarray(b), jfmt)
        _eq(got, want)


@pytest.mark.parametrize("kind,bits,signed", FORMATS)
def test_sign_extend_scale_and_fixups_match_reference(kind, bits, signed):
    fmt, jfmt = _fmts(kind, bits, signed)
    a, b = _pairs(fmt, bits + 1)
    ta, tb = _t(a), _t(b)
    with _x64():
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        pairs = [
            (samd.sign_extend_for_mul(ta, fmt),
             jsamd.sign_extend_for_mul(ja, jfmt)),
            (samd.vector_scale_perm(ta, tb, fmt),
             jsamd.vector_scale_perm(ja, jb, jfmt)),
            (samd.correct_signed_product(ta, fmt),
             jsamd.correct_signed_product(ja, jfmt)),
            (samd.correct_signed_product_perm(ta, fmt),
             jsamd.correct_signed_product_perm(ja, jfmt)),
            (samd.unpack_signed_product(ta, fmt, 3),
             jsamd.unpack_signed_product(ja, jfmt, 3)),
        ]
        if kind == "dense" and 2 * bits <= 64:
            pat = b & np.uint64((1 << bits) - 1)  # the b-bit pattern
            pairs.append((samd.vector_scale_temp(ta, _t(pat), fmt),
                          jsamd.vector_scale_temp(ja, jnp.asarray(pat),
                                                  jfmt)))
        for got, want in pairs:
            _eq(got, want)


@pytest.mark.parametrize("word_bits", [32, 64])
def test_double_word_helpers_match_reference(word_bits):
    """dw_add (carries out of the low half), dw_bitand and dw_bitxor on
    (hi, lo) pairs of either width; the 64-bit widening product against
    the reference's and against Python's exact product."""
    fmt = samd.dense_format(3, True, word_bits)
    a, b = _pairs(fmt, word_bits)
    if word_bits == 32:
        a, b = a.astype(np.uint32), b.astype(np.uint32)
    m_hi, m_lo = 0xF0F0F0F0, 0x0FF00FF0
    with _x64():
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        for got, want in zip(samd.dw_add((_t(b), _t(a)), (_t(a), _t(b))),
                             jsamd.dw_add((jb, ja), (ja, jb))):
            _eq(got, want)
        for got, want in zip(samd.dw_bitxor((_t(a), _t(b)), (_t(b), _t(b))),
                             jsamd.dw_bitxor((ja, jb), (jb, jb))):
            _eq(got, want)
        for got, want in zip(samd.dw_bitand((_t(a), _t(b)), m_hi, m_lo),
                             jsamd.dw_bitand((ja, jb), m_hi, m_lo)):
            _eq(got.to(torch.int64),
                np.asarray(want).astype(np.uint64).astype(
                    a.dtype).view(_bits(a).dtype).astype(np.int64))
        if word_bits == 64:
            hi, lo = conv._widening_mul(_t(a), _t(b), fmt)
            jhi, jlo = jconv._widening_mul(ja, jb, 64)
            _eq(hi, jhi)
            _eq(lo, jlo)
            full = [(int(x) * int(y)) for x, y in zip(a, b)]
            got = [(int(h) << 64) | int(low) for h, low in zip(
                hi.numpy().view(np.uint64), lo.numpy().view(np.uint64))]
            assert got == full


# -- conv as multiplication at 64-bit words -----------------------------------

def _rand(bits, signed, shape, rng):
    lo, hi = overflow.input_range(bits, signed)
    return rng.integers(lo, hi + 1, size=shape)


def _ref(fn, *args):
    with _x64():
        return np.asarray(fn(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args]))


@pytest.mark.parametrize("taps", [1, 2, 3, 5])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_conv_full_matches_reference_and_numpy(bits, signed, taps):
    rng = np.random.default_rng(bits * 10 + taps + signed)
    x = _rand(bits, signed, (2, 71), rng)
    k = _rand(bits, signed, taps, rng)
    with _x64():
        try:
            jplan = jconv.make_plan(bits, taps, signed, word_bits=64)
        except ValueError:
            with pytest.raises(ValueError, match="does not fit a 64-bit"):
                conv.make_plan(bits, taps, signed, word_bits=64)
            return
    plan = conv.make_plan(bits, taps, signed, word_bits=64)
    assert plan.fmt == samd.SAMDFormat(bits, jplan.fmt.lane_width, signed, 64)
    x[0, :3] = overflow.input_range(bits, signed)[0]  # extreme chunks
    got = conv.samd_conv_full(torch.from_numpy(x), torch.from_numpy(k), plan)
    want = _ref(lambda x_, k_: jconv.samd_conv_full(x_, k_, jplan), x, k)
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(2):
        np.testing.assert_array_equal(got[r].numpy(), np.convolve(x[r], k))
    got_v = conv.samd_correlate_valid(torch.from_numpy(x[0]),
                                      torch.from_numpy(k), plan)
    np.testing.assert_array_equal(
        got_v.numpy(), _ref(lambda x_, k_: jconv.samd_correlate_valid(
            x_, k_, jplan), x[0], k))


@pytest.mark.parametrize("lane_width", [None, 12, 20, 31, 40])
def test_chunk_products_and_lanes_match_reference(lane_width):
    """The pipeline's stages one by one at 64-bit words: chunk words, the
    kernel word, the (hi, lo) product after the Grys adjustment and the
    borrow fixup, and the extracted lanes (lanes straddling the halves
    and lanes over 32 bits wide, which wrap to int32 in both)."""
    lw = lane_width or 0
    bits, taps = 4, (1 if lw > 32 else 2 if lw > 21 else 3)
    plan = conv.make_plan(bits, taps, True, 64, lane_width=lane_width)
    rng = np.random.default_rng(lane_width or 0)
    x = _rand(bits, True, 40, rng)
    k = _rand(bits, True, taps, rng)
    k[0] = -8
    with _x64():
        jplan = jconv.make_plan(bits, taps, True, 64, lane_width=lane_width)
        jxw = jconv.pack_conv_operand(jnp.asarray(x), jplan)
        jkw = jconv.pack_conv_kernel(jnp.asarray(k), jplan)
        jhi, jlo = jconv.chunk_products(jxw, jkw, jplan)
        jext = jconv.extract_outputs(jhi, jlo, jplan)
    xw = conv.pack_conv_operand(torch.from_numpy(x), plan)
    kw = conv.pack_conv_kernel(torch.from_numpy(k), plan)
    hi, lo = conv.chunk_products(xw, kw, plan)
    _eq(xw, jxw)
    _eq(kw, jkw)
    _eq(hi, jhi)
    _eq(lo, jlo)
    _eq(conv.extract_outputs(hi, lo, plan), jext)


@pytest.mark.parametrize("bits,channels", [(2, 3), (2, 12), (3, 9), (4, 4),
                                           (3, 64), (4, 64)])
def test_multichannel_matches_reference(bits, channels):
    """Lanes from the §7 analysis of the kernel at 64-bit words; over 8
    channels takes the reference's scan branch. At 64 channels of 3 and
    4 bits the plan does not fit a 32-bit word (the reference refuses
    it), but a 64-bit word holds it."""
    rng = np.random.default_rng(bits + channels)
    k = _rand(bits, True, (channels, 3), rng)
    x = _rand(bits, True, (channels, 30), rng)
    plan = overflow.plan_for_kernel(k, bits, True, bits, word_bits=64)
    with _x64():
        jplan = joverflow.plan_for_kernel(k, bits, True, bits, word_bits=64)
    assert plan.fmt == samd.SAMDFormat(jplan.fmt.bits, jplan.fmt.lane_width,
                                       True, 64)
    if channels == 64 and bits > 2:
        for plan_for in (overflow.plan_for_kernel,
                         joverflow.plan_for_kernel):
            with pytest.raises(ValueError, match="32-bit word"):
                plan_for(k, bits, True, bits)
    got = conv.samd_conv_multichannel(torch.from_numpy(x),
                                      torch.from_numpy(k), plan)
    want = _ref(lambda x_, k_: jconv.samd_conv_multichannel(x_, k_, jplan),
                x, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), sum(np.convolve(x[c], k[c]) for c in range(channels)))


@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("bits,channels", [(2, 5), (2, 40), (3, 9), (4, 7),
                                           (4, 64)])
def test_grouped_matches_reference(bits, channels, word_bits):
    rng = np.random.default_rng(bits * channels + word_bits)
    k = _rand(bits, True, (channels, 3), rng)
    x = _rand(bits, True, (channels, 33), rng)
    got = conv.samd_conv_grouped(torch.from_numpy(x), torch.from_numpy(k),
                                 bits, word_bits=word_bits)
    want = _ref(lambda x_, k_: jconv.samd_conv_grouped(
        x_, k_, bits, word_bits=word_bits), x, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), sum(np.convolve(x[c], k[c]) for c in range(channels)))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [4, 8, 12, 16])
def test_conv_by_scale_matches_reference(bits, signed):
    """The vector-scale fallback at 64-bit words (lanes of 2b bits, up to
    32). Its int32 output is the exact convolution mod 2^32: at 16 bits
    a sum of four products can pass 2^31, and both packages wrap."""
    rng = np.random.default_rng(bits + 7 * signed)
    x = _rand(bits, signed, (2, 29), rng)
    k = _rand(bits, signed, 4, rng)
    x[0, 0] = k[0] = overflow.input_range(bits, signed)[0]
    got = conv.conv_by_scale(torch.from_numpy(x), torch.from_numpy(k), bits,
                             signed, word_bits=64)
    want = _ref(lambda x_, k_: jconv.conv_by_scale(x_, k_, bits, signed,
                                                   word_bits=64), x, k)
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(2):
        np.testing.assert_array_equal(
            got[r].numpy(), np.convolve(x[r], k).astype(np.int32))


# -- paper_compat -------------------------------------------------------------

@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 6, 8, 12])
def test_paper_compat_lanes_match_reference(bits, signed, word_bits):
    for taps in (1, 2, 3, 4, 5, 9):
        for compat in (False, True):
            assert samd.conv_lane_width(bits, taps, signed, compat) == (
                jsamd.conv_lane_width(bits, taps, signed, compat))
            fmt = samd.conv_format(bits, taps, signed, word_bits, compat)
            jfmt = jsamd.conv_format(bits, taps, signed, word_bits, compat)
            assert (fmt.lane_width, fmt.lanes_per_word) == (
                jfmt.lane_width, jfmt.lanes_per_word)
            try:
                with _x64():
                    jplan = jconv.make_plan(bits, taps, signed, word_bits,
                                            paper_compat=compat)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    conv.make_plan(bits, taps, signed, word_bits,
                                   paper_compat=compat)
                continue
            plan = conv.make_plan(bits, taps, signed, word_bits,
                                  paper_compat=compat)
            assert plan.fmt.lane_width == jplan.fmt.lane_width


@pytest.mark.parametrize("signed", [False, True])
def test_paper_compat_conv_matches_reference(signed):
    """A paper-sized (2b + 2 at 3 taps) plan's convolution, 64-bit words."""
    rng = np.random.default_rng(3 + signed)
    x, k = _rand(4, signed, 50, rng), _rand(4, signed, 3, rng)
    plan = conv.make_plan(4, 3, signed, 64, paper_compat=True)
    assert plan.fmt.lane_width == 10
    with _x64():
        jplan = jconv.make_plan(4, 3, signed, 64, paper_compat=True)
    got = conv.samd_conv_full(torch.from_numpy(x), torch.from_numpy(k), plan)
    np.testing.assert_array_equal(
        got.numpy(), _ref(lambda x_, k_: jconv.samd_conv_full(x_, k_, jplan),
                          x, k))
    np.testing.assert_array_equal(got.numpy(), np.convolve(x, k))


# -- codegen at both widths ---------------------------------------------------

def _counts(op):
    return dataclasses.astuple(op.counts)


@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("regime", ["temporary", "permanent"])
@pytest.mark.parametrize("bits", [2, 4, 7])
def test_codegen_pointwise_matches_reference(bits, regime, signed,
                                             word_bits):
    ops_ = codegen.generate_pointwise(bits, regime, signed, word_bits)
    fmt = ops_["add"].fmt
    a, b = _pairs(samd.SAMDFormat(fmt.bits, fmt.lane_width, signed, 64),
                  bits + word_bits, n_random=32)
    if word_bits == 32:
        a, b = a.astype(np.uint32), b.astype(np.uint32)
    with _x64():
        jops_ = jcodegen.generate_pointwise(bits, regime, signed, word_bits)
        for name, op in ops_.items():
            jop = jops_[name]
            assert (op.name, _counts(op), op.values_per_word) == (
                jop.name, _counts(jop), jop.values_per_word)
            _eq(op.fn(_t(a), _t(b)), jop.fn(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("word_bits", [32, 64])
@pytest.mark.parametrize("paper_compat", [False, True])
@pytest.mark.parametrize("bits,channels", [(2, 1), (3, 1), (2, 4), (4, 1)])
def test_codegen_conv_matches_reference(bits, channels, paper_compat,
                                        word_bits):
    rng = np.random.default_rng(bits * channels + word_bits)
    kw = dict(regime="permanent", channels=channels,
              paper_compat=paper_compat)
    with _x64():
        jop = jcodegen.generate_conv(bits, 3, True, word_bits, **kw)
        op = codegen.generate_conv(bits, 3, True, word_bits, **kw)
        assert (op.name, _counts(op), op.values_per_word, op.fmt) == (
            jop.name, _counts(jop), jop.values_per_word,
            samd.SAMDFormat(jop.fmt.bits, jop.fmt.lane_width, True,
                            word_bits))
        shape = (channels, 30) if channels > 1 else (30,)
        x = _rand(bits, True, shape, rng)
        k = _rand(bits, True, (channels, 3) if channels > 1 else 3, rng)
        np.testing.assert_array_equal(
            op.fn(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
            np.asarray(jop.fn(jnp.asarray(x), jnp.asarray(k))))
    kernel = _rand(bits, True, (8, 3), rng)
    with _x64():
        jop = jcodegen.generate_conv(bits, 3, True, 64, kernel=kernel,
                                     channels=8)
    op = codegen.generate_conv(bits, 3, True, 64, kernel=kernel, channels=8)
    assert (_counts(op), op.fmt.lane_width) == (_counts(jop),
                                                jop.fmt.lane_width)


# -- the fused conv1d kernel takes 32-bit words only --------------------------

def test_samd_conv1d_refuses_a_64_bit_plan_where_the_reference_is_wrong():
    """A kept difference: the reference's op runs its uint32 Pallas
    kernel on a 64-bit plan's words and returns wrong values without an
    error; the port raises ValueError, on either device, and points at
    ``core.conv.samd_conv_full``, which is right."""
    rng = np.random.default_rng(0)
    x, k = _rand(4, True, 200, rng), np.array([3, -8, 7])
    with _x64():
        jplan = jconv.make_plan(4, 3, True, word_bits=64)
        bad = np.asarray(jops.samd_conv1d(jnp.asarray(x), jnp.asarray(k),
                                          jplan))
    assert not np.array_equal(bad, np.convolve(x, k))
    plan = conv.make_plan(4, 3, True, word_bits=64)
    with pytest.raises(ValueError, match="32-bit words.*samd_conv_full"):
        ops.samd_conv1d(torch.from_numpy(x), torch.from_numpy(k), plan)
    np.testing.assert_array_equal(
        conv.samd_conv_full(torch.from_numpy(x), torch.from_numpy(k),
                            plan).numpy(), np.convolve(x, k))
