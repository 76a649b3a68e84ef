"""Port parity of the convolution slice: ``repro_torch`` against the JAX
reference ``repro`` on the same seeded numpy inputs, on the CPU.

Integer results are compared bit for bit: SAMD words (as int32 bits),
conv outputs, chunk lanes and op counts. ``samd_conv2d`` computes in f32
on both sides and differs only in summation order, so it is held to
atol = 1e-5 x max |out| (rtol 1e-5): a 3x3 x C_in <= 40 sum of products
of magnitude ~1e2 carries ~1e-5 relative f32 rounding. The CUDA kernels
are held against the plain versions on a card by ``test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402
import itertools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import codegen as jcodegen  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.core import overflow as joverflow  # noqa: E402
from repro.core import samd as jsamd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.quant import packing as jpacking  # noqa: E402
from repro_torch.configs.vggb import VGGB_LAYERS  # noqa: E402
from repro_torch.core import codegen, conv, overflow, samd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import samd_conv as sc  # noqa: E402
from repro_torch.quant import packing  # noqa: E402
from repro_torch.quant.config import QuantConfig  # noqa: E402

CONV2D_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # JAX's CPU thread pool and torch's OpenMP threads oversubscribe the
    # cores when both run in one process; these shapes are tiny anyway
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor; uint32 words keep their
    bits as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _words(a) -> np.ndarray:
    """Words of either package as int32 bit patterns."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _rand(bits, signed, shape, rng):
    lo, hi = overflow.input_range(bits, signed)
    return rng.integers(lo, hi + 1, size=shape)


# -- core/conv -----------------------------------------------------------------

@pytest.mark.parametrize("taps", [2, 3])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_conv_full_matches_reference_and_numpy(bits, signed, taps):
    rng = np.random.default_rng(bits * 10 + taps + signed)
    x = _rand(bits, signed, 65, rng)
    k = _rand(bits, signed, taps, rng)
    jplan, plan = (jconv.make_plan(bits, taps, signed),
                   conv.make_plan(bits, taps, signed))
    assert plan.fmt.lane_width == jplan.fmt.lane_width
    got = conv.samd_conv_full(torch.from_numpy(x), torch.from_numpy(k), plan)
    want = jconv.samd_conv_full(jnp.asarray(x), jnp.asarray(k), jplan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.convolve(x, k))


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_correlate_valid_matches_reference(bits):
    rng = np.random.default_rng(bits)
    x, k = _rand(bits, True, 40, rng), _rand(bits, True, 3, rng)
    got = conv.samd_correlate_valid(torch.from_numpy(x), torch.from_numpy(k),
                                    conv.make_plan(bits, 3, True))
    want = jconv.samd_correlate_valid(jnp.asarray(x), jnp.asarray(k),
                                      jconv.make_plan(bits, 3, True))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.correlate(x, k, mode="valid"))


@pytest.mark.parametrize("bits,channels", [(2, 2), (2, 4), (2, 12), (3, 2),
                                           (3, 4), (4, 2)])
def test_multichannel_matches_reference(bits, channels):
    """§7 lane sizing from the actual kernel; 12 channels takes the
    reference's scan branch (over 8)."""
    rng = np.random.default_rng(bits + channels)
    k = _rand(bits, True, (channels, 3), rng)
    x = _rand(bits, True, (channels, 30), rng)
    plan = overflow.plan_for_kernel(k, bits, input_signed=True,
                                    kernel_bits=bits)
    jplan = joverflow.plan_for_kernel(k, bits, input_signed=True,
                                      kernel_bits=bits)
    assert (plan.fmt.lane_width, plan.fmt.bits) == (jplan.fmt.lane_width,
                                                    jplan.fmt.bits)
    got = conv.samd_conv_multichannel(torch.from_numpy(x),
                                      torch.from_numpy(k), plan)
    want = jconv.samd_conv_multichannel(jnp.asarray(x), jnp.asarray(k), jplan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), sum(np.convolve(x[c], k[c]) for c in range(channels)))


@pytest.mark.parametrize("bits,channels", [(2, 5), (2, 40), (3, 9), (4, 7)])
def test_grouped_matches_reference(bits, channels):
    rng = np.random.default_rng(bits * channels)
    k = _rand(bits, True, (channels, 3), rng)
    x = _rand(bits, True, (channels, 33), rng)
    got = conv.samd_conv_grouped(torch.from_numpy(x), torch.from_numpy(k),
                                 bits)
    want = jconv.samd_conv_grouped(jnp.asarray(x), jnp.asarray(k), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), sum(np.convolve(x[c], k[c]) for c in range(channels)))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_conv_by_scale_matches_reference(bits, signed):
    rng = np.random.default_rng(bits + 7 * signed)
    x, k = _rand(bits, signed, 44, rng), _rand(bits, signed, 5, rng)
    got = conv.conv_by_scale(torch.from_numpy(x), torch.from_numpy(k), bits,
                             signed)
    want = jconv.conv_by_scale(jnp.asarray(x), jnp.asarray(k), bits, signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.convolve(x, k))


def test_plans_refuse_what_the_reference_refuses():
    with pytest.raises(ValueError, match="does not fit"):
        conv.make_plan(5, 3, True)
    with pytest.raises(ValueError, match="does not fit"):
        jconv.make_plan(5, 3, True)
    # 64-bit words: the plans the reference makes, and its convolution
    import jax

    x = np.random.default_rng(5).integers(-2, 2, 40)
    k = np.array([1, -2, 1])
    with jax.enable_x64(True):
        jplan = jconv.make_plan(2, 3, True, word_bits=64)
        want = np.asarray(jconv.samd_conv_full(jnp.asarray(x),
                                               jnp.asarray(k), jplan))
        with pytest.raises(ValueError, match="does not fit"):
            jconv.make_plan(11, 3, True, word_bits=64)
    plan = conv.make_plan(2, 3, True, word_bits=64)
    assert plan == conv.ConvPlan(samd.SAMDFormat(
        2, jplan.fmt.lane_width, True, 64), 3)
    got = conv.samd_conv_full(torch.from_numpy(x), torch.from_numpy(k), plan)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.convolve(x, k))
    with pytest.raises(ValueError, match="does not fit"):
        conv.make_plan(11, 3, True, word_bits=64)


# -- core/samd lane helpers ------------------------------------------------------

# words with carries at the word's edges: all ones, the top bit alone, lane
# MSBs set, and random words
EDGE_WORDS = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xAAAAAAAA,
                       0x55555555, 0xFFFF0000, 0x0000FFFF, 0x88888888],
                      dtype=np.uint32)


def _word_pair(seed):
    """Every pair of edge words, then 64 random pairs (uint32)."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 32, size=(2, 64), dtype=np.uint64)
    a = np.concatenate([np.repeat(EDGE_WORDS, len(EDGE_WORDS)),
                        rand[0].astype(np.uint32)])
    b = np.concatenate([np.tile(EDGE_WORDS, len(EDGE_WORDS)),
                        rand[1].astype(np.uint32)])
    return a, b


FORMATS = [("dense", 3, True), ("dense", 4, False), ("perm", 3, True),
           ("perm", 7, False), ("scale", 4, True), ("scale", 5, False)]


def _fmts(kind, bits, signed):
    make = {"dense": samd.dense_format, "perm": samd.perm_format,
            "scale": samd.scale_format}[kind]
    jmake = {"dense": jsamd.dense_format, "perm": jsamd.perm_format,
             "scale": jsamd.scale_format}[kind]
    return make(bits, signed), jmake(bits, signed)


@pytest.mark.parametrize("kind,bits,signed", FORMATS)
@pytest.mark.parametrize("op", ["samd_add", "samd_sub", "samd_add_perm",
                                "samd_mul"])
def test_lane_arithmetic_matches_reference(op, kind, bits, signed):
    fmt, jfmt = _fmts(kind, bits, signed)
    assert (fmt.msb_mask, fmt.value_msb_mask, fmt.value_bits_mask) == (
        jfmt.msb_mask, jfmt.value_msb_mask, jfmt.value_bits_mask)
    a, b = _word_pair(bits)
    got = getattr(samd, op)(_t(a), _t(b), fmt)
    want = getattr(jsamd, op)(jnp.asarray(a), jnp.asarray(b), jfmt)
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("kind,bits,signed", FORMATS)
def test_sign_extend_scale_and_fixup_match_reference(kind, bits, signed):
    fmt, jfmt = _fmts(kind, bits, signed)
    a, b = _word_pair(bits + 1)
    pairs = [
        (samd.sign_extend_for_mul(_t(a), fmt),
         jsamd.sign_extend_for_mul(jnp.asarray(a), jfmt)),
        (samd.vector_scale_perm(_t(a), _t(b), fmt),
         jsamd.vector_scale_perm(jnp.asarray(a), jnp.asarray(b), jfmt)),
        (samd.correct_signed_product(_t(a), fmt),
         jsamd.correct_signed_product(jnp.asarray(a), jfmt)),
        (samd.unpack_lanes_wide(_t(a), fmt, 5),
         jsamd.unpack_lanes_wide(jnp.asarray(a), jfmt, 5)),
        (samd.unpack_signed_product(_t(a), fmt, 5),
         jsamd.unpack_signed_product(jnp.asarray(a), jfmt, 5)),
    ]
    if kind == "dense":
        pat = b & np.uint32((1 << bits) - 1)  # the b-bit pattern
        pairs.append((samd.vector_scale_temp(_t(a), _t(pat), fmt),
                      jsamd.vector_scale_temp(jnp.asarray(a),
                                              jnp.asarray(pat), jfmt)))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), _words(want))


def test_wide_multiply_and_dw_add_match_reference():
    a, b = _word_pair(3)
    hi, lo = samd.mul_wide_u32(_t(a), _t(b))
    jhi, jlo = jsamd.mul_wide_u32(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(hi.numpy(), _words(jhi))
    np.testing.assert_array_equal(lo.numpy(), _words(jlo))
    full = a.astype(np.uint64) * b.astype(np.uint64)  # mod 2^64
    np.testing.assert_array_equal(
        (hi.numpy().view(np.uint32).astype(np.uint64) << np.uint64(32))
        | lo.numpy().view(np.uint32).astype(np.uint64), full)
    # carries out of the low half at every edge word
    s = samd.dw_add((_t(b), _t(a)), (_t(a), _t(b)))
    js = jsamd.dw_add((jnp.asarray(b), jnp.asarray(a)),
                      (jnp.asarray(a), jnp.asarray(b)))
    for got, want in zip(s, js):
        np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("w", [2, 3, 5, 8])
def test_masks_and_formats_match_reference(w, signed):
    from repro.core import masks as jmasks
    from repro_torch.core import masks

    assert masks.even_lane_mask(w) == jmasks.even_lane_mask(w)
    assert masks.odd_lane_mask(w) == jmasks.odd_lane_mask(w)
    for taps in (1, 2, 3, 5):
        assert samd.conv_lane_width(w, taps, signed) == (
            jsamd.conv_lane_width(w, taps, signed))


# -- core/overflow -----------------------------------------------------------

@pytest.mark.parametrize("input_signed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overflow_matches_reference(seed, input_signed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-7 if seed else 0, 8, size=(4, 3))
    for fn, args in [
        ("conv_output_range", (k, 4, input_signed)),
        ("conv_output_bits", (k, 4, input_signed)),
        ("generic_output_bits", (4, 9, 3, True, input_signed)),
        ("dot_range", (k, -3, 11)),
        ("bits_required_signed", (-100 - seed, 37)),
        ("bits_required_unsigned", (1000 + seed,)),
    ]:
        assert getattr(overflow, fn)(*args) == getattr(joverflow, fn)(*args)
    plan = overflow.plan_for_kernel(k[:1], 3, input_signed, 3)
    jplan = joverflow.plan_for_kernel(k[:1], 3, input_signed, 3)
    assert (plan.taps, plan.fmt.bits, plan.fmt.lane_width,
            plan.fmt.signed) == (jplan.taps, jplan.fmt.bits,
                                 jplan.fmt.lane_width, jplan.fmt.signed)


# -- core/codegen --------------------------------------------------------------

def _counts(op):
    return dataclasses.astuple(op.counts)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("regime", ["temporary", "permanent"])
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_codegen_matches_reference(bits, regime, signed):
    rng = np.random.default_rng(bits)
    ops_, jops_ = (codegen.generate_pointwise(bits, regime, signed),
                   jcodegen.generate_pointwise(bits, regime, signed))
    a, b = _word_pair(bits + 5)
    for name, op in ops_.items():
        jop = jops_[name]
        assert (op.name, _counts(op), op.values_per_word) == (
            jop.name, _counts(jop), jop.values_per_word)
        np.testing.assert_array_equal(
            op.fn(_t(a), _t(b)).numpy(),
            _words(jop.fn(jnp.asarray(a), jnp.asarray(b))))
    if bits == 4:  # 4 channels of 4-bit products overflow a 32-bit kernel
        for gen in (codegen.generate_conv, jcodegen.generate_conv):
            with pytest.raises(ValueError, match="does not fit"):
                gen(bits, 3, signed, regime=regime, channels=4)
    for channels in (1, 4) if bits < 4 else (1,):
        op = codegen.generate_conv(bits, 3, signed, regime=regime,
                                   channels=channels)
        jop = jcodegen.generate_conv(bits, 3, signed, regime=regime,
                                     channels=channels)
        assert (op.name, _counts(op), op.values_per_word,
                op.fmt.lane_width) == (jop.name, _counts(jop),
                                       jop.values_per_word,
                                       jop.fmt.lane_width)
        shape = (channels, 30) if channels > 1 else (30,)
        x = _rand(bits, signed, shape, rng)
        k = _rand(bits, signed, (channels, 3) if channels > 1 else 3, rng)
        np.testing.assert_array_equal(
            op.fn(torch.from_numpy(x), torch.from_numpy(k)).numpy(),
            np.asarray(jop.fn(jnp.asarray(x), jnp.asarray(k))))
    assert dataclasses.astuple(codegen.native_conv_counts(3, 4)) == (
        dataclasses.astuple(jcodegen.native_conv_counts(3, 4)))


def test_codegen_with_a_known_kernel_matches_reference():
    k = np.array([[1, -2, 1], [0, 3, -1]])
    op = codegen.generate_conv(2, 3, True, kernel=k, channels=2)
    jop = jcodegen.generate_conv(2, 3, True, kernel=k, channels=2)
    assert (_counts(op), op.fmt.lane_width) == (_counts(jop),
                                                jop.fmt.lane_width)
    assert op.counts_per_value() == jop.counts_per_value()


# -- quant/packing -------------------------------------------------------------

@pytest.mark.parametrize("c_in", [3, 19, 64])
@pytest.mark.parametrize("bits,spacer", [(2, "temporary"), (4, "temporary"),
                                         (4, "permanent"), (8, "temporary")])
def test_pack_conv_weights_is_bit_identical(bits, spacer, c_in):
    rng = np.random.default_rng(bits + c_in)
    w = rng.normal(size=(3, 3, c_in, 10)).astype(np.float32)
    jcfg, cfg = (JQuantConfig(bits=bits, spacer=spacer),
                 QuantConfig(bits=bits, spacer=spacer))
    jpacked, jscale = jpacking.pack_conv_weights(jnp.asarray(w), jcfg)
    packed, scale = packing.pack_conv_weights(torch.from_numpy(w), cfg)
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), _words(jpacked))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        packing.unpack_conv_weights(packed, c_in, cfg).numpy(),
        np.asarray(jpacking.unpack_conv_weights(jpacked, c_in, jcfg)))
    np.testing.assert_array_equal(
        packing.dequant_conv_weights(packed, scale, c_in, cfg).numpy(),
        np.asarray(jpacking.dequant_conv_weights(jpacked, jscale, c_in,
                                                 jcfg)))


def test_vggb_layers_match_reference():
    from repro.configs.vggb import VGGB_LAYERS as J_LAYERS

    assert VGGB_LAYERS == J_LAYERS


# -- kernels: samd_conv_chunks and samd_conv1d ---------------------------------

PLANS = [(2, True), (3, True), (4, True), (4, False), (2, False)]


@pytest.mark.parametrize("bits,signed", PLANS)
def test_conv_chunks_plain_matches_pallas_kernel(bits, signed):
    """The chunk lanes of the plain version against the Pallas kernel in
    the interpreter, bit for bit, and samd_conv1d end to end."""
    rng = np.random.default_rng(bits * 3 + signed)
    n = 997  # ragged last chunk
    x, k = _rand(bits, signed, n, rng), _rand(bits, signed, 3, rng)
    jplan, plan = (jconv.make_plan(bits, 3, signed),
                   conv.make_plan(bits, 3, signed))
    jxw = jconv.pack_conv_operand(jnp.asarray(x), jplan)
    jkw = jconv.pack_conv_kernel(jnp.asarray(k), jplan)
    xw = conv.pack_conv_operand(torch.from_numpy(x), plan)
    kw = conv.pack_conv_kernel(torch.from_numpy(k), plan)
    np.testing.assert_array_equal(xw.numpy(), _words(jxw))
    np.testing.assert_array_equal(kw.numpy(), _words(jkw))
    from repro.kernels import samd_conv as jsc

    want = jsc.samd_conv_chunks(jxw, jkw, jplan, block=128, interpret=True)
    np.testing.assert_array_equal(
        sc.samd_conv_chunks_plain(xw, kw, plan).numpy(), np.asarray(want))
    got = ops.samd_conv1d(torch.from_numpy(x), torch.from_numpy(k), plan)
    jgot = jops.samd_conv1d(jnp.asarray(x), jnp.asarray(k), jplan,
                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(got.numpy(), np.convolve(x, k))


def test_conv_chunks_at_extreme_words():
    """Every chunk word at the edges (top bit set, all ones) against the
    reference's core, for each plan: the Grys adjustment and the borrow
    carry across bit 32 are exercised."""
    for bits, signed in PLANS:
        jplan, plan = (jconv.make_plan(bits, 3, signed),
                       conv.make_plan(bits, 3, signed))
        for kword in EDGE_WORDS:
            k = np.asarray(kword, np.uint32)
            want = jconv.extract_outputs(
                *jconv.chunk_products(jnp.asarray(EDGE_WORDS),
                                      jnp.asarray(k), jplan), jplan)
            got = sc.samd_conv_chunks_plain(_t(EDGE_WORDS), _t(k), plan)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- kernels: the fused samd_conv1d's plain version and its tiling -----------

CONV1D_DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64]


def _max_taps(bits, signed):
    """The most taps a 32-bit plan of ``bits`` admits (its kernel fits
    one word)."""
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


def _truncate(v, bits, signed):
    """What packing keeps of integer values: their low ``bits`` bits,
    read as two's complement when signed."""
    v = np.asarray(v, np.int64) & ((1 << bits) - 1)
    return v - ((v >> (bits - 1) & 1) << bits) if signed else v


def _conv1d_lengths(plan):
    return (1, plan.lanes_per_chunk - 1, plan.lanes_per_chunk, 997)


def _conv1d_signal(bits, signed, taps, n, wide):
    """Seeded x [n] and k [taps]: b-bit values, or (``wide``) any int8
    values, which packing truncates to b bits."""
    rng = np.random.default_rng([bits, int(signed), taps, n, int(wide)])
    lo, hi = (-128, 127) if wide else overflow.input_range(bits, signed)
    return (rng.integers(lo, hi + 1, size=n),
            rng.integers(lo, hi + 1, size=taps))


@functools.lru_cache(maxsize=None)
def _jax_conv1d(bits, signed, taps, n, wide):
    x, k = _conv1d_signal(bits, signed, taps, n, wide)
    return np.asarray(jops.samd_conv1d(
        jnp.asarray(x), jnp.asarray(k), jconv.make_plan(bits, taps, signed),
        interpret=True))


@pytest.mark.parametrize("dtype", CONV1D_DTYPES, ids=str)
@pytest.mark.parametrize("bits,signed,taps", CONV1D_CASES)
def test_samd_conv1d_plain_matches_reference(bits, signed, taps, dtype):
    """The fused kernel's plain version (and ``ops.samd_conv1d`` on the
    CPU) against the JAX op through the Pallas kernel in the interpreter
    and ``np.convolve``, bit for bit, at n = 1, lanes - 1, lanes and a
    ragged 997, with b-bit values and with int8 values out of the b-bit
    range (truncated by packing, as the reference truncates them)."""
    plan = conv.make_plan(bits, taps, signed)
    for n in _conv1d_lengths(plan):
        for wide in (False, True):
            x, k = _conv1d_signal(bits, signed, taps, n, wide)
            xt = torch.from_numpy(x).to(dtype)
            kt = torch.from_numpy(k).to(dtype)
            got = sc.samd_conv1d_plain(xt, kt, plan)
            assert got.dtype == torch.int32 and got.shape == (n + taps - 1,)
            np.testing.assert_array_equal(
                got.numpy(), _jax_conv1d(bits, signed, taps, n, wide))
            np.testing.assert_array_equal(
                got.numpy(), np.convolve(_truncate(x, bits, signed),
                                         _truncate(k, bits, signed)))
            assert torch.equal(ops.samd_conv1d(xt, kt, plan), got)
    # values far outside the b-bit range, where the dtype holds them
    rng = np.random.default_rng(bits + taps)
    big = min(torch.iinfo(dtype).max, 1 << 20)
    x, k = rng.integers(-big, big, size=301), rng.integers(-big, big, taps)
    got = sc.samd_conv1d_plain(torch.from_numpy(x).to(dtype),
                               torch.from_numpy(k).to(dtype), plan)
    np.testing.assert_array_equal(
        got.numpy(), np.convolve(_truncate(x, bits, signed),
                                 _truncate(k, bits, signed)))


def _emulate_tiles(x, k, plan, p):
    """The fused kernel's tiling in numpy: each tile packs its chunks and
    its halo chunk, and output j takes lane j mod lanes of its chunk plus
    lane j mod lanes + lanes of the chunk before (when j mod lanes <
    taps - 1)."""
    lanes, tl = p.lanes, plan.taps - 1
    kw = conv.pack_conv_kernel(torch.from_numpy(k), plan)
    out = np.full(p.n_out, -999, np.int64)
    for b in range(p.tiles):
        halo, first, stop, out_stop = p.tile(b)
        vals = np.zeros((stop - halo) * lanes, np.int64)
        seg = x[max(halo, 0) * lanes:stop * lanes]
        vals[lanes if halo < 0 else 0:][:len(seg)] = seg
        words = conv.pack_conv_operand(torch.from_numpy(vals), plan)
        ext = sc.samd_conv_chunks_plain(words, kw, plan).numpy()
        for j in range(first * lanes, out_stop):
            c, t = divmod(j, lanes)
            v = ext[c - halo, t]
            if t < tl:
                v += ext[c - halo - 1, t + lanes]
            assert out[j] == -999, "an output written twice"
            out[j] = v
    return out


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int64],
                         ids=str)
@pytest.mark.parametrize("bits,signed,taps", CONV1D_CASES)
def test_conv1d_plan_tiles_the_signal(bits, signed, taps, dtype):
    """``conv1d_plan``: the tiles cover every output chunk exactly once,
    each tile's halo is the chunk before it (the zero chunk before the
    first), the last tile ends at n + taps - 1, tiles are whole 16-chunk
    groups of at most ``C1D_TILE_BYTES`` of values, taken by no more
    persistent blocks than tiles; and the kernel's tiling, emulated on
    the plan, gives ``np.convolve``."""
    plan = conv.make_plan(bits, taps, signed)
    lanes = plan.lanes_per_chunk
    for n in (*_conv1d_lengths(plan), 16 * lanes + 1,
              2 * sc.C1D_TILE_CHUNKS * lanes - taps + 2):
        p = sc.conv1d_plan(n, plan, dtype)
        assert p.n_out == n + taps - 1 and p.lanes == lanes
        assert p.tile_chunks % 16 == 0
        assert 16 <= p.tile_chunks <= sc.C1D_TILE_CHUNKS
        assert p.tile_chunks * lanes * dtype.itemsize <= sc.C1D_TILE_BYTES
        assert p.blocks == min(p.tiles, sc.C1D_BLOCKS_PER_SM * sc.NUM_SMS)
        assert (p.chunks - 1) * lanes < p.n_out <= p.chunks * lanes
        covered = []
        for b in range(p.tiles):
            halo, first, stop, out_stop = p.tile(b)
            assert halo == first - 1 and stop > first
            covered += range(first, stop)
        assert covered == list(range(p.chunks))
        assert p.tile(p.tiles - 1)[3] == n + taps - 1
        rng = np.random.default_rng(n)
        lo, hi = overflow.input_range(bits, signed)
        x, k = rng.integers(lo, hi + 1, n), rng.integers(lo, hi + 1, taps)
        np.testing.assert_array_equal(_emulate_tiles(x, k, plan, p),
                                      np.convolve(x, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64, torch.bool,
                                   torch.complex64])
def test_conv1d_plan_refuses_what_the_kernel_does_not_take(dtype):
    with pytest.raises(TypeError):
        sc.conv1d_plan(100, conv.make_plan(4, 3, True), dtype)


@pytest.mark.parametrize("dtype", CONV1D_DTYPES, ids=str)
@pytest.mark.parametrize("signed", [True, False])
def test_conv1d_plan_bounds_every_plans_tile(signed, dtype):
    """Every 32-bit plan (1-32 bits, any taps it admits, up to 32
    lanes at 1 bit) gets whole 16-chunk tiles, the most up to
    ``C1D_TILE_CHUNKS`` within ``C1D_TILE_BYTES`` of values (16 chunks
    at the least)."""
    seen = set()
    for bits, taps in itertools.product(range(1, 33), range(1, 33)):
        try:
            plan = conv.make_plan(bits, taps, signed)
        except ValueError:
            continue
        lanes = plan.lanes_per_chunk
        seen.add(lanes)
        tile = sc.conv1d_plan(10_000, plan, dtype).tile_chunks
        fit = sc.C1D_TILE_BYTES // (lanes * dtype.itemsize) // 16 * 16
        assert tile % 16 == 0
        assert tile == max(16, min(sc.C1D_TILE_CHUNKS, fit))
    assert max(seen) == (32 if not signed else 16)


@pytest.mark.parametrize("form", ["stepped", "expanded", "column"])
def test_samd_conv1d_takes_a_strided_kernel(form):
    """``ops.samd_conv1d`` on the CPU reads a kernel that is a view
    (every other element, one value expanded, a column) as its values."""
    plan = conv.make_plan(4, 3, True)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-8, 8, size=997))
    big = torch.from_numpy(rng.integers(-8, 8, size=(6, 2)))
    k = {"stepped": big.reshape(-1)[::2][:3],
         "expanded": big[0, :1].expand(3),
         "column": big[:3, 1]}[form]
    assert not k.is_contiguous()
    np.testing.assert_array_equal(ops.samd_conv1d(x, k, plan).numpy(),
                                  np.convolve(x.numpy(), k.numpy()))


# -- kernels: samd_conv2d -------------------------------------------------------

def _conv2d_case(bits, c_in, c_out, h, w, signed, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c_in, h, w)).astype(np.float32)
    jcfg = JQuantConfig(bits=bits)
    if signed:
        wt = rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32)
        packed, scale = jpacking.pack_conv_weights(jnp.asarray(wt), jcfg)
    else:
        q = rng.integers(0, 1 << bits, size=(3, 3, c_in, c_out))
        fmt = jsamd.SAMDFormat(bits, jcfg.lane_width, signed=False)
        packed = jnp.moveaxis(jsamd.pack(
            jnp.asarray(np.moveaxis(q, 2, -1), jnp.int32), fmt), -1, 2)
        scale = jnp.asarray(rng.uniform(0.5, 2.0, size=(1, c_out)),
                            jnp.float32)
    return x, np.asarray(packed), np.asarray(scale), jcfg


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("bits,c_in,c_out,h,w", [(2, 3, 5, 6, 7),
                                                 (4, 19, 9, 5, 5),
                                                 (8, 21, 4, 4, 6)])
def test_samd_conv2d_plain_matches_reference(bits, c_in, c_out, h, w,
                                             padding, signed):
    """Ragged C_in (3 against vpw 16; 19 against 8 and 21 against 4, each
    two reduction steps of ``samd_conv.BLOCK_C`` channels with a ragged
    last word), both paddings, signed and unsigned lanes; the reference
    in its xla and its interpret (Pallas kernel body, C_in blocks of 2
    words) lowerings."""
    x, packed, scale, jcfg = _conv2d_case(bits, c_in, c_out, h, w, signed,
                                          seed=bits * 100 + c_in + padding)
    got = ops.samd_conv2d(torch.from_numpy(x), _t(packed),
                          torch.from_numpy(scale), QuantConfig(bits=bits),
                          padding=padding, signed=signed)
    for backend, kw in (("xla", {}), ("interpret",
                                      dict(block_cw=2, block_n=4))):
        want = np.asarray(jops.samd_conv2d(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), jcfg,
            padding=padding, signed=signed, backend=backend, verify=False,
            **kw))
        assert got.shape == want.shape == (h + 2 * padding - 2,
                                           w + 2 * padding - 2, c_out)
        atol = CONV2D_TOL * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=CONV2D_TOL,
                                   atol=atol, err_msg=backend)


def test_samd_conv2d_plain_bf16_and_checks():
    """bf16 x gives bf16 out (the f32 sum rounded once); inconsistent
    operands raise."""
    x, packed, scale, jcfg = _conv2d_case(4, 16, 8, 6, 6, True, seed=5)
    cfg = QuantConfig(bits=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.samd_conv2d(xb, _t(packed), torch.from_numpy(scale), cfg)
    want = ops.samd_conv2d(xb.float(), _t(packed), torch.from_numpy(scale),
                           cfg)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="cannot hold"):
        ops.samd_conv2d(torch.zeros(40, 6, 6), _t(packed),
                        torch.from_numpy(scale), cfg)
    with pytest.raises(ValueError, match="does not fit"):
        ops.samd_conv2d(torch.zeros(16, 1, 1), _t(packed),
                        torch.from_numpy(scale), cfg, padding=0)


WIDE_CODES = [(10, True), (12, True), (16, True), (9, False), (12, False),
              (16, False)]


@pytest.mark.parametrize("bits,signed", WIDE_CODES)
def test_samd_conv2d_plain_bf16_wide_codes_match_reference(bits, signed):
    """bf16 x with codes that bf16 cannot hold exactly (signed over 9
    bits, unsigned over 8): the reference casts the codes to x's dtype
    before the product (``codes.astype(x.dtype)``), and so must the port;
    within 1e-3 of the output scale of the xla lowering (the codes kept
    exact instead read 2.4-4.7e-3 here)."""
    x, packed, scale, jcfg = _conv2d_case(bits, 16, 8, 6, 6, signed,
                                          seed=bits + 7 * signed)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jops.samd_conv2d(
        xb, jnp.asarray(packed), jnp.asarray(scale), jcfg, signed=signed,
        backend="xla", verify=False), np.float32)
    got = ops.samd_conv2d(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        _t(packed), torch.from_numpy(scale), QuantConfig(bits=bits),
        signed=signed)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-3 * np.abs(want).max(), err


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("layer", VGGB_LAYERS, ids=lambda lay: lay[0])
def test_conv2d_plan_fills_the_card_at_vggb_shapes(layer, bits, x_bf16):
    """Every VGG-B layer runs at least 66 blocks (half the SMs), its K
    splits divide its K-steps and form clusters of at most 8, and only
    conv1_1 (27 products a pixel) takes the im2col launcher, in one
    K-step (32 values for f32 x, 64 for bf16 x)."""
    name, c_in, c_out, h, w = layer
    vpw = QuantConfig(bits=bits).values_per_word
    plan = sc.conv2d_plan(c_in, -(-c_in // vpw), h, w, 3, 3, c_out, 1, vpw,
                          x_bf16)
    assert plan.blocks >= 66
    assert 1 <= plan.splits <= sc.MAX_SPLITS
    assert plan.steps % plan.splits == 0
    assert plan.terms == (1 if x_bf16 else 2)
    if name == "conv1_1":
        assert plan.launcher == sc.IM2COL and plan.steps == 1
        assert (plan.ws_rows, plan.ws_cols) == (h * w, plan.step_k)
    else:
        assert plan.launcher == sc.DIRECT
        assert plan.steps == 9 * c_in // plan.step_k
        assert plan.ws_rows == (h + 2) * (w + 2) and plan.ws_cols == c_in
    if plan.tiles >= sc.NUM_SMS:
        assert plan.splits == 1
    else:
        assert plan.splits > 1 and plan.blocks <= 2 * sc.NUM_SMS


@pytest.mark.parametrize("bits,spacer", [(1, "temporary"), (2, "permanent"),
                                         (3, "temporary"), (5, "temporary"),
                                         (8, "permanent"), (9, "temporary"),
                                         (16, "permanent")])
@pytest.mark.parametrize("c_in,h,w,kh,kw,c_out,padding", [
    (3, 20, 37, 3, 3, 64, 1), (300, 7, 7, 3, 3, 70, 1),
    (37, 9, 12, 1, 1, 70, 0), (37, 9, 12, 5, 3, 70, 1),
    (19, 5, 6, 3, 3, 8, 0)])
def test_conv2d_plan_covers_k_exactly(c_in, h, w, kh, kw, c_out, padding,
                                      bits, spacer):
    """Every lanes-per-word count: a K-step is a multiple of 16 values of
    K, the steps cover every (tap, channel) product, the workspace holds
    every row the kernel reads, and the deep small layer is split."""
    vpw = QuantConfig(bits=bits, spacer=spacer).values_per_word
    cw = -(-c_in // vpw)
    plan = sc.conv2d_plan(c_in, cw, h, w, kh, kw, c_out, padding, vpw, False)
    assert plan.step_k % 16 == 0 and plan.step_k % vpw == 0  # whole words
    assert 32 <= plan.step_k <= 80
    assert plan.steps * plan.step_k >= kh * kw * c_in
    assert plan.steps % plan.splits == 0 and plan.splits <= sc.MAX_SPLITS
    assert plan.ws_elems == 2 * plan.ws_rows * plan.ws_cols
    oh, ow = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    if plan.launcher == sc.IM2COL:
        assert plan.ws_rows == oh * ow
        assert plan.ws_cols == plan.steps * plan.step_k
    else:
        assert plan.ws_rows == (h + 2 * padding) * (w + 2 * padding)
        assert plan.ws_cols * kh * kw == plan.steps * plan.step_k
        assert plan.ws_cols >= cw * vpw
    if (c_in, h) == (300, 7):
        assert plan.splits > 1


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("c_in,bits,surplus", [(32, 4, 1), (37, 4, 3),
                                               (64, 4, 1), (3, 4, 1),
                                               (16, 16, 1), (300, 2, 2)])
def test_conv2d_plan_covers_surplus_words(c_in, bits, surplus, x_bf16):
    """Packed weights may hold more words than C_in needs: the direct
    launcher's steps cover every word of a tap (C_in 64 at 4 bits with 9
    words takes three steps a tap with f32 x where 8 words take two), the
    workspace holds them, the splits still divide the steps, and the
    im2col launcher, which reads C_in's words only, keeps its plan."""
    vpw = QuantConfig(bits=bits).values_per_word
    cw = -(-c_in // vpw)
    plan = sc.conv2d_plan(c_in, cw + surplus, 9, 12, 3, 3, 70, 1, vpw, x_bf16)
    assert plan.steps % plan.splits == 0
    assert plan.ws_elems == plan.terms * plan.ws_rows * plan.ws_cols
    if plan.launcher == sc.DIRECT:
        assert plan.ws_cols >= (cw + surplus) * vpw
        assert plan.steps == 9 * plan.ws_cols // plan.step_k
    else:
        assert plan == sc.conv2d_plan(c_in, cw, 9, 12, 3, 3, 70, 1, vpw,
                                      x_bf16, sc.IM2COL)
    if (c_in, bits, surplus, x_bf16) == (64, 4, 1, False):
        tight = sc.conv2d_plan(c_in, cw, 9, 12, 3, 3, 70, 1, vpw, x_bf16)
        assert tight.launcher == plan.launcher == sc.DIRECT
        assert (tight.steps, plan.steps) == (18, 27)  # 4 words a step


# -- analysis: the conv lane-safety checks -------------------------------------

@pytest.mark.parametrize("bits,signed", PLANS)
@pytest.mark.parametrize("narrower", [0, 1, 2])
@pytest.mark.parametrize("taps", [2, 3])
def test_conv_plan_check_matches_reference(bits, signed, narrower, taps):
    """Exact-capacity plans are safe; a lane one or two bits narrower is
    refused with the reference's verdict (a signed lane one short is the
    borrow headroom of §6)."""
    from repro.analysis import contracts as jcontracts
    from repro_torch.analysis import contracts

    lane = samd.conv_lane_width(bits, taps, signed) - narrower
    got = contracts.check_conv_plan(
        conv.make_plan(bits, taps, signed, lane_width=lane))
    want = jcontracts.check_conv_plan(
        jconv.make_plan(bits, taps, signed, lane_width=lane))
    assert got.to_dict() == want.to_dict()
    assert got.ok == (narrower == 0)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits,spacer", [(2, "temporary"), (4, "permanent"),
                                         (8, "temporary")])
def test_conv2d_check_matches_reference(bits, spacer, signed):
    from repro.analysis import contracts as jcontracts
    from repro_torch.analysis import contracts

    for kh, kw, c_in in ((3, 3, 3), (3, 3, 512), (1, 1, 7)):
        got = contracts.check_conv2d_config(
            QuantConfig(bits=bits, spacer=spacer), kh, kw, c_in,
            signed=signed)
        want = jcontracts.check_conv2d_config(
            JQuantConfig(bits=bits, spacer=spacer), kh, kw, c_in,
            signed=signed)
        assert got.ok and got.to_dict() == want.to_dict()


@pytest.mark.parametrize("signed", [True, False])
def test_samd_conv1d_refuses_an_unsafe_plan_as_the_reference(signed):
    """A plan whose lanes are one bit short raises ``LaneSafetyError``
    with the reference's verdict before any kernel runs."""
    from repro.analysis import LaneSafetyError as JLaneSafetyError
    from repro_torch.analysis.lanes import LaneSafetyError

    lane = samd.conv_lane_width(4, 3, signed) - 1
    rng = np.random.default_rng(3)
    x, k = _rand(4, signed, 40, rng), _rand(4, signed, 3, rng)
    with pytest.raises(LaneSafetyError) as got:
        ops.samd_conv1d(torch.from_numpy(x), torch.from_numpy(k),
                        conv.make_plan(4, 3, signed, lane_width=lane))
    with pytest.raises(JLaneSafetyError) as want:
        jops.samd_conv1d(jnp.asarray(x), jnp.asarray(k),
                         jconv.make_plan(4, 3, signed, lane_width=lane))
    assert got.value.verdict.to_dict() == want.value.verdict.to_dict()
    assert not got.value.verdict.ok
