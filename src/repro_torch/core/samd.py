"""SAMD vector format and lane-wise arithmetic (paper §2-§6), in PyTorch.

A SAMD word embeds ``lanes_per_word`` lanes of ``lane_width`` bits; a
value occupies the low ``bits`` bits of its lane and the rest are spacer
bits (zero after ``pack``). Lane 0 sits at the least significant bit.

Two word widths, as in the reference:

* 32-bit words are held as ``torch.int32`` with the same bits as the
  reference's ``uint32`` words. PyTorch has no shifts or adds on
  ``torch.uint32``, and ``>>`` on int32 is arithmetic, so each lane
  function widens its words to int64 holding the unsigned value (products
  of 16-bit limbs fit, compares are unsigned, right shifts logical) and
  wraps the result back to int32 words.
* 64-bit words, the paper's own CPU configuration, are held as
  ``torch.int64`` with the bits of the reference's ``uint64`` words
  (PyTorch has no shifts on ``torch.uint64`` either). int64 adds,
  subtracts, left shifts and multiplies wrap mod 2^64 as uint64 ones do,
  so the lane functions work on the bit patterns directly; a right shift
  is made logical by masking off the bits the sign filled in
  (``shr``), and an unsigned compare flips both operands' top bits.

``word_dtype`` / ``word_bits_of`` map a width to its container and back;
``widen`` / ``narrow`` convert between a word tensor and the int64 the
arithmetic runs on, ``word_mask`` gives a mask as the Python int that
int64 takes, and ``shr`` is the logical right shift. Every lane function
here and in ``conv`` is written once over them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import masks

_M32 = 0xFFFFFFFF
_TOP64 = -(1 << 63)


def word_dtype(word_bits: int) -> torch.dtype:
    """The port's container of a ``word_bits`` word: int32 or int64."""
    if word_bits == 32:
        return torch.int32
    if word_bits == 64:
        return torch.int64
    raise ValueError(f"word_bits must be 32 or 64, got {word_bits}")


def word_bits_of(t: torch.Tensor) -> int:
    """The word width a word tensor is held at (``word_dtype``'s inverse):
    the double-word helpers take their pairs as the reference's do, with
    the width in the dtype."""
    return 64 if t.dtype == torch.int64 else 32


@dataclasses.dataclass(frozen=True)
class SAMDFormat:
    """How values are embedded in words.

    bits:        precision of each value.
    lane_width:  bits per lane, value + spacer (``bits`` for the dense
                 temporary-spacer format, ``bits + 1`` for one permanent
                 spacer bit, ``2 * bits`` for the vector-scale format,
                 wider for the convolution format).
    signed:      two's-complement lanes if True.
    word_bits:   32 or 64.
    """

    bits: int
    lane_width: int
    signed: bool = True
    word_bits: int = 32

    def __post_init__(self):
        if self.bits < 1:
            raise ValueError("bits must be >= 1")
        if self.lane_width < self.bits:
            raise ValueError("lane_width must be >= bits")
        if self.word_bits not in (32, 64):
            raise ValueError(
                f"word_bits must be 32 or 64, got {self.word_bits}")
        if self.lane_width > self.word_bits:
            raise ValueError("lane must fit in a word")

    @property
    def lanes_per_word(self) -> int:
        return self.word_bits // self.lane_width

    @property
    def dtype(self) -> torch.dtype:
        return word_dtype(self.word_bits)

    @property
    def msb_mask(self) -> int:
        """The top bit of every lane."""
        return masks.build_mask(self.lane_width - 1, 1, self.lane_width,
                                self.word_bits)

    @property
    def value_msb_mask(self) -> int:
        """The top bit of every lane's value (its sign bit)."""
        return masks.build_mask(self.bits - 1, 1, self.lane_width,
                                self.word_bits)

    @property
    def value_bits_mask(self) -> int:
        """The value bits of every lane; spacer bits are outside it."""
        return masks.value_mask(self.bits, self.lane_width, self.word_bits)

    @property
    def lane_bits_mask(self) -> int:
        """Every bit of every whole lane."""
        return masks.lane_mask(self.lane_width, self.word_bits)


def dense_format(bits: int, signed: bool = True,
                 word_bits: int = 32) -> SAMDFormat:
    """Temporary-spacer format: lanes exactly ``bits`` wide (Fig. 5)."""
    return SAMDFormat(bits, bits, signed, word_bits)


def perm_format(bits: int, signed: bool = True,
                word_bits: int = 32) -> SAMDFormat:
    """One permanent spacer bit in the MSB of each lane (Fig. 2)."""
    return SAMDFormat(bits, bits + 1, signed, word_bits)


def scale_format(bits: int, signed: bool = True,
                 word_bits: int = 32) -> SAMDFormat:
    """Vector-scale format: b value bits + b spacer bits a lane (Fig. 8)."""
    return SAMDFormat(bits, 2 * bits, signed, word_bits)


def conv_lane_width(bits: int, taps: int, signed: bool,
                    paper_compat: bool = False) -> int:
    """Least output-lane width for conv-via-multiplication (§5.1).

    ``paper_compat=True`` gives the paper's generic sizing, ``2b +
    ceil(log2(taps))`` (``2b + 2`` at 3 taps). Otherwise the exact
    capacity: signed products are at most 4^(b-1) in magnitude, plus one
    unit for the borrow of signed extraction (§6)."""
    if paper_compat:
        if taps > 1:
            return 2 * bits + max(1, (taps - 1).bit_length())
        return 2 * bits
    if signed:
        max_mag = taps * (1 << (bits - 1)) * (1 << (bits - 1)) + 1
        lane = 1
        while (1 << (lane - 1)) < max_mag:
            lane += 1
        return max(lane, bits + 1)
    max_val = taps * ((1 << bits) - 1) ** 2
    lane = 1
    while (1 << lane) - 1 < max_val:
        lane += 1
    return max(lane, bits)


def conv_format(bits: int, taps: int = 3, signed: bool = True,
                word_bits: int = 32, paper_compat: bool = False,
                lane_width: int | None = None) -> SAMDFormat:
    """Convolution format (§5.1): lanes wide enough that ``taps`` products
    of b-bit values (and the signed-extraction borrow) never overflow."""
    lane = lane_width or conv_lane_width(bits, taps, signed, paper_compat)
    return SAMDFormat(bits, lane, signed, word_bits)


# -- words and the int64 the arithmetic runs on ------------------------------

def as_unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding their unsigned value."""
    return words.to(torch.int64) & _M32


def to_int32_words(words64: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 bit patterns -> int32 with the same bits."""
    w = words64 & _M32
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def word_mask(mask: int, word_bits: int) -> int:
    """A word mask as the Python int the int64 arithmetic takes: a 64-bit
    mask as the int64 with its bits."""
    if word_bits == 32:
        return mask
    mask &= (1 << 64) - 1
    return mask - (1 << 64) if mask >> 63 else mask


def widen(words: torch.Tensor, word_bits: int) -> torch.Tensor:
    """Words -> int64: the unsigned value of a 32-bit word, the bits of a
    64-bit one."""
    return as_unsigned(words) if word_bits == 32 else words.to(torch.int64)


def narrow(x: torch.Tensor, word_bits: int) -> torch.Tensor:
    """int64 arithmetic -> words, wrapped to ``word_bits``."""
    return to_int32_words(x) if word_bits == 32 else x


def shr(x: torch.Tensor, s: int, word_bits: int = 32) -> torch.Tensor:
    """Logical right shift of an int64 by ``s``. A 32-bit word's value is
    never negative, so only a 64-bit word's sign fill is masked off."""
    if s == 0:
        return x
    if word_bits == 64:
        return (x >> s) & ((1 << (64 - s)) - 1)
    return x >> s


def _shl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Left shift of an int64, 0 at 64 or more (as a uint64 shift is in
    the reference)."""
    return torch.zeros_like(x) if s >= 64 else x << s


def _ult(a: torch.Tensor, b: torch.Tensor, word_bits: int) -> torch.Tensor:
    """Unsigned a < b on the int64 arithmetic of ``word_bits`` words."""
    if word_bits == 64:
        return (a ^ _TOP64) < (b ^ _TOP64)
    return a < b


def num_words(n_values: int, fmt: SAMDFormat) -> int:
    return -(-n_values // fmt.lanes_per_word)


def pack(values: torch.Tensor, fmt: SAMDFormat) -> torch.Tensor:
    """Pack integer ``values`` [..., n] into words [..., n_words].

    Values are cast to int32 first, as in the reference, then truncated
    to ``fmt.bits`` bits (two's complement when signed); spacer bits and
    the lanes past ``n`` are zero.
    """
    wb = fmt.word_bits
    n = values.shape[-1]
    k = fmt.lanes_per_word
    nw = num_words(n, fmt)
    v = values.to(torch.int32).to(torch.int64)
    pad = nw * k - n
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(v.shape[:-1] + (nw, k)) & word_mask((1 << fmt.bits) - 1, wb)
    shifts = torch.arange(k, dtype=torch.int64, device=v.device)
    # the lanes' bits are disjoint, so the (wrapping) sum is their OR
    return narrow((v << (shifts * fmt.lane_width)).sum(dim=-1), wb)


def _lanes(words: torch.Tensor, fmt: SAMDFormat, width: int,
           n: int) -> torch.Tensor:
    """The low ``width`` bits of each of the first ``n`` lanes [..., n],
    in the words' own dtype. An arithmetic right shift by a lane's offset
    fills only bits above the word's top, which lie above the lane's
    ``width`` bits and are masked off, so every lane inside its word
    reads exactly: one shift and one mask over all lanes at once (the
    dequantize path's unpack)."""
    shifts = torch.arange(fmt.lanes_per_word, dtype=words.dtype,
                          device=words.device) * fmt.lane_width
    lanes = words[..., None] >> shifts
    if width < fmt.word_bits:
        lanes = lanes & ((1 << width) - 1)
    return lanes.reshape(lanes.shape[:-2] + (-1,))[..., :n]


def unpack(words: torch.Tensor, fmt: SAMDFormat, n: int) -> torch.Tensor:
    """Unpack SAMD words back to int32 values [..., n]; reads the low
    ``fmt.bits`` of each lane and sign-extends when signed. As in the
    reference, the value is taken to int32 before its sign: a value of
    32 bits or more keeps its low 32 bits."""
    out = _lanes(words, fmt, fmt.bits, n)
    if fmt.word_bits == 64:
        out = to_int32_words(out)
    if fmt.signed and fmt.bits < 32:
        sign = (out >> (fmt.bits - 1)) & 1
        out = out - (sign << fmt.bits)
    return out


def unpack_lanes_wide(words: torch.Tensor, fmt: SAMDFormat,
                      n: int) -> torch.Tensor:
    """Unpack reading the whole lane (value and spacer bits) as the value,
    sign-extended over ``lane_width`` bits when signed: the reader of
    double-width products in vector-scale and conv results. The result is
    int32, as the reference's: a lane wider than 32 bits wraps."""
    out = _lanes(words, fmt, fmt.lane_width, n).to(torch.int64)
    L = fmt.lane_width
    if fmt.signed and L < fmt.word_bits:
        out = out - (((out >> (L - 1)) & 1) << L)
    return to_int32_words(out)


# -- lane-wise arithmetic (paper Figs. 2, 5, 6, 7) ---------------------------

def samd_add(a: torch.Tensor, b: torch.Tensor,
             fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise add with temporary spacer bits (Fig. 5): a masked add,
    then each lane's MSB recomputed by XOR."""
    wb = fmt.word_bits
    a, b = widen(a, wb), widen(b, wb)
    mask = word_mask(fmt.msb_mask, wb)
    inv = word_mask(~fmt.msb_mask & masks.full_mask(wb), wb)
    msb = (a ^ b) & mask
    return narrow(msb ^ ((a & inv) + (b & inv)), wb)


def samd_sub(a: torch.Tensor, b: torch.Tensor,
             fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise subtract with temporary spacer bits (Fig. 6)."""
    wb = fmt.word_bits
    a, b = widen(a, wb), widen(b, wb)
    mask = word_mask(fmt.msb_mask, wb)
    inv = word_mask(~fmt.msb_mask & masks.full_mask(wb), wb)
    msb = (a ^ b) & mask
    diff = (a | mask) - (b & inv)
    return narrow(msb ^ diff ^ mask, wb)


def samd_add_perm(a: torch.Tensor, b: torch.Tensor,
                  fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise add with a permanent spacer bit in each lane's MSB
    (Fig. 2): clear the spacers and let the native adder run; overflow
    lands in the spacers, whose bits are left as garbage (§6.1)."""
    wb = fmt.word_bits
    inv = word_mask(~fmt.msb_mask & masks.full_mask(wb), wb)
    return narrow((widen(a, wb) & inv) + (widen(b, wb) & inv), wb)


def samd_mul(a: torch.Tensor, b: torch.Tensor,
             fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise multiply by shift-and-add (Fig. 7, with the reference's
    repair: each partial product's write mask is cut at the lane's value
    bits so it cannot cross into the next lane). Gives the low ``bits``
    of each lane's product, right for signed and unsigned lanes."""
    wb = fmt.word_bits
    bits, lw = fmt.bits, fmt.lane_width
    ub = widen(b, wb)
    av = widen(a, wb) & word_mask(fmt.value_bits_mask, wb)
    total = torch.zeros_like(a)
    for i in range(bits):
        bit = ub & word_mask(masks.build_mask(i, 1, lw, wb), wb)
        write = (_shl(bit, bits) - bit) & word_mask(
            masks.build_mask(i, bits - i, lw, wb), wb)
        total = samd_add(total, narrow((av << i) & write, wb), fmt)
    return total


# -- sign extension and vector scale (Figs. 8, 9, 11, 12) --------------------

def sign_extend_for_mul(vec: torch.Tensor, fmt: SAMDFormat) -> torch.Tensor:
    """Sign-extend each lane's value into its spacer bits (Fig. 11), so
    the word as a plain integer is ``sum_i value_i * 2**(i * lane_width)``
    with signed coefficients."""
    wb = fmt.word_bits
    v = widen(vec, wb)
    return narrow(v - ((v & word_mask(fmt.value_msb_mask, wb)) << 1), wb)


def _mul_lo(a: torch.Tensor, b: torch.Tensor, word_bits: int) -> torch.Tensor:
    """The low ``word_bits`` of the product of two words' int64 forms. A
    32-bit product is built from 16-bit limbs so that no int64 product
    overflows; a 64-bit one is the int64 product, which wraps."""
    if word_bits == 64:
        return a * b
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    return (a0 * b0 + (((a0 * b1 + a1 * b0) & 0xFFFF) << 16)) & _M32


def vector_scale_perm(vec: torch.Tensor, scalar: torch.Tensor,
                      fmt: SAMDFormat) -> torch.Tensor:
    """Every lane times one scalar in a single native multiply (Fig. 8);
    ``fmt`` has at least b spacer bits a lane. Signed lanes are
    sign-extended first, the scalar passed as a full-width word, and the
    product read with ``unpack_signed_product``."""
    wb = fmt.word_bits
    return narrow(_mul_lo(widen(vec, wb), widen(scalar, wb), wb), wb)


def vector_scale_temp(vec: torch.Tensor, scalar: torch.Tensor,
                      fmt: SAMDFormat) -> torch.Tensor:
    """Vector scale with temporary spacer bits (Fig. 9) on the dense
    format: odd and even lanes are split to make b spacer bits, scaled,
    masked and merged. ``scalar`` is the b-bit pattern of the value."""
    wb = fmt.word_bits
    b = fmt.bits
    v, s = widen(vec, wb), widen(scalar, wb)
    lo_of_pair = word_mask(masks.value_mask(b, 2 * b, wb), wb)
    ev = _mul_lo(v & word_mask(masks.even_lane_mask(b, wb), wb), s, wb)
    od = _mul_lo(shr(v & word_mask(masks.odd_lane_mask(b, wb), wb), b, wb), s, wb)
    return narrow((ev & lo_of_pair) | ((od & lo_of_pair) << b), wb)


def correct_signed_product(prod: torch.Tensor,
                           fmt: SAMDFormat) -> torch.Tensor:
    """Borrow correction after a signed SAMD multiply (Fig. 12):
    ``q = p + (p & msb); result = q ^ (p & msb)``."""
    wb = fmt.word_bits
    p = widen(prod, wb)
    msb = p & word_mask(fmt.msb_mask, wb)
    return narrow((p + msb) ^ msb, wb)


def correct_signed_product_perm(prod: torch.Tensor,
                                fmt: SAMDFormat) -> torch.Tensor:
    """§6.1's low-complexity variant: with a permanent spacer bit in each
    lane's MSB the final XOR is skipped (the MSB is not kept)."""
    wb = fmt.word_bits
    p = widen(prod, wb)
    return narrow(p + (p & word_mask(fmt.msb_mask, wb)), wb)


def unpack_signed_product(prod: torch.Tensor, fmt: SAMDFormat,
                          n: int) -> torch.Tensor:
    """Read ``n`` wide lanes of a product word, with the Fig. 12 borrow
    fixup applied first for signed formats."""
    if fmt.signed:
        prod = correct_signed_product(prod, fmt)
    return unpack_lanes_wide(prod, fmt, n)


# -- double-word helpers: (hi, lo) pairs of words ----------------------------

def mul_wide_u32(a: torch.Tensor, b: torch.Tensor):
    """Full 32x32 -> 64-bit unsigned product as (hi, lo) int32 words,
    from 16-bit limbs as the reference builds it."""
    a, b = as_unsigned(a), as_unsigned(b)
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = (p00 & 0xFFFF) | ((mid << 16) & _M32)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return to_int32_words(hi), to_int32_words(lo)


def mul_wide_u64(a: torch.Tensor, b: torch.Tensor):
    """Full 64x64 -> 128-bit unsigned product as (hi, lo) int64 words,
    from 32-bit limbs as the reference's 64-bit ``_widening_mul``: each
    limb product and sum wraps mod 2^64 as its uint64 one does."""
    a0, a1 = a & _M32, shr(a, 32, 64)
    b0, b1 = b & _M32, shr(b, 32, 64)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = shr(p00, 32, 64) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | (mid << 32)
    hi = (p11 + shr(p01, 32, 64) + shr(p10, 32, 64)
          + shr(mid, 32, 64))
    return hi, lo


def dw_add(a, b):
    """(hi, lo) + (hi, lo) with the carry between the halves (an unsigned
    compare of the low sum against an addend). The halves are int32
    (32-bit) or int64 (64-bit) words."""
    (ah, al), (bh, bl) = a, b
    wb = word_bits_of(al)
    al = widen(al, wb)
    lo = al + widen(bl, wb)
    if wb == 32:
        lo = lo & _M32
    carry = _ult(lo, al, wb).to(torch.int64)
    return (narrow(widen(ah, wb) + widen(bh, wb) + carry, wb),
            narrow(lo, wb))


def dw_bitand(a, m_hi: int, m_lo: int):
    """(hi, lo) & (m_hi, m_lo), each mask a word's bit pattern."""

    def masked(w, m):
        wb = word_bits_of(w)
        return narrow(widen(w, wb) & word_mask(m, wb), wb)

    return masked(a[0], m_hi), masked(a[1], m_lo)


def dw_bitxor(a, b):
    (ah, al), (bh, bl) = a, b
    return ah ^ bh, al ^ bl
