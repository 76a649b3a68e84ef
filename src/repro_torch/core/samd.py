"""SAMD vector format on 32-bit words (paper §2-§6), in PyTorch.

A SAMD word embeds ``lanes_per_word`` lanes of ``lane_width`` bits; a
value occupies the low ``bits`` bits of its lane and the rest are spacer
bits (zero after ``pack``). Lane 0 sits at the least significant bit.

Words are held as ``torch.int32`` with the same bits as the reference's
``uint32`` words: PyTorch's CPU build has no shifts or adds on
``torch.uint32``, and ``>>`` on int32 is arithmetic. So ``pack`` widens to
int64 and wraps back, and ``unpack`` masks after every right shift, which
is exact while ``shift + bits <= 32`` (always true for a lane inside its
word).

The lane arithmetic (paper Figs. 2, 5-12) works the same way: each
function widens its words to int64 holding the unsigned value, so that
products of 16-bit limbs fit, compares are unsigned and right shifts are
logical, and wraps the result back to int32 words. ``word_bits`` on a
format is geometry only: 64-bit words (the paper's CPU configuration)
have masks and lane counts here, but their arithmetic is not ported and
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import masks

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SAMDFormat:
    """How values are embedded in words.

    bits:        precision of each value.
    lane_width:  bits per lane, value + spacer (``bits`` for the dense
                 temporary-spacer format, ``bits + 1`` for one permanent
                 spacer bit, ``2 * bits`` for the vector-scale format,
                 wider for the convolution format).
    signed:      two's-complement lanes if True.
    word_bits:   32 (the port's words) or 64 (geometry only).
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


def conv_lane_width(bits: int, taps: int, signed: bool) -> int:
    """Least output-lane width for conv-via-multiplication (§5.1), at
    exact capacity: signed products are at most 4^(b-1) in magnitude,
    plus one unit for the borrow of signed extraction (§6)."""
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
                word_bits: int = 32,
                lane_width: int | None = None) -> SAMDFormat:
    """Convolution format (§5.1): lanes wide enough that ``taps`` products
    of b-bit values (and the signed-extraction borrow) never overflow."""
    lane = lane_width or conv_lane_width(bits, taps, signed)
    return SAMDFormat(bits, lane, signed, word_bits)


def words32(fmt: SAMDFormat) -> None:
    """Raise unless ``fmt`` has the port's 32-bit words."""
    if fmt.word_bits != 32:
        raise NotImplementedError(
            "64-bit SAMD words are not ported; the port's words are 32-bit")


def as_unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding their unsigned value."""
    return words.to(torch.int64) & _M32


def _mul_lo(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of the product of two unsigned values (int64), from
    16-bit limbs so that no int64 product overflows."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    return (a0 * b0 + (((a0 * b1 + a1 * b0) & 0xFFFF) << 16)) & _M32


def num_words(n_values: int, fmt: SAMDFormat) -> int:
    return -(-n_values // fmt.lanes_per_word)


def to_int32_words(words64: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 bit patterns -> int32 with the same bits."""
    w = words64 & _M32
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def pack(values: torch.Tensor, fmt: SAMDFormat) -> torch.Tensor:
    """Pack integer ``values`` [..., n] into int32 words [..., n_words].

    Values are truncated to ``fmt.bits`` bits (two's complement when
    signed); spacer bits and the lanes past ``n`` are zero.
    """
    words32(fmt)
    n = values.shape[-1]
    k = fmt.lanes_per_word
    nw = num_words(n, fmt)
    v = values.to(torch.int64)
    pad = nw * k - n
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(v.shape[:-1] + (nw, k)) & ((1 << fmt.bits) - 1)
    shifts = torch.arange(k, dtype=torch.int64, device=v.device)
    words = (v << (shifts * fmt.lane_width)).sum(dim=-1)  # disjoint bits
    return to_int32_words(words)


def unpack(words: torch.Tensor, fmt: SAMDFormat, n: int) -> torch.Tensor:
    """Unpack int32 SAMD words back to int32 values [..., n]; reads the
    low ``fmt.bits`` of each lane and sign-extends when signed."""
    words32(fmt)
    k = fmt.lanes_per_word
    shifts = torch.arange(k, dtype=torch.int32, device=words.device)
    lanes = (words[..., None] >> (shifts * fmt.lane_width)) & (
        (1 << fmt.bits) - 1
    )
    out = lanes.reshape(lanes.shape[:-2] + (-1,))[..., :n]
    if fmt.signed:
        sign = (out >> (fmt.bits - 1)) & 1
        out = out - (sign << fmt.bits)
    return out


def unpack_lanes_wide(words: torch.Tensor, fmt: SAMDFormat,
                      n: int) -> torch.Tensor:
    """Unpack reading the whole lane (value and spacer bits) as the value,
    sign-extended over ``lane_width`` bits when signed: the reader of
    double-width products in vector-scale and conv results."""
    words32(fmt)
    k = fmt.lanes_per_word
    shifts = torch.arange(k, dtype=torch.int64, device=words.device)
    lanes = (as_unsigned(words)[..., None] >> (shifts * fmt.lane_width)) & (
        (1 << fmt.lane_width) - 1)
    out = lanes.reshape(lanes.shape[:-2] + (-1,))[..., :n]
    if fmt.signed:
        sign = (out >> (fmt.lane_width - 1)) & 1
        out = out - (sign << fmt.lane_width)
    return to_int32_words(out)


# -- lane-wise arithmetic (paper Figs. 2, 5, 6, 7) ---------------------------

def samd_add(a: torch.Tensor, b: torch.Tensor,
             fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise add with temporary spacer bits (Fig. 5): a masked add,
    then each lane's MSB recomputed by XOR."""
    words32(fmt)
    a, b = as_unsigned(a), as_unsigned(b)
    mask, inv = fmt.msb_mask, ~fmt.msb_mask & _M32
    msb = (a ^ b) & mask
    return to_int32_words(msb ^ ((a & inv) + (b & inv)))


def samd_sub(a: torch.Tensor, b: torch.Tensor,
             fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise subtract with temporary spacer bits (Fig. 6)."""
    words32(fmt)
    a, b = as_unsigned(a), as_unsigned(b)
    mask, inv = fmt.msb_mask, ~fmt.msb_mask & _M32
    msb = (a ^ b) & mask
    diff = ((a | mask) - (b & inv)) & _M32
    return to_int32_words(msb ^ diff ^ mask)


def samd_add_perm(a: torch.Tensor, b: torch.Tensor,
                  fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise add with a permanent spacer bit in each lane's MSB
    (Fig. 2): clear the spacers and let the native adder run; overflow
    lands in the spacers, whose bits are left as garbage (§6.1)."""
    words32(fmt)
    inv = ~fmt.msb_mask & _M32
    return to_int32_words((as_unsigned(a) & inv) + (as_unsigned(b) & inv))


def samd_mul(a: torch.Tensor, b: torch.Tensor,
             fmt: SAMDFormat) -> torch.Tensor:
    """Lane-wise multiply by shift-and-add (Fig. 7, with the reference's
    repair: each partial product's write mask is cut at the lane's value
    bits so it cannot cross into the next lane). Gives the low ``bits``
    of each lane's product, right for signed and unsigned lanes."""
    words32(fmt)
    bits, lw = fmt.bits, fmt.lane_width
    ub = as_unsigned(b)
    av = as_unsigned(a) & fmt.value_bits_mask
    total = torch.zeros_like(a)
    for i in range(bits):
        bit = ub & masks.build_mask(i, 1, lw)
        write = ((bit << bits) - bit) & masks.build_mask(i, bits - i, lw)
        total = samd_add(total, to_int32_words((av << i) & write), fmt)
    return total


# -- sign extension and vector scale (Figs. 8, 9, 11, 12) --------------------

def sign_extend_for_mul(vec: torch.Tensor, fmt: SAMDFormat) -> torch.Tensor:
    """Sign-extend each lane's value into its spacer bits (Fig. 11), so
    the word as a plain integer is ``sum_i value_i * 2**(i * lane_width)``
    with signed coefficients."""
    words32(fmt)
    v = as_unsigned(vec)
    return to_int32_words(v - ((v & fmt.value_msb_mask) << 1))


def vector_scale_perm(vec: torch.Tensor, scalar: torch.Tensor,
                      fmt: SAMDFormat) -> torch.Tensor:
    """Every lane times one scalar in a single native multiply (Fig. 8);
    ``fmt`` has at least b spacer bits a lane. Signed lanes are
    sign-extended first, the scalar passed as a full-width word, and the
    product read with ``unpack_signed_product``."""
    words32(fmt)
    return to_int32_words(_mul_lo(as_unsigned(vec), as_unsigned(scalar)))


def vector_scale_temp(vec: torch.Tensor, scalar: torch.Tensor,
                      fmt: SAMDFormat) -> torch.Tensor:
    """Vector scale with temporary spacer bits (Fig. 9) on the dense
    format: odd and even lanes are split to make b spacer bits, scaled,
    masked and merged. ``scalar`` is the b-bit pattern of the value."""
    words32(fmt)
    b = fmt.bits
    v, s = as_unsigned(vec), as_unsigned(scalar)
    lo_of_pair = masks.value_mask(b, 2 * b)
    ev = _mul_lo(v & masks.even_lane_mask(b), s) & lo_of_pair
    od = _mul_lo((v & masks.odd_lane_mask(b)) >> b, s) & lo_of_pair
    return to_int32_words(ev | (od << b))


def correct_signed_product(prod: torch.Tensor,
                           fmt: SAMDFormat) -> torch.Tensor:
    """Borrow correction after a signed SAMD multiply (Fig. 12):
    ``q = p + (p & msb); result = q ^ (p & msb)``."""
    words32(fmt)
    p = as_unsigned(prod)
    msb = p & fmt.msb_mask
    return to_int32_words((p + msb) ^ msb)


def unpack_signed_product(prod: torch.Tensor, fmt: SAMDFormat,
                          n: int) -> torch.Tensor:
    """Read ``n`` wide lanes of a product word, with the Fig. 12 borrow
    fixup applied first for signed formats."""
    if fmt.signed:
        prod = correct_signed_product(prod, fmt)
    return unpack_lanes_wide(prod, fmt, n)


# -- double-word helpers (32x32 -> 64-bit products as (hi, lo) words) -------

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


def dw_add(a, b):
    """(hi, lo) + (hi, lo) with the carry between the halves (an unsigned
    compare of the low sum against an addend)."""
    (ah, al), (bh, bl) = a, b
    al = as_unsigned(al)
    lo = (al + as_unsigned(bl)) & _M32
    carry = (lo < al).to(torch.int64)
    return (to_int32_words(as_unsigned(ah) + as_unsigned(bh) + carry),
            to_int32_words(lo))
