"""Convolution as long multiplication (paper §5-§6), in PyTorch.

Counterpart of ``repro/core/conv.py``. Packing values at bit-stride L
makes a word the base-2^L evaluation of a polynomial, so one widening
multiply of two such words is the polynomial product: the full
convolution of the two coefficient sequences, as long as no product
coefficient overflows its L-bit lane.

Signed lanes are sign-extended into their spacer bits
(``samd.sign_extend_for_mul``), so a packed word is
``sum_i s_i * 2**(i*L)`` with negative coefficients. The unsigned
widening multiply then needs the Grys adjustment of its high half
(``hi -= sx*k_word + sk*x_word``), and each extracted lane the Fig. 12
borrow fixup, both applied here as in the reference.

Words are int32 holding uint32 bits or int64 holding uint64 bits
(``core.samd``); a widening product is a (hi, lo) pair of such words,
built from 16-bit limbs (32-bit words) or 32-bit limbs (64-bit words) as
the reference builds it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import masks
from repro_torch.core.samd import (
    SAMDFormat,
    conv_format,
    dw_add,
    mul_wide_u32,
    mul_wide_u64,
    narrow,
    pack,
    scale_format,
    shr,
    sign_extend_for_mul,
    to_int32_words,
    unpack_signed_product,
    vector_scale_perm,
    widen,
    word_mask,
)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Static plan of one conv-via-multiplication op: a (bits, taps,
    signedness) tuple and the lane format it needs."""

    fmt: SAMDFormat
    taps: int

    @property
    def lanes_per_chunk(self) -> int:
        return self.fmt.lanes_per_word

    @property
    def out_lanes_per_chunk(self) -> int:
        return self.lanes_per_chunk + self.taps - 1

    def validate(self):
        if self.taps * self.fmt.lane_width > self.fmt.word_bits:
            raise ValueError(
                f"kernel ({self.taps} taps x {self.fmt.lane_width}b lanes) "
                f"does not fit a {self.fmt.word_bits}-bit word; use "
                f"conv_by_scale (vector-scale fallback) for wide formats"
            )
        wide = self.out_lanes_per_chunk * self.fmt.lane_width
        if wide > 2 * self.fmt.word_bits:
            raise ValueError("product lanes exceed double-width result")


def make_plan(bits: int, taps: int, signed: bool = True, word_bits: int = 32,
              paper_compat: bool = False,
              lane_width: int | None = None) -> ConvPlan:
    fmt = conv_format(bits, taps, signed, word_bits, paper_compat,
                      lane_width)
    plan = ConvPlan(fmt, taps)
    plan.validate()
    return plan


# -- double-width lane machinery ---------------------------------------------

def _dw_extract_lane(hi: torch.Tensor, lo: torch.Tensor, offset: int,
                     width: int, word_bits: int) -> torch.Tensor:
    """``width`` bits at bit ``offset`` of the (hi, lo) pair, as int64
    (the pair's halves in their int64 form, ``samd.widen``)."""
    wb = word_bits
    if offset + width <= wb:
        out = shr(lo, offset, wb)
    elif offset >= wb:
        out = shr(hi, offset - wb, wb)
    else:  # straddles the boundary
        out = shr(lo, offset, wb) | (hi << (wb - offset))
    return out & word_mask((1 << width) - 1, wb)


def _dw_msb_fixup(hi: torch.Tensor, lo: torch.Tensor, fmt: SAMDFormat):
    """Signed-product borrow fixup (Fig. 12) across a (hi, lo) pair."""
    wb = fmt.word_bits
    msb = masks.build_mask(fmt.lane_width - 1, 1, fmt.lane_width, 2 * wb)
    s_hi = narrow(widen(hi, wb) & word_mask(msb >> wb, wb), wb)
    s_lo = narrow(widen(lo, wb) & word_mask(msb & ((1 << wb) - 1), wb), wb)
    q_hi, q_lo = dw_add((hi, lo), (s_hi, s_lo))
    return q_hi ^ s_hi, q_lo ^ s_lo


def _widening_mul(x_word: torch.Tensor, k_word: torch.Tensor,
                  fmt: SAMDFormat):
    """The full unsigned product of two words as a (hi, lo) pair."""
    if fmt.word_bits == 32:
        return mul_wide_u32(x_word, k_word)
    return mul_wide_u64(x_word, k_word)


def _grys_adjust_hi(hi, x_word, k_word, fmt: SAMDFormat):
    """hi -= sx*k + sk*x: the signed high half of an unsigned widening
    multiply (§6, Grys [9]); sx, sk are the words' top bits."""
    wb = fmt.word_bits
    x, k, h = widen(x_word, wb), widen(k_word, wb), widen(hi, wb)
    h = h - torch.where(shr(x, wb - 1, wb) == 1, k, torch.zeros_like(k))
    h = h - torch.where(shr(k, wb - 1, wb) == 1, x, torch.zeros_like(x))
    return narrow(h, wb)


# -- the op: full 1D convolution via scalar multiplication --------------------

def pack_conv_operand(values: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Pack [..., n] integer values chunk-wise, one word per ``lanes``
    values, sign-extended into the spacer bits when the plan is signed."""
    fmt = plan.fmt
    k = fmt.lanes_per_word
    n = values.shape[-1]
    nc = -(-n // k)
    v = values
    if nc * k - n:
        v = torch.nn.functional.pad(v, (0, nc * k - n))
    v = v.reshape(v.shape[:-1] + (nc, k))
    words = pack(v, fmt)[..., 0]
    if fmt.signed:
        words = sign_extend_for_mul(words, fmt)
    return words  # [..., nc]


def pack_conv_kernel(kernel: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Pack [..., taps] kernel values into one word each."""
    words = pack(kernel, plan.fmt)[..., 0]
    if plan.fmt.signed:
        words = sign_extend_for_mul(words, plan.fmt)
    return words


def chunk_products(x_words: torch.Tensor, k_word: torch.Tensor,
                   plan: ConvPlan):
    """Widening multiply of every chunk word by the kernel word, with the
    signed high-half adjustment and borrow fixup. Returns (hi, lo)."""
    hi, lo = _widening_mul(x_words, k_word, plan.fmt)
    if plan.fmt.signed:
        hi = _grys_adjust_hi(hi, x_words, k_word, plan.fmt)
        hi, lo = _dw_msb_fixup(hi, lo, plan.fmt)
    return hi, lo


def extract_outputs(hi: torch.Tensor, lo: torch.Tensor,
                    plan: ConvPlan) -> torch.Tensor:
    """The ``lanes + taps - 1`` output lanes of each chunk product, those
    that straddle the halves included, as int32 [..., nc, out_lanes]:
    sign-extended over the lane when signed, then taken to int32 as the
    reference does (a lane wider than 32 bits wraps)."""
    fmt = plan.fmt
    wb, L = fmt.word_bits, fmt.lane_width
    h, lo_ = widen(hi, wb), widen(lo, wb)
    outs = []
    for t in range(plan.out_lanes_per_chunk):
        v = _dw_extract_lane(h, lo_, t * L, L, wb)
        if fmt.signed and L < 64:
            v = v - ((shr(v, L - 1, 64) & 1) << L)
        outs.append(to_int32_words(v))
    return torch.stack(outs, dim=-1)


def overlap_add(ext: torch.Tensor, plan: ConvPlan, n_out: int) -> torch.Tensor:
    """Align the parallelogram partial-product regions of successive
    chunks (§5.1): chunk c's lane t lands at global index c*lanes + t."""
    lanes = plan.lanes_per_chunk
    nc = ext.shape[-2]
    total = nc * lanes + plan.taps - 1
    out = torch.zeros(ext.shape[:-2] + (total,), dtype=torch.int32,
                      device=ext.device)
    for t in range(plan.out_lanes_per_chunk):
        out[..., t:t + nc * lanes:lanes] += ext[..., :, t]
    return out[..., :n_out]


def samd_conv_full(x: torch.Tensor, kernel: torch.Tensor,
                   plan: ConvPlan) -> torch.Tensor:
    """Full 1D convolution (``np.convolve(x, k)``) of integer sequences,
    one widening multiply per ``lanes_per_chunk`` input values.

    x: [..., n] int; kernel: [taps] int -> [..., n + taps - 1] int32.
    """
    n = x.shape[-1]
    hi, lo = chunk_products(pack_conv_operand(x, plan),
                            pack_conv_kernel(kernel, plan), plan)
    return overlap_add(extract_outputs(hi, lo, plan), plan,
                       n + plan.taps - 1)


def samd_correlate_valid(x: torch.Tensor, kernel: torch.Tensor,
                         plan: ConvPlan) -> torch.Tensor:
    """CNN-style 'valid' correlation: out[i] = sum_j k[j] * x[i+j]."""
    full = samd_conv_full(x, torch.flip(kernel, [-1]), plan)
    return full[..., plan.taps - 1:x.shape[-1]]


def samd_conv_multichannel(x: torch.Tensor, kernel: torch.Tensor,
                           plan: ConvPlan) -> torch.Tensor:
    """sum_c full_conv(x[c], kernel[c]), accumulated across channels in
    the packed domain before one fixup and extraction (§5).

    x: [..., C, n]; kernel: [C, taps] -> [..., n + taps - 1] int32. The
    plan's lanes must hold the cross-channel sum
    (``overflow.plan_for_kernel``).
    """
    fmt = plan.fmt
    n = x.shape[-1]
    xw = pack_conv_operand(x, plan)          # [..., C, nc]
    kw = pack_conv_kernel(kernel, plan)[..., :, None]  # [C, 1]
    hi, lo = _widening_mul(xw, kw, fmt)
    if fmt.signed:
        hi = _grys_adjust_hi(hi, xw, kw, fmt)
    acc = hi[..., 0, :], lo[..., 0, :]
    for c in range(1, x.shape[-2]):
        acc = dw_add(acc, (hi[..., c, :], lo[..., c, :]))
    if fmt.signed:
        acc = _dw_msb_fixup(*acc, fmt)
    return overlap_add(extract_outputs(*acc, plan), plan, n + plan.taps - 1)


def samd_conv_grouped(x: torch.Tensor, kernel: torch.Tensor, bits: int,
                      word_bits: int = 32) -> torch.Tensor:
    """Multichannel conv-as-multiplication with channels accumulated in
    packed groups sized by the worst-case §7 bound for a ``word_bits``
    word (lanes of ``word_bits // taps`` bits), and the groups summed
    after extraction.

    x: [C, n], kernel: [C, taps] -> [n + taps - 1] int32.
    """
    c, n = x.shape
    taps = kernel.shape[-1]
    lane_max = word_bits // taps
    cap = (1 << (lane_max - 1)) - 1
    prod_max = taps * (1 << (bits - 1)) * (1 << (bits - 1))
    g = min(max(1, cap // prod_max), c)   # channels per packed group
    plan = make_plan(bits, taps, signed=True, word_bits=word_bits,
                     lane_width=lane_max)
    ng = -(-c // g)
    if ng * g - c:
        x = torch.nn.functional.pad(x, (0, 0, 0, ng * g - c))
        kernel = torch.nn.functional.pad(kernel, (0, 0, 0, ng * g - c))
    outs = [samd_conv_multichannel(x[i * g:(i + 1) * g],
                                   kernel[i * g:(i + 1) * g], plan)
            for i in range(ng)]
    return torch.stack(outs).sum(dim=0, dtype=torch.int32)


def conv_by_scale(x: torch.Tensor, kernel: torch.Tensor, bits: int,
                  signed: bool = True, word_bits: int = 32) -> torch.Tensor:
    """Full 1D convolution by one vector scale (§4) per kernel tap: for
    formats too wide for conv-via-multiplication. Each tap multiplies the
    whole packed input by one scalar word; the shifted partial results
    are summed in the value domain."""
    fmt = scale_format(bits, signed, word_bits)
    n = x.shape[-1]
    taps = kernel.shape[-1]
    xw = pack(x, fmt)
    if signed:
        xw = sign_extend_for_mul(xw, fmt)
    out = torch.zeros(x.shape[:-1] + (n + taps - 1,), dtype=torch.int32,
                      device=x.device)
    for j in range(taps):
        # the tap as a full-width two's-complement word
        kj = narrow(kernel[..., j].to(torch.int64), word_bits)[..., None]
        vals = unpack_signed_product(vector_scale_perm(xw, kj, fmt), fmt, n)
        out[..., j:j + n] += vals
    return out
