"""Constant-kernel overflow analysis (paper §7, Fig. 13, repaired).

The port's copy of ``repro/core/overflow.py`` (numpy only), building
the port's ``ConvPlan``.

Once a network is trained, kernel values are known constants. The worst-case
accumulator magnitude is then determined by the actual positive/negative tap
sums rather than the generic ``taps * max_product`` bound, so output lanes
can be packed tighter at deployment time.

Fig. 13 in the paper has two defects we repair: the inner ``kw`` loop is
missing, and the interaction with signed inputs is not spelled out. This
module computes exact worst-case bounds for all four signedness
combinations, plus the one extra unit of headroom needed for the signed
extraction borrow (§6).
"""
from __future__ import annotations

import numpy as np


def bits_required_unsigned(v: int) -> int:
    """Bits to represent non-negative v as an unsigned integer."""
    if v < 0:
        raise ValueError("unsigned representation of a negative value")
    return max(1, int(v).bit_length())


def bits_required_signed(lo: int, hi: int) -> int:
    """Bits for a two's-complement range covering [lo, hi]."""
    bits = 1
    while -(1 << (bits - 1)) > lo or (1 << (bits - 1)) - 1 < hi:
        bits += 1
    return bits


def input_range(input_bits: int, input_signed: bool) -> tuple[int, int]:
    if input_signed:
        return -(1 << (input_bits - 1)), (1 << (input_bits - 1)) - 1
    return 0, (1 << input_bits) - 1


def dot_range(
    kernel: np.ndarray, in_lo: int, in_hi: int
) -> tuple[int, int]:
    """Exact worst-case [min, max] of sum_j k_j * x_j for constant taps
    ``kernel`` against inputs ranging over [in_lo, in_hi] — the §7
    positive/negative tap-sum split, generalized to any input interval
    (the lane abstract interpreter feeds it intermediate intervals)."""
    k = np.asarray(kernel, dtype=np.int64)
    pos = int(k[k > 0].sum()) if (k > 0).any() else 0
    neg = int(k[k < 0].sum()) if (k < 0).any() else 0
    return pos * in_lo + neg * in_hi, pos * in_hi + neg * in_lo


def conv_output_range(
    kernel: np.ndarray, input_bits: int, input_signed: bool
) -> tuple[int, int]:
    """Exact worst-case [min, max] of sum_j k_j * x_j over all inputs.

    ``kernel`` may be any shape; all elements are assumed to contribute to a
    single accumulator (e.g. [C, KH, KW] for a full CNN conv output point).
    """
    in_min, in_max = input_range(input_bits, input_signed)
    return dot_range(kernel, in_min, in_max)


def conv_output_bits(
    kernel: np.ndarray, input_bits: int, input_signed: bool
) -> int:
    """Paper Fig. 13: lane bits needed for the accumulated output of a
    *known* kernel, including the signed-borrow headroom."""
    out_min, out_max = conv_output_range(kernel, input_bits, input_signed)
    if out_min >= 0:
        # result always non-negative, but extraction still needs the borrow
        # slot if any operand lane is signed-packed; be conservative only
        # when a negative tap exists.
        if (np.asarray(kernel) < 0).any() or input_signed:
            return bits_required_signed(out_min - 1, out_max)
        return bits_required_unsigned(out_max)
    return bits_required_signed(out_min - 1, out_max)


def generic_output_bits(
    kernel_bits: int, taps: int, input_bits: int,
    kernel_signed: bool, input_signed: bool,
) -> int:
    """Worst case over *unknown* kernels (pre-deployment bound)."""
    k_lo, k_hi = input_range(kernel_bits, kernel_signed)
    worst = np.full((taps,), k_lo if abs(k_lo) >= k_hi else k_hi, np.int64)
    return conv_output_bits(worst, input_bits, input_signed)


def plan_for_kernel(
    kernel: np.ndarray,
    input_bits: int,
    input_signed: bool,
    kernel_bits: int,
    word_bits: int = 32,
):
    """Build a ConvPlan whose lane width is derived from the §7 analysis of
    the actual kernel values. ``kernel``: [..., taps] (leading dims are
    accumulated channels)."""
    from repro_torch.core.conv import ConvPlan
    from repro_torch.core.samd import SAMDFormat

    taps = int(np.asarray(kernel).shape[-1])
    signed = bool(input_signed or (np.asarray(kernel) < 0).any())
    lane = conv_output_bits(kernel, input_bits, input_signed)
    lane = max(lane, max(input_bits, kernel_bits) + (1 if signed else 0))
    fmt = SAMDFormat(max(input_bits, kernel_bits), lane, signed, word_bits)
    plan = ConvPlan(fmt, taps)
    plan.validate()
    return plan
