"""Bit-precise op generator (paper §8), in PyTorch.

Counterpart of ``repro/core/codegen.py``: for one (bits, taps,
signedness, spacer regime, word width) tuple it returns a closure over the lane
functions of ``core.samd`` and ``core.conv`` with the geometry fixed,
and a model of the native scalar instructions each word operation costs
(the paper's op-level analysis). The closures run eagerly; nothing is
compiled.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core import conv as conv_mod
from repro_torch.core import overflow
from repro_torch.core.samd import (
    SAMDFormat,
    dense_format,
    perm_format,
    samd_add,
    samd_add_perm,
    samd_mul,
    samd_sub,
)


@dataclasses.dataclass(frozen=True)
class OpCounts:
    """Native scalar instructions per word operation (model, paper §8)."""

    bitwise: int = 0
    addsub: int = 0
    mul: int = 0
    shift: int = 0

    @property
    def total(self) -> int:
        return self.bitwise + self.addsub + self.mul + self.shift

    def __add__(self, o: "OpCounts") -> "OpCounts":
        return OpCounts(self.bitwise + o.bitwise, self.addsub + o.addsub,
                        self.mul + o.mul, self.shift + o.shift)

    def scaled(self, k: int) -> "OpCounts":
        return OpCounts(self.bitwise * k, self.addsub * k, self.mul * k,
                        self.shift * k)


# op-count models of the primitive SAMD sequences (constants folded)
ADD_TEMP = OpCounts(bitwise=4, addsub=1)          # Fig. 5
ADD_PERM = OpCounts(bitwise=2, addsub=1)          # Fig. 2
SUB_TEMP = OpCounts(bitwise=5, addsub=1)          # Fig. 6
SIGN_EXTEND = OpCounts(bitwise=1, addsub=1, shift=1)   # Fig. 11
FIXUP_TEMP = OpCounts(bitwise=2, addsub=1)        # Fig. 12: q=p+(p&m); q^(p&m)
FIXUP_PERM = OpCounts(bitwise=1, addsub=1)        # §6.1: xor elided
WIDE_MUL_NATIVE = OpCounts(mul=1)                 # 64x64->128 on a CPU
WIDE_MUL_TPU32 = OpCounts(mul=4, addsub=3, bitwise=4, shift=5)  # 16-bit limbs
GRYS_ADJUST = OpCounts(bitwise=2, addsub=2, shift=2)


@dataclasses.dataclass(frozen=True)
class SynthesizedOp:
    """A generated bit-precise op: a callable and its static metadata."""

    name: str
    fn: Callable
    fmt: SAMDFormat
    counts: OpCounts
    values_per_word: int

    def counts_per_value(self) -> float:
        return self.counts.total / max(1, self.values_per_word)


def generate_pointwise(bits: int, regime: str = "temporary",
                       signed: bool = True, word_bits: int = 32):
    """The lane-wise add/sub/mul family of one format."""
    if regime == "temporary":
        fmt = dense_format(bits, signed, word_bits)
        add_fn, add_counts = samd_add, ADD_TEMP
    elif regime == "permanent":
        fmt = perm_format(bits, signed, word_bits)
        add_fn, add_counts = samd_add_perm, ADD_PERM
    else:
        raise ValueError(f"unknown spacer regime {regime!r}")

    k = fmt.lanes_per_word
    return {
        "add": SynthesizedOp(f"samd_add_b{bits}_{regime[:4]}",
                             lambda a, b: add_fn(a, b, fmt), fmt,
                             add_counts, k),
        "sub": SynthesizedOp(f"samd_sub_b{bits}_{regime[:4]}",
                             lambda a, b: samd_sub(a, b, fmt), fmt,
                             SUB_TEMP, k),
        "mul": SynthesizedOp(
            f"samd_mul_b{bits}_{regime[:4]}",
            lambda a, b: samd_mul(a, b, fmt), fmt,
            # per iteration: read-mask AND, write-mask build (shift, sub,
            # AND), partial-product AND + shift, then a SAMD add
            (OpCounts(bitwise=3, addsub=1, shift=2) + add_counts).scaled(bits),
            k),
    }


def generate_conv(bits: int, taps: int, signed: bool = True,
                  word_bits: int = 32, regime: str = "permanent",
                  kernel: Optional[np.ndarray] = None,
                  channels: int = 1,
                  paper_compat: bool = False) -> SynthesizedOp:
    """A conv-via-multiplication op (§5) for one geometry.

    With ``kernel`` given, the §7 constant-kernel analysis picks the least
    lane width for the whole cross-channel sum; otherwise the generic
    worst case over ``channels * taps`` products does.
    """
    if kernel is not None:
        plan = overflow.plan_for_kernel(
            np.asarray(kernel), bits, input_signed=signed,
            kernel_bits=bits, word_bits=word_bits)
    else:
        lane = overflow.generic_output_bits(
            bits, taps * channels, bits, kernel_signed=signed,
            input_signed=signed)
        plan = conv_mod.make_plan(bits, taps, signed, word_bits,
                                  paper_compat=paper_compat,
                                  lane_width=max(lane, bits + 1))

    if channels > 1:
        def fn(x, k):
            return conv_mod.samd_conv_multichannel(x, k, plan)
    else:
        def fn(x, k):
            return conv_mod.samd_conv_full(x, k, plan)

    per_chunk = WIDE_MUL_NATIVE if word_bits == 64 else WIDE_MUL_TPU32
    if signed:
        per_chunk = per_chunk + GRYS_ADJUST
    # one fixup + extraction amortized across channels (accumulate first)
    fixup = FIXUP_PERM if regime == "permanent" else FIXUP_TEMP
    extract = OpCounts(bitwise=2, shift=2).scaled(plan.out_lanes_per_chunk)
    counts = per_chunk.scaled(channels) + fixup + extract + SIGN_EXTEND.scaled(
        channels if signed else 0)
    return SynthesizedOp(
        f"samd_conv_b{bits}_t{taps}_c{channels}_{regime[:4]}", fn, plan.fmt,
        counts, plan.lanes_per_chunk * channels)


def native_conv_counts(taps: int, channels: int) -> OpCounts:
    """Baseline: the native 8-bit MAC loop (Fig. 14) per output point."""
    return OpCounts(mul=taps * channels, addsub=taps * channels)
