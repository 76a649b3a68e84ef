"""Bit-width abstract interpreter over SAMD programs (lane safety).

Counterpart of ``repro/analysis/lanes.py``, cut to the ops that the
port's conv contracts run. A (bits, lane_width, signedness, depth)
configuration is safe iff no lane's worst-case integer interval
overflows into its neighbour, and every signed wide read of a product
word comes after the Fig. 12 borrow fixup (§6). A program is a
straight-line list of ops; the abstract state is the exact per-lane
interval plus two flags (sign-extended? borrow pending?). Signed
capacity includes the one unit the extraction borrow occupies below the
interval's minimum, as ``core.overflow.conv_output_bits`` counts it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

from repro_torch.core import overflow
from repro_torch.core.samd import SAMDFormat

SAFE = "safe"
NEEDS_SPACER = "needs-spacer-bits"
BORROW_MISSING = "borrow-fixup-missing"


class LaneSafetyError(ValueError):
    """An unsafe configuration; carries the machine-readable verdict."""

    def __init__(self, verdict: "Verdict"):
        self.verdict = verdict
        super().__init__(str(verdict))


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Lane-safety verdict of one checked configuration.

    ``required_lane_width`` is the widest any intermediate interval
    needed, ``spacer_bits_needed`` how many bits the lane is short (0
    when safe), ``lane_lo``/``lane_hi`` the widest interval reached.
    """

    status: str
    bits: int
    lane_width: int
    signed: bool
    word_bits: int
    depth: int
    required_lane_width: int
    spacer_bits_needed: int
    lane_lo: int
    lane_hi: int
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.status == SAFE

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        fmt = (f"b={self.bits} lane={self.lane_width} "
               f"{'signed' if self.signed else 'unsigned'} "
               f"word={self.word_bits} depth={self.depth}")
        if self.ok:
            return (f"safe [{fmt}]: range [{self.lane_lo}, {self.lane_hi}] "
                    f"uses {self.required_lane_width}/{self.lane_width} "
                    f"lane bits "
                    f"({self.lane_width - self.required_lane_width} spare)")
        return f"{self.status} [{fmt}]: {self.detail}"


@dataclasses.dataclass(frozen=True)
class Pack:
    """Pack b-bit values into lanes (``samd.pack``)."""


@dataclasses.dataclass(frozen=True)
class SignExtend:
    """Sign-extend lane values into their spacer bits (Fig. 11)."""


@dataclasses.dataclass(frozen=True)
class MulKernel:
    """Multiply by a packed kernel word of the format's b-bit values:
    each output lane sums up to ``taps`` products (§5)."""

    taps: int


@dataclasses.dataclass(frozen=True)
class BorrowFixup:
    """``correct_signed_product`` (Fig. 12)."""


@dataclasses.dataclass(frozen=True)
class ReadWide:
    """Read whole ``lane_width``-bit lanes (``unpack_lanes_wide``)."""


@dataclasses.dataclass(frozen=True)
class ReadValue:
    """Read the low ``bits`` of each lane (``samd.unpack``)."""


Op = Union[Pack, SignExtend, MulKernel, BorrowFixup, ReadWide, ReadValue]


def _required_width(lo: int, hi: int, signed: bool, borrow: bool) -> int:
    """Lane bits needed to store [lo, hi], with the borrow unit a signed
    product word occupies below ``lo`` (§6)."""
    if signed:
        return overflow.bits_required_signed(lo - (1 if borrow else 0), hi)
    return overflow.bits_required_unsigned(hi)


def interpret(fmt: SAMDFormat, program: Sequence[Op],
              depth: int = 1) -> Verdict:
    """Run ``program`` abstractly over ``fmt``'s lanes; ``depth`` only
    labels the verdict."""
    lo, hi = overflow.input_range(fmt.bits, fmt.signed)
    sign_extended = not fmt.signed
    pending_borrow = False
    worst_lo, worst_hi = lo, hi
    required = _required_width(lo, hi, fmt.signed, False)

    def verdict(status: str, detail: str = "") -> Verdict:
        return Verdict(status, fmt.bits, fmt.lane_width, fmt.signed,
                       fmt.word_bits, depth, required,
                       max(0, required - fmt.lane_width), worst_lo, worst_hi,
                       detail)

    for op in program:
        if isinstance(op, Pack):
            lo, hi = overflow.input_range(fmt.bits, fmt.signed)
            pending_borrow = False
            sign_extended = not fmt.signed
        elif isinstance(op, SignExtend):
            if not fmt.signed:
                raise ValueError("sign extension on an unsigned format")
            sign_extended = True
        elif isinstance(op, MulKernel):
            if fmt.signed and not sign_extended:
                raise ValueError(
                    "signed multiply without sign_extend_for_mul: the "
                    "packed word is not the signed-coefficient polynomial "
                    "(Fig. 11)")
            k_lo, k_hi = overflow.input_range(fmt.bits, fmt.signed)
            cross = (lo * k_lo, lo * k_hi, hi * k_lo, hi * k_hi)
            lo, hi = op.taps * min(cross), op.taps * max(cross)
            pending_borrow = fmt.signed
        elif isinstance(op, BorrowFixup):
            pending_borrow = False
        elif isinstance(op, (ReadWide, ReadValue)):
            if fmt.signed and pending_borrow:
                return verdict(
                    BORROW_MISSING,
                    "signed product word read without the Fig. 12 borrow "
                    "fixup — route the read through unpack_signed_product "
                    "(or apply correct_signed_product first)")
            continue
        else:
            raise TypeError(f"unknown op {op!r}")

        # after every state-changing op the interval (and a pending borrow
        # unit below it) must fit the lane
        need = _required_width(lo, hi, fmt.signed, pending_borrow)
        if need > required:
            required = need
            worst_lo, worst_hi = lo, hi
        if need > fmt.lane_width:
            borrow_note = ""
            if (fmt.signed and pending_borrow
                    and _required_width(lo, hi, True, False)
                    <= fmt.lane_width):
                borrow_note = (" (the magnitude fits; the missing bit is the "
                               "signed extraction borrow headroom, §6)")
            return verdict(
                NEEDS_SPACER,
                f"lane interval [{lo}, {hi}] after {type(op).__name__} "
                f"needs {need} bits but lane_width={fmt.lane_width}; add "
                f"{need - fmt.lane_width} spacer bit(s)" + borrow_note)

    return verdict(SAFE)
