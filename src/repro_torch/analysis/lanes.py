"""Bit-width abstract interpreter over SAMD programs (lane safety).

The port's copy of ``repro/analysis/lanes.py``. A (bits, lane_width,
word_bits, signedness, accumulation-depth) configuration is safe iff no
lane's worst-case integer range can overflow into its neighbour, and
every signed wide-lane read applies the Fig. 12 borrow fixup (§6). A
SAMD program is a straight-line list of ops (pack -> sign-extend ->
multiply -> accumulate -> shift -> unpack); the abstract state is the
*exact* per-lane integer interval plus two bits of dataflow state
(sign-extended? borrow pending?).

The interval arithmetic is exact: products take min/max over interval
cross products, known constant kernels use the §7 positive/negative
tap-sum split (:func:`repro_torch.core.overflow.dot_range`), and signed
capacity includes the one unit the extraction borrow occupies below the
interval minimum, as ``core.overflow.conv_output_bits`` counts it.

The result is a machine-readable :class:`Verdict`, field for field the
reference's:

* ``safe``: every intermediate interval fits its lane and all signed
  wide reads are borrow-corrected;
* ``needs-spacer-bits``: some interval needs N more bits per lane
  (``spacer_bits_needed``);
* ``borrow-fixup-missing``: a signed product word is read without
  ``correct_signed_product`` / ``unpack_signed_product``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core import overflow
from repro_torch.core.samd import SAMDFormat

SAFE = "safe"
NEEDS_SPACER = "needs-spacer-bits"
BORROW_MISSING = "borrow-fixup-missing"


class LaneSafetyError(ValueError):
    """Raised when an enforced check (``verify=True``) finds an unsafe
    configuration. Carries the machine-readable verdict."""

    def __init__(self, verdict: "Verdict"):
        self.verdict = verdict
        super().__init__(str(verdict))


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Machine-readable lane-safety verdict for one checked configuration.

    ``required_lane_width`` is the worst-case width any intermediate
    interval needed; ``spacer_bits_needed`` is how many bits the lane is
    short (0 when safe). ``lane_lo``/``lane_hi`` is the widest interval
    reached (including the signed borrow unit when applicable).
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

    @property
    def headroom_bits(self) -> int:
        """Spare lane bits at the widest point (negative when unsafe)."""
        return self.lane_width - self.required_lane_width

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        fmt = (
            f"b={self.bits} lane={self.lane_width} "
            f"{'signed' if self.signed else 'unsigned'} "
            f"word={self.word_bits} depth={self.depth}"
        )
        if self.ok:
            return (
                f"safe [{fmt}]: range [{self.lane_lo}, {self.lane_hi}] "
                f"uses {self.required_lane_width}/{self.lane_width} lane "
                f"bits ({self.headroom_bits} spare)"
            )
        return f"{self.status} [{fmt}]: {self.detail}"


# ---------------------------------------------------------------------------
# program ops (straight-line IR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pack:
    """Pack b-bit values into lanes (``samd.pack`` / ``quant.packing``).

    ``bits``/``signed`` override the format's value range when the packed
    values are known to be narrower (e.g. unsigned codes in signed lanes).
    """

    bits: Optional[int] = None
    signed: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class SignExtend:
    """Sign-extend lane values into their spacer bits (Fig. 11)."""


@dataclasses.dataclass(frozen=True)
class MulKernel:
    """Multiply by a packed kernel word: each output lane accumulates up
    to ``taps`` products (conv-as-multiplication, §5; ``taps=1`` is the
    vector-scale op, §4).

    With ``kernel`` (known constants, shape [taps]) the §7 tap-sum bound
    applies; otherwise the worst case over ``kernel_bits``-bit
    (``kernel_signed``) kernels is used.
    """

    taps: int
    kernel_bits: Optional[int] = None
    kernel_signed: Optional[bool] = None
    kernel: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class Accumulate:
    """Accumulate ``depth`` independent product words lane-wise in the
    packed domain (cross-channel accumulation, §5 last paragraph)."""

    depth: int


@dataclasses.dataclass(frozen=True)
class ShiftRight:
    """Arithmetic right shift of every lane value (rescale)."""

    amount: int


@dataclasses.dataclass(frozen=True)
class BorrowFixup:
    """``correct_signed_product`` (Fig. 12): repairs the inter-lane
    borrow a signed multiply leaves in the raw word."""


@dataclasses.dataclass(frozen=True)
class ReadWide:
    """Read full ``lane_width``-bit lanes (``unpack_lanes_wide``). On a
    signed product word this is only sound after :class:`BorrowFixup` —
    ``unpack_signed_product`` fuses the two."""


@dataclasses.dataclass(frozen=True)
class ReadValue:
    """Read the low ``bits`` of each lane (``samd.unpack``), defined
    mod 2^bits — exact for stored codes, also borrow-sensitive on raw
    signed product words."""


Op = Union[
    Pack,
    SignExtend,
    MulKernel,
    Accumulate,
    ShiftRight,
    BorrowFixup,
    ReadWide,
    ReadValue,
]


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def _required_width(lo: int, hi: int, signed: bool, borrow: bool) -> int:
    """Lane bits needed to store [lo, hi], including the borrow unit a
    signed product word temporarily occupies below ``lo`` (§6)."""
    if signed:
        return overflow.bits_required_signed(lo - (1 if borrow else 0), hi)
    return overflow.bits_required_unsigned(hi)


def _mul_interval(
    lo: int, hi: int, op: MulKernel, fmt: SAMDFormat
) -> tuple[int, int]:
    if op.kernel is not None:
        return overflow.dot_range(np.asarray(op.kernel), lo, hi)
    kb = op.kernel_bits if op.kernel_bits is not None else fmt.bits
    ks = op.kernel_signed if op.kernel_signed is not None else fmt.signed
    k_lo, k_hi = overflow.input_range(kb, ks)
    cross = (lo * k_lo, lo * k_hi, hi * k_lo, hi * k_hi)
    return op.taps * min(cross), op.taps * max(cross)


def interpret(
    fmt: SAMDFormat, program: Sequence[Op], depth: int = 1
) -> Verdict:
    """Run the abstract interpreter over ``program`` and return the
    verdict. ``depth`` only labels the verdict (callers pass the total
    accumulation depth they encoded in the program)."""
    lo, hi = overflow.input_range(fmt.bits, fmt.signed)
    sign_extended = not fmt.signed  # unsigned lanes need no extension
    pending_borrow = False
    worst_lo, worst_hi = lo, hi
    required = _required_width(lo, hi, fmt.signed, False)

    def verdict(status: str, detail: str = "") -> Verdict:
        return Verdict(
            status=status,
            bits=fmt.bits,
            lane_width=fmt.lane_width,
            signed=fmt.signed,
            word_bits=fmt.word_bits,
            depth=depth,
            required_lane_width=required,
            spacer_bits_needed=max(0, required - fmt.lane_width),
            lane_lo=worst_lo,
            lane_hi=worst_hi,
            detail=detail,
        )

    for op in program:
        if isinstance(op, Pack):
            bits = op.bits if op.bits is not None else fmt.bits
            signed = op.signed if op.signed is not None else fmt.signed
            if bits > fmt.bits:
                raise ValueError(
                    f"packed values ({bits}b) wider than format value "
                    f"field ({fmt.bits}b)"
                )
            lo, hi = overflow.input_range(bits, signed)
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
                    "(Fig. 11)"
                )
            lo, hi = _mul_interval(lo, hi, op, fmt)
            pending_borrow = fmt.signed
        elif isinstance(op, Accumulate):
            if op.depth < 1:
                raise ValueError(f"accumulation depth {op.depth} < 1")
            lo, hi = lo * op.depth, hi * op.depth
        elif isinstance(op, ShiftRight):
            lo, hi = lo >> op.amount, hi >> op.amount
        elif isinstance(op, BorrowFixup):
            pending_borrow = False
        elif isinstance(op, (ReadWide, ReadValue)):
            if fmt.signed and pending_borrow:
                return verdict(
                    BORROW_MISSING,
                    "signed product word read without the Fig. 12 borrow "
                    "fixup — route the read through unpack_signed_product "
                    "(or apply correct_signed_product first)",
                )
            continue
        else:
            raise TypeError(f"unknown op {op!r}")

        # capacity check after every state-changing op: the interval
        # (plus the pending borrow unit below it) must fit the lane
        need = _required_width(lo, hi, fmt.signed, pending_borrow)
        if need > required:
            required = need
            worst_lo, worst_hi = lo, hi
        if need > fmt.lane_width:
            borrow_note = ""
            if (
                fmt.signed
                and pending_borrow
                and _required_width(lo, hi, fmt.signed, False)
                <= fmt.lane_width
            ):
                borrow_note = (
                    " (the magnitude fits; the missing bit is the signed "
                    "extraction borrow headroom, §6)"
                )
            return verdict(
                NEEDS_SPACER,
                f"lane interval [{lo}, {hi}] after {type(op).__name__} "
                f"needs {need} bits but lane_width={fmt.lane_width}; add "
                f"{need - fmt.lane_width} spacer bit(s)" + borrow_note,
            )

    return verdict(SAFE)


# ---------------------------------------------------------------------------
# canonical programs + the (format, K, signedness) entry point
# ---------------------------------------------------------------------------


def accumulation_program(
    fmt: SAMDFormat,
    depth: int,
    *,
    taps: int = 1,
    kernel: Optional[np.ndarray] = None,
    kernel_bits: Optional[int] = None,
    kernel_signed: Optional[bool] = None,
    input_bits: Optional[int] = None,
    input_signed: Optional[bool] = None,
    fixup: bool = True,
    shift: int = 0,
) -> list:
    """The canonical packed-domain pipeline: pack -> sign-extend ->
    multiply (``taps`` products/lane) -> accumulate ``depth`` words ->
    shift -> wide read. ``fixup=False`` models the buggy program that
    skips the Fig. 12 correction."""
    ops: list = [Pack(bits=input_bits, signed=input_signed)]
    if fmt.signed:
        ops.append(SignExtend())
    if kernel is not None:
        kernel = tuple(int(v) for v in np.asarray(kernel).reshape(-1))
        ops.append(MulKernel(taps=len(kernel), kernel=kernel))
    else:
        ops.append(
            MulKernel(
                taps=taps,
                kernel_bits=kernel_bits,
                kernel_signed=kernel_signed,
            )
        )
    if depth > 1:
        ops.append(Accumulate(depth))
    if shift:
        ops.append(ShiftRight(shift))
    if fixup and fmt.signed:
        ops.append(BorrowFixup())
    ops.append(ReadWide())
    return ops


def check_accumulation(
    fmt: SAMDFormat,
    depth: int,
    *,
    taps: int = 1,
    kernel: Optional[np.ndarray] = None,
    kernel_bits: Optional[int] = None,
    kernel_signed: Optional[bool] = None,
    input_bits: Optional[int] = None,
    input_signed: Optional[bool] = None,
    fixup: bool = True,
) -> Verdict:
    """Verdict for a (SAMDFormat, K, signedness) tuple: ``depth`` words of
    ``taps`` b-bit products accumulated per lane in the packed domain,
    then read wide. ``kernel`` (known constants) tightens the bound per
    §7; total products per lane = ``taps * depth``."""
    program = accumulation_program(
        fmt,
        depth,
        taps=taps,
        kernel=kernel,
        kernel_bits=kernel_bits,
        kernel_signed=kernel_signed,
        input_bits=input_bits,
        input_signed=input_signed,
        fixup=fixup,
    )
    n_taps = taps if kernel is None else int(np.asarray(kernel).size)
    return interpret(fmt, program, depth=depth * n_taps)
