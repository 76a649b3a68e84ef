"""SAMD vector format on 32-bit words (paper §2-§4), in PyTorch.

A SAMD word embeds ``lanes_per_word`` lanes of ``lane_width`` bits; a
value occupies the low ``bits`` bits of its lane and the rest are spacer
bits (zero after ``pack``). Lane 0 sits at the least significant bit.

Words are held as ``torch.int32`` with the same bits as the reference's
``uint32`` words: PyTorch's CPU build has no shifts or adds on
``torch.uint32``, and ``>>`` on int32 is arithmetic. So ``pack`` widens to
int64 and wraps back, and ``unpack`` masks after every right shift, which
is exact while ``shift + bits <= 32`` (always true for a lane inside its
word).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import masks


@dataclasses.dataclass(frozen=True)
class SAMDFormat:
    """How values are embedded in 32-bit words.

    bits:        precision of each value.
    lane_width:  bits per lane, value + spacer (``bits`` for the dense
                 temporary-spacer format, ``bits + 1`` for one permanent
                 spacer bit).
    signed:      two's-complement lanes if True.
    """

    bits: int
    lane_width: int
    signed: bool = True

    def __post_init__(self):
        if self.bits < 1:
            raise ValueError("bits must be >= 1")
        if self.lane_width < self.bits:
            raise ValueError("lane_width must be >= bits")
        if self.lane_width > 32:
            raise ValueError("lane must fit in a word")

    @property
    def lanes_per_word(self) -> int:
        return 32 // self.lane_width

    @property
    def value_bits_mask(self) -> int:
        """The value bits of every lane; spacer bits are outside it."""
        return masks.value_mask(self.bits, self.lane_width)


def num_words(n_values: int, fmt: SAMDFormat) -> int:
    return -(-n_values // fmt.lanes_per_word)


def to_int32_words(words64: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 bit patterns -> int32 with the same bits."""
    w = words64 & 0xFFFFFFFF
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def pack(values: torch.Tensor, fmt: SAMDFormat) -> torch.Tensor:
    """Pack integer ``values`` [..., n] into int32 words [..., n_words].

    Values are truncated to ``fmt.bits`` bits (two's complement when
    signed); spacer bits and the lanes past ``n`` are zero.
    """
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
