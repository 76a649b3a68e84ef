"""Bitmask construction for SAMD words (paper Fig. 3), as Python ints."""
from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=None)
def build_mask(start: int, width: int, stride: int,
               word_bits: int = 32) -> int:
    """Lay a run of ``width`` ones at every ``stride`` bits, from ``start``."""
    if width <= 0 or stride <= 0:
        raise ValueError(
            f"width/stride must be positive, got {width}/{stride}"
        )
    sub_mask = (1 << width) - 1
    mask = 0
    for i in range(start, word_bits, stride):
        mask |= sub_mask << i
    return mask & ((1 << word_bits) - 1)


def value_mask(value_bits: int, lane_width: int, word_bits: int = 32) -> int:
    """Low ``value_bits`` of each ``lane_width``-bit lane (value portion)."""
    return build_mask(0, value_bits, lane_width, word_bits)


def even_lane_mask(w: int, word_bits: int = 32) -> int:
    """All bits of every even-numbered ``w``-bit lane."""
    return build_mask(0, w, 2 * w, word_bits)


def odd_lane_mask(w: int, word_bits: int = 32) -> int:
    """All bits of every odd-numbered ``w``-bit lane."""
    return build_mask(w, w, 2 * w, word_bits)


def msb_lane_mask(w: int, word_bits: int = 32) -> int:
    """1 in the most significant bit of each ``w``-bit lane."""
    return build_mask(w - 1, 1, w, word_bits)


def lsb_lane_mask(w: int, word_bits: int = 32) -> int:
    """1 in the least significant bit of each ``w``-bit lane."""
    return build_mask(0, 1, w, word_bits)


def lane_mask(lane_width: int, word_bits: int = 32) -> int:
    """All bits of each lane (everything below the last partial lane)."""
    return build_mask(0, lane_width, lane_width, word_bits)


def full_mask(word_bits: int = 32) -> int:
    return (1 << word_bits) - 1
