"""SAMD packing of quantized weights and the quantized matmul entry point.

Layout (the reference's): a weight W[K, N] quantized to b bits is stored
as 32-bit words of ``values_per_word`` lanes packed along the reduction
axis K,

    packed[ceil(K / vpw), N]  int32 (uint32 bits),   scale[1, N]  float32

so the matmul kernel reads only packed bytes and unpacks lanes in
registers. Conv weights W[KH, KW, C_in, C_out] pack the same way along
C_in, their innermost reduction axis (``pack_conv_weights``).
"""
from __future__ import annotations

import torch

from repro_torch.core import samd
from repro_torch.quant.config import QuantConfig
from repro_torch.quant.quantizer import quantize_symmetric


def _fmt(cfg: QuantConfig) -> samd.SAMDFormat:
    return samd.SAMDFormat(cfg.bits, cfg.lane_width, signed=True)


def pack_weights(w: torch.Tensor, cfg: QuantConfig):
    """Quantize + SAMD-pack a [K, N] weight along axis 0.

    Returns (packed int32 [ceil(K/vpw), N], scale f32 [1, N]).
    """
    q, scale = quantize_symmetric(w, cfg.bits, axis=0)
    words = samd.pack(q.transpose(0, 1), _fmt(cfg))
    return words.transpose(0, 1).contiguous(), scale


def unpack_weights(packed: torch.Tensor, k: int,
                   cfg: QuantConfig) -> torch.Tensor:
    """Unpack to int32 codes [K, N]."""
    vals = samd.unpack(packed.transpose(0, 1), _fmt(cfg), k)
    return vals.transpose(0, 1)


def dequant_weights(packed: torch.Tensor, scale: torch.Tensor, k: int,
                    cfg: QuantConfig, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_weights(packed, k, cfg)
    return (q.to(torch.float32) * scale).to(dtype)


def pack_conv_weights(w: torch.Tensor, cfg: QuantConfig):
    """Quantize + SAMD-pack a conv weight W[KH, KW, C_in, C_out].

    One scale per output channel over its whole (KH, KW, C_in) fan-in, so
    the conv kernel sums raw codes over every tap and channel and scales
    once at the store. Lanes pack along C_in, lane 0 in the low bits.

    Returns (packed int32 [KH, KW, ceil(C_in/vpw), C_out], scale f32
    [1, C_out]).
    """
    kh, kw, c_in, c_out = w.shape
    q, scale = quantize_symmetric(w.reshape(kh * kw * c_in, c_out),
                                  cfg.bits, axis=0)
    q = q.reshape(kh, kw, c_in, c_out)
    words = samd.pack(q.movedim(2, -1), _fmt(cfg))   # [kh, kw, c_out, cw]
    return words.movedim(-1, 2).contiguous(), scale


def unpack_conv_weights(packed: torch.Tensor, c_in: int,
                        cfg: QuantConfig) -> torch.Tensor:
    """Inverse of ``pack_conv_weights`` (codes only): int32
    [KH, KW, C_in, C_out]."""
    vals = samd.unpack(packed.movedim(2, -1), _fmt(cfg), c_in)
    return vals.movedim(-1, 2)


def dequant_conv_weights(packed: torch.Tensor, scale: torch.Tensor,
                         c_in: int, cfg: QuantConfig,
                         dtype=torch.float32) -> torch.Tensor:
    """Dense [KH, KW, C_in, C_out] conv weight from the packed form."""
    q = unpack_conv_weights(packed, c_in, cfg)
    return (q.to(torch.float32) * scale.reshape(1, 1, 1, -1)).to(dtype)


def pack_int8_lanes(vals: torch.Tensor) -> torch.Tensor:
    """int8 [..., D] -> int32 words [..., D//4]: four 8-bit lanes per word
    along the trailing axis, lane 0 in the low byte. The storage format of
    the packed paged KV pool."""
    d = vals.shape[-1]
    if d % 4:
        raise ValueError(f"trailing dim {d} must pack into whole words")
    u = vals.to(torch.int64) & 0xFF
    u = u.reshape(vals.shape[:-1] + (d // 4, 4))
    shifts = torch.arange(4, dtype=torch.int64, device=vals.device) * 8
    return samd.to_int32_words((u << shifts).sum(dim=-1))


def unpack_int8_lanes(words: torch.Tensor) -> torch.Tensor:
    """int32 words [..., W] -> sign-extended int32 [..., W*4] (inverse of
    ``pack_int8_lanes``)."""
    shifts = torch.arange(4, dtype=torch.int32, device=words.device) * 8
    v = (words[..., None] >> shifts) & 0xFF
    v = v - ((v >> 7) & 1) * 256
    return v.reshape(words.shape[:-1] + (words.shape[-1] * 4,))


def qmatmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
            k: int, cfg: QuantConfig) -> torch.Tensor:
    """x[..., K] @ dequant(packed)[K, N] through the SAMD matmul kernel
    (its plain version for a CPU tensor)."""
    from repro_torch.kernels import ops

    return ops.samd_matmul(x, packed, scale, k, cfg)
