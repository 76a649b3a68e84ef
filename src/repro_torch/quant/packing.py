"""SAMD packing of quantized weights and the quantized matmul entry point.

Layout (the reference's): a weight W[K, N] quantized to b bits is stored
as 32-bit words of ``values_per_word`` lanes packed along the reduction
axis K,

    packed[ceil(K / vpw), N]  int32 (uint32 bits),
    scale[1, N] float32, or scale[K // group_size, N] with group scales

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


# columns quantized and packed at a time: packing widens to int64, so a
# [5120, 151936] LM head in one piece would need ~20 GB of temporaries
_PACK_COLUMNS = 1 << 13


def pack_weights(w: torch.Tensor, cfg: QuantConfig):
    """Quantize + SAMD-pack a [K, N] weight along axis 0.

    Returns (packed int32 [ceil(K/vpw), N], scale f32 [1, N], or
    [K // group_size, N] when ``cfg.group_size`` is set). Columns are
    independent, so they are packed ``_PACK_COLUMNS`` at a time.
    """
    parts = []
    for c in range(0, w.shape[1], _PACK_COLUMNS):
        q, scale = quantize_symmetric(w[:, c:c + _PACK_COLUMNS], cfg.bits,
                                      axis=0, group_size=cfg.group_size)
        words = samd.pack(q.transpose(0, 1), _fmt(cfg))
        parts.append((words.transpose(0, 1), scale))
    if len(parts) == 1:
        return parts[0][0].contiguous(), parts[0][1]
    return (torch.cat([p for p, _ in parts], dim=1),
            torch.cat([s for _, s in parts], dim=1))


def unpack_weights(packed: torch.Tensor, k: int,
                   cfg: QuantConfig) -> torch.Tensor:
    """Unpack to int32 codes [K, N]."""
    vals = samd.unpack(packed.transpose(0, 1), _fmt(cfg), k)
    return vals.transpose(0, 1)


def dequant_weights(packed: torch.Tensor, scale: torch.Tensor, k: int,
                    cfg: QuantConfig, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_weights(packed, k, cfg)
    if cfg.group_size is not None:
        g = cfg.group_size
        qg = q.reshape((k // g, g) + tuple(q.shape[1:]))
        w = qg.to(torch.float32) * scale[:, None]
        return w.reshape(q.shape).to(dtype)
    return (q.to(torch.float32) * scale).to(dtype)


def pack_conv_weights(w: torch.Tensor, cfg: QuantConfig):
    """Quantize + SAMD-pack a conv weight W[KH, KW, C_in, C_out].

    One scale per output channel over its whole (KH, KW, C_in) fan-in, so
    the conv kernel sums raw codes over every tap and channel and scales
    once at the store. Lanes pack along C_in, lane 0 in the low bits.

    Returns (packed int32 [KH, KW, ceil(C_in/vpw), C_out], scale f32
    [1, C_out]).
    """
    if cfg.group_size is not None:
        raise NotImplementedError("conv packing is per-output-channel only")
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
    """x[..., K] @ dequant(packed)[K, N].

    Per-channel scales run the SAMD matmul kernel (its plain version for
    a CPU tensor). Group scales (``cfg.group_size``) dequantize the
    weight to x's dtype and multiply with ``torch.matmul``: the
    reference's one working route for them (``backend="xla"``; its
    Pallas kernel refuses group scales, and so does ``ops.samd_matmul``).
    No kernel of either package computes that product, so this is the
    route itself, not a fallback from one.
    """
    if cfg.group_size is not None:
        return torch.matmul(x, dequant_weights(packed, scale, k, cfg,
                                               dtype=x.dtype))
    from repro_torch.kernels import ops

    return ops.samd_matmul(x, packed, scale, k, cfg)
