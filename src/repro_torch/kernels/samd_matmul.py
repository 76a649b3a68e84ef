"""SAMD packed-weight matmul: the CUDA kernel and its plain PyTorch version.

    out[M, N] = x[M, K] @ (codes(packed[ceil(K/vpw), N]) * scale[1, N])

Counterpart of ``repro/kernels/samd_matmul.py``. The kernel is
``csrc/samd_matmul.cu`` (it replaces the Pallas TPU kernel
``samd_matmul``); ``samd_matmul_plain`` is the reference's K-block loop
(``samd_matmul_xla``) in PyTorch: per block of packed words, unpack to
integer codes, accumulate the raw-code product in f32, and apply the
per-column scale once at the end.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import samd
from repro_torch.kernels._build import Kernel, ptr, stream_handle
from repro_torch.quant.config import QuantConfig

KERNEL = Kernel(
    "samd_matmul", "samd_matmul.cu",
    {"samd_matmul_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p]},
)


def unpack_codes(words: torch.Tensor, bits: int, lane_width: int,
                 signed: bool = True) -> torch.Tensor:
    """int32 words [bk, bn] -> int32 codes [bk * vpw, bn]: shift, mask
    and (signed lanes only) the sign fixup of ``core.samd.unpack``."""
    fmt = samd.SAMDFormat(bits, lane_width, signed=signed)
    n = words.shape[0] * fmt.lanes_per_word
    return samd.unpack(words.t(), fmt, n).t()


def _check(x, packed, scale, k, cfg):
    m, kx = x.shape
    if kx != k:
        raise ValueError(f"x has K={kx}, weight K={k}")
    kw, n = packed.shape
    if kw * cfg.values_per_word < k:
        raise ValueError(f"{kw} packed words cannot hold K={k}")
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for N={n}")
    return m, n, kw


def samd_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor, k: int, cfg: QuantConfig, *,
                      block_kw: int = 128, signed: bool = True
                      ) -> torch.Tensor:
    """The K-block loop in PyTorch; returns x's dtype. Ragged K is cut
    at K (the tail lanes of the last word are never multiplied)."""
    m, n, kw = _check(x, packed, scale, k, cfg)
    vpw = cfg.values_per_word
    bkw = min(block_kw, kw)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for w0 in range(0, kw, bkw):
        k0 = w0 * vpw
        if k0 >= k:
            break
        codes = unpack_codes(packed[w0:w0 + bkw], cfg.bits, cfg.lane_width,
                             signed)
        k1 = min(k0 + codes.shape[0], k)
        acc += x[:, k0:k1].to(torch.float32) @ codes[:k1 - k0].to(
            torch.float32)
    return (acc * scale.reshape(1, n).to(torch.float32)).to(x.dtype)


def samd_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, k: int, cfg: QuantConfig, *,
                     signed: bool = True) -> torch.Tensor:
    """Launch ``csrc/samd_matmul.cu`` on the current stream. Takes bf16
    ``x``, int32 words and f32 scales, all on one CUDA device; raises on
    anything else, and on a failed build or launch."""
    m, n, _ = _check(x, packed, scale, k, cfg)
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise TypeError(f"samd_matmul kernel takes bf16 x, got {x.dtype}")
    if packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(
            f"packed must be int32 and scale f32, got {packed.dtype}/"
            f"{scale.dtype}"
        )
    if packed.device != dev or scale.device != dev:
        raise ValueError("x, packed and scale must share one CUDA device")
    x = x.contiguous()
    packed = packed.contiguous()
    scale = scale.contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out
    with torch.cuda.device(dev):
        KERNEL.launch(
            "samd_matmul_launch", ptr(x), ptr(packed), ptr(scale), ptr(out),
            m, n, k, cfg.bits, cfg.lane_width, cfg.values_per_word,
            int(signed), stream_handle(x),
        )
    return out
