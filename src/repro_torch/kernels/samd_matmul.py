"""SAMD packed-weight matmul: the CUDA kernel and its plain PyTorch version.

    out[M, N] = x[M, K] @ (codes(packed[ceil(K/vpw), N]) * scale[1, N])

Counterpart of ``repro/kernels/samd_matmul.py``. The kernel is
``csrc/samd_matmul.cu`` (it replaces the Pallas TPU kernel
``samd_matmul``) with two launchers of one tensor-core body:
``samd_matmul_splitk_launch`` for M <= ``SPLITK_MAX_M`` (decode and the
speculative verify) and ``samd_matmul_tile_launch`` above it (prefill);
:func:`launcher_for` is the rule and :func:`split_k` cuts K across blocks
when the output tiles alone would leave SMs idle. ``samd_matmul_plain``
is the reference's K-block loop (``samd_matmul_xla``) in PyTorch: per
block of packed words, unpack to integer codes, cast them through x's
dtype, accumulate the raw-code product in f32, and apply the
per-column scale once at the end.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core import samd
from repro_torch.kernels._build import Kernel, is_fake, stream_handle
from repro_torch.quant.config import QuantConfig

SPLITK = "samd_matmul_splitk_launch"
TILE = "samd_matmul_tile_launch"
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
KERNEL = Kernel("samd_matmul", "samd_matmul.cu", {SPLITK: _ARGS, TILE: _ARGS})

# rows of x at or under which the split-K launcher runs (decode M = 8, the
# 4-bit verify's 8 x 3 = 24); prefill's 8 x bucket >= 64 rows take the tile
SPLITK_MAX_M = 32
# (output columns, rows of x) per block of each launcher, as in the source
BLOCK = {SPLITK: (32, 32), TILE: (128, 64)}
STEP_WORDS = 16   # words per column per K-step of the kernel
MAX_SPLITS = 8    # K splits of one tile form one cluster: the portable size
NUM_SMS = 132     # H100 SXM
# blocks each launcher aims at when it splits K. A split-K block (2 warps,
# one or a few K-steps) hides little latency alone, so as many as fit; a
# tile block fills its SM, so one wave: a second, part-filled wave costs
# more than the split saves
BLOCK_TARGET = {SPLITK: 8 * NUM_SMS, TILE: NUM_SMS}
# output tiles at which a launcher stops splitting K: a split-K launch
# splits until its tiles alone reach the target (qwen3-14b's wg / wu, 544
# tiles at N = 17408, ran unsplit at 4.4x their bytes bound under the
# half-target rule); a tile launch stops at half its target
NO_SPLIT_TILES = {SPLITK: BLOCK_TARGET[SPLITK], TILE: BLOCK_TARGET[TILE] // 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launcher_for(m: int) -> str:
    """The launcher that runs a product with ``m`` rows of x."""
    return SPLITK if m <= SPLITK_MAX_M else TILE


@functools.lru_cache(maxsize=4096)
def split_k(m: int, n: int, k: int, vpw: int) -> tuple[int, int]:
    """(splits, K-steps per split) for an [m, k] x [k, n] product. The
    output tiles run alone when they reach the launcher's
    ``NO_SPLIT_TILES``; else K is cut into at most ``MAX_SPLITS`` runs,
    each of at least one step, toward ``BLOCK_TARGET`` blocks."""
    fn = launcher_for(m)
    bn, bm = BLOCK[fn]
    steps = max(1, _cdiv(_cdiv(k, vpw), STEP_WORDS))
    tiles = _cdiv(n, bn) * _cdiv(m, bm)
    if tiles >= NO_SPLIT_TILES[fn]:
        return 1, steps
    per = _cdiv(steps, min(steps, MAX_SPLITS,
                           _cdiv(BLOCK_TARGET[fn], tiles)))
    return _cdiv(steps, per), per


def unpack_codes(words: torch.Tensor, bits: int, lane_width: int,
                 signed: bool = True) -> torch.Tensor:
    """int32 words [bk, bn] -> int32 codes [bk * vpw, bn]: shift, mask
    and (signed lanes only) the sign fixup of ``core.samd.unpack``."""
    fmt = samd.SAMDFormat(bits, lane_width, signed=signed)
    n = words.shape[0] * fmt.lanes_per_word
    return samd.unpack(words.t(), fmt, n).t()


def _check(x, packed, scale, k, cfg):
    """(M, N, words) of x [..., K] against the packed weight; raises on
    a mismatch."""
    kx = x.shape[-1]
    m = math.prod(x.shape[:-1])
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
        # codes go through x's dtype as the reference's codes.astype(
        # x.dtype): bf16 rounds codes over 8 unsigned / 9 signed bits
        acc += x[:, k0:k1].to(torch.float32) @ codes[:k1 - k0].to(
            x.dtype).to(torch.float32)
    return (acc * scale.reshape(1, n).to(torch.float32)).to(x.dtype)


def samd_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, k: int, cfg: QuantConfig, *,
                     signed: bool = True) -> torch.Tensor:
    """Launch ``csrc/samd_matmul.cu`` on the current stream: x [..., K]
    -> [..., N]. Takes bf16 ``x``, int32 words and f32 scales, all on one
    CUDA device; raises on anything else, and on a failed build or
    launch. The launcher follows :func:`launcher_for`, the K split
    :func:`split_k`. A fake ``x`` (a traced dry-run) gets its output's
    shape and launches nothing."""
    m, n, _ = _check(x, packed, scale, k, cfg)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"samd_matmul kernel takes bf16 x, got {x.dtype}")
    if packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(
            f"packed must be int32 and scale f32, got {packed.dtype}/"
            f"{scale.dtype}"
        )
    dev = x.get_device()
    if packed.get_device() != dev or scale.get_device() != dev:
        raise ValueError("x, packed and scale must share one CUDA device")
    if not x.is_contiguous():
        x = x.contiguous()
    if not packed.is_contiguous():
        packed = packed.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.bfloat16,
                      device=x.device)
    if m == 0 or is_fake(x):  # a fake tensor has a shape and no data
        return out
    vpw = cfg.values_per_word
    splits, per = split_k(m, n, k, vpw)
    args = (launcher_for(m), x.data_ptr(), packed.data_ptr(),
            scale.data_ptr(), out.data_ptr(), m, n, k, cfg.bits,
            cfg.lane_width, vpw, int(signed), splits, per, stream_handle(x))
    if dev == torch.cuda.current_device():
        KERNEL.launch(*args)
    else:
        with torch.cuda.device(dev):
            KERNEL.launch(*args)
    return out
