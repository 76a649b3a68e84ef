"""Kernel entry points: a CUDA tensor launches the hand-written kernel, a
CPU tensor runs its plain PyTorch version.

The choice follows the device of the tensor alone. There is no fallback:
on a CUDA tensor a kernel that cannot be built or launched raises, and a
tensor on any other device raises.

With ``repro_torch.tracing`` on, ``samd_matmul`` and
``paged_decode_attention`` count each call under its launcher and shape
(on the CPU, the launcher a card would take).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import tracing
from repro_torch.analysis.contracts import (
    assert_safe,
    check_conv2d_config,
    check_conv_plan,
    check_matmul_config,
)
from repro_torch.core.conv import ConvPlan
from repro_torch.kernels import _build
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import samd_conv as _conv
from repro_torch.kernels import samd_matmul as _mm
from repro_torch.quant.config import QuantConfig

KERNELS = (_mm.KERNEL, _pa.KERNEL, _conv.KERNEL)


def build_kernels() -> None:
    """Build every kernel now, one nvcc per source, all in parallel."""
    _build.build_all(KERNELS)


def launch_counts() -> dict:
    """Launches made so far, one counter per exported launcher (keyed by
    the launcher's C name)."""
    return {fn: n for k in KERNELS for fn, n in k.launches.items()}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = dict.fromkeys(k.launches, 0)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


@functools.lru_cache(maxsize=None)
def _verify_matmul(cfg: QuantConfig, k: int, signed: bool) -> None:
    assert_safe(check_matmul_config(cfg, k, signed=signed))


def samd_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                k: int, cfg: QuantConfig, *,
                signed: bool = True) -> torch.Tensor:
    """Packed-weight matmul: x[..., K] @ dequant(packed)[K, N]. The
    lane-safety check of (cfg, K, signed) runs first and raises
    ``LaneSafetyError`` on an unsafe configuration. On a card, M rows of
    x at or under ``samd_matmul.SPLITK_MAX_M`` take the split-K launcher,
    more take the tile launcher. A group-scaled ``cfg`` raises
    ``NotImplementedError``, as the reference's kernel does."""
    _verify_matmul(cfg, int(k), bool(signed))
    if cfg.group_size is not None:
        # as the reference's kernel: per-channel scales only (a grouped
        # weight goes through quant.packing.qmatmul's dequantize route)
        raise NotImplementedError("samd_matmul supports per-channel scales")
    if tracing.on:
        m = math.prod(x.shape[:-1])
        tracing.count((_mm.launcher_for(m), m, int(k), int(packed.shape[1]),
                       cfg.values_per_word))
    if _on_cuda(x):
        return _mm.samd_matmul_cuda(x, packed, scale, k, cfg, signed=signed)
    lead = x.shape[:-1]
    out = _mm.samd_matmul_plain(x.reshape(-1, x.shape[-1]), packed, scale,
                                k, cfg, signed=signed)
    return out.reshape(lead + (out.shape[-1],))


def paged_decode_attention(q, k_pages, v_pages, page_table, q_pos, *,
                           k_scale=None, v_scale=None, extra_k=None,
                           extra_v=None, extra_pos=None) -> torch.Tensor:
    """Fused decode attention over the paged KV pool: q [B, H, dh] ->
    [B, H, dh]. Pass ``k_scale``/``v_scale`` iff the pools are packed.
    ``extra_k``/``extra_v`` [B, R, Hkv, dh] with ``extra_pos`` [B, R]
    (-1 = unwritten) fold the speculative draft's ring into the same
    softmax after the pages; ``q_pos`` then bounds the pool read."""
    if tracing.on:
        # the rows, keys and pages it reads are the enclosing decode
        # span's (the pool's int32 words hold four int8 values)
        tracing.count((
            "paged_decode_attention_launch" if extra_k is None
            else "paged_decode_ring_attention_launch", tracing.current(),
            q.shape[1], k_pages.shape[2], q.shape[2],
            1 if k_pages.dtype == torch.int32 else k_pages.element_size()))
    fn = (_pa.paged_decode_attention_cuda if _on_cuda(q)
          else _pa.paged_decode_attention_plain)
    return fn(q, k_pages, v_pages, page_table, q_pos,
              k_scale=k_scale, v_scale=v_scale, extra_k=extra_k,
              extra_v=extra_v, extra_pos=extra_pos)


def paged_verify_attention(q, k_pages, v_pages, page_table, q_pos, *,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Multi-query paged attention (the speculative verify): q [B, S, H,
    dh] with a position per query, ``q_pos`` [B, S] (-1 = a masked row,
    which comes out as zeros) -> [B, S, H, dh]."""
    fn = (_pa.paged_verify_attention_cuda if _on_cuda(q)
          else _pa.paged_verify_attention_plain)
    return fn(q, k_pages, v_pages, page_table, q_pos,
              k_scale=k_scale, v_scale=v_scale)


def samd_conv2d(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                cfg: QuantConfig, *, padding: int = 1,
                signed: bool = True) -> torch.Tensor:
    """Stride-1 2D conv over SAMD-packed weights: x [C_in, H, W] with
    packed [KH, KW, ceil(C_in/vpw), C_out] and scale [1, C_out] (from
    ``quant.packing.pack_conv_weights``) -> [OH, OW, C_out] in x's
    dtype. The lane-safety check of (cfg, KH x KW x C_in, signed) runs
    first and raises ``LaneSafetyError`` on an unsafe configuration."""
    kh, kw = packed.shape[:2]
    assert_safe(check_conv2d_config(cfg, int(kh), int(kw), int(x.shape[0]),
                                    signed=bool(signed)))
    fn = _conv.samd_conv2d_cuda if _on_cuda(x) else _conv.samd_conv2d_plain
    return fn(x, packed, scale, cfg, padding=padding, signed=signed)


def samd_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                plan: ConvPlan) -> torch.Tensor:
    """Full 1D integer convolution by conv as multiplication: x [n] int,
    kernel [taps] int -> [n + taps - 1] int32 (``np.convolve``). On a
    card one fused kernel packs, multiplies and overlap-adds
    (``samd_conv1d_launch``); on the CPU the plain composition runs. The
    plan's lane-safety check runs first and raises ``LaneSafetyError`` on
    an unsafe plan.

    A plan of 64-bit words raises ValueError on either device: the fused
    kernel, like the TPU kernel it ports, multiplies 32-bit words, and
    ``core.conv.samd_conv_full`` runs 64-bit plans. (The reference's op
    returns wrong values for such a plan, without an error.)"""
    _conv.check_kernel_word_bits(plan)
    assert_safe(check_conv_plan(plan))
    fn = _conv.samd_conv1d_cuda if _on_cuda(x) else _conv.samd_conv1d_plain
    return fn(x, kernel, plan)
