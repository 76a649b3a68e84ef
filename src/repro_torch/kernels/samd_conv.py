"""SAMD convolutions: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``repro/kernels/samd_conv.py``; both kernels are in
``csrc/samd_conv.cu``, each with a launcher of its own:

- ``samd_conv2d_launch`` replaces the Pallas kernel ``samd_conv2d``: a
  stride-1 2D conv of x [C_in, H, W] with packed HWIO weights
  [KH, KW, ceil(C_in/vpw), C_out] -> [OH, OW, C_out], the scale applied
  once per output channel. ``samd_conv2d_plain`` is the reference's
  ``samd_conv2d_xla`` in PyTorch: per block of C_in words and per (kh,
  kw), unpack the codes and contract the shifted window in f32.
- ``samd_conv_chunks_launch`` replaces ``samd_conv_chunks``: each packed
  chunk word times the kernel word (conv as long multiplication, §5-6),
  extracted to int32 [nc, lanes + taps - 1]. ``samd_conv_chunks_plain``
  is ``core.conv.chunk_products`` + ``extract_outputs`` (16-bit limbs, as
  the reference); the kernel's output is bit-identical to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.conv import ConvPlan, chunk_products, extract_outputs
from repro_torch.core.samd import words32
from repro_torch.kernels._build import Kernel, ptr, stream_handle
from repro_torch.kernels.samd_matmul import unpack_codes
from repro_torch.quant.config import QuantConfig

KERNEL = Kernel(
    "samd_conv", "samd_conv.cu",
    {"samd_conv2d_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                           + [ctypes.c_void_p],
     "samd_conv_chunks_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                + [ctypes.c_void_p]},
)
# channels the kernel and its plain version take per reduction step
# (rounded to whole words)
BLOCK_C = 16


def block_words(vpw: int) -> int:
    """Words of C_in per reduction step at ``vpw`` values a word."""
    return max(1, BLOCK_C // vpw)


def conv2d_shape(x: torch.Tensor, packed: torch.Tensor, cfg: QuantConfig,
                 padding: int):
    """(OH, OW, C_out) of the conv; raises on inconsistent operands."""
    if x.dim() != 3 or packed.dim() != 4:
        raise ValueError(f"x must be [C_in, H, W] and packed [KH, KW, CW, "
                         f"C_out], got {tuple(x.shape)} and "
                         f"{tuple(packed.shape)}")
    c_in, h, w = x.shape
    kh, kw, cw, n = packed.shape
    if cw * cfg.values_per_word < c_in:
        raise ValueError(f"{cw} packed words cannot hold C_in={c_in}")
    oh, ow = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"a {kh}x{kw} kernel does not fit {h}x{w} with "
                         f"padding {padding}")
    return oh, ow, n


def samd_conv2d_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor, cfg: QuantConfig, *,
                      padding: int = 1,
                      signed: bool = True) -> torch.Tensor:
    """The blocked conv loop in PyTorch; returns [OH, OW, C_out] in x's
    dtype. C_in is contracted in the kernel's steps of ``BLOCK_C``
    channels, zero-padded to whole steps, and the image by ``padding``,
    as the reference's ``_pad_conv_operands``."""
    oh, ow, n = conv2d_shape(x, packed, cfg, padding)
    kh_taps, kw_taps, cw, _ = packed.shape
    vpw = cfg.values_per_word
    bcw = min(block_words(vpw), cw)
    cwp = -(-cw // bcw) * bcw
    packed = torch.nn.functional.pad(packed, (0, 0, 0, cwp - cw))
    xp = torch.nn.functional.pad(
        x.to(torch.float32),
        (padding, padding, padding, padding, 0, cwp * vpw - x.shape[0]))
    bc = bcw * vpw
    acc = torch.zeros((oh * ow, n), dtype=torch.float32, device=x.device)
    for cb in range(cwp // bcw):
        xb = xp[cb * bc:(cb + 1) * bc]
        for i in range(kh_taps):
            for j in range(kw_taps):
                codes = unpack_codes(packed[i, j, cb * bcw:(cb + 1) * bcw],
                                     cfg.bits, cfg.lane_width, signed)
                patch = xb[:, i:i + oh, j:j + ow].reshape(bc, oh * ow)
                acc += patch.t() @ codes.to(torch.float32)
    out = acc * scale.reshape(1, n).to(torch.float32)
    return out.reshape(oh, ow, n).to(x.dtype)


def samd_conv2d_cuda(x: torch.Tensor, packed: torch.Tensor,
                     scale: torch.Tensor, cfg: QuantConfig, *,
                     padding: int = 1, signed: bool = True) -> torch.Tensor:
    """Launch ``samd_conv2d_launch`` on the current stream. Takes f32 or
    bf16 ``x``, int32 words and f32 scales, all on one CUDA device;
    raises on anything else, and on a failed build or launch."""
    oh, ow, n = conv2d_shape(x, packed, cfg, padding)
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"samd_conv2d kernel takes f32 or bf16 x, got "
                        f"{x.dtype}")
    if packed.dtype != torch.int32 or scale.dtype != torch.float32:
        raise TypeError(f"packed must be int32 and scale f32, got "
                        f"{packed.dtype}/{scale.dtype}")
    if scale.numel() != n:
        raise ValueError(f"scale has {scale.numel()} entries for C_out={n}")
    if packed.device != dev or scale.device != dev:
        raise ValueError("x, packed and scale must share one CUDA device")
    x, packed, scale = x.contiguous(), packed.contiguous(), scale.contiguous()
    c_in, h, w = x.shape
    kh, kw, cw, _ = packed.shape
    vpw = cfg.values_per_word
    out = torch.empty((oh, ow, n), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(
            "samd_conv2d_launch", ptr(x), ptr(packed), ptr(scale), ptr(out),
            c_in, h, w, kh, kw, cw, n, padding, cfg.bits, cfg.lane_width,
            vpw, int(signed), block_words(vpw),
            int(x.dtype == torch.bfloat16), stream_handle(x))
    return out


def samd_conv_chunks_plain(x_words: torch.Tensor, k_word: torch.Tensor,
                           plan: ConvPlan) -> torch.Tensor:
    """[nc] chunk words x the kernel word -> int32 [nc, out_lanes]."""
    return extract_outputs(*chunk_products(x_words, k_word, plan), plan)


def samd_conv_chunks_cuda(x_words: torch.Tensor, k_word: torch.Tensor,
                          plan: ConvPlan) -> torch.Tensor:
    """Launch ``samd_conv_chunks_launch`` on the current stream: int32
    chunk words [nc] and a one-element int32 kernel word on one CUDA
    device; raises on anything else."""
    words32(plan.fmt)
    plan.validate()
    dev = x_words.device
    if x_words.dtype != torch.int32 or k_word.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {x_words.dtype}/"
                        f"{k_word.dtype}")
    if x_words.dim() != 1 or k_word.numel() != 1:
        raise ValueError(f"x_words must be [nc] and k_word one word, got "
                         f"{tuple(x_words.shape)}/{tuple(k_word.shape)}")
    if k_word.device != dev:
        raise ValueError("x_words and k_word must share one CUDA device")
    x_words, k_word = x_words.contiguous(), k_word.contiguous()
    nc, lanes = x_words.shape[0], plan.out_lanes_per_chunk
    out = torch.empty((nc, lanes), dtype=torch.int32, device=dev)
    if nc == 0:
        return out
    with torch.cuda.device(dev):
        KERNEL.launch(
            "samd_conv_chunks_launch", ptr(x_words), ptr(k_word), ptr(out),
            nc, plan.fmt.lane_width, lanes, int(plan.fmt.signed),
            stream_handle(x_words))
    return out
