"""Lane-safety contracts of the kernels, built on the abstract
interpreter (the port's copy of ``repro/analysis/contracts.py``), and
shared-memory budgets of the port's Hopper kernels.

``kernels.ops.samd_matmul``, ``samd_conv2d`` and ``samd_conv1d`` run the
checks before every call, as the reference's ``verify=True`` does: pure
Python over the static configuration, cached, raising
:class:`LaneSafetyError` before an unsafe configuration reaches a
kernel. ``serving.engine.ServingEngine(verify=True)`` runs the matmul
check at admission over ``packed_reduction_depths`` of its packed
weights, and ``analysis.certify`` sweeps the configurations the repo
ships.

Two kinds of checks:

1. **Unpacked-accumulation paths** (``samd_matmul`` and the blocked
   ``samd_conv2d``): lanes are storage only, codes are unpacked before
   the f32 contraction, so the lane program is ``Pack -> ReadValue``.
   The reduction depth K still matters when activations are quantized
   (``cfg.act_bits``): raw-code products accumulate in float32, whose
   24-bit mantissa bounds the depth at which integer accumulation stays
   exact.
2. **Packed-domain paths** (conv as multiplication, ``ConvPlan``): the
   whole pipeline runs in the lanes, so the canonical accumulation
   program applies, borrow-fixup tracking included.

The reference's VMEM estimates (its 12 MiB TPU budget) become estimates
of each CUDA kernel's shared memory per block, from the same constants
the sources use, held against the H100's per-block limit
(``SMEM_LIMIT_BYTES``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np

from repro_torch.analysis.lanes import (
    NEEDS_SPACER,
    LaneSafetyError,
    Pack,
    ReadValue,
    Verdict,
    check_accumulation,
    interpret,
)
from repro_torch.core import overflow
from repro_torch.core.conv import ConvPlan
from repro_torch.core.samd import SAMDFormat
from repro_torch.quant.config import QuantConfig

# float32 keeps integers exact up to 2^24 (mantissa incl. implicit bit)
F32_MANTISSA_BITS = 24

# shared memory one block may opt into on an H100 (sm_90): 227 KB
SMEM_LIMIT_BYTES = 227 * 1024


def assert_safe(verdict: Verdict) -> Verdict:
    """Raise :class:`LaneSafetyError` on any verdict that is not safe."""
    if not verdict.ok:
        raise LaneSafetyError(verdict)
    return verdict


def _storage_format(cfg: QuantConfig, signed: bool) -> SAMDFormat:
    return SAMDFormat(cfg.bits, cfg.lane_width, signed=signed, word_bits=32)


def _f32_exact_depth(cfg: QuantConfig, signed: bool) -> Optional[int]:
    """Max reduction depth at which raw-code x quantized-activation
    products stay integer-exact in a float32 accumulator; None when
    activations are float (no integer-exactness contract applies)."""
    if not cfg.act_bits:
        return None
    code_hi = 1 << (cfg.bits - 1) if signed else (1 << cfg.bits) - 1
    act_hi = 1 << (cfg.act_bits - 1)
    # every integer of magnitude <= 2^24 is exactly representable; the
    # worst single product is |(-2^(b-1)) * (-2^(a-1))| = code_hi * act_hi
    return max(1, (1 << F32_MANTISSA_BITS) // max(1, code_hi * act_hi))


@functools.lru_cache(maxsize=None)
def _check_unpacked_acc(cfg: QuantConfig, k: int, signed: bool) -> Verdict:
    fmt = _storage_format(cfg, signed)
    storage = interpret(fmt, [Pack(), ReadValue()], depth=k)
    if not storage.ok:
        return storage
    exact_depth = _f32_exact_depth(cfg, signed)
    if exact_depth is None:
        return dataclasses.replace(
            storage,
            detail=(
                "storage-only lanes (codes unpack to int32 before the "
                f"f32 contraction); depth K={k} accumulates out of the "
                "packed domain in float"
            ),
        )
    code_lo, code_hi = overflow.input_range(cfg.bits, signed)
    act_lo, act_hi = overflow.input_range(cfg.act_bits, True)
    cross = (
        code_lo * act_lo,
        code_lo * act_hi,
        code_hi * act_lo,
        code_hi * act_hi,
    )
    acc_lo, acc_hi = k * min(cross), k * max(cross)
    # exactness criterion is MAGNITUDE <= 2^24 (every such integer is
    # representable, and partial sums are bounded by the endpoints), not
    # bit width: 2^24 itself needs 26 signed bits yet is exact.
    if max(-acc_lo, acc_hi) > (1 << F32_MANTISSA_BITS):
        need = overflow.bits_required_signed(acc_lo, acc_hi)
        return dataclasses.replace(
            storage,
            status=NEEDS_SPACER,
            required_lane_width=need,
            spacer_bits_needed=max(1, need - F32_MANTISSA_BITS - 1),
            lane_lo=acc_lo,
            lane_hi=acc_hi,
            detail=(
                f"f32 accumulator: K={k} products of {cfg.bits}-bit codes "
                f"x {cfg.act_bits}-bit activations span [{acc_lo}, "
                f"{acc_hi}] but float32 is integer-exact only to "
                f"2^{F32_MANTISSA_BITS} — lower bits/act_bits or split "
                f"the reduction (exact to depth {exact_depth})"
            ),
        )
    return dataclasses.replace(
        storage,
        detail=(
            f"f32 accumulator integer-exact at K={k} "
            f"(exact to depth {exact_depth})"
        ),
    )


def check_matmul_config(cfg: QuantConfig, k: int, *,
                        signed: bool = True) -> Verdict:
    """Verdict of ``samd_matmul`` at reduction depth ``k`` under ``cfg``:
    storage lanes, plus the f32 accumulator's exactness when
    ``cfg.act_bits`` is set."""
    return _check_unpacked_acc(cfg, int(k), bool(signed))


def check_conv2d_config(cfg: QuantConfig, kh: int, kw: int, c_in: int, *,
                        signed: bool = True) -> Verdict:
    """Verdict of the blocked ``samd_conv2d``: ``samd_matmul``'s at the
    depth of the KH x KW x C_in fan-in (one accumulator per output
    point, the per-channel scale applied once)."""
    return _check_unpacked_acc(cfg, int(kh) * int(kw) * int(c_in),
                               bool(signed))


def check_conv_plan(plan: ConvPlan, channels: int = 1, *,
                    kernel: Optional[np.ndarray] = None,
                    input_bits: Optional[int] = None) -> Verdict:
    """Verdict of conv as multiplication under ``plan``: ``plan.taps``
    products a lane, accumulated over ``channels`` words before the
    extraction. ``kernel`` (known constants, flattened [channels *
    taps]) applies the §7 tap-sum bound instead of the worst case."""
    plan.validate()
    if kernel is not None:
        return check_accumulation(
            plan.fmt, 1, kernel=np.asarray(kernel).reshape(-1),
            input_bits=input_bits,
        )
    return _check_plan_cached(plan, int(channels), input_bits)


@functools.lru_cache(maxsize=None)
def _check_plan_cached(plan: ConvPlan, channels: int,
                       input_bits: Optional[int]) -> Verdict:
    return check_accumulation(plan.fmt, channels, taps=plan.taps,
                              input_bits=input_bits)


# ---------------------------------------------------------------------------
# shared memory of one block of each kernel (bytes), from the constants the
# CUDA sources use; each is the kernel's dynamic shared memory plus the
# static tiles of any other kernel the same launch runs
# ---------------------------------------------------------------------------

# samd_matmul.cu: (warps, n16 tiles a warp, m8 tiles, stages) a launcher
MATMUL_CONFIG = {
    "samd_matmul_splitk_launch": (2, 1, 4, 4),
    "samd_matmul_tile_launch": (4, 2, 8, 3),
}
MATMUL_W_PAD, MATMUL_X_PAD = 4, 8   # words / bf16 of padding a tile row


def matmul_smem_bytes(launcher: str, m: int, vpw: int, splits: int) -> int:
    """Shared memory of one ``samd_matmul`` block: the cp.async ring of
    STAGES steps, each a [STEP_WORDS, BN] word tile and the block's x
    rows of one step, or the split-K reduction buffer when it is larger
    (``splits`` > 1)."""
    from repro_torch.kernels import samd_matmul as mm

    warps, nt, mt, stages = MATMUL_CONFIG[launcher]
    bn, bm = mm.BLOCK[launcher]
    if (bn, bm) != (warps * nt * 16, mt * 8):
        raise AssertionError(f"{launcher}: BLOCK {mm.BLOCK[launcher]} does "
                             "not match its warp tiling")
    ks = mm.STEP_WORDS * vpw
    w_bytes = mm.STEP_WORDS * (bn + MATMUL_W_PAD) * 4
    xrows = -(-m // 8) * 8 if m < bm else bm
    ring = stages * (w_bytes + xrows * (ks + MATMUL_X_PAD) * 2)
    red = nt * mt * 4 * warps * 32 * 4 if splits > 1 else 0
    return max(ring, red)


# samd_conv.cu: conv_mma_kernel's tile (output pixels, channels), stages,
# padding and strides; the static tiles of the x pre-pass kernels
CONV2D_BM, CONV2D_BN, CONV2D_STAGES = 128, 64, 3
CONV2D_WPAD, CONV2D_SB, CONV2D_RED_STRIDE = 4, 64 + 8, 64 + 4
CONV2D_PREPASS_BYTES = {"samd_conv2d_launch": 64 * 33 * 4,
                        "samd_conv2d_im2col_launch": 32 * 33 * 4}


def conv2d_smem_bytes(plan, vpw: int, wide: bool = False) -> int:
    """Shared memory of one block of the ``samd_conv2d`` launch under
    ``plan`` (``samd_conv.conv2d_plan``) at ``vpw`` values a word: the
    ring of STAGES K-steps (x terms' A tiles, the word tile, the code
    tiles: two for f32 x with ``wide`` codes), or the split reduction
    buffer when larger, and at least the pre-pass kernel's static
    tile."""
    kc = plan.step_k
    ct = 2 if (wide and plan.terms == 2) else 1
    a_bytes = CONV2D_BM * (kc + 8) * 2
    w_bytes = (kc // vpw) * (CONV2D_BN + CONV2D_WPAD) * 4
    b_bytes = ct * kc * CONV2D_SB * 2
    ring = CONV2D_STAGES * (plan.terms * a_bytes + w_bytes + b_bytes)
    red = CONV2D_BM * CONV2D_RED_STRIDE * 4
    return max(ring, red, CONV2D_PREPASS_BYTES[plan.launcher])


def conv1d_smem_bytes(plan, itemsize: int) -> int:
    """Shared memory of one ``samd_conv1d`` block under ``plan``
    (``samd_conv.conv1d_plan``) for x of ``itemsize`` bytes: two tile
    buffers (16-byte vectors before the tile holding the halo chunk, and
    the tile's values), the 64-bit products of the halo and the tile's
    chunks, the kernel word."""
    pre = -(-plan.lanes * itemsize // 16) * 16 // itemsize
    buf = (pre + plan.tile_chunks * plan.lanes) * itemsize
    return 2 * buf + (plan.tile_chunks + 1) * 8 + 16


# ---------------------------------------------------------------------------
# model reduction depths (what the serving engine validates at admission)
# ---------------------------------------------------------------------------

def model_reduction_depths(template, qcfg: Optional[QuantConfig] = None, *,
                           respect_min_size: bool = False) -> list[int]:
    """Reduction depths (K) of every quantizable weight in a TensorSpec
    template (nested dicts and lists): the depths a packed matmul will
    accumulate over.

    ``respect_min_size=True`` mirrors ``quantize_params``' size floor
    (only leaves that would be packed); the default returns every
    quantizable depth, the superset the certification sweep wants.
    Leaves with a 'vocab' axis count only when ``qcfg`` is None or
    quantizes embeddings."""
    from repro_torch.models.quantize import _MIN_QUANT_SIZE
    from repro_torch.models.spec import TensorSpec

    depths = set()

    def visit(node):
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)
        elif isinstance(node, TensorSpec) and node.quant_axis is not None:
            if respect_min_size and math.prod(node.shape) < _MIN_QUANT_SIZE:
                return
            if (qcfg is not None and "vocab" in node.axes
                    and not qcfg.quantize_embeddings):
                return
            depths.add(int(node.shape[node.quant_axis]))

    visit(template)
    return sorted(depths)


def packed_reduction_depths(params) -> list[int]:
    """Reduction depths of the ``QuantizedTensor`` leaves present in a
    packed parameter tree (nested dicts and lists), sorted."""
    from repro_torch.models.layers import QuantizedTensor

    depths = set()

    def visit(node):
        if isinstance(node, QuantizedTensor):
            depths.add(int(node.k))
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(params)
    return sorted(depths)
