"""Lane-safety contracts of the matmul and the two conv paths (counterpart
of the checks in ``repro/analysis/contracts.py``).

``kernels.ops.samd_matmul``, ``samd_conv2d`` and ``samd_conv1d`` run them
before every call, as the reference's ``verify=True`` does: pure Python
over the static configuration, cached, raising :class:`LaneSafetyError`
before an unsafe configuration reaches a kernel.

* ``samd_matmul`` and the blocked ``samd_conv2d`` keep lanes as storage
  only: codes are unpacked before the f32 contraction, so their program
  is ``Pack -> ReadValue`` at depth K (KH*KW*C_in for the conv). (The
  reference adds an f32 exactness bound for quantized activations; the
  port's ``QuantConfig`` has no ``act_bits``, so that bound never
  applies.)
* Conv as multiplication (``samd_conv1d``) runs the whole pipeline in
  the lanes: pack, sign-extend, ``taps`` products a lane, the borrow
  fixup, a wide read.

``serving.engine.ServingEngine(verify=True)`` runs the matmul check at
admission over ``packed_reduction_depths`` of its packed weights.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.analysis.lanes import (
    BorrowFixup,
    LaneSafetyError,
    MulKernel,
    Pack,
    ReadValue,
    ReadWide,
    SignExtend,
    Verdict,
    interpret,
)
from repro_torch.core.conv import ConvPlan
from repro_torch.core.samd import SAMDFormat
from repro_torch.quant.config import QuantConfig


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


def assert_safe(verdict: Verdict) -> Verdict:
    """Raise :class:`LaneSafetyError` on any verdict that is not safe."""
    if not verdict.ok:
        raise LaneSafetyError(verdict)
    return verdict


@functools.lru_cache(maxsize=None)
def check_matmul_config(cfg: QuantConfig, k: int, *,
                        signed: bool = True) -> Verdict:
    """Verdict of ``samd_matmul`` at reduction depth ``k``."""
    fmt = SAMDFormat(cfg.bits, cfg.lane_width, signed=signed, word_bits=32)
    k = int(k)
    verdict = interpret(fmt, [Pack(), ReadValue()], depth=k)
    if not verdict.ok:
        return verdict
    return dataclasses.replace(
        verdict,
        detail=("storage-only lanes (codes unpack to int32 before the f32 "
                f"contraction); depth K={k} accumulates out of the packed "
                "domain in float"))


def check_conv2d_config(cfg: QuantConfig, kh: int, kw: int, c_in: int, *,
                        signed: bool = True) -> Verdict:
    """Verdict of the blocked ``samd_conv2d``: ``samd_matmul``'s at the
    depth of the KH x KW x C_in fan-in."""
    return check_matmul_config(cfg, int(kh) * int(kw) * int(c_in),
                               signed=bool(signed))


@functools.lru_cache(maxsize=None)
def check_conv_plan(plan: ConvPlan) -> Verdict:
    """Verdict of conv as multiplication under ``plan``: ``plan.taps``
    products of b-bit values a lane, read wide after the borrow fixup."""
    plan.validate()
    signed = plan.fmt.signed
    program = ([Pack()] + ([SignExtend()] if signed else [])
               + [MulKernel(plan.taps)] + ([BorrowFixup()] if signed else [])
               + [ReadWide()])
    return interpret(plan.fmt, program, depth=plan.taps)
