"""Parameter templates: shape, dtype and quantization eligibility in one
place, so init and SAMD quantization cannot drift apart.

A model is a nested dict/list of :class:`TensorSpec`; ``init_from_spec``
materializes random parameters from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """shape + dtype + logical axis names (+ quantization eligibility).

    ``quant_axis``: the reduction axis if this is a matmul weight that the
    SAMD backend may pack; None = never quantized. ``axes`` names each
    dimension ('vocab' marks the embedding, which stays bf16).
    """

    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'decay'
    init_scale: float = 0.02
    quant_axis: Optional[int] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def map_specs(fn, tree):
    """Apply ``fn`` to every TensorSpec of a nested dict/list."""
    if isinstance(tree, TensorSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return [map_specs(fn, v) for v in tree]


def init_from_spec(spec_tree, generator: torch.Generator,
                   device="cuda"):
    """Random parameters for a TensorSpec tree: N(0, init_scale) drawn in
    f32 from ``generator`` (which must live on ``device``), then cast;
    'decay' leaves (SSM / RWKV gates) are the reference's slow-decay
    ramp, linspace(-6, -1) over the leaf in row-major order."""

    def make(sp: TensorSpec) -> torch.Tensor:
        if sp.init == "zeros":
            return torch.zeros(sp.shape, dtype=sp.dtype, device=device)
        if sp.init == "ones":
            return torch.ones(sp.shape, dtype=sp.dtype, device=device)
        if sp.init == "decay":
            v = torch.linspace(-6.0, -1.0, math.prod(sp.shape),
                               dtype=torch.float32, device=device)
            return v.reshape(sp.shape).to(sp.dtype)
        w = torch.randn(sp.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * sp.init_scale).to(sp.dtype)

    return map_specs(make, spec_tree)


def shape_dtype_from_spec(spec_tree):
    """Meta tensors of each spec's shape and dtype (stand-ins that hold
    no memory; the reference's ShapeDtypeStructs)."""
    return map_specs(
        lambda sp: torch.empty(sp.shape, dtype=sp.dtype, device="meta"),
        spec_tree)


def param_count(spec_tree) -> int:
    n = 0

    def add(sp):
        nonlocal n
        n += math.prod(sp.shape)

    map_specs(add, spec_tree)
    return n
