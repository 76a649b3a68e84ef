"""Deploy-time SAMD packing of a parameter tree (paper §7 flow: train in
full precision -> freeze -> pack tight)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import QuantizedTensor
from repro_torch.models.spec import TensorSpec, map_specs
from repro_torch.quant.config import QuantConfig
from repro_torch.quant.packing import pack_weights
from repro_torch.tree import tree_leaves

# don't bother packing tiny tensors (norms, biases)
_MIN_QUANT_SIZE = 1 << 16


def _packs(spec, qcfg: QuantConfig) -> bool:
    """The reference's rule: a leaf is packed iff its spec declares a
    ``quant_axis``, it holds at least ``_MIN_QUANT_SIZE`` values, and it
    has no 'vocab' axis unless ``qcfg.quantize_embeddings``."""
    return (isinstance(spec, TensorSpec) and spec.quant_axis is not None
            and math.prod(spec.shape) >= _MIN_QUANT_SIZE
            and ("vocab" not in spec.axes or qcfg.quantize_embeddings))


def quantize_params(params, template, qcfg: QuantConfig):
    """Replace every quantizable leaf with a SAMD-packed QuantizedTensor.

    ``template`` is the TensorSpec tree of ``build_template`` (either
    layout). A leaf is packed along its ``quant_axis`` moved first, the
    other axes flattened into columns (``_packs`` says which leaves);
    with ``quantize_embeddings`` an untied LM head is packed too (the
    embedding table is gathered, never multiplied, and has no
    ``quant_axis``).
    """
    if not qcfg.enabled:
        return params

    def visit(spec, w):
        if isinstance(spec, dict):
            return {k: visit(spec[k], w[k]) for k in spec}
        if isinstance(spec, list):
            return [visit(s, x) for s, x in zip(spec, w)]
        if not _packs(spec, qcfg):
            return w
        axis = spec.quant_axis
        k = spec.shape[axis]
        w2d = w.movedim(axis, 0).reshape(k, -1)
        packed, scale = pack_weights(w2d, qcfg)
        return QuantizedTensor(packed, scale, tuple(spec.shape), axis, qcfg)

    return visit(template, params)


def quantized_spec_tree(template, qcfg: QuantConfig):
    """The packed parameter tree's shapes without packing anything:
    meta tensors where ``quantize_params`` would put tensors (packed
    words [ceil(K/vpw), rest] int32, scale [1 or K // group_size, rest]
    f32)."""

    def visit(spec):
        if not qcfg.enabled or not _packs(spec, qcfg):
            return torch.empty(spec.shape, dtype=spec.dtype, device="meta")
        k = spec.shape[spec.quant_axis]
        rest = math.prod(spec.shape) // k
        groups = 1 if qcfg.group_size is None else k // qcfg.group_size
        return QuantizedTensor(
            torch.empty((-(-k // qcfg.values_per_word), rest),
                        dtype=torch.int32, device="meta"),
            torch.empty((groups, rest), dtype=torch.float32, device="meta"),
            tuple(spec.shape), spec.quant_axis, qcfg)

    return map_specs(visit, template)


def tree_bytes(tree) -> int:
    """Bytes of a parameter tree's tensors, a packed weight counted as its
    words and scales: the sum the reference takes over
    ``jax.tree.leaves``, whose leaves of a ``QuantizedTensor`` are those
    two."""
    total = 0
    for leaf in tree_leaves(tree):
        parts = ((leaf.packed, leaf.scale)
                 if isinstance(leaf, QuantizedTensor) else (leaf,))
        total += sum(t.numel() * t.element_size() for t in parts)
    return total
