"""Deploy-time SAMD packing of a parameter tree (paper §7 flow: train in
full precision -> freeze -> pack tight)."""
from __future__ import annotations

import math

from repro_torch.models.layers import QuantizedTensor
from repro_torch.models.spec import TensorSpec
from repro_torch.quant.config import QuantConfig
from repro_torch.quant.packing import pack_weights

# don't bother packing tiny tensors (norms, biases)
_MIN_QUANT_SIZE = 1 << 16


def quantize_params(params, template, qcfg: QuantConfig):
    """Replace every quantizable leaf with a SAMD-packed QuantizedTensor.

    A leaf is packed iff its spec declares a ``quant_axis`` and it holds at
    least ``_MIN_QUANT_SIZE`` values; leaves with a 'vocab' axis (the
    embedding, an untied LM head) stay bf16. The rule is the reference's
    at its default ``quantize_embeddings=False``, so both packages pack
    the same leaves.
    """
    if not qcfg.enabled:
        return params

    def visit(spec, w):
        if isinstance(spec, dict):
            return {k: visit(spec[k], w[k]) for k in spec}
        if isinstance(spec, list):
            return [visit(s, x) for s, x in zip(spec, w)]
        if not isinstance(spec, TensorSpec) or spec.quant_axis is None:
            return w
        if math.prod(spec.shape) < _MIN_QUANT_SIZE:
            return w
        if "vocab" in spec.axes:
            return w
        axis = spec.quant_axis
        k = spec.shape[axis]
        w2d = w.movedim(axis, 0).reshape(k, -1)
        packed, scale = pack_weights(w2d, qcfg)
        return QuantizedTensor(packed, scale, tuple(spec.shape), axis, qcfg)

    return visit(template, params)
