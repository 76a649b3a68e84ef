"""Weight bridge: parameters exported as numpy -> the port's parameters.

The input is the reference's parameter tree with every array as numpy
(e.g. ``jax.tree.map(np.asarray, params)``): nested dicts and lists whose
leaves are arrays, or packed weights with the attributes ``packed``
(uint32 words), ``scale``, ``orig_shape``, ``axis`` and ``cfg`` (a
quantization config with ``bits``, ``spacer``, ``group_size``,
``kv_bits``...). Nothing of the reference package is imported: objects
are read by attribute. The reference's two matmul routes
(``backend="pallas"`` and ``"xla"``) compute the same product, so both
map to the port's one route for the weight's scale layout
(``quant.packing.qmatmul``). The stacked scan-over-layers layout (a dict
under ``blocks`` whose leaves carry a leading layer axis) is unstacked
into the port's list of per-layer dicts.

Packed words move through ``ndarray.view(np.int32)``, so they stay bit
identical; bf16 arrays go through f32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import QuantizedTensor
from repro_torch.quant.config import QuantConfig


def quant_config(ref_cfg) -> QuantConfig:
    """The port's QuantConfig equal to a reference QuantConfig."""
    if ref_cfg.backend not in ("pallas", "xla"):
        raise ValueError(f"unknown reference backend {ref_cfg.backend!r}")
    return QuantConfig(
        bits=ref_cfg.bits, enabled=ref_cfg.enabled, spacer=ref_cfg.spacer,
        group_size=ref_cfg.group_size,
        quantize_embeddings=ref_cfg.quantize_embeddings,
        act_bits=ref_cfg.act_bits, kv_bits=ref_cfg.kv_bits,
    )


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Convert a numpy parameter tree (see module doc) to port tensors on
    ``device``. Stacked ``blocks`` are unstacked with
    ``model.unstack_blocks`` (the layer count read from a norm weight),
    which raises ValueError on a packed leaf quantized from a stacked
    weight, as the reference's scan does when it serves one."""
    if isinstance(tree, dict):
        out = {k: params_from_numpy(v, device) for k, v in tree.items()}
        if isinstance(out.get("blocks"), dict):
            from repro_torch.models.model import unstack_blocks

            out["blocks"] = unstack_blocks(
                out["blocks"], _first_leaf(out["blocks"]).shape[0])
        return out
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if hasattr(tree, "packed") and hasattr(tree, "cfg"):
        return QuantizedTensor(
            tensor_from_numpy(tree.packed, device),
            tensor_from_numpy(tree.scale, device),
            tuple(tree.orig_shape), int(tree.axis), quant_config(tree.cfg),
        )
    return tensor_from_numpy(tree, device)


def _first_leaf(tree):
    """The first tensor leaf that is not packed (norm weights are never
    packed, so every stacked layer dict has one)."""
    for v in tree.values():
        if isinstance(v, dict):
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        elif not isinstance(v, QuantizedTensor):
            return v
    return None
