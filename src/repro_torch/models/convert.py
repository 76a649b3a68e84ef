"""Weight bridge: parameters exported as numpy -> the port's parameters.

The input is the reference's parameter tree with every array as numpy
(e.g. ``jax.tree.map(np.asarray, params)``): nested dicts and lists whose
leaves are arrays, or packed weights with the attributes ``packed``
(uint32 words), ``scale``, ``orig_shape``, ``axis`` and ``cfg`` (a
quantization config with ``bits``, ``spacer``, ``kv_bits``...). Nothing
of the reference package is imported: objects are read by attribute.
The reference's two matmul routes (``backend="pallas"`` and ``"xla"``)
compute the same product, so both map to the port's one route, the SAMD
matmul kernel.

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
    if getattr(ref_cfg, "group_size", None) is not None:
        raise NotImplementedError("per-group scales are not ported")
    if getattr(ref_cfg, "act_bits", None) is not None:
        raise NotImplementedError("activation fake-quant is not ported")
    if getattr(ref_cfg, "quantize_embeddings", False):
        raise NotImplementedError("quantized embeddings are not ported")
    if ref_cfg.backend not in ("pallas", "xla"):
        raise ValueError(f"unknown reference backend {ref_cfg.backend!r}")
    return QuantConfig(
        bits=ref_cfg.bits, enabled=ref_cfg.enabled, spacer=ref_cfg.spacer,
        kv_bits=ref_cfg.kv_bits,
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
    ``device``. Stacked layer params (a dict of per-layer-stacked arrays
    under ``blocks``) are not accepted: export the unrolled layout."""
    if isinstance(tree, dict):
        if isinstance(tree.get("blocks"), dict):
            raise ValueError("stacked 'blocks' layout: export it unrolled")
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if hasattr(tree, "packed") and hasattr(tree, "cfg"):
        return QuantizedTensor(
            tensor_from_numpy(tree.packed, device),
            tensor_from_numpy(tree.scale, device),
            tuple(tree.orig_shape), int(tree.axis), quant_config(tree.cfg),
        )
    return tensor_from_numpy(tree, device)
