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

The way back: ``reference_layout`` stacks the port's list of layers into
the reference's layout (when ``cfg.scan_layers``) for any tree of the
parameters' structure (parameters, gradients, AdamW moments), and
``params_to_numpy`` makes that numpy. Checkpoints are written in that
layout, so the two packages name their leaves alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import QuantizedTensor
from repro_torch.quant.config import QuantConfig
from repro_torch.tree import tree_map


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
        return port_layout(
            {k: params_from_numpy(v, device) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if hasattr(tree, "packed") and hasattr(tree, "cfg"):
        return QuantizedTensor(
            tensor_from_numpy(tree.packed, device),
            tensor_from_numpy(tree.scale, device),
            tuple(tree.orig_shape), int(tree.axis), quant_config(tree.cfg),
        )
    return tensor_from_numpy(tree, device)


def reference_layout(tree, cfg):
    """A tree of the port's parameter structure in the reference's layout:
    with ``cfg.scan_layers`` its ``blocks`` list becomes ONE layer dict
    whose leaves stack the layers along a new leading axis (a copy);
    otherwise the tree itself. Dtypes and devices are kept."""
    if not (cfg.scan_layers and isinstance(tree, dict)
            and isinstance(tree.get("blocks"), list)):
        return tree
    return {**tree, "blocks": tree_map(lambda *xs: torch.stack(xs),
                                       *tree["blocks"])}


def port_layout(tree):
    """The inverse of ``reference_layout``: stacked ``blocks`` become one
    dict per layer (views of the stacked leaves)."""
    if isinstance(tree, dict) and isinstance(tree.get("blocks"), dict):
        from repro_torch.models.model import unstack_blocks

        return {**tree, "blocks": unstack_blocks(
            tree["blocks"], _first_leaf(tree["blocks"]).shape[0])}
    return tree


def params_to_numpy(tree, cfg):
    """``reference_layout(tree, cfg)`` as numpy arrays (on the host).
    numpy has no bf16 of its own: bf16 leaves come out in the bf16 dtype
    that ``ml_dtypes`` registers with numpy (present wherever the
    reference runs), or raise TypeError where it is not registered (the
    checkpoint store writes bf16 through torch and needs none)."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype != torch.bfloat16:
            return t.numpy()
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError("a bf16 numpy array needs ml_dtypes") from e
        return t.view(torch.int16).numpy().view(bf16)

    return tree_map(leaf, reference_layout(tree, cfg))


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
