"""Logical-axis -> mesh-axis sharding rules (the port of
``repro/distributed/sharding.py``), and their DTensor placements.

Every parameter's logical axes are declared in its TensorSpec; the rules
resolve them against a mesh with a divisibility check: an axis that does
not divide evenly is replicated.

Rules (the reference's):
  vocab / ff / heads / kv_heads / experts / ssm_inner / rwkv_att -> 'model'
  embed -> ('data', 'pod') in train mode (FSDP / ZeRO style: parameters
           and optimizer state sharded over the data axes; each layer's
           weights are all-gathered where they are used), replicated in
           serve mode
  batch -> ('pod', 'data') when divisible, else ('data',), else replicated
  long-context KV cache: sequence -> 'data' when batch is unshardable

A spec is a :class:`P`, one entry a tensor dim: None (replicated), a
mesh-axis name, or a tuple of names (the dim split over those axes, the
first the major one). A mesh is either an object whose ``.shape`` maps
axis names to sizes, or a ``torch.distributed.device_mesh.DeviceMesh``
(whose names are ``mesh_dim_names``). :func:`placements` turns a spec
tree into DTensor placements on a DeviceMesh, and :func:`distribute`
places a tree of tensors by them.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.layers import QuantizedTensor
from repro_torch.models.quantize import _packs
from repro_torch.models.spec import TensorSpec, map_specs

_MODEL_AXES = {
    "vocab", "ff", "heads", "kv_heads", "experts", "ssm_inner", "rwkv_att",
}


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh-axis
    name or a tuple of names. The entries are kept as made, so
    ``P(("data",), "model")`` is not ``P("data", "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of an object with a .shape
    dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(mesh, name: str) -> int:
    return _mesh_shape(mesh).get(name, 1)


def _data_axes_for(dim: int, mesh) -> tuple | None:
    """FSDP axes for an 'embed' dim: ('data', 'pod') when both divide."""
    axes = []
    div = 1
    for name in ("data", "pod"):
        sz = _axis_size(mesh, name)
        if sz > 1 and dim % (div * sz) == 0:
            axes.append(name)
            div *= sz
    return tuple(axes) if axes else None


def logical_to_mesh(axes, shape, mesh, mode: str = "train") -> P:
    """Resolve logical axis names to a spec.

    At most one dim takes 'model'; at most one dim takes the data axes.
    Indivisible axes are replicated. ``mode='train'``: 'embed' is
    FSDP-sharded over (data, pod); ``mode='serve'``: 'embed' stays
    replicated, weight shards are on 'model' only and no step gathers a
    weight.
    """
    out = []
    model_used = False
    data_used = False
    for dim, name in zip(shape, axes):
        if (name in _MODEL_AXES and not model_used
                and dim % _axis_size(mesh, "model") == 0):
            out.append("model")
            model_used = True
        elif name == "embed" and not data_used and mode == "train":
            ax = _data_axes_for(dim, mesh)
            out.append(ax)
            data_used = ax is not None
        else:
            out.append(None)
    return P(*out)


def _pspec_for_spec(spec: TensorSpec, mesh, mode: str = "train") -> P:
    return logical_to_mesh(spec.axes, spec.shape, mesh, mode)


def _pspec_for_quantized(spec: TensorSpec, mesh, qcfg,
                         mode: str = "train") -> tuple:
    """Packed weights are 2D [K/vpw, prod(rest)]: the packed reduction
    dim on the data axes (FSDP, train mode only) when it divides, and
    the flattened rest on 'model' iff a rest axis was model-sharded and
    the sizes divide."""
    axis = spec.quant_axis
    kw = -(-spec.shape[axis] // qcfg.values_per_word)
    rest_axes = [a for i, a in enumerate(spec.axes) if i != axis]
    rest = math.prod(s for i, s in enumerate(spec.shape) if i != axis)
    shard_rest = (any(a in _MODEL_AXES for a in rest_axes)
                  and rest % _axis_size(mesh, "model") == 0)
    d_ax = _data_axes_for(kw, mesh) if mode == "train" else None
    wspec = P(d_ax, "model" if shard_rest else None)
    sspec = P(None, "model" if shard_rest else None)
    return wspec, sspec


def param_pspecs(template, mesh, qcfg=None, mode: str = "train"):
    """Spec tree matching the params: a :class:`P` a leaf, or, for a leaf
    ``quantize_params`` packs under an enabled ``qcfg``, a QuantizedTensor
    whose ``packed`` and ``scale`` are the specs of its words and scales.
    ``mode``: 'train' = FSDP embed sharding, 'serve' = model axis only."""
    quantized = qcfg is not None and qcfg.enabled

    def visit(spec):
        if not quantized or not _packs(spec, qcfg):
            return _pspec_for_spec(spec, mesh, mode)
        wspec, sspec = _pspec_for_quantized(spec, mesh, qcfg, mode)
        return QuantizedTensor(wspec, sspec, tuple(spec.shape),
                               spec.quant_axis, qcfg)

    return map_specs(visit, template)


def batch_pspec(batch: int, mesh) -> tuple:
    """Mesh axes for the global batch dimension (greedy, pod first)."""
    axes = []
    div = 1
    for name in ("pod", "data"):
        sz = _axis_size(mesh, name)
        if sz > 1 and batch % (div * sz) == 0:
            axes.append(name)
            div *= sz
    return tuple(axes)


def data_pspec(batch: int, mesh) -> P:
    axes = batch_pspec(batch, mesh)
    return P(axes if axes else None, None)


def cache_pspecs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                 stacked: bool = False, kv_bits=None):
    """Spec tree matching ``init_cache(cfg, batch, max_len)`` (the
    reference's layout, ``layers_stacked`` when ``stacked``).

    Every mesh axis is spent on the decode KV cache: batch over the data
    axes; KV heads over 'model' when divisible, otherwise the sequence
    axis goes on 'model' (flash-decoding style). Batch-1 long context
    also shards the sequence over 'data'.
    """
    from repro_torch.models.ssm import mamba2_dims, rwkv6_dims

    b = shape.global_batch
    baxes = batch_pspec(b, mesh) or None
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data")
    kv_div = bool(cfg.n_kv_heads) and cfg.n_kv_heads % model == 0
    seq_axes = []
    if (baxes is None or "data" not in baxes) and shape.seq_len % data == 0:
        seq_axes.append("data")  # batch can't use data -> sequence does
    if not kv_div and shape.seq_len % model == 0:
        seq_axes.append("model")  # flash-decoding key-range sharding
    kv_ax = "model" if kv_div else None
    seq_ax = tuple(seq_axes) if seq_axes else None

    def kv():
        out = {
            "k": P(baxes, seq_ax, kv_ax, None),
            "v": P(baxes, seq_ax, kv_ax, None),
            "pos": P(baxes, seq_ax),
        }
        if kv_bits == 8:
            out["k_scale"] = P(baxes, seq_ax, kv_ax)
            out["v_scale"] = P(baxes, seq_ax, kv_ax)
        return out

    def rwkv():
        h, _ = rwkv6_dims(cfg)
        h_ax = "model" if h % model == 0 else None
        d_ax = "model" if cfg.d_model % model == 0 else None
        return {"wkv": P(baxes, h_ax, None, None),
                "shift_tm": P(baxes, d_ax), "shift_cm": P(baxes, d_ax)}

    if stacked:  # leading layer dim from the scan-over-layers prefill
        if cfg.family in ("dense", "moe"):
            one = kv()
        elif cfg.family == "rwkv6":
            one = rwkv()
        else:
            raise ValueError(cfg.family)
        return {"layers_stacked": {k: P(None, *p) for k, p in one.items()}}

    layers = []
    if cfg.family in ("dense", "moe"):
        layers = [kv() for _ in range(cfg.n_layers)]
    elif cfg.family == "rwkv6":
        layers = [rwkv() for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid_mamba2":
        _, n_heads, conv_dim = mamba2_dims(cfg)
        h_ax = "model" if n_heads % model == 0 else None
        c_ax = "model" if conv_dim % model == 0 else None
        for i in range(cfg.n_layers):
            st = {"conv": P(baxes, c_ax, None),
                  "ssd": P(baxes, h_ax, None, None)}
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                st["attn_kv"] = kv()
            layers.append(st)
    return {"layers": layers}


# -- DTensor placements -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a tensor lives: a DeviceMesh and one DTensor placement per
    mesh dim (the counterpart of the reference's NamedSharding)."""

    mesh: object
    placements: tuple


def _placements_of(spec: P, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if a in names]
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of {spec}")
            out[i] = Shard(d)
        if len(idx) == 2 and idx[0] > idx[1]:
            # the multi-pod FSDP dim, ('data', 'pod') on a (pod, data, ...)
            # mesh: data-major as the reference's NamedSharding splits it.
            # DTensor splits in mesh order unless the earlier mesh dim is
            # a strided shard of the later one's blocks
            out[idx[1]] = _StridedShard(d, split_factor=mesh.size(idx[0]))
        elif idx != sorted(idx):
            raise NotImplementedError(
                f"dim {d} of {spec} is split over {axes}: more than two "
                f"mesh axes out of the mesh's order {tuple(names)}")
    return tuple(out)


def _map_pspecs(fn, tree):
    """``fn`` over the P leaves of a spec tree (a QuantizedTensor node's
    packed and scale specs included)."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, packed=fn(tree.packed),
                                   scale=fn(tree.scale))
    if isinstance(tree, dict):
        return {k: _map_pspecs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_pspecs(fn, v) for v in tree]
    return tree


def placements(tree, mesh):
    """Spec tree -> tree of :class:`Layout` on the DeviceMesh ``mesh``: a
    dim sharded on mesh axis a becomes ``Shard(dim)`` at a's mesh dim,
    every other mesh dim ``Replicate()``. A dim split over two mesh axes
    in the mesh's order is ``Shard(dim)`` on both; over two in the other
    order (('data', 'pod') on the multi-pod mesh), ``Shard(dim)`` on the
    major axis and ``_StridedShard(dim, split_factor=<its size>)`` on the
    minor one, so each rank holds the block the reference's
    NamedSharding gives it (data-major, pod-minor). More than two axes
    out of order raise NotImplementedError."""
    return _map_pspecs(lambda p: Layout(mesh, _placements_of(p, mesh)),
                       tree)


def distribute(tree, layouts):
    """Place every tensor of ``tree`` by the Layout at the same place in
    ``layouts`` (``distribute_tensor``: each rank keeps its shard of the
    full tensor it holds, so every rank passes the same ``tree``). A
    QuantizedTensor's ``packed`` and ``scale`` are placed by its
    layout's."""
    from repro_torch.tree import tree_leaves, tree_unflatten

    out = []
    for t, lay in zip(tree_leaves(tree), tree_leaves(layouts)):
        if isinstance(t, QuantizedTensor):
            t = dataclasses.replace(t, packed=_place(t.packed, lay.packed),
                                    scale=_place(t.scale, lay.scale))
        else:
            t = _place(t, lay)
        out.append(t)
    return tree_unflatten(tree, out)


def _place(t, lay: Layout):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(lay.mesh.device_type), lay.mesh,
                             lay.placements)
