"""The few places where a sharded step (parameters and batch as
``torch.distributed.tensor.DTensor``, placed by ``sharding``) needs more
than PyTorch's own sharding rules. The model calls these at one place
each, so a PyTorch whose rules take more drops them here.

A plain tensor the step makes (positions, rope tables, masks, the
learning rate) takes part as a replicated DTensor inside
:func:`replicating`; :func:`on_local_heads` runs attention on each
rank's own batch rows and heads; :func:`linear_input` gathers a
sequence-sharded activation before a linear; :func:`unshard` gathers a
dim whose shards an op cannot take; :func:`constrain` applies the
activation-sharding hint; :func:`placed_like` puts a gradient back on
its parameter's placements. On plain tensors each is a no-op, so the
unsharded step runs exactly as before.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch

_REPLICATING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_replicating", default=False)


@functools.cache
def _dtensor():
    """The DTensor class, imported at first use (these helpers run on
    every forward, sharded or not)."""
    from torch.distributed.tensor import DTensor

    return DTensor


@contextlib.contextmanager
def replicating(*tensors):
    """Where one of ``tensors`` is a DTensor, a scope in which plain
    tensors take part in DTensor ops as replicated
    (``implicit_replication``); otherwise, or inside such a scope
    already, nothing. A sharded step keeps the scope over its backward
    pass too."""
    if _REPLICATING.get() or not any(is_dtensor(t) for t in tensors):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    token = _REPLICATING.set(True)
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING.reset(token)


def unshard(t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """A DTensor with its shards of dim ``dim`` gathered whole on every
    rank, for an op DTensor has no sharding rule for; with ``dim`` None,
    the DTensor replicated (shards gathered, partial sums reduced). Its
    backward reduce-scatters the gradient. Any other tensor is returned
    as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    if dim is None:
        new = [Replicate()] * len(t.placements)
    else:
        dim %= t.ndim
        new = [Replicate() if p.is_shard(dim) else p for p in t.placements]
    if new == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, new)


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements (a partial sum
    reduced, as FSDP reduce-scatters it); any other gradient as it is."""
    if is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def is_dtensor(t) -> bool:
    return isinstance(t, _dtensor())


def constrain(x: torch.Tensor, placements) -> torch.Tensor:
    """``x`` redistributed to ``placements`` (one per mesh dim) where both
    are given and ``x`` is a DTensor, as the reference's
    ``with_sharding_constraint``; otherwise ``x`` as it is."""
    if placements is None or not is_dtensor(x):
        return x
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def linear_input(x: torch.Tensor) -> torch.Tensor:
    """A linear's input with its middle dims (the sequence) gathered where
    a DTensor shards them: Megatron-SP's all-gather before a linear. It is
    needed wherever the weight is sharded on the same mesh dim, and made
    also where it is not, as the matmul flattens (batch, sequence), which
    PyTorch 2.11's view rules refuse with the second dim sharded. On a
    stream that the hint leaves unsharded over the sequence it is a
    no-op."""
    for d in range(1, x.ndim - 1):
        x = unshard(x, d)
    return x


def on_local_heads(attend, q, k, v, q_pos, k_pos):
    """``attend(q, k, v, q_pos, k_pos)`` (q [B, Sq, H, dh], k / v [B, Sk,
    Hkv, dh], positions [B, S]) on DTensors, run on each rank's own
    batch rows and heads as plain tensors: attention is independent per
    row and head, so no collective is made where q, k and v are sharded
    alike on the batch (dim 0) or the heads (dim 2, when H and Hkv split
    evenly, which keeps each query head with its KV head). A mesh dim
    that shards them otherwise (the sequence, a partial sum, or q apart
    from k and v) is gathered first. The output has q's placements; its
    gradient is put back on them before it flows into the per-rank
    computation."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = q.device_mesh
    whole = [Replicate()] * mesh.ndim

    def dt(t):
        return t if is_dtensor(t) else DTensor.from_local(
            t, mesh, whole, run_check=False)

    k, v = dt(k), dt(v)
    place, heads = [], 1
    for i, p in enumerate(q.placements):
        alike = k.placements[i] == p and v.placements[i] == p
        if alike and (p.is_shard(0) or p.is_shard(2)):
            place.append(p)
            heads *= mesh.size(i) if p.is_shard(2) else 1
        else:
            place.append(Replicate())
    if q.shape[2] % heads or k.shape[2] % heads:
        place = [Replicate() if p.is_shard(2) else p for p in place]
    q, k, v = (constrain(t, place) for t in (q, k, v))
    rows = [p if p.is_shard(0) else Replicate() for p in place]
    ql, kl, vl = (t.to_local() for t in (q, k, v))
    qp, kp = (constrain(dt(t), rows).to_local() for t in (q_pos, k_pos))
    out = attend(ql, kl, vl, qp, kp)
    shape = (*q.shape[:-1], out.shape[-1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=shape, stride=stride)
