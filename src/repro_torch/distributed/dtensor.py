"""The few places where a sharded step (parameters and batch as
``torch.distributed.tensor.DTensor``, placed by ``sharding``) needs more
than PyTorch's own sharding rules. The model calls these at one place
each, so a PyTorch whose rules take more drops them here.

A plain tensor the step makes (positions, rope tables, masks, the
learning rate) takes part as a replicated DTensor inside
:func:`replicating`. :func:`on_local_blocks` runs attention or a
recurrent scan on each rank's own batch rows and heads, or MoE experts
on its own groups and experts; :func:`on_local_words` runs a packed
linear on each rank's own words and :func:`on_local_columns` unpacks
them; :func:`write_columns` writes a ring cache's columns into each
rank's shard.
:func:`linear_input` gathers a sequence-sharded activation before a
linear, :func:`fsdp_gathered` a weight's FSDP shards where it is used,
:func:`whole_heads` a feature dim whose shards would split a head (and
:func:`merge_heads` the gradient of one), and :func:`unshard` a dim
whose shards an op cannot take. :func:`constrain` applies the
activation-sharding hint; :func:`grad_placed` and :func:`placed_like`
put a gradient back on its tensor's or parameter's placements. On plain
tensors each is a no-op, so the unsharded step runs exactly as before.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
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
    rank and its partial sums reduced, for an op DTensor has no sharding
    rule for; with ``dim`` None, the DTensor replicated. Its backward
    reduce-scatters the gradient. Any other tensor is returned as it
    is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    if dim is None:
        new = [Replicate()] * len(t.placements)
    else:
        dim %= t.ndim
        new = [Replicate() if p.is_shard(dim) or p.is_partial() else p
               for p in t.placements]
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


def whole_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``x`` [..., heads * dh] ready for its split into heads: where a
    DTensor shards the last dim over mesh dims whose sizes together do
    not divide ``heads``, that dim is gathered on them, so every shard
    holds whole heads (DTensor cannot unflatten a dim whose shards split
    one). The reference's XLA pads such shards instead; this gather is
    the port's own communication. Otherwise ``x`` as it is."""
    if not is_dtensor(x):
        return x
    mesh, last = x.device_mesh, x.ndim - 1
    over = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
    if heads % math.prod(mesh.size(i) for i in over) == 0:
        return x
    return unshard(x, last)


class _GradMapped(torch.autograd.Function):
    """Identity whose backward hands on ``fn(gradient)``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; on a DTensor that requires grad, its gradient is
    put on ``x``'s own placements (a partial sum's: replicated; partial
    sums reduced) as it comes back, where DTensor would leave a partial
    sum for some later op to reduce over a dim of its own choice."""
    if not (is_dtensor(x) and x.requires_grad and torch.is_grad_enabled()):
        return x
    from torch.distributed.tensor import Replicate

    place = [Replicate() if p.is_partial() else p for p in x.placements]
    return _GradMapped.apply(x, functools.partial(constrain,
                                                  placements=place))


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., heads, dh] flattened to [..., heads * dh]. On a DTensor
    the gradient coming back is gathered as :func:`whole_heads` gathers
    before it is split into heads again (the flatten's backward)."""
    flat = x.flatten(-2)
    if not is_dtensor(flat) or not torch.is_grad_enabled():
        return flat
    return _GradMapped.apply(flat, functools.partial(whole_heads,
                                                     heads=x.shape[-2]))


def fsdp_gathered(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight with its shards over the data axes ('data',
    'pod': the FSDP split of train mode) gathered, its 'model' split
    kept: the all-gather where a layer uses its weight, whose backward
    reduce-scatters the gradient. (Left to DTensor's own choice, a
    matmul may carry the weight's split over to its activations, which
    for the multi-pod strided split it cannot propagate.) Any other
    tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names or ()
    new = [Replicate() if n in ("data", "pod") else p
           for n, p in zip(names, w.placements)]
    return constrain(w, new)


def on_local_words(product, x, packed, scale, k: int, vpw: int,
                   grouped: bool):
    """``product(x, packed, scale, k)`` (x [..., K] @ the SAMD-packed
    weight: words [ceil(K / vpw), N], scales [G, N]) where ``packed`` is
    a DTensor, run on each rank's own words as plain tensors. Per mesh
    dim:

      * words split on N: x gathered on K, the output split on N;
      * words split on K at whole words (plain ``Shard(0)``, K a multiple
        of ``vpw`` and the word count of every split; per-channel scales
        only): x split on the same K boundaries, the output a partial
        sum, which the next op that needs it reduces;
      * any other: the words gathered, x's batch or sequence split kept
        (a split of K or a partial sum gathered or reduced).

    ``scale`` follows the words' N split. Inference only (the product
    has no gradient)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = packed.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    last = x.ndim - 1
    words = packed.shape[0]
    xp, wp, sp, out = [], [], [], []
    k_split = 1
    for i, (a, p) in enumerate(zip(x.placements, packed.placements)):
        n = mesh.size(i)
        if p.is_shard(1):
            xp.append(Replicate())
            wp.append(p)
            sp.append(Shard(1))
            out.append(Shard(last))
        elif (type(p) is Shard and p.dim == 0 and not grouped
              and k % vpw == 0 and words % (k_split * n) == 0):
            k_split *= n
            xp.append(Shard(last))
            wp.append(p)
            sp.append(Replicate())
            out.append(Partial())
        else:
            keep = a.is_shard() and a.dim % x.ndim != last
            xp.append(a if keep else Replicate())
            wp.append(Replicate())
            sp.append(Replicate())
            out.append(a if keep else Replicate())
    x, packed, scale = (constrain(t, pl) for t, pl in
                        ((x, xp), (packed, wp), (scale, sp)))
    local = product(x.to_local(), packed.to_local(), scale.to_local(),
                    k // k_split)
    shape = (*x.shape[:-1], packed.shape[1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=shape, stride=stride)


def write_columns(buf, val: torch.Tensor, start: int) -> None:
    """``buf[:, start:start + S] = val`` IN PLACE for a DTensor ``buf``
    [B, T, ...] (a ring cache) and ``val`` [B, S, ...] of its dtype: each
    rank writes the columns its own shard holds. (DTensor slices a dim it
    splits by gathering it into a new tensor, so a plain slice
    assignment on a sequence-sharded ring would write into that copy.)
    ``val`` is first placed as ``buf``, its second dim whole."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = buf.device_mesh
    if not is_dtensor(val):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    val = constrain(val, [Replicate() if p.is_shard(1) else p
                          for p in buf.placements]).to_local()
    # this rank's columns [first, first + size): DTensor's Shard splits
    # as torch.chunk does, mesh dim by mesh dim
    first, size = 0, buf.shape[1]
    coord = mesh.get_coordinate()
    for i, p in enumerate(buf.placements):
        if p.is_shard(1):
            step = -(-size // mesh.size(i))
            lo = min(coord[i] * step, size)
            first, size = first + lo, min(step, size - lo)
    lo = max(start, first)
    hi = min(start + val.shape[1], first + size)
    if lo < hi:
        buf.to_local()[:, lo - first:hi - first] = (
            val[:, lo - start:hi - start])


def on_local_columns(unpack, packed, scale, k: int):
    """``unpack(packed, scale)`` -> the dense [K, N] weight of SAMD-packed
    words [ceil(K / vpw), N] and their scales [G, N], for a DTensor
    ``packed``: the words and scales gathered whole over K (their FSDP
    split), then each rank's own columns unpacked as plain tensors; the
    dense weight keeps the words' split of N."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = packed.device_mesh
    place = [Shard(1) if p.is_shard(1) else Replicate()
             for p in packed.placements]
    packed, scale = constrain(packed, place), constrain(scale, place)
    dense = unpack(packed.to_local(), scale.to_local())
    shape = (k, packed.shape[1])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(dense, mesh, place, run_check=False,
                              shape=shape, stride=stride)


def on_local_blocks(fn, args, dims, out_dims):
    """``fn(*args)`` where one of ``args`` is a DTensor, run on each
    rank's own blocks of two dims along which ``fn`` is independent, as
    plain tensors: batch rows and heads of attention (q, k, v with their
    positions; a query head stays with its KV head when both head counts
    split evenly) or of a recurrent scan (the chunked RWKV6 and Mamba2
    scans, whose Python loop over chunks would dispatch each of its many
    small ops through DTensor), or MoE groups and experts. No collective
    is made where the args are split alike. ``dims`` gives each arg's
    (first, second) dim, either None where it has no such dim;
    ``out_dims`` each output's. A mesh dim that splits the first arg on
    its first dim splits every arg's first dim; else one that splits an
    arg on its second dim splits every arg's second dim; each only where
    every arg's dim divides evenly, and any other is gathered. An arg
    without the split dim is whole on that mesh dim (its gradient a
    partial sum over it, reduced as it leaves: ``grad_placed``), and an
    output without it is a partial sum over it (``fn`` sums over its
    experts)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    whole = [Replicate()] * mesh.ndim
    args = [grad_placed(a) if is_dtensor(a) else DTensor.from_local(
        a, mesh, whole, run_check=False) for a in args]

    def divide(k, n):  # every arg's k-th dim splits evenly into n
        return all(a.shape[d[k]] % n == 0 for a, d in zip(args, dims)
                   if d[k] is not None)

    split = []  # per mesh dim: 0 (first dims), 1 (second dims) or None
    blocks = [1, 1]
    for i in range(mesh.ndim):
        n = mesh.size(i) * blocks[0], mesh.size(i) * blocks[1]
        if args[0].placements[i].is_shard(dims[0][0]) and divide(0, n[0]):
            k = 0
        elif any(d[1] is not None and a.placements[i].is_shard(d[1])
                 for a, d in zip(args, dims)) and divide(1, n[1]):
            k = 1
        else:
            k = None
        split.append(k)
        if k is not None:
            blocks[k] = n[k]

    def place(d, missing):
        return [Replicate() if k is None
                else missing if d[k] is None else Shard(d[k])
                for k in split]

    # an arg whole on a mesh dim whose split the ranks share gets, from
    # each rank, only its blocks' part of the gradient: a partial sum
    local = [constrain(a, place(d, Replicate())).to_local(
        grad_placements=place(d, Partial())) for a, d in zip(args, dims)]
    outs = fn(*local)
    return tuple(DTensor.from_local(o, mesh, place(d, Partial()),
                                    run_check=False)
                 for o, d in zip(outs, out_dims))
