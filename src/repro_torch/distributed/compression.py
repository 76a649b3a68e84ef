"""Gradient compression with error feedback for data parallelism over a
slow link.

The gradient all-reduce payload is quantized, and what the quantization
lost is carried into the next step (the residual):

    send_t   = quantize(grad_t + residual_{t-1})
    residual = (grad_t + residual_{t-1}) - dequantize(send_t)

8 bits: symmetric per-tensor int8. 4 bits: the codes SAMD-packed eight
lanes a 32-bit word (``core.samd.dense_format(4, signed=True)``), the
paper's packing applied to gradient traffic. ``compress_tree`` applies
the quantize-dequantize round trip leaf by leaf, so a run that trains
with it has the dynamics of the compressed all-reduce; ``compressed_psum``
is that all-reduce over a process group. Payloads, scales
and residuals are the reference's bit for bit (the same f32 arithmetic;
packed words as int32 where the reference has uint32).
"""
from __future__ import annotations

import torch

from repro_torch.core import samd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_INT4 = samd.dense_format(4, signed=True, word_bits=32)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_int4_packed(x: torch.Tensor):
    """4-bit payload, SAMD-packed 8 lanes a word. Returns (int32 words,
    scale)."""
    xf = x.to(torch.float32).reshape(-1)
    amax = torch.amax(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / 7.0
    q = torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int32)
    return samd.pack(q, _INT4), scale


def dequantize_int4_packed(words: torch.Tensor, scale: torch.Tensor, n: int,
                           shape) -> torch.Tensor:
    q = samd.unpack(words, _INT4, n)
    return (q.to(torch.float32) * scale).reshape(shape)


def compress_grad(g: torch.Tensor, residual: torch.Tensor, bits: int = 8):
    """Error-feedback compression of one gradient leaf. Returns (payload,
    scale, new residual); the payload is int8 (bits=8) or packed int32
    words (bits=4)."""
    acc = g.to(torch.float32) + residual
    if bits == 8:
        q, scale = quantize_int8(acc)
        deq = dequantize_int8(q, scale)
    elif bits == 4:
        q, scale = quantize_int4_packed(acc)
        deq = dequantize_int4_packed(q, scale, acc.numel(), acc.shape)
    else:
        raise ValueError(bits)
    return q, scale, acc - deq


def compressed_psum(x: torch.Tensor, group=None, bits: int = 8):
    """All-reduce (SUM) with quantize-before-send semantics: ``x`` is
    quantized (int8, or 4-bit SAMD-packed), dequantized, and the f32
    values summed over ``group``: a process group, a one-dimensional
    DeviceMesh (e.g. ``mesh["data"]``, one mesh dim), or None for the
    default group. What crosses the link is the quantized payload;
    accumulation is in f32 after dequantization, as the reference's
    ``psum`` inside ``shard_map``. Bits other than 8 and 4 raise
    ValueError before any collective."""
    import torch.distributed as dist

    if bits == 8:
        q, scale = quantize_int8(x)
        deq = dequantize_int8(q, scale)
    elif bits == 4:
        q, scale = quantize_int4_packed(x)
        deq = dequantize_int4_packed(q, scale, x.numel(), x.shape)
    else:
        raise ValueError(bits)
    if hasattr(group, "get_group"):  # a DeviceMesh of one dim
        group = group.get_group()
    dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq


def compress_tree(grads, residuals, bits: int = 8):
    """Error-feedback compression leaf by leaf. Returns (the dequantized
    gradients, each in its leaf's dtype, new residuals): what a
    bandwidth-limited all-reduce would deliver."""
    outs, new_res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        q, scale, nr = compress_grad(g, r, bits)
        if bits == 8:
            deq = dequantize_int8(q, scale)
        else:
            deq = dequantize_int4_packed(q, scale, g.numel(), g.shape)
        outs.append(deq.to(g.dtype))
        new_res.append(nr)
    return tree_unflatten(grads, outs), tree_unflatten(grads, new_res)


def init_residuals(params):
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
