"""Symmetric per-channel quantization and straight-through-estimator
fake-quant."""
from __future__ import annotations

import torch


def quantize_symmetric(w: torch.Tensor, bits: int, axis: int = 0,
                       group_size: int | None = None):
    """Quantize to signed ``bits`` with symmetric per-channel scaling.

    Returns (q int32 in [-2^(b-1)+1, 2^(b-1)-1], scale f32); the scale is
    constant along ``axis``, the reduction axis of the matmul the weight
    feeds, unless ``group_size`` splits that axis into groups of its own
    scale (scale then has ``len // group_size`` entries along ``axis``).
    Same f32 arithmetic as the reference, so codes agree bit for bit.
    """
    qmax = (1 << (bits - 1)) - 1
    wf = w.to(torch.float32)
    if group_size is not None:
        k = w.shape[axis]
        if k % group_size:
            raise ValueError(f"group_size {group_size} !| axis len {k}")
        shp = list(w.shape)
        shp[axis:axis + 1] = [k // group_size, group_size]
        wg = wf.reshape(shp)
        amax = wg.abs().amax(dim=axis + 1, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / qmax
        q = torch.clamp(torch.round(wg / scale), -qmax, qmax)
        return (q.to(torch.int32).reshape(w.shape),
                scale.squeeze(axis + 1))
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int32)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


class _RoundSTE(torch.autograd.Function):
    """round() forward, identity backward (straight-through estimator)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(w: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT), so a
    network is trained for the precision it is deployed at (paper §7).
    The scale's amax is detached, as the reference's ``stop_gradient``:
    the gradient reaches ``w`` through the rounding only. The clip is a
    maximum then a minimum, as ``jnp.clip`` is: where the code sits on
    the bound (the amax element of each channel) each passes half the
    gradient, and beyond it none."""
    qmax = (1 << (bits - 1)) - 1
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True).detach()
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = _RoundSTE.apply(w / scale)
    lo = torch.full((), -qmax, dtype=q.dtype, device=q.device)
    q = torch.minimum(torch.maximum(lo, q), -lo)
    return q * scale
