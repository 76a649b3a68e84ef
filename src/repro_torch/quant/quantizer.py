"""Symmetric per-channel quantization."""
from __future__ import annotations

import torch


def quantize_symmetric(w: torch.Tensor, bits: int, axis: int = 0):
    """Quantize to signed ``bits`` with symmetric per-channel scaling.

    Returns (q int32 in [-2^(b-1)+1, 2^(b-1)-1], scale f32); the scale is
    constant along ``axis``, the reduction axis of the matmul the weight
    feeds. Same f32 arithmetic as the reference, so codes agree bit for
    bit.
    """
    qmax = (1 << (bits - 1)) - 1
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int32)
    return q, scale
