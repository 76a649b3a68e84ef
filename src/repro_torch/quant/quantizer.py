"""Symmetric per-channel quantization."""
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
