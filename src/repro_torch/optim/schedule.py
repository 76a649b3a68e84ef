"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step: torch.Tensor, *, peak_lr: float, warmup: int = 100,
                  total: int = 10000, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``floor`` x
    ``peak_lr`` at ``total``. ``step`` is an integer tensor; the result is
    an f32 tensor on its device, computed in f32 in the reference's order
    of operations. The cosine of the f32 argument is taken in f64 and
    rounded once to f32, i.e. correctly rounded (almost always), as XLA's
    f32 cosine is at all but about 1% of arguments; torch's own f32
    cosine (SLEEF on the CPU, ``cosf`` on CUDA) is 1-2 units off the last
    place more often."""
    s = step.to(torch.float32)
    # (s+1)/warmup so the very first step already trains
    warm = peak_lr * torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cosine = torch.cos((math.pi * frac).to(torch.float64)).to(torch.float32)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + cosine))
    return torch.where(s < warmup, warm, cos)
