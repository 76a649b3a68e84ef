"""AdamW with decoupled weight decay and global-norm clipping.

Moments are f32 whatever the parameter's dtype, laid out as the
parameters are; weight decay skips leaves of fewer than two dimensions
(norms, biases, gates). The update is out of place: it returns new
parameters, each rounded back to its own dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import register_node, tree_leaves, tree_map
from repro_torch.tree import tree_unflatten


@register_node
@dataclasses.dataclass
class AdamWState:
    """``step``: a 0-d int32 tensor, the number of updates made; ``m`` and
    ``v``: f32 trees of the parameters' structure. The field order is the
    reference's pytree children, so checkpoint leaves are named
    ``opt/0``, ``opt/1/...``, ``opt/2/...`` in both packages."""

    step: torch.Tensor
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):  # a DTensor parameter's moments take its placements
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(grads, state: AdamWState, params, lr: torch.Tensor, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (new_params, new_state, {"grad_norm"}). ``grads`` has the
    parameters' structure, in any float dtype."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1c = 1.0 - b1 ** step.to(torch.float32)
        b2c = 1.0 - b2 ** step.to(torch.float32)

        def upd(g, m, v, p):
            g = g.to(torch.float32) * scale
            m2 = b1 * m + (1.0 - b1) * g
            v2 = b2 * v + (1.0 - b2) * g * g
            mhat = m2 / b1c
            vhat = v2 / b2c
            delta = mhat / (torch.sqrt(vhat) + eps)
            if p.ndim >= 2 and weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            p2 = (p.to(torch.float32) - lr * delta).to(p.dtype)
            return p2, m2, v2

        out = [upd(*xs) for xs in zip(*map(tree_leaves, (
            grads, state.m, state.v, params)))]
        new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                               for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
