"""Serving steps over the paged KV pool: ragged decode, batched prefill,
and in-step sampling (the paged subset of ``repro/launch/steps.py``).

Each step runs one ``forward`` and samples on the device, so only the
[B] vector of next token ids crosses to the host.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import forward


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float) -> torch.Tensor:
    """Greedy at temperature == 0 (argmax; ties go to the first index, as
    in the reference), Gumbel-max otherwise: argmax(logits / T + g) with
    g ~ Gumbel(0, 1) drawn from ``generator``. This samples the same
    distribution as the reference, softmax(logits / T), but not the same
    draws (the reference's noise comes from ``jax.random``); a fixed
    generator seed makes it reproducible."""
    lf = logits.to(torch.float32)
    if temperature <= 0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    u = torch.rand(lf.shape, generator=generator, device=lf.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(lf / max(temperature, 1e-6) + g, dim=-1).to(
        torch.int32)


def make_paged_ragged_serve_step(cfg: ArchConfig, max_len: int,
                                 page_size: int):
    """Position-ragged decode against the paged KV pool: every slot
    advances at its own position. Row i's token is written at page
    ``page_table[i, pos_i // page_size]``; rows whose table row is all -1
    (inactive slots) write nowhere and read no key. Attention runs the
    fused paged decode kernel."""

    def paged_ragged_serve_step(params, tokens, cache, positions, active,
                                page_table, generator, temperature):
        """tokens [B, 1]; positions [B]; active [B] bool. Writes the
        tokens' K/V into ``cache`` in place; returns the next ids [B]
        int32, -1 where inactive."""
        pos = positions.to(torch.int64).clamp(0, max_len - 1)
        logits = forward(
            params, tokens, cfg, positions=pos[:, None], cache=cache,
            page_table=page_table, page_size=page_size,
            paged_attn="fused",
        )
        nxt = sample_tokens(logits[:, -1], generator, temperature)
        return torch.where(active, nxt, -1)

    return paged_ragged_serve_step


def make_paged_prefill_step(cfg: ArchConfig, page_size: int):
    """Bucket-padded batched prefill writing straight into the page pool.

    Each row carries its UNSHARED prompt suffix, written from its first
    unshared position ``starts[row]``; shared prefix pages are in the
    row's table, so the suffix attends to them without rewriting them.
    Padding tokens and padding rows (table all -1) write nothing.
    """

    def paged_prefill_step(params, tokens, lens, starts, page_table, valid,
                           cache, generator, temperature):
        """tokens [Nb, Lb] right-padded; lens, starts [Nb]; page_table
        [Nb, n_pp]; valid [Nb] bool. Writes K/V into ``cache`` in place;
        returns the first generated id per row, -1 for padding rows."""
        lb = tokens.shape[1]
        t_idx = torch.arange(lb, device=tokens.device)[None, :]
        pos = torch.where(t_idx < lens[:, None], starts[:, None] + t_idx, -1)
        logits = forward(
            params, tokens, cfg, positions=pos, cache=cache,
            page_table=page_table, page_size=page_size,
        )
        last_idx = (lens - 1).clamp(min=0)
        last = logits[torch.arange(tokens.shape[0], device=tokens.device),
                      last_idx]
        tok0 = sample_tokens(last, generator, temperature)
        return torch.where(valid, tok0, -1)

    return paged_prefill_step
