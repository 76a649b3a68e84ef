"""The yardstick's arithmetic: the H100's peaks, the operations and bytes
of one kernel launch, and the model's operations per token (counted by
the configuration's family, ``families/<family>.py``).

Bytes count each input read once and each output written once, at the
sizes these inputs need; operations count the multiply-adds as two.
"""
from __future__ import annotations

import math

from perfcells import families

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over peak bfloat16 rate and the bytes over peak bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def samd_matmul(m: int, k: int, n: int, values_per_word: int) -> tuple:
    """(operations, bytes) of x [m, k] bf16 times a packed weight [k, n]
    (ceil(k / vpw) int32 words a column, one f32 scale a column) into a
    bf16 [m, n]."""
    flops = 2.0 * m * k * n
    nbytes = (math.ceil(k / values_per_word) * n * 4 + n * 4
              + m * k * 2 + m * n * 2)
    return flops, nbytes


def paged_decode_attention(contexts, pages, page_size: int, n_heads: int,
                           n_kv_heads: int, head_dim: int,
                           kv_bytes: int = 2) -> tuple:
    """(operations, bytes) of one decode attention launch over a paged
    pool. ``contexts`` lists each active row's keys (its position + 1);
    ``pages`` lists each active row's page ids in logical order. A page
    that several rows read is read once: each distinct page counts the
    most slots any row reads of it. q in and the output out are bf16."""
    flops = sum(4.0 * n_heads * head_dim * c for c in contexts)
    used: dict = {}
    for c, row in zip(contexts, pages):
        for blk, page in enumerate(row[: -(-c // page_size)]):
            slots = min(page_size, c - blk * page_size)
            used[page] = max(used.get(page, 0), slots)
    kv = sum(used.values()) * n_kv_heads * head_dim * 2 * kv_bytes
    q_out = 2 * len(contexts) * n_heads * head_dim * 2
    return flops, kv + q_out


def matmul_params_per_token(arch: dict, head: bool = True) -> int:
    """Weights one token multiplies through (routed experts: top_k of
    them, and the router), the LM head unless ``head`` is False; the
    embedding gather is no matmul. The configuration's family counts."""
    return families.load(arch["family"]).matmul_params_per_token(arch, head)


def token_flops(arch: dict, context: int) -> float:
    """Model operations of one token that attends to ``context`` keys."""
    return families.load(arch["family"]).token_flops(arch, context)


def prefill_flops(arch: dict, start: int, length: int) -> float:
    """Model operations of prefilling positions start .. start+length-1,
    each attending causally to every position before it and itself; the
    LM head runs for the last position alone (its first token)."""
    return families.load(arch["family"]).prefill_flops(arch, start, length)
