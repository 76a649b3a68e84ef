"""Analytic per-cell FLOP / HBM-byte calculator (the port's copy of
``repro/launch/analytic_costs.py`` for the dense family, the only one the
port's ``ArchConfig`` admits).

The serving front door prices admission with it
(``serving/server.price_request``), and its refusals compare these
floats, so every expression is the reference's, in the same order: each
field comes out equal to the reference's, not merely close. Terms that
are zero for a dense decoder (recurrent mixers, expert dispatch, shared
blocks) are left out of the sums; the moe, rwkv6 and hybrid branches
come with those families.

Conventions:
  * one matmul of [m,k]x[k,n] = 2mkn flops; bwd = 2x fwd (dx and dW).
  * attention: the full [s_q, s_kv] rectangle, 4·B·s_q·s_kv·H·dh flops
    fwd (QK^T + AV); the causal mask skips no work in the count.
  * bytes: weights read once per step (packed size when SAMD-quantized),
    KV cache read+written, activations ~2 reads+1 write per matmul
    operand at bf16 (coarse; dominated by weights/cache in the cells that
    matter).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass
class CellCost:
    flops: float          # global, one step
    weight_bytes: float   # global params read per step (packed if quant)
    cache_bytes: float    # KV read+write per step
    act_bytes: float      # activation traffic estimate
    details: dict

    @property
    def hbm_bytes(self) -> float:
        return self.weight_bytes + self.cache_bytes + self.act_bytes


def _param_counts(cfg: ArchConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    emb = v * d
    head = 0 if cfg.tie_embeddings else d * v
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = d * h * dh + 2 * d * kv * dh + h * dh * d
    f = cfg.d_ff
    per_layer += d * f * (3 if cfg.activation == "swiglu" else 2)
    total = emb + head + per_layer * cfg.n_layers
    # every parameter is active and none is shared across layers
    return {"total": total, "active": total, "per_layer": per_layer,
            "shared": 0, "emb": emb, "head": head}


def _attn_flops(cfg: ArchConfig, b: int, s_q: int, s_kv: int,
                n_attn_layers: int) -> float:
    if not cfg.uses_attention:
        return 0.0
    h, dh = cfg.n_heads, cfg.head_dim
    return 4.0 * b * s_q * s_kv * h * dh * n_attn_layers


def cell_cost(cfg: ArchConfig, shape: ShapeConfig,
              quant_bits: int | None = None,
              kv_bits: int | None = None) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    p = _param_counts(cfg)
    kind = shape.kind

    if kind == "decode":
        toks = b
        s_q, s_kv = 1, s
    else:
        toks = b * s
        s_q = s_kv = s

    matmul_flops = 2.0 * p["active"] * toks
    attn = _attn_flops(cfg, b, s_q, s_kv, cfg.n_layers)
    # a dense decoder has no recurrent mixer and no expert dispatch: the
    # reference's two terms are 0.0 here and leave the sum as it is
    fwd = matmul_flops + attn
    flops = fwd * (3.0 if kind == "train" else 1.0)  # bwd ~= 2x fwd

    # ---- bytes ----
    wbytes = p["total"] * 2.0  # bf16
    if quant_bits and kind != "train":
        lane = quant_bits  # temporary-spacer packing
        packed_fraction = lane / 16.0  # vs bf16
        # embeddings/head stay bf16
        big = p["total"] - p["emb"] - p["head"]
        wbytes = (p["emb"] + p["head"]) * 2.0 + big * 2.0 * packed_fraction
    if kind == "train":
        # params + grads + 2 opt moments (f32) read+write
        wbytes = p["total"] * (2 + 4 + 4 + 4 + 2)

    cache_bytes = 0.0
    if kind != "train":
        kv_elem_bytes = 1.0 + 4.0 / cfg.head_dim if kv_bits == 8 else 2.0
        per_tok_kv = 2 * cfg.n_kv_heads * cfg.head_dim * kv_elem_bytes
        # decode reads the whole cache once (attention) + writes new slot;
        # prefill writes the full cache once
        cache_bytes = cfg.n_layers * b * s * per_tok_kv

    # activations: ~6 bytes per token per matmul-d_model crossing (coarse)
    act_bytes = toks * cfg.d_model * 2.0 * 6 * max(cfg.n_layers, 1)
    if kind == "train":
        act_bytes *= 2.5  # bwd re-reads (with remat recompute)

    return CellCost(
        flops=flops, weight_bytes=wbytes, cache_bytes=cache_bytes,
        act_bytes=act_bytes,
        details={"params_total": p["total"], "params_active": p["active"],
                 "attn_flops": attn, "matmul_flops": matmul_flops,
                 "recurrent_flops": 0.0, "moe_dispatch_flops": 0.0},
    )
