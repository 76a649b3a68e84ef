"""Analytic per-cell FLOP / HBM-byte calculator (the port's copy of
``repro/launch/analytic_costs.py``, all four families).

The serving front door prices admission with it
(``serving/server.price_request``), and its refusals compare these
floats, so every expression is the reference's, in the same order: each
field comes out equal to the reference's, not merely close.

Conventions:
  * one matmul of [m,k]x[k,n] = 2mkn flops; bwd = 2x fwd (dx and dW).
  * attention: the full [s_q, s_kv] rectangle, 4·B·s_q·s_kv·H·dh flops
    fwd (QK^T + AV); the causal mask skips no work in the count.
  * recurrent mixers: the chunked scans' flops as implemented.
  * bytes: weights read once per step (packed size when SAMD-quantized),
    KV cache/state read+written, activations ~2 reads+1 write per matmul
    operand at bf16 (coarse; dominated by weights/cache in the cells that
    matter).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.ssm import mamba2_dims, rwkv6_dims


@dataclasses.dataclass
class CellCost:
    flops: float          # global, one step
    weight_bytes: float   # global params read per step (packed if quant)
    cache_bytes: float    # KV/state read+write per step
    act_bytes: float      # activation traffic estimate
    details: dict

    @property
    def hbm_bytes(self) -> float:
        return self.weight_bytes + self.cache_bytes + self.act_bytes


def _param_counts(cfg: ArchConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    emb = v * d
    head = 0 if cfg.tie_embeddings else d * v
    per_layer = 0
    shared = 0
    if cfg.family in ("dense", "moe"):
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        per_layer += attn
        if cfg.family == "dense":
            f = cfg.d_ff
            mlp = d * f * (3 if cfg.activation == "swiglu" else 2)
            per_layer += mlp
        else:
            e, f = cfg.n_experts, cfg.expert_d_ff
            n_mats = 3 if cfg.activation == "swiglu" else 2
            per_layer += e * d * f * n_mats + d * e
            if cfg.dense_residual:
                per_layer += d * cfg.expert_d_ff * n_mats
    elif cfg.family == "rwkv6":
        f = cfg.d_ff
        per_layer += 5 * d * d + d * f * 2 + d * d  # r,k,v,g,o + ffn + wr_c
        per_layer += 7 * d * cfg.lora_rank          # loras (approx)
    elif cfg.family == "hybrid_mamba2":
        d_inner, n_heads, conv_dim = mamba2_dims(cfg)
        n = cfg.ssm_state
        per_layer += d * (2 * d_inner + 2 * n + n_heads) + d_inner * d
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        shared += d * h * dh + 2 * d * kv * dh + h * dh * d
        shared += d * cfg.d_ff * (3 if cfg.activation == "swiglu" else 2)
    total = emb + head + per_layer * cfg.n_layers + shared
    active = total
    if cfg.family == "moe":
        e, f = cfg.n_experts, cfg.expert_d_ff
        n_mats = 3 if cfg.activation == "swiglu" else 2
        expert_p = cfg.n_layers * e * d * f * n_mats
        active = total - expert_p + expert_p * cfg.top_k / e
    return {"total": total, "active": active, "per_layer": per_layer,
            "shared": shared, "emb": emb, "head": head}


def _attn_flops(cfg: ArchConfig, b: int, s_q: int, s_kv: int,
                n_attn_layers: int) -> float:
    if not cfg.uses_attention:
        return 0.0
    h, dh = cfg.n_heads, cfg.head_dim
    return 4.0 * b * s_q * s_kv * h * dh * n_attn_layers


def _recurrent_flops(cfg: ArchConfig, b: int, t: int) -> float:
    """Chunked-scan mixer flops (per the implemented algorithm)."""
    if cfg.family == "rwkv6":
        h, hd = rwkv6_dims(cfg)
        c = min(32, t)
        # intra: [t, c, hd] dec+rk tensors ~ 4 flops/elem; inter + state:
        per_tok = (c * hd * 4 + 2 * hd * hd + 2 * hd * hd) * h
        return float(b * t * per_tok * cfg.n_layers)
    if cfg.family == "hybrid_mamba2":
        d_inner, n_heads, conv_dim = mamba2_dims(cfg)
        hd, n = cfg.ssm_head_dim, cfg.ssm_state
        c = min(128, t)
        per_tok = (2 * c * n + c * hd * 2 + 4 * hd * n) * n_heads
        per_tok += conv_dim * cfg.ssm_conv * 2
        return float(b * t * per_tok * cfg.n_layers)
    return 0.0


def _moe_dispatch_flops(cfg: ArchConfig, tokens: int) -> float:
    if cfg.family != "moe":
        return 0.0
    gt = min(cfg.moe_group_tokens, tokens)
    cap = max(int(gt * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    d = cfg.d_model
    # dispatch + combine einsums: 2 * T * E * C * D each
    return 2.0 * 2.0 * tokens * cfg.n_experts * cap * d * cfg.n_layers


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

    n_attn_layers = 0
    if cfg.family in ("dense", "moe"):
        n_attn_layers = cfg.n_layers
    elif cfg.family == "hybrid_mamba2" and cfg.attn_every:
        n_attn_layers = cfg.n_layers // cfg.attn_every

    matmul_flops = 2.0 * p["active"] * toks
    attn = _attn_flops(cfg, b, s_q, s_kv, n_attn_layers)
    rec = _recurrent_flops(cfg, b, 1 if kind == "decode" else s)
    moe_disp = _moe_dispatch_flops(cfg, toks)
    fwd = matmul_flops + attn + rec + moe_disp
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
        if cfg.family in ("dense", "moe"):
            per_tok_kv = 2 * cfg.n_kv_heads * cfg.head_dim * kv_elem_bytes
            full = cfg.n_layers * b * s * per_tok_kv
        elif cfg.family == "rwkv6":
            h, hd = rwkv6_dims(cfg)
            full = cfg.n_layers * b * (
                h * hd * hd * 4.0 + 2 * cfg.d_model * 4.0
            )
        else:
            d_inner, n_heads, conv_dim = mamba2_dims(cfg)
            full = cfg.n_layers * b * (
                n_heads * cfg.ssm_head_dim * cfg.ssm_state * 4.0
                + conv_dim * (cfg.ssm_conv - 1) * 2.0
            )
            if cfg.attn_every:
                full += (
                    (cfg.n_layers // cfg.attn_every) * b * s * 2
                    * cfg.n_kv_heads * cfg.head_dim * kv_elem_bytes
                )
        if kind == "decode":
            cache_bytes = full * (2.0 if cfg.family in ("rwkv6",) else 1.0)
            # decode reads the whole cache once (attention) + writes new slot
        else:  # prefill writes the full cache once
            cache_bytes = full

    # activations: ~6 bytes per token per matmul-d_model crossing (coarse)
    act_bytes = toks * cfg.d_model * 2.0 * 6 * max(cfg.n_layers, 1)
    if kind == "train":
        act_bytes *= 2.5  # bwd re-reads (with remat recompute)

    return CellCost(
        flops=flops, weight_bytes=wbytes, cache_bytes=cache_bytes,
        act_bytes=act_bytes,
        details={"params_total": p["total"], "params_active": p["active"],
                 "attn_flops": attn, "matmul_flops": matmul_flops,
                 "recurrent_flops": rec, "moe_dispatch_flops": moe_disp},
    )
