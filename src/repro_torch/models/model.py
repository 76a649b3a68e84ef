"""Dense decoder assembly: template -> init -> forward over the paged pool.

Parameters are plain nested dicts of tensors whose leaves are declared
once as TensorSpecs, so init and SAMD quantization derive from the same
source (the reference's layout, with ``blocks`` a list of per-layer
dicts: PyTorch runs eagerly, so there is no scan-over-layers variant).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec


def _attn_template(cfg: ArchConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "ln": TensorSpec((d,), (None,), init="ones"),
        "wq": TensorSpec((d, h * dh), ("embed", "heads"), quant_axis=0),
        "wk": TensorSpec((d, hkv * dh), ("embed", "kv_heads"), quant_axis=0),
        "wv": TensorSpec((d, hkv * dh), ("embed", "kv_heads"), quant_axis=0),
        "wo": TensorSpec((h * dh, d), ("heads", "embed"), quant_axis=0),
    }
    if cfg.qkv_bias:
        t["bq"] = TensorSpec((h * dh,), ("heads",), init="zeros")
        t["bk"] = TensorSpec((hkv * dh,), ("kv_heads",), init="zeros")
        t["bv"] = TensorSpec((hkv * dh,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = TensorSpec((dh,), (None,), init="ones")
        t["k_norm"] = TensorSpec((dh,), (None,), init="ones")
    return t


def _mlp_template(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    t = {
        "ln": TensorSpec((d,), (None,), init="ones"),
        "wu": TensorSpec((d, f), ("embed", "ff"), quant_axis=0),
        "wd": TensorSpec((f, d), ("ff", "embed"), quant_axis=0),
    }
    if cfg.activation == "swiglu":
        t["wg"] = TensorSpec((d, f), ("embed", "ff"), quant_axis=0)
    return t


def build_template(cfg: ArchConfig) -> dict:
    """Parameter template: embed, final norm, optional untied LM head and
    one {'attn', 'mlp'} dict per layer."""
    d, v = cfg.d_model, cfg.vocab
    t: dict = {
        "embed": TensorSpec((v, d), ("vocab", "embed"), init_scale=0.01),
        "final_ln": TensorSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = TensorSpec((d, v), ("embed", "vocab"), quant_axis=0)
    t["blocks"] = [
        {"attn": _attn_template(cfg), "mlp": _mlp_template(cfg)}
        for _ in range(cfg.n_layers)
    ]
    return t


def init_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, kv_bits: Optional[int] = None,
                     device="cuda") -> dict:
    """Decode-time KV state as a global page pool per layer.

    ``kv_bits=8`` pools hold SAMD-packed words (four int8 lanes along
    head_dim, as int32) plus an f32 scale per (token, kv-head). Which
    slot owns which page is the caller's page table, not part of this
    dict. Each pool has ``num_pages + 1`` pages: page ``num_pages`` is
    the scratch page that takes dropped writes (see
    ``layers._paged_write``); page tables never name it.
    """
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)

    def kv_pool():
        if kv_bits == 8:
            if cfg.head_dim % 4:
                raise ValueError(f"head_dim {cfg.head_dim} must be % 4")
            packed = shape[:3] + (cfg.head_dim // 4,)
            return {
                "k": torch.zeros(packed, dtype=torch.int32, device=device),
                "v": torch.zeros(packed, dtype=torch.int32, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
            }
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"layers": [kv_pool() for _ in range(cfg.n_layers)]}


def init_cache(cfg: ArchConfig, batch: int, length: int,
               device="cuda") -> dict:
    """The speculative draft's tick-local KV ring: per layer bf16 ``k``/
    ``v`` [batch, length, Hkv, dh] and ``pos`` [batch, length] int32, -1
    where nothing was written (the reference's ``init_cache`` in the
    layout the draft uses; no other caller needs a ring)."""
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)

    def ring():
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "pos": torch.full(shape[:2], -1, dtype=torch.int32,
                                  device=device)}

    return {"layers": [ring() for _ in range(cfg.n_layers)]}


def copy_paged_page(cache: dict, src: int, dst: int) -> None:
    """Copy pool page ``src`` into page ``dst`` in every layer's pools, in
    place: the copy-on-write fork of prefix sharing."""
    for layer in cache["layers"]:
        for pool in layer.values():
            pool[dst].copy_(pool[src])


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None,
            page_table: Optional[torch.Tensor] = None,
            page_size: int = 0, paged_attn: str = "gather",
            cache_index: int = 0, pool_cache: Optional[dict] = None,
            pool_bound: Optional[torch.Tensor] = None):
    """Returns logits [B, S, vocab] bf16.

    With ``cache`` (``init_paged_cache``) and ``page_table`` [B, n_pp],
    every token's K/V is written into the pools IN PLACE at its logical
    position (-1 = padding, not written) and attention reads the pools;
    ``paged_attn="fused"`` routes single-token decode attention through
    the paged decode kernel and a multi-token block (the speculative
    verify) through the paged verify kernel, ``"gather"`` keeps the
    dense page gather.

    ``pool_cache`` switches to the speculative DRAFT layout: ``cache`` is
    then the draft's ring (``init_cache``), written IN PLACE at column
    ``cache_index``, while the paged pools in ``pool_cache`` are read
    only, at positions <= ``pool_bound`` [B].
    """
    b, s = tokens.shape
    x = params["embed"][tokens].to(torch.bfloat16)
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    for i, p in enumerate(params["blocks"]):
        layer_cache = cache["layers"][i] if cache is not None else None
        pool_layer = (pool_cache["layers"][i] if pool_cache is not None
                      else None)
        x = x + L.attention_block(
            p["attn"], x, positions, cfg, kv_cache=layer_cache,
            page_table=page_table, page_size=page_size,
            paged_attn=paged_attn, cache_index=cache_index,
            pool_kv=pool_layer, pool_bound=pool_bound,
        )
        x = x + L.mlp_block(p["mlp"], x, cfg)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    else:
        logits = L.apply_linear(params["lm_head"], x)
    return logits
