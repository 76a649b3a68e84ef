"""Dense decoder assembly: template -> init -> forward over the paged pool
or the per-slot KV ring.

Parameters are plain nested dicts of tensors whose leaves are declared
once as TensorSpecs, so init and SAMD quantization derive from the same
source. The port's layout has ``blocks`` as a list of per-layer dicts
(PyTorch runs eagerly: ``forward`` loops over the layers);
``build_template(cfg, stacked=True)`` gives the reference's
scan-over-layers layout, a dict of leaves with a leading layer axis,
which ``unstack_blocks`` turns into the port's (``convert`` does so).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import QuantizedTensor
from repro_torch.models.spec import TensorSpec, map_specs


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


def _stack_spec(sp: TensorSpec, n: int) -> TensorSpec:
    return TensorSpec(
        (n,) + sp.shape, (None,) + sp.axes, sp.dtype, sp.init,
        sp.init_scale,
        None if sp.quant_axis is None else sp.quant_axis + 1,
    )


def build_template(cfg: ArchConfig, stacked: bool = False) -> dict:
    """Parameter template: embed, final norm, optional untied LM head and
    one {'attn', 'mlp'} dict per layer; ``stacked=True`` makes ``blocks``
    ONE such dict whose leaves carry a leading layer axis (the
    reference's layout when ``scan_layers`` is set, its default for
    full-width configs)."""
    d, v = cfg.d_model, cfg.vocab
    t: dict = {
        "embed": TensorSpec((v, d), ("vocab", "embed"), init_scale=0.01),
        "final_ln": TensorSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = TensorSpec((d, v), ("embed", "vocab"), quant_axis=0)
    if stacked:
        layer = {"attn": _attn_template(cfg), "mlp": _mlp_template(cfg)}
        t["blocks"] = map_specs(lambda sp: _stack_spec(sp, cfg.n_layers),
                                layer)
    else:
        t["blocks"] = [
            {"attn": _attn_template(cfg), "mlp": _mlp_template(cfg)}
            for _ in range(cfg.n_layers)
        ]
    return t


def unstack_blocks(stacked: dict, n_layers: int) -> list:
    """Stacked ``blocks`` -> one dict per layer, slicing axis 0 of every
    leaf (views), as the reference's scan over layers does. A packed
    leaf is sliced the same way, in its words and scale. Raises
    ValueError, as the scan does, unless every leaf's leading size is
    ``n_layers``; a packed leaf quantized from a stacked weight fails it
    (its layers lie side by side in its columns, ``packed[:, l*N:
    (l+1)*N]``), so neither package serves one."""
    sizes = []

    def leading(node):
        if isinstance(node, QuantizedTensor):
            sizes.extend([node.packed.shape[0], node.scale.shape[0]])
        elif isinstance(node, dict):
            for v in node.values():
                leading(v)
        else:
            sizes.append(node.shape[0])

    leading(stacked)
    if any(s != n_layers for s in sizes):
        raise ValueError(
            "stacked blocks need every leaf's leading axis to be the "
            f"{n_layers} layers; got leading sizes {sizes}")

    def take(node, i):
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(node.packed[i], node.scale[i],
                                   node.orig_shape, node.axis, node.cfg)
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    return [take(stacked, i) for i in range(n_layers)]


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
               dtype=torch.bfloat16, kv_bits: Optional[int] = None,
               device="cuda") -> dict:
    """Per-slot KV ring for every layer: ``k``/``v`` [batch, length, Hkv,
    dh] in ``dtype`` and ``pos`` [batch, length] int32, -1 where nothing
    was written; ``kv_bits=8`` holds int8 ``k``/``v`` with f32
    ``k_scale``/``v_scale`` [batch, length, Hkv]. The engine's
    ``kv_mode="ring"`` cache at [max_batch, max_len], and the speculative
    draft's tick-local ring at [B, K]."""
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)

    def ring():
        pos = torch.full(shape[:2], -1, dtype=torch.int32, device=device)
        if kv_bits == 8:
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "pos": pos,
            }
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": pos}

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

    ``params["blocks"]`` is a list of per-layer dicts (``unstack_blocks``
    turns the stacked layout into one).

    With ``cache`` (``init_cache``) and no ``page_table``, each layer's
    K/V ring is written IN PLACE at ``cache_index`` (an int, or a [B]
    tensor of per-row offsets) and attention reads the whole ring.

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
