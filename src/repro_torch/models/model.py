"""Decoder assembly: template -> init -> forward over the paged pool, the
per-slot KV ring or the recurrent state.

One code path serves all four families ('dense', 'moe', 'rwkv6',
'hybrid_mamba2'); each layer's block kind follows from the ArchConfig.

Parameters are plain nested dicts of tensors whose leaves are declared
once as TensorSpecs, so init and SAMD quantization derive from the same
source. The port's layout has ``blocks`` as a list of per-layer dicts
(PyTorch runs eagerly: ``forward`` loops over the layers);
``build_template(cfg, stacked=True)`` gives the reference's
scan-over-layers layout, a dict of leaves with a leading layer axis,
which ``unstack_blocks`` turns into the port's (``convert`` does so).
"""
from __future__ import annotations

import contextvars
import functools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.dtensor import constrain, fsdp_gathered
from repro_torch.distributed.dtensor import replicating, unshard
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import QuantizedTensor
from repro_torch.models.spec import TensorSpec, map_specs
from repro_torch.tree import tree_map


# Optional activation-sharding hint (sequence parallelism): DTensor
# placements (one per mesh dim) for the [B, S, D] residual stream, which
# a DTensor stream is redistributed to between blocks, as the reference
# applies its PartitionSpec with with_sharding_constraint.
_ACT_SHARDING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)


def set_activation_sharding(placements) -> None:
    """Set (or with None clear) the residual stream's placements between
    blocks: a sequence of DTensor placements, or a ``sharding.Layout``."""
    _ACT_SHARDING.set(getattr(placements, "placements", placements))


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


def _mlp_template(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    t = {
        "ln": TensorSpec((d,), (None,), init="ones"),
        "wu": TensorSpec((d, f), ("embed", "ff"), quant_axis=0),
        "wd": TensorSpec((f, d), ("ff", "embed"), quant_axis=0),
    }
    if cfg.activation == "swiglu":
        t["wg"] = TensorSpec((d, f), ("embed", "ff"), quant_axis=0)
    return t


def _moe_template(cfg: ArchConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    t = {
        "ln": TensorSpec((d,), (None,), init="ones"),
        "router": TensorSpec((d, e), ("embed", None), dtype=torch.float32),
        "w_up": TensorSpec((e, d, f), ("experts", "embed", "ff"),
                           quant_axis=1),
        "w_down": TensorSpec((e, f, d), ("experts", "ff", "embed"),
                             quant_axis=1),
    }
    if cfg.activation == "swiglu":
        t["w_gate"] = TensorSpec((e, d, f), ("experts", "embed", "ff"),
                                 quant_axis=1)
    if cfg.dense_residual:
        t["dense"] = _mlp_template(cfg, cfg.expert_d_ff)
    return t


def _mamba2_template(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_inner, n_heads, conv_dim = S.mamba2_dims(cfg)
    n = cfg.ssm_state
    return {
        "ln": TensorSpec((d,), (None,), init="ones"),
        "in_proj": TensorSpec(
            (d, 2 * d_inner + 2 * n + n_heads), ("embed", "ssm_inner"),
            quant_axis=0,
        ),
        "conv_w": TensorSpec((conv_dim, cfg.ssm_conv), ("ssm_inner", None)),
        "dt_bias": TensorSpec((n_heads,), (None,), init="zeros"),
        "a_log": TensorSpec((n_heads,), (None,), init="decay"),
        "d_skip": TensorSpec((n_heads,), (None,), init="ones"),
        "out_norm": TensorSpec((d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": TensorSpec((d_inner, d), ("ssm_inner", "embed"),
                               quant_axis=0),
    }


def _rwkv6_template(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h, hd = S.rwkv6_dims(cfg)
    r = cfg.lora_rank
    tm = {
        "ln": TensorSpec((d,), (None,), init="ones"),
        "w0": TensorSpec((d,), (None,), init="decay"),
        "u_bonus": TensorSpec((h, hd), (None, None), init="zeros"),
        "gn": TensorSpec((hd,), (None,), init="ones"),
        "wr": TensorSpec((d, d), ("embed", "rwkv_att"), quant_axis=0),
        "wk": TensorSpec((d, d), ("embed", "rwkv_att"), quant_axis=0),
        "wv": TensorSpec((d, d), ("embed", "rwkv_att"), quant_axis=0),
        "wg": TensorSpec((d, d), ("embed", "rwkv_att"), quant_axis=0),
        "wo": TensorSpec((d, d), ("rwkv_att", "embed"), quant_axis=0),
        "w_lora_a": TensorSpec((d, r), ("embed", None)),
        "w_lora_b": TensorSpec((r, d), (None, "rwkv_att")),
    }
    for nm in ("r", "k", "v", "w", "g"):
        tm[f"mu_{nm}"] = TensorSpec((d,), (None,), init="zeros")
        tm[f"lora_{nm}_a"] = TensorSpec((d, r // 2), ("embed", None))
        tm[f"lora_{nm}_b"] = TensorSpec((r // 2, d), (None, "rwkv_att"))
    cm = {
        "ln": TensorSpec((d,), (None,), init="ones"),
        "mu_ck": TensorSpec((d,), (None,), init="zeros"),
        "mu_cr": TensorSpec((d,), (None,), init="zeros"),
        "wk_c": TensorSpec((d, cfg.d_ff), ("embed", "ff"), quant_axis=0),
        "wv_c": TensorSpec((cfg.d_ff, d), ("ff", "embed"), quant_axis=0),
        "wr_c": TensorSpec((d, d), ("embed", "rwkv_att"), quant_axis=0),
    }
    return {"tm": tm, "cm": cm}


def _layer_template(cfg: ArchConfig) -> dict:
    if cfg.family == "dense":
        return {"attn": _attn_template(cfg), "mlp": _mlp_template(cfg)}
    if cfg.family == "moe":
        return {"attn": _attn_template(cfg), "moe": _moe_template(cfg)}
    if cfg.family == "rwkv6":
        return _rwkv6_template(cfg)
    if cfg.family == "hybrid_mamba2":
        return {"m": _mamba2_template(cfg)}
    raise ValueError(cfg.family)


def _stack_spec(sp: TensorSpec, n: int) -> TensorSpec:
    return TensorSpec(
        (n,) + sp.shape, (None,) + sp.axes, sp.dtype, sp.init,
        sp.init_scale,
        None if sp.quant_axis is None else sp.quant_axis + 1,
    )


def build_template(cfg: ArchConfig, stacked: bool = False) -> dict:
    """Parameter template: embed, final norm, optional untied LM head and
    one layer dict per layer (``_layer_template``); the hybrid adds the
    attention and MLP blocks its attention layers share. ``stacked=True``
    makes ``blocks`` ONE layer dict whose leaves carry a leading layer
    axis (the reference's layout when ``scan_layers`` is set, its
    default for full-width configs)."""
    d, v = cfg.d_model, cfg.vocab
    t: dict = {
        "embed": TensorSpec((v, d), ("vocab", "embed"), init_scale=0.01),
        "final_ln": TensorSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = TensorSpec((d, v), ("embed", "vocab"), quant_axis=0)
    if stacked:
        t["blocks"] = map_specs(lambda sp: _stack_spec(sp, cfg.n_layers),
                                _layer_template(cfg))
    else:
        t["blocks"] = [_layer_template(cfg) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid_mamba2":
        t["shared_attn"] = _attn_template(cfg)
        t["shared_mlp"] = _mlp_template(cfg)
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
    """Decode-time KV state as a global page pool per layer (attention
    families only: recurrent state is O(1) a slot, nothing to page).

    ``kv_bits=8`` pools hold SAMD-packed words (four int8 lanes along
    head_dim, as int32) plus an f32 scale per (token, kv-head). Which
    slot owns which page is the caller's page table, not part of this
    dict. Each pool has ``num_pages + 1`` pages: page ``num_pages`` is
    the scratch page that takes dropped writes (see
    ``layers._paged_write``); page tables never name it.
    """
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"paged KV cache needs an attention family, got {cfg.family}"
        )
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
    """Decode-time state of every layer, ``{"layers": [...]}``.

    Attention layers get a per-slot KV ring: ``k``/``v`` [batch, length,
    Hkv, dh] in ``dtype`` and ``pos`` [batch, length] int32, -1 where
    nothing was written; ``kv_bits=8`` holds int8 ``k``/``v`` with f32
    ``k_scale``/``v_scale`` [batch, length, Hkv]. (The engine's
    ``kv_mode="ring"`` cache at [max_batch, max_len], and the
    speculative draft's tick-local ring at [B, K].)

    rwkv6 layers hold f32 ``wkv`` [batch, H, hd, hd], ``shift_tm`` and
    ``shift_cm`` [batch, d_model]; hybrid_mamba2 layers ``conv`` [batch,
    conv_dim, ssm_conv - 1] in ``dtype`` and f32 ``ssd`` [batch, H,
    ssm_head_dim, ssm_state], plus an ``attn_kv`` ring on the layers
    after which the shared attention runs (``(i + 1) % attn_every ==
    0``)."""
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

    def f32(*dims):
        return torch.zeros(dims, dtype=torch.float32, device=device)

    if cfg.family in ("dense", "moe"):
        return {"layers": [ring() for _ in range(cfg.n_layers)]}
    if cfg.family == "rwkv6":
        h, hd = S.rwkv6_dims(cfg)
        return {"layers": [
            {"wkv": f32(batch, h, hd, hd),
             "shift_tm": f32(batch, cfg.d_model),
             "shift_cm": f32(batch, cfg.d_model)}
            for _ in range(cfg.n_layers)]}
    if cfg.family == "hybrid_mamba2":
        _, n_heads, conv_dim = S.mamba2_dims(cfg)
        layers = []
        for i in range(cfg.n_layers):
            st = {"conv": torch.zeros((batch, conv_dim, cfg.ssm_conv - 1),
                                      dtype=dtype, device=device),
                  "ssd": f32(batch, n_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)}
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                st["attn_kv"] = ring()
            layers.append(st)
        return {"layers": layers}
    raise ValueError(cfg.family)


def copy_paged_page(cache: dict, src: int, dst: int) -> None:
    """Copy pool page ``src`` into page ``dst`` in every layer's pools, in
    place: the copy-on-write fork of prefix sharing."""
    for layer in cache["layers"]:
        for pool in layer.values():
            pool[dst].copy_(pool[src])


def _store(state: Optional[dict], new: dict) -> None:
    """Write a recurrent block's new state into its cache IN PLACE (the
    engine holds views of the cache's rows)."""
    if state is not None:
        for name, t in new.items():
            state[name].copy_(t)


class _EmbedGather(torch.autograd.Function):
    """``table[tokens]`` whose backward sums each row's gradient in f32
    (``embedding_dense_backward`` of the f32 cotangent: on CUDA a sorted,
    deterministic reduction, not bf16 atomics in no fixed order), then
    rounds it to the table's dtype once, as the reference's gather-then-
    cast does."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        gw = torch.ops.aten.embedding_dense_backward(
            g.to(torch.float32), tokens, ctx.rows, -1, False)
        return gw.to(ctx.dtype), None


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    # A DTensor table (vocab on 'model', embed on the data axes) is
    # gathered whole, the ids stay sharded over the batch. The embed dims'
    # gather is FSDP's; the vocab's is the port's choice where the
    # reference keeps the vocab sharded (DTensor's embedding rule takes a
    # vocab-sharded table only with replicated ids)
    table = unshard(table)
    if table.requires_grad and torch.is_grad_enabled():
        return _EmbedGather.apply(table, tokens)
    # an embedding, not an index: DTensor (2.11) has no rule for indexing
    # with ids split over two mesh dims, as the multi-pod batch is
    return F.embedding(tokens, table)


def _gathered(p: dict) -> dict:
    """A layer's parameters with their FSDP shards gathered (DTensors
    split over the data axes in train mode), as FSDP gathers a layer's
    weights before it runs; packed weights and plain tensors as they
    are."""
    return tree_map(fsdp_gathered, p)


def _remat(fn, remat: bool):
    """``fn`` recomputed in the backward pass instead of keeping its
    activations (the reference's ``jax.checkpoint``) when ``remat``."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _scoped(fn):
    """``fn(params, tokens, ...)`` inside ``replicating`` when its tokens
    or embedding table are DTensors."""

    @functools.wraps(fn)
    def run(params, tokens, *args, **kwargs):
        with replicating(tokens, params["embed"]):
            return fn(params, tokens, *args, **kwargs)

    return run


@_scoped
def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[dict] = None,
            page_table: Optional[torch.Tensor] = None,
            page_size: int = 0, paged_attn: str = "gather",
            cache_index=0, pool_cache: Optional[dict] = None,
            pool_bound: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            return_aux: bool = False, remat: bool = False):
    """Returns logits [B, S(+P), vocab] bf16; with ``return_aux`` also the
    MoE load-balance loss summed over the layers (f32 scalar, 0 for the
    other families), the reference's third output.

    ``params["blocks"]`` is a list of per-layer dicts (``unstack_blocks``
    turns the stacked layout into one). ``prefix_embeds`` [B, P, D] are
    put before the tokens' embeddings (the frontend stub of the audio and
    vision archs); positions then count them.

    With ``cache`` (``init_cache``) and no ``page_table``, each attention
    layer's K/V ring is written IN PLACE at ``cache_index`` (an int, or a
    [B] tensor of per-row offsets) and attention reads the whole ring;
    recurrent layers read their state and write the new one IN PLACE
    (the hybrid's shared attention uses its layer's ``attn_kv`` ring).

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

    ``remat`` (training: no cache) recomputes each block in the backward
    pass (``torch.utils.checkpoint``): the dense and MoE layers, the
    RWKV6 layer, the Mamba2 mixer and the hybrid's shared attention +
    MLP, as the reference's ``jax.checkpoint`` wraps them. The recompute
    runs the same operations on the same inputs, so the MoE router
    picks the same experts.

    DTensor parameters and tokens (``distributed.sharding``) run the
    forward sharded: each layer gathers its FSDP shards first, and the
    residual stream is put back on one placement after every residual
    add, ``set_activation_sharding``'s, else the embedding's.
    """
    if remat and (cache is not None or pool_cache is not None):
        raise ValueError("remat is for training: it takes no cache")
    b, s = tokens.shape
    x = _embed(params["embed"], tokens).to(torch.bfloat16)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # a DTensor residual stream is put back on one placement after every
    # residual add: the hint's, else the embedding's (left to DTensor,
    # a norm of a partial sum may come out split over the sequence, and
    # the split drifts from block to block)
    stream = _ACT_SHARDING.get() or getattr(x, "placements", None)

    def settle(x):
        return constrain(x, stream)

    def attn_layer(p, x, layer_cache, pool_layer):
        p = _gathered(p)
        x = settle(x + L.attention_block(
            p["attn"], x, positions, cfg, kv_cache=layer_cache,
            page_table=page_table, page_size=page_size,
            paged_attn=paged_attn, cache_index=cache_index,
            pool_kv=pool_layer, pool_bound=pool_bound,
        ))
        if cfg.family == "dense":
            return settle(x + L.mlp_block(p["mlp"], x, cfg)), None
        mo, aux = L.moe_block(p["moe"], x, cfg,
                              group_tokens=cfg.moe_group_tokens)
        return settle(x + mo), aux

    def rwkv_layer(p, x, layer_cache):
        p = _gathered(p)
        delta, st_tm = S.rwkv6_time_mix(p["tm"], x, cfg, layer_cache)
        x = settle(x + delta)
        delta, st_cm = S.rwkv6_channel_mix(p["cm"], x, cfg, layer_cache)
        return settle(x + delta), {**st_tm, **st_cm}

    def mamba_layer(p, x, layer_cache):
        p = _gathered(p)
        delta, st = S.mamba2_block(p["m"], x, cfg, layer_cache)
        return settle(x + delta), st

    def shared_layer(p_attn, p_mlp, x, kv_c):
        p_attn, p_mlp = _gathered(p_attn), _gathered(p_mlp)
        x = settle(x + L.attention_block(p_attn, x, positions, cfg,
                                         kv_cache=kv_c,
                                         cache_index=cache_index))
        return settle(x + L.mlp_block(p_mlp, x, cfg))

    attn_fn, rwkv_fn, mamba_fn, shared_fn = (
        _remat(fn, remat)
        for fn in (attn_layer, rwkv_layer, mamba_layer, shared_layer))
    for i, p in enumerate(params["blocks"]):
        layer_cache = cache["layers"][i] if cache is not None else None
        if cfg.family in ("dense", "moe"):
            pool_layer = (pool_cache["layers"][i] if pool_cache is not None
                          else None)
            x, aux = attn_fn(p, x, layer_cache, pool_layer)
            if cfg.family == "moe":
                aux_total = aux_total + aux
        elif cfg.family == "rwkv6":
            x, st = rwkv_fn(p, x, layer_cache)
            _store(layer_cache, st)
        elif cfg.family == "hybrid_mamba2":
            x, st = mamba_fn(p, x, layer_cache)
            _store(layer_cache, st)
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                kv_c = (layer_cache["attn_kv"] if layer_cache is not None
                        else None)
                x = shared_fn(params["shared_attn"], params["shared_mlp"],
                              x, kv_c)
        else:
            raise ValueError(cfg.family)
        x = settle(x)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        # the table's FSDP shards gathered before the transpose: PyTorch
        # 2.11 mis-sizes the multi-pod strided split gathered after one
        table = fsdp_gathered(params["embed"])
        logits = L.apply_linear(table.to(x.dtype).t(), x)
    else:
        logits = L.apply_linear(params["lm_head"], x)
    return (logits, aux_total) if return_aux else logits
