"""Transformer building blocks (the port of ``repro/models/layers.py``):
quantized linears, RMSNorm, RoPE, GQA attention over the paged KV pool or
a per-slot KV ring, MLPs (swiglu, squared ReLU, gelu) and the
capacity-based MoE.

Norms, softmax and attention probabilities run in f32; matmul outputs
stay bf16, as in the reference.

The paged KV pool and the ring are written IN PLACE (the reference
returns new ones and donates the old).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.distributed.dtensor import (
    fsdp_gathered, grad_placed, is_dtensor, linear_input, merge_heads,
    on_local_blocks, on_local_columns, on_local_words, whole_heads,
    write_columns,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.quant.config import QuantConfig
from repro_torch.quant.packing import (
    dequant_weights, pack_int8_lanes, qmatmul, unpack_int8_lanes,
)

MASK_VALUE = -1e30


# ---------------------------------------------------------------------------
# linear (+ quantized linear) application
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedTensor:
    """SAMD-packed weight: int32 words (uint32 bits) + per-channel scale.

    Packed along its reduction axis and stored 2D as
    [ceil(K/values_per_word), prod(rest)]; ``orig_shape``/``axis`` give
    the full layout.
    """

    packed: torch.Tensor
    scale: torch.Tensor
    orig_shape: tuple
    axis: int
    cfg: QuantConfig

    @property
    def k(self) -> int:
        return self.orig_shape[self.axis]


def materialize(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense view of a (possibly SAMD-packed) weight in its original
    shape."""
    if not isinstance(w, QuantizedTensor):
        return w
    with tracing.span("model.dequantize", device=True):
        return _dequantize(w, dtype)


def _dequantize(w, dtype) -> torch.Tensor:
    k = w.k
    rest = tuple(s for i, s in enumerate(w.orig_shape) if i != w.axis)
    if is_dtensor(w.packed):  # each rank's own columns, the words whole
        dense2d = on_local_columns(
            functools.partial(dequant_weights, k=k, cfg=w.cfg, dtype=dtype),
            w.packed, w.scale, k)
        # whole experts (or leading rest dim) before the columns unflatten
        dense2d = whole_heads(dense2d, rest[0]) if len(rest) > 1 else dense2d
    else:
        dense2d = dequant_weights(w.packed, w.scale, k, w.cfg, dtype=dtype)
    return dense2d.reshape((k,) + rest).movedim(0, w.axis)


def apply_linear(w, x: torch.Tensor) -> torch.Tensor:
    """x[..., K] @ w[K, N] where w is a tensor or a QuantizedTensor: a 2D
    weight packed along axis 0 goes through ``qmatmul`` (on each rank's
    own words where they are a DTensor: ``dtensor.on_local_words``), any
    other packed layout is materialized, then multiplied."""
    if isinstance(w, QuantizedTensor):
        if len(w.orig_shape) == 2 and w.axis == 0:
            if is_dtensor(w.packed):
                return on_local_words(
                    functools.partial(qmatmul, cfg=w.cfg), linear_input(x),
                    w.packed, w.scale, w.k, w.cfg.values_per_word,
                    w.cfg.group_size is not None)
            return qmatmul(x, w.packed, w.scale, w.k, w.cfg)
        return torch.matmul(x, materialize(w, x.dtype))
    # the gradient comes back on the output's placements, so its
    # flatten in the weight's gradient never meets a sequence split
    return grad_placed(torch.matmul(linear_input(x), fsdp_gathered(w)))


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32)).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., S] -> (sin, cos) [..., S, head_dim//2] f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / theta ** exps  # a Python base: no host->device copy
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x [..., S, H, D]; sin/cos [..., S, D//2]."""
    half = x.shape[-1] // 2
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    s = sin[..., None, :]  # broadcast over heads
    c = cos[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attend_chunk(q, k, v, q_pos, k_pos, scale):
    """q [B,Cq,Hkv,G,dh]; k/v [B,S,Hkv,dh] -> [B,Cq,Hkv,G,dh].

    Masks keys with k_pos > q_pos (causal) or k_pos < 0 (unfilled). The
    probabilities stay f32 through the PV product and only the output is
    rounded, matching the f32 accumulation of the paged decode kernel.
    """
    scores = torch.einsum("bqhgd,bshd->bhgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask = (k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]) & (
        k_pos[:, None, None, None, :] >= 0
    )
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs, v.to(torch.float32))
    return out.to(v.dtype)


def attention(q, k, v, q_pos, k_pos, chunk: int = 1024):
    """Causal GQA attention, query-chunked to bound live memory.

    q [B, Sq, H, dh]; k/v [B, Sk, Hkv, dh]; q_pos [B, Sq]; k_pos [B, Sk]
    (negative = masked). DTensors attend on each rank's own batch rows
    and heads (``dtensor.on_local_blocks``).
    """
    if is_dtensor(q):
        return on_local_blocks(
            lambda *a: (attention(*a, chunk=chunk),), (q, k, v, q_pos, k_pos),
            ((0, 2),) * 3 + ((0, None),) * 2, ((0, 2),))[0]
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    scale = 1.0 / (dh ** 0.5)
    outs = [
        _attend_chunk(qg[:, c:c + chunk], k, v, q_pos[:, c:c + chunk],
                      k_pos, scale)
        for c in range(0, sq, chunk)
    ]
    return torch.cat(outs, dim=1).reshape(b, sq, h, dh)


# ---------------------------------------------------------------------------
# paged KV cache (block tables over a global page pool)
# ---------------------------------------------------------------------------
#
# Each attention layer owns pools [P, page_size, ...] shared by all slots.
# A host-managed page table [B, n_pp] maps a slot's logical block to a pool
# page; -1 marks an unallocated block. Token t of slot b lives at page
# page_table[b, t // page_size], offset t % page_size. Validity is derived
# from the page table plus causality, as in the reference.
#
# The LAST page of every pool is scratch: no page table names it, and
# writes the reference drops (padding, unallocated pages) land there. A
# boolean filter would drop them too, but it makes the host wait for the
# device on every write (the result's size depends on device data); the
# scratch page keeps the scatter's shape fixed and the stream unblocked.

def _paged_flat_index(page_table, positions, page_size: int, oob: int):
    """Flat pool index [B, S] of each (row, position); a negative
    position, a block beyond the table or an unallocated page maps to
    ``oob`` instead (PyTorch would raise on an out-of-range index, or
    wrap a -1, where the reference drops the write)."""
    n_pp = page_table.shape[1]
    pos = positions.to(torch.int64)
    block = torch.div(pos, page_size, rounding_mode="floor")
    page = torch.gather(page_table.to(torch.int64), 1,
                        block.clamp(0, n_pp - 1))
    ok = (pos >= 0) & (block < n_pp) & (page >= 0)
    return torch.where(ok, page * page_size + pos % page_size, oob)


def _paged_write(pool, val, page_table, positions, page_size: int) -> None:
    """Scatter ``val`` [B, S, ...] into ``pool`` [P + 1, page_size, ...]
    in place at the slots named by (page_table, positions); writes to
    invalid positions land in the scratch page P."""
    p = pool.shape[0]
    flat = pool.view((p * page_size,) + tuple(pool.shape[2:]))
    idx = _paged_flat_index(page_table, positions, page_size,
                            (p - 1) * page_size)
    flat[idx.reshape(-1)] = val.reshape(
        (-1,) + tuple(val.shape[2:])).to(pool.dtype)


def _paged_gather(pool, page_table, page_size: int):
    """Each row's pages as a contiguous [B, n_pp * page_size, ...] view in
    logical order. Unallocated blocks read page 0; their keys are masked
    by ``_paged_key_positions``."""
    b, n_pp = page_table.shape
    safe = page_table.to(torch.int64).clamp(0, pool.shape[0] - 1)
    pages = pool[safe.reshape(-1)]
    return pages.reshape((b, n_pp * page_size) + tuple(pool.shape[2:]))


def _paged_key_positions(page_table, page_size: int):
    """k_pos [B, n_pp * page_size] for the gathered view: the logical
    position for allocated blocks, -1 (masked) for unallocated ones."""
    b, n_pp = page_table.shape
    iota = torch.arange(n_pp * page_size, dtype=torch.int64,
                        device=page_table.device)[None, :]
    valid = torch.repeat_interleave(page_table >= 0, page_size, dim=1)
    return torch.where(valid, iota, -1)


def _gathered_pool_kv(pool: dict, page_table, page_size: int, dtype):
    """Dense per-row gather of a KV pool into [B, n_pp * page_size, Hkv,
    dh] K/V; packed pools are lane-unpacked and rescaled after the
    gather."""
    if pool["k"].dtype == torch.int32:
        out = []
        for name in ("k", "v"):
            g = _paged_gather(pool[name], page_table, page_size)
            s = _paged_gather(pool[name + "_scale"], page_table, page_size)
            out.append((unpack_int8_lanes(g).to(torch.float32)
                        * s[..., None]).to(dtype))
        return tuple(out)
    return (_paged_gather(pool["k"], page_table, page_size).to(dtype),
            _paged_gather(pool["v"], page_table, page_size).to(dtype))


def _cache_write(buf, val, cache_index) -> None:
    """Write ``val`` [B, S, ...] into the ring ``buf`` [B, T, ...] in
    place at time offset ``cache_index``: an int (lockstep batch: columns
    ``cache_index..cache_index + S - 1``, the reference's
    ``dynamic_update_slice``) or a [B] tensor (ragged batch: row i writes
    at its own offset). Per-row offsets must be in range (the engine
    clamps them), as in the reference. A DTensor ring takes an int
    offset and is written on each rank's own columns
    (``dtensor.write_columns``)."""
    val = val.to(buf.dtype)
    if is_dtensor(buf):
        write_columns(buf, val, int(cache_index))
        return
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        b, s = val.shape[:2]
        rows = torch.arange(b, device=buf.device)[:, None]
        cols = (cache_index.to(torch.int64)[:, None]
                + torch.arange(s, device=buf.device)[None, :])
        buf[rows, cols] = val
        return
    buf[:, cache_index:cache_index + val.shape[1]] = val


def _quant_kv(t: torch.Tensor):
    """int8 KV write: per-(token, kv-head) symmetric scale."""
    tf = t.to(torch.float32)
    amax = tf.abs().amax(dim=-1)
    scale = amax.clamp(min=1e-6) / 127.0
    qv = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return qv.to(torch.int8), scale


def _ring_attention(ring: dict, q, k, v, positions, cache_index,
                    chunk: int):
    """Write this block's K/V and positions into the per-slot ring at
    ``cache_index`` (int8 lanes and per-(token, kv-head) scales when the
    ring is int8), then attend over the whole ring, masked by its
    ``pos`` (-1 = unwritten) and causality."""
    if ring["k"].dtype == torch.int8:
        for name, t in (("k", k), ("v", v)):
            tq, ts = _quant_kv(t)
            _cache_write(ring[name], tq, cache_index)
            _cache_write(ring[name + "_scale"], ts, cache_index)
        _cache_write(ring["pos"], positions, cache_index)
        k_full, v_full = (
            (ring[n].to(torch.float32) * ring[n + "_scale"][..., None]
             ).to(q.dtype) for n in ("k", "v"))
    else:
        _cache_write(ring["k"], k, cache_index)
        _cache_write(ring["v"], v, cache_index)
        _cache_write(ring["pos"], positions, cache_index)
        k_full, v_full = ring["k"].to(q.dtype), ring["v"].to(q.dtype)
    return attention(q, k_full, v_full, positions, ring["pos"], chunk=chunk)


def attention_block(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg,
                    *, kv_cache=None, page_table=None, page_size: int = 0,
                    paged_attn: str = "gather", cache_index: int = 0,
                    pool_kv=None, pool_bound=None):
    """norm -> qkv -> rope -> attend -> out; returns the residual delta.

    With ``kv_cache`` (one layer's pools) and ``page_table``, this token
    block's K/V are written into the pool at each token's logical
    position (bf16, or SAMD-packed int8 lanes + scales when the pool is
    int32) before attention. Without ``page_table``, ``kv_cache`` is a
    per-slot ring (``model.init_cache``), written at ``cache_index`` (an
    int, or a [B] tensor of per-row offsets) and attended whole through
    its ``pos``. ``paged_attn="fused"`` attends straight off
    the pool: one query per slot (decode) through
    ``kernels.ops.paged_decode_attention``, a block of queries per slot
    (the speculative verify) through ``kernels.ops.paged_verify_attention``;
    ``"gather"`` (also prefill's path) gathers the slots' pages into a
    dense view. Without a cache, attention is causal over the block.

    ``pool_kv`` switches to the speculative DRAFT layout: ``kv_cache`` is
    then the draft's ring, written here at column ``cache_index``, and
    the pool in ``pool_kv`` is READ ONLY at positions <= ``pool_bound``
    [B] (above it the pool may hold a previous tick's rejected drafts).
    Fused, the decode kernel folds the ring in after the pool's pages;
    "gather" concatenates the gathered pool with the ring.
    """
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q = apply_linear(p["wq"], xn)
    k = apply_linear(p["wk"], xn)
    v = apply_linear(p["wv"], xn)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = whole_heads(q, h).reshape(b, s, h, dh)
    k = whole_heads(k, hkv).reshape(b, s, hkv, dh)
    v = whole_heads(v, hkv).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    sin, cos = rope_tables(positions, dh, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if kv_cache is None:
        att = attention(q, k, v, positions, positions, chunk=cfg.attn_chunk)
    elif pool_kv is not None:
        ring = kv_cache
        _cache_write(ring["k"], k, cache_index)
        _cache_write(ring["v"], v, cache_index)
        _cache_write(ring["pos"], positions, cache_index)
        if paged_attn == "fused" and s == 1:
            att = kernel_ops.paged_decode_attention(
                q[:, 0].contiguous(), pool_kv["k"], pool_kv["v"],
                page_table, pool_bound.to(torch.int32).contiguous(),
                k_scale=pool_kv.get("k_scale"),
                v_scale=pool_kv.get("v_scale"), extra_k=ring["k"],
                extra_v=ring["v"], extra_pos=ring["pos"],
            )[:, None]
        else:
            k_pos = _paged_key_positions(page_table, page_size)
            k_pos = torch.where(k_pos <= pool_bound[:, None], k_pos, -1)
            pool_k, pool_v = _gathered_pool_kv(pool_kv, page_table,
                                               page_size, q.dtype)
            att = attention(
                q, torch.cat([pool_k, ring["k"].to(q.dtype)], dim=1),
                torch.cat([pool_v, ring["v"].to(q.dtype)], dim=1), positions,
                torch.cat([k_pos, ring["pos"].to(k_pos.dtype)], dim=1),
                chunk=cfg.attn_chunk)
    elif page_table is None:
        att = _ring_attention(kv_cache, q, k, v, positions, cache_index,
                              cfg.attn_chunk)
    else:
        pool = kv_cache
        if pool["k"].dtype == torch.int32:
            # pack the int8 lanes BEFORE the scatter: the pool only ever
            # holds packed words
            for name, t in (("k", k), ("v", v)):
                tq, ts = _quant_kv(t)
                _paged_write(pool[name], pack_int8_lanes(tq), page_table,
                             positions, page_size)
                _paged_write(pool[name + "_scale"], ts, page_table,
                             positions, page_size)
        else:
            _paged_write(pool["k"], k, page_table, positions, page_size)
            _paged_write(pool["v"], v, page_table, positions, page_size)
        if paged_attn == "fused" and s == 1:
            att = kernel_ops.paged_decode_attention(
                q[:, 0].contiguous(), pool["k"], pool["v"], page_table,
                positions[:, 0].to(torch.int32).contiguous(),
                k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
            )[:, None]
        elif paged_attn == "fused":
            att = kernel_ops.paged_verify_attention(
                q.contiguous(), pool["k"], pool["v"], page_table,
                positions.to(torch.int32).contiguous(),
                k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
            )
        else:
            k_pos = _paged_key_positions(page_table, page_size)
            k_full, v_full = _gathered_pool_kv(pool, page_table, page_size,
                                               q.dtype)
            att = attention(q, k_full, v_full, positions, k_pos,
                            chunk=cfg.attn_chunk)
    return apply_linear(p["wo"], merge_heads(att))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    if cfg.activation == "swiglu":
        gate = apply_linear(p["wg"], xn)
        up = apply_linear(p["wu"], xn)
        hid = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    elif cfg.activation == "sq_relu":
        up = apply_linear(p["wu"], xn)
        r = torch.relu(up)
        hid = r * r
    elif cfg.activation == "gelu":
        up = apply_linear(p["wu"], xn)
        # jax.nn.gelu's default is the tanh approximation
        hid = F.gelu(up.to(torch.float32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(cfg.activation)
    return apply_linear(p["wd"], hid)


# ---------------------------------------------------------------------------
# MoE (grouped capacity-based dispatch)
# ---------------------------------------------------------------------------

def moe_capacity(group_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(group_tokens * top_k * capacity_factor / n_experts)
    return max(c, 1)


@contextlib.contextmanager
def _true_f32():
    """f32 matmuls in f32, not TF32, whatever the process-wide setting
    (the router's top-k must see the reference's probabilities)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def top_k_lower_first(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    equal values ordered lower index first, as ``jax.lax.top_k`` orders
    them (``torch.topk`` promises no order among ties): a stable
    descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _experts(activation, dispatch, combine, xg, w_up, *rest):
    """The experts' part of ``moe_block`` (bf16 einsums): tokens
    dispatched to their experts' slots, through each expert's MLP, and
    combined back: ([G, T, D],)."""
    xin = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    h1 = torch.einsum("gecd,edf->gecf", xin, w_up)
    if activation == "swiglu":
        w_gate, w_down = rest
        hg = torch.einsum("gecd,edf->gecf", xin, w_gate)
        h = F.silu(hg.to(torch.float32)).to(torch.bfloat16) * h1
    else:
        (w_down,) = rest
        h = F.silu(h1.to(torch.float32)).to(torch.bfloat16)
    y = torch.einsum("gecf,efd->gecd", h, w_down)
    return (torch.einsum("gtec,gecd->gtd", combine, y),)


def moe_block(p: dict, x: torch.Tensor, cfg, *, group_tokens: int = 2048):
    """Top-k routed experts with per-group capacity (GShard-style).

    x: [B, S, D]. Groups are contiguous spans of ``group_tokens`` tokens
    (one row's, since ``S % group_tokens == 0``); within a group each
    expert takes at most ``moe_capacity`` tokens, slot 0's choices first
    in token order, then slot 1's, and the rest are dropped. The router
    runs in f32 and the experts (packed along their D or F axis) are
    dequantized to bf16 with ``materialize`` for bf16 einsums, as in the
    reference. Returns (out [B, S, D], Switch-style load-balance aux
    loss, a scalar f32).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    gt = min(group_tokens, s)
    if s % gt:
        raise ValueError(f"sequence {s} is not a whole number of "
                         f"{gt}-token groups")
    ng = b * (s // gt)
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xg = xn.reshape(ng, gt, d)

    with _true_f32():
        router_logits = torch.einsum(
            "gtd,de->gte", xg.to(torch.float32),
            p["router"].to(torch.float32))
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_first(probs, k)  # [ng, gt, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=1)                                          # [ng, e]
    ce = F.one_hot(gate_idx[..., 0], e).to(torch.float32).mean(dim=1)
    aux = (me * ce).mean() * (e * e)

    cap = moe_capacity(gt, e, k, cfg.capacity_factor)
    # position of each token within its expert, k-slot priority order
    dispatch = torch.zeros((ng, gt, e, cap), dtype=torch.bfloat16,
                           device=x.device)
    combine = torch.zeros((ng, gt, e, cap), dtype=torch.float32,
                          device=x.device)
    counts = torch.zeros((ng, e), dtype=torch.int64, device=x.device)
    for slot in range(k):
        mask = F.one_hot(gate_idx[..., slot], e)                # [ng, gt, e]
        pos = torch.cumsum(mask, dim=1) - 1 + counts[:, None, :]
        counts = counts + mask.sum(dim=1)
        keep = (pos < cap) & (mask > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1).to(
            torch.bfloat16)[..., :cap]                     # [ng, gt, e, cap]
        sel = pos_oh * mask[..., None].to(torch.bfloat16)
        dispatch = dispatch + sel
        combine = combine + sel.to(torch.float32) * gate_vals[
            ..., slot][..., None, None]

    weights = [materialize(p[n]) for n in ("w_up", "w_gate", "w_down")
               if n in p]
    args = (dispatch, combine.to(torch.bfloat16), xg.to(torch.bfloat16),
            *weights)
    if is_dtensor(xg):  # each rank's own groups and experts
        (out,) = on_local_blocks(
            functools.partial(_experts, cfg.activation), args,
            ((0, 2), (0, 2), (0, None)) + ((None, 0),) * len(weights),
            ((0, None),))
    else:
        (out,) = _experts(cfg.activation, *args)
    out = out.reshape(b, s, d).to(x.dtype)

    if cfg.dense_residual:
        out = out + mlp_block(p["dense"], x, cfg)
    return out, aux
