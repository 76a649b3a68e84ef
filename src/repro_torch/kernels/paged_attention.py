"""Fused paged attention over the KV pool: the CUDA kernels and their
plain PyTorch versions.

Counterpart of ``repro/kernels/paged_attention.py``. The kernels are
``csrc/paged_attention.cu``, which exports three launchers:

* ``paged_decode_attention_launch`` replaces the Pallas TPU kernel
  ``paged_decode_attention``: q [B, H, dh] attends through
  ``page_table`` [B, n_pp] (-1 = unallocated) to keys at logical offsets
  <= ``q_pos`` [B];
* ``paged_decode_ring_attention_launch`` is the same page loop followed
  by the speculative draft's ring fold (``extra_k``/``extra_v``
  [B, R, Hkv, dh] bf16, ``extra_pos`` [B, R], an entry valid iff >= 0),
  which the reference computes in its jnp lowering; ``q_pos`` then
  bounds the POOL read;
* ``paged_verify_attention_launch`` replaces ``paged_verify_attention``:
  a block of S queries per slot, q [B, S, H, dh], one position per query
  (``q_pos`` [B, S], -1 = a masked row that emits zeros).

``paged_decode_attention_plain`` and ``paged_verify_attention_plain`` are
the reference's page loops (``paged_decode_attention_xla`` with its ring
fold, ``paged_verify_attention_xla``) in PyTorch.

Pools are bf16 [P, page_size, Hkv, dh], or SAMD-packed int32 words
[P, page_size, Hkv, dh/4] (four int8 lanes each) with f32 scales
[P, page_size, Hkv].
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, ptr, stream_handle
from repro_torch.quant.packing import unpack_int8_lanes

DEFAULT_MASK_VALUE = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = Kernel(
    "paged_attention", "paged_attention.cu",
    {"paged_decode_attention_launch":
         [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
     "paged_decode_ring_attention_launch":
         [_P] * 11 + [_I] * 7 + [ctypes.c_float, _I, _P],
     "paged_verify_attention_launch":
         [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P]},
)


def _dims(h, dh, k_pages, k_scale, v_scale):
    """(hkv, g, page_size, packed) of the pools for h query heads of
    width dh; raises on a pool that does not fit them."""
    packed = k_pages.dtype == torch.int32
    if packed:
        if k_scale is None or v_scale is None:
            raise ValueError("packed int8 pools need per-(token, head) scales")
        if k_pages.shape[-1] * 4 != dh:
            raise ValueError(f"packed pool {tuple(k_pages.shape)} vs dh={dh}")
    elif k_pages.shape[-1] != dh:
        raise ValueError(f"pool {tuple(k_pages.shape)} vs dh={dh}")
    _, page_size, hkv = k_pages.shape[:3]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    return hkv, h // hkv, page_size, packed


def _page_kv(k_pages, v_pages, k_scale, v_scale, safe, packed):
    """Pages ``safe`` [B] of the pools as f32 K and V [B, ps, Hkv, dh]."""
    k = k_pages[safe]
    v = v_pages[safe]
    if packed:
        return (unpack_int8_lanes(k).float() * k_scale[safe][..., None],
                unpack_int8_lanes(v).float() * v_scale[safe][..., None])
    return k.to(torch.float32), v.to(torch.float32)


def _online_fold(m, l_sum, acc, s, v, eq, keep, mask_value, live=None):
    """One online-softmax step over masked scores ``s`` [..., n] and
    values ``v``, contracted by einsum ``eq``; rows where ``keep`` is
    False keep their state, rows where ``live`` is False add no mass."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    pexp = torch.exp(s - m_new[..., None])
    if live is not None:
        pexp = torch.where(live, pexp, 0.0)
    l_new = l_sum * alpha + pexp.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(eq, pexp, v)
    return (torch.where(keep, m_new, m), torch.where(keep, l_new, l_sum),
            torch.where(keep[..., None], acc_new, acc))


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, q_pos, *,
                                 k_scale=None, v_scale=None, extra_k=None,
                                 extra_v=None, extra_pos=None,
                                 mask_value: float = DEFAULT_MASK_VALUE):
    """The page loop in PyTorch: one step per page column, batched over
    slots, online softmax in f32, pages folded in ascending order. A row
    whose page is invalid keeps its running state, so a slot with no
    valid key keeps l == 0 and emits zeros. With ``extra_k``, the ring
    entries are folded in after the pages (a slot with none valid keeps
    its state)."""
    b, h, dh = q.shape
    hkv, g, page_size, packed = _dims(h, dh, k_pages, k_scale, v_scale)
    p = k_pages.shape[0]
    sm_scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(b, hkv, g, dh).to(torch.float32) * sm_scale
    pt = page_table.to(torch.int64)
    pos = q_pos.to(torch.int64)
    dev = q.device
    m = torch.full((b, hkv, g), mask_value, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((b, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, dh), dtype=torch.float32, device=dev)
    offs0 = torch.arange(page_size, dtype=torch.int64, device=dev)
    for j in range(pt.shape[1]):
        page = pt[:, j]
        base = j * page_size
        safe = page.clamp(0, p - 1)  # invalid rows read page 0, then drop
        k, v = _page_kv(k_pages, v_pages, k_scale, v_scale, safe, packed)
        s = torch.einsum("bhgd,bphd->bhgp", qg, k)
        valid = (page[:, None] >= 0) & (base + offs0[None, :] <= pos[:, None])
        s = torch.where(valid[:, None, None, :], s, mask_value)
        keep = ((page >= 0) & (base <= pos))[:, None, None]
        m, l_sum, acc = _online_fold(m, l_sum, acc, s, v,
                                     "bhgp,bphd->bhgd", keep, mask_value)
    if extra_k is not None:
        s = torch.einsum("bhgd,brhd->bhgr", qg, extra_k.to(torch.float32))
        valid = extra_pos >= 0  # written ring entries
        s = torch.where(valid[:, None, None, :], s, mask_value)
        keep = valid.any(dim=1)[:, None, None]
        m, l_sum, acc = _online_fold(m, l_sum, acc, s,
                                     extra_v.to(torch.float32),
                                     "bhgr,brhd->bhgd", keep, mask_value)
    out = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def paged_verify_attention_plain(q, k_pages, v_pages, page_table, q_pos, *,
                                 k_scale=None, v_scale=None,
                                 mask_value: float = DEFAULT_MASK_VALUE):
    """The multi-query page loop in PyTorch: q [B, S, H, dh] with one
    position per query (``q_pos`` [B, S]). A page is skipped for a slot
    when it is unallocated or lies wholly past the slot's last query;
    inside a page each row masks keys past its own position, and a row
    at position -1 adds no mass, so it emits zeros."""
    b, sq, h, dh = q.shape
    hkv, g, page_size, packed = _dims(h, dh, k_pages, k_scale, v_scale)
    p = k_pages.shape[0]
    sm_scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(b, sq, hkv, g, dh).to(torch.float32) * sm_scale
    pt = page_table.to(torch.int64)
    pos = q_pos.to(torch.int64)  # [B, S]
    row_max = pos.amax(dim=1)    # last query of each slot
    live = (pos >= 0)[:, :, None, None, None]
    dev = q.device
    m = torch.full((b, sq, hkv, g), mask_value, dtype=torch.float32,
                   device=dev)
    l_sum = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, dh), dtype=torch.float32, device=dev)
    offs0 = torch.arange(page_size, dtype=torch.int64, device=dev)
    for j in range(pt.shape[1]):
        page = pt[:, j]
        base = j * page_size
        safe = page.clamp(0, p - 1)
        k, v = _page_kv(k_pages, v_pages, k_scale, v_scale, safe, packed)
        s = torch.einsum("bqhgd,bphd->bqhgp", qg, k)
        valid = (page[:, None, None] >= 0) & (
            base + offs0[None, None, :] <= pos[:, :, None])  # [B, S, ps]
        s = torch.where(valid[:, :, None, None, :], s, mask_value)
        keep = ((page >= 0) & (base <= row_max))[:, None, None, None]
        m, l_sum, acc = _online_fold(m, l_sum, acc, s, v,
                                     "bqhgp,bphd->bqhgd", keep, mask_value,
                                     live=live)
    out = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _check_cuda(q, k_pages, v_pages, page_table, q_pos, k_scale, v_scale,
                packed, *more):
    """Raise unless every operand is what the kernels take: bf16 q, bf16
    or packed int32 pools (f32 scales), int32 table and positions, all
    contiguous on one CUDA device."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged attention kernel takes bf16 q, got {q.dtype}")
    if not packed and k_pages.dtype != torch.bfloat16:
        raise TypeError(f"pools must be bf16 or int32, got {k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("k and v pools must match in shape and dtype")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("page_table and q_pos must be int32")
    tensors = [q, k_pages, v_pages, page_table, q_pos, *more]
    if packed:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("pool scales must be f32")
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must share one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the pools, page table, q and ring must be "
                         "contiguous")


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, q_pos, *,
                                k_scale=None, v_scale=None, extra_k=None,
                                extra_v=None, extra_pos=None):
    """Launch the decode kernel of ``csrc/paged_attention.cu`` on the
    current stream, one block per (slot, kv-head); with ``extra_k`` the
    ring-fold launcher. Takes bf16 ``q`` and ring, bf16 or packed int32
    pools, on one CUDA device; raises on anything else, and on a failed
    build or launch."""
    b, h, dh = q.shape
    hkv, g, page_size, packed = _dims(h, dh, k_pages, k_scale, v_scale)
    ring = () if extra_k is None else (extra_k, extra_v, extra_pos)
    _check_cuda(q, k_pages, v_pages, page_table, q_pos, k_scale, v_scale,
                packed, *ring)
    if ring:
        r = extra_k.shape[1]
        if (extra_k.dtype != torch.bfloat16 or extra_v.dtype != torch.bfloat16
                or extra_pos.dtype != torch.int32):
            raise TypeError("the ring is bf16 k/v with int32 positions")
        if (tuple(extra_k.shape) != (b, r, hkv, dh)
                or extra_v.shape != extra_k.shape
                or tuple(extra_pos.shape) != (b, r)):
            raise ValueError(
                f"ring {tuple(extra_k.shape)}/{tuple(extra_pos.shape)} vs "
                f"q {tuple(q.shape)} and {hkv} kv heads")
    out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=q.device)
    if b == 0:
        return out
    sm_scale = 1.0 / (dh ** 0.5)
    head = (ptr(q), ptr(k_pages), ptr(v_pages),
            ptr(k_scale if packed else None),
            ptr(v_scale if packed else None), ptr(page_table), ptr(q_pos))
    dims = (b, page_table.shape[1], page_size, hkv, g, dh)
    with torch.cuda.device(q.device):
        if ring:
            KERNEL.launch(
                "paged_decode_ring_attention_launch", *head,
                *(ptr(t) for t in ring), ptr(out), *dims,
                extra_k.shape[1], sm_scale, int(packed), stream_handle(q))
        else:
            KERNEL.launch("paged_decode_attention_launch", *head, ptr(out),
                          *dims, sm_scale, int(packed), stream_handle(q))
    return out


def paged_verify_attention_cuda(q, k_pages, v_pages, page_table, q_pos, *,
                                k_scale=None, v_scale=None):
    """Launch the verify kernel of ``csrc/paged_attention.cu`` on the
    current stream, one block per (slot, kv-head) covering its S*G query
    rows. Same operand rules as the decode kernel; ``q_pos`` is int32
    [B, S]."""
    b, sq, h, dh = q.shape
    hkv, g, page_size, packed = _dims(h, dh, k_pages, k_scale, v_scale)
    _check_cuda(q, k_pages, v_pages, page_table, q_pos, k_scale, v_scale,
                packed)
    if tuple(q_pos.shape) != (b, sq):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} vs q {tuple(q.shape)}")
    out = torch.empty((b, sq, h, dh), dtype=torch.bfloat16, device=q.device)
    if b == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        KERNEL.launch(
            "paged_verify_attention_launch", ptr(q), ptr(k_pages),
            ptr(v_pages), ptr(k_scale if packed else None),
            ptr(v_scale if packed else None), ptr(page_table), ptr(q_pos),
            ptr(out), b, page_table.shape[1], page_size, hkv, g, dh, sq,
            1.0 / (dh ** 0.5), int(packed), stream_handle(q))
    return out
