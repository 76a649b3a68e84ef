"""Fused decode attention over the paged KV pool: the CUDA kernel and its
plain PyTorch version.

Counterpart of ``repro/kernels/paged_attention.py`` (decode only; the
multi-query verify kernel waits for speculative decoding). The kernel is
``csrc/paged_attention.cu`` (it replaces the Pallas TPU kernel
``paged_decode_attention``); ``paged_decode_attention_plain`` is the
reference's page loop (``paged_decode_attention_xla``, without the draft
ring fold) in PyTorch.

q [B, H, dh] attends through ``page_table`` [B, n_pp] (-1 = unallocated)
to keys at logical offsets <= ``q_pos`` [B]; pools are bf16
[P, page_size, Hkv, dh], or SAMD-packed int32 words [P, page_size, Hkv,
dh/4] (four int8 lanes each) with f32 scales [P, page_size, Hkv].
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, ptr, stream_handle
from repro_torch.quant.packing import unpack_int8_lanes

DEFAULT_MASK_VALUE = -1e30

KERNEL = Kernel(
    "paged_attention", "paged_attention.cu",
    {"paged_decode_attention_launch": [ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 6
                                      + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p]},
)


def _dims(q, k_pages, k_scale, v_scale):
    b, h, dh = q.shape
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
    return b, h, dh, hkv, h // hkv, page_size, packed


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, q_pos, *,
                                 k_scale=None, v_scale=None,
                                 mask_value: float = DEFAULT_MASK_VALUE):
    """The page loop in PyTorch: one step per page column, batched over
    slots, online softmax in f32, pages folded in ascending order. A row
    whose page is invalid keeps its running state, so a slot with no
    valid key keeps l == 0 and emits zeros."""
    b, h, dh, hkv, g, page_size, packed = _dims(q, k_pages, k_scale, v_scale)
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
        k = k_pages[safe]
        v = v_pages[safe]
        if packed:
            k = unpack_int8_lanes(k).float() * k_scale[safe][..., None]
            v = unpack_int8_lanes(v).float() * v_scale[safe][..., None]
        else:
            k = k.to(torch.float32)
            v = v.to(torch.float32)
        s = torch.einsum("bhgd,bphd->bhgp", qg, k)
        valid = (page[:, None] >= 0) & (base + offs0[None, :] <= pos[:, None])
        s = torch.where(valid[:, None, None, :], s, mask_value)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l_new = l_sum * alpha + pexp.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bhgp,bphd->bhgd", pexp, v)
        keep = ((page >= 0) & (base <= pos))[:, None, None]
        m = torch.where(keep, m_new, m)
        l_sum = torch.where(keep, l_new, l_sum)
        acc = torch.where(keep[..., None], acc_new, acc)
    out = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, q_pos, *,
                                k_scale=None, v_scale=None):
    """Launch ``csrc/paged_attention.cu`` on the current stream: one block
    per (slot, kv-head). Takes bf16 ``q`` and bf16 or packed int32 pools
    on one CUDA device; raises on anything else, and on a failed build or
    launch."""
    b, h, dh, hkv, g, page_size, packed = _dims(q, k_pages, k_scale, v_scale)
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged attention kernel takes bf16 q, got {q.dtype}")
    if not packed and k_pages.dtype != torch.bfloat16:
        raise TypeError(f"pools must be bf16 or int32, got {k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("k and v pools must match in shape and dtype")
    if page_table.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("page_table and q_pos must be int32")
    tensors = [q, k_pages, v_pages, page_table, q_pos]
    if packed:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("pool scales must be f32")
        tensors += [k_scale, v_scale]
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must share one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the pools, page table and q must be contiguous")
    out = torch.empty((b, h, dh), dtype=torch.bfloat16, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        KERNEL.launch(
            "paged_decode_attention_launch", ptr(q), ptr(k_pages),
            ptr(v_pages), ptr(k_scale if packed else None),
            ptr(v_scale if packed else None), ptr(page_table), ptr(q_pos),
            ptr(out), b, page_table.shape[1], page_size, hkv, g, dh,
            1.0 / (dh ** 0.5), int(packed), stream_handle(q),
        )
    return out
