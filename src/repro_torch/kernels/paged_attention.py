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
fold, ``paged_verify_attention_xla``) in PyTorch. The kernel splits each
slot's pages across the blocks of a cluster (:func:`attention_plan` picks
how many, from shapes alone) and merges their online-softmax states in
rank order; :func:`paged_attention_states` runs the plain page loop over
such a split and :func:`merge_states` is the merge, for the tests.

Pools are bf16 [P, page_size, Hkv, dh], or SAMD-packed int32 words
[P, page_size, Hkv, dh/4] (four int8 lanes each) with f32 scales
[P, page_size, Hkv].
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import Kernel, ptr, stream_handle
from repro_torch.quant.packing import unpack_int8_lanes

DEFAULT_MASK_VALUE = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int

# each launcher ends (sm_scale, packed, splits, rt, stream)
_TAIL = [ctypes.c_float, _I, _I, _I, _P]
KERNEL = Kernel(
    "paged_attention", "paged_attention.cu",
    {"paged_decode_attention_launch": [_P] * 8 + [_I] * 6 + _TAIL,
     "paged_decode_ring_attention_launch": [_P] * 11 + [_I] * 7 + _TAIL,
     "paged_verify_attention_launch": [_P] * 8 + [_I] * 7 + _TAIL},
)

THREADS = 128     # threads a block, as in the source
MAX_SPLITS = 8    # the KV splits of one (slot, kv-head) form one cluster
NUM_SMS = 132     # H100 SXM
SMEM_PER_SM = 233472  # bytes of shared memory an SM can give its blocks
BLOCKS_PER_SM = 4     # the source caps registers for 4 blocks an SM
# the split fills the SMs' resident blocks to this share, not to the last
# block: clusters pack into the GPUs' SM groups with slack, and a second
# wave doubles the time
WAVE_FILL = 0.8
MMA_ROWS = 16              # rows a block of the tensor-core path holds
MMA_HEAD_DIMS = (64, 128)  # the tensor-core path's instantiations
STEP_PAGES, STAGES = 2, 3    # as in the source: pages a step, steps staged


class AttentionPlan(NamedTuple):
    splits: int      # blocks (one cluster) sharing a slot's pages
    rt: int          # 1 (a row a stream of dh/8 lanes) or MMA_ROWS
    row_blocks: int  # blocks over the S*G rows of one (slot, kv-head)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_smem(rt: int, dh: int, ps: int, n_pp: int, s: int, r: int,
               packed: bool) -> int:
    """Shared memory of one block, as the source lays it out (this
    mirrors its ``Layout``) with the largest split inbox: staged pages
    (the streams' partials take their place after), the ring, the table,
    positions, the partials' m and l, and the inbox of the split
    merge."""
    def r16(n):
        return (n + 15) // 16 * 16

    row = dh if packed else 2 * dh
    prows = (THREADS // 32 * MMA_ROWS if rt == MMA_ROWS
             else THREADS // (dh // 8) * rt)
    brows = MMA_ROWS if rt == MMA_ROWS else prows
    stage = r16(STEP_PAGES * (2 * ps * row + (8 * ps if packed else 0)))
    share = _cdiv(brows * dh, MAX_SPLITS)
    return (max(STAGES * stage, 4 * prows * dh)
            + (r16(4 * r * dh + 4 * r) if r else 0) + r16(4 * n_pp)
            + r16(4 * s) + 8 * prows + 4 * MAX_SPLITS * (share + 2 * brows))


@functools.lru_cache(maxsize=1024)
def attention_plan(b: int, hkv: int, rows: int, dh: int, n_pp: int,
                   ps: int, s: int, r: int, packed: bool) -> AttentionPlan:
    """How the kernel cuts the work of ``b`` slots x ``hkv`` kv-heads x
    ``rows`` (S*G, from ``s`` queries) query rows of width ``dh`` over a
    page table of ``n_pp`` columns of ``ps``-token pages (``r`` ring
    entries; ``packed`` pools): ``rt``, the kernel's path (1: one row a
    stream of dh/8 lanes, on CUDA cores; ``MMA_ROWS``: 16 rows a block on
    the tensor cores, for several rows at dh = 64 or 128, where the
    sweep of ``tools/attention_ablation.py`` put it 1.1-1.9x ahead), blocks
    over the rows (128 / (dh/8) one-row streams, or 16 rows, a block),
    and the KV splits: as many as keep the blocks within
    ``WAVE_FILL`` of one wave of resident blocks (``BLOCKS_PER_SM`` an SM,
    fewer where the shared memory runs out), at most ``MAX_SPLITS`` (one
    cluster) and at most ``n_pp``. Shapes alone decide it, so the
    wrapper never reads positions or the table."""
    rt = MMA_ROWS if rows > 1 and dh in MMA_HEAD_DIMS else 1
    per_block = 1 if rt == MMA_ROWS else THREADS // (dh // 8)
    row_blocks = max(1, _cdiv(_cdiv(rows, rt), per_block))
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (
        block_smem(rt, dh, ps, n_pp, s, r, packed) + 1024))
    resident = int(WAVE_FILL * max(1, per_sm) * NUM_SMS)
    splits = min(MAX_SPLITS, max(1, n_pp),
                 resident // max(1, b * hkv * row_blocks))
    return AttentionPlan(max(1, splits), rt, row_blocks)


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


def _split_states(qg, k_pages, v_pages, page_table, pos, k_scale, v_scale,
                  packed, bounds, live, ring, mask_value):
    """The page loop over each split of page columns
    ``bounds[i]:bounds[i + 1]``, from a fresh state each: qg [B, S, Hkv,
    G, dh] f32 (scaled), pos [B, S]. Returns one (m, l, acc) per split,
    the ring (extra_k, extra_v, extra_pos) folded into the last."""
    b, sq, hkv, g, dh = qg.shape
    p, page_size = k_pages.shape[:2]
    pt = page_table.to(torch.int64)
    pos = pos.to(torch.int64)
    row_max = pos.amax(dim=1)  # the slot's last query
    alive = (pos >= 0)[:, :, None, None, None] if live else None
    dev = qg.device
    offs0 = torch.arange(page_size, dtype=torch.int64, device=dev)
    states = []
    for j0, j1 in zip(bounds[:-1], bounds[1:]):
        m = torch.full((b, sq, hkv, g), mask_value, dtype=torch.float32,
                       device=dev)
        l_sum = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, sq, hkv, g, dh), dtype=torch.float32,
                          device=dev)
        for j in range(j0, j1):
            page = pt[:, j]
            base = j * page_size
            safe = page.clamp(0, p - 1)  # invalid rows read page 0, then drop
            k, v = _page_kv(k_pages, v_pages, k_scale, v_scale, safe, packed)
            s = torch.einsum("bqhgd,bphd->bqhgp", qg, k)
            valid = (page[:, None, None] >= 0) & (
                base + offs0[None, None, :] <= pos[:, :, None])  # [B, S, ps]
            s = torch.where(valid[:, :, None, None, :], s, mask_value)
            keep = ((page >= 0) & (base <= row_max))[:, None, None, None]
            m, l_sum, acc = _online_fold(m, l_sum, acc, s, v,
                                         "bqhgp,bphd->bqhgd", keep,
                                         mask_value, live=alive)
        states.append((m, l_sum, acc))
    if ring:
        extra_k, extra_v, extra_pos = ring
        m, l_sum, acc = states[-1]
        s = torch.einsum("bqhgd,brhd->bqhgr", qg, extra_k.to(torch.float32))
        valid = extra_pos >= 0  # written ring entries
        s = torch.where(valid[:, None, None, None, :], s, mask_value)
        keep = valid.any(dim=1)[:, None, None, None]
        states[-1] = _online_fold(m, l_sum, acc, s, extra_v.to(torch.float32),
                                  "bqhgr,brhd->bqhgd", keep, mask_value)
    return states


def paged_attention_states(q, k_pages, v_pages, page_table, q_pos, bounds,
                           *, k_scale=None, v_scale=None, extra_k=None,
                           extra_v=None, extra_pos=None,
                           mask_value: float = DEFAULT_MASK_VALUE):
    """The plain page loop cut at the page columns ``bounds`` (from 0 to
    n_pp, ascending), as the kernel's ranks cut it: one online-softmax
    state (m, l, acc) per split, each [B, S, Hkv, G(, dh)], the ring in
    the last. Decode takes q [B, H, dh] and q_pos [B] (S = 1), the verify
    q [B, S, H, dh] and q_pos [B, S]; a verify row at -1 adds no mass."""
    verify = q.dim() == 4
    b, sq, h, dh = q.shape if verify else (q.shape[0], 1, *q.shape[1:])
    hkv, g, _, packed = _dims(h, dh, k_pages, k_scale, v_scale)
    sm_scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(b, sq, hkv, g, dh).to(torch.float32) * sm_scale
    ring = None if extra_k is None else (extra_k, extra_v, extra_pos)
    return _split_states(qg, k_pages, v_pages, page_table,
                         q_pos.reshape(b, sq), k_scale, v_scale, packed,
                         tuple(bounds), verify, ring, mask_value)


def merge_states(states):
    """The kernel's merge of partial states in rank order: m = max m_i,
    then l and acc sum the states weighted by exp(m_i - m), so a state
    whose keys were all masked for a row (m = -1e30, l > 0) drops out
    wherever another holds a real score."""
    m = states[0][0]
    for mi, _, _ in states[1:]:
        m = torch.maximum(m, mi)
    l_sum = torch.zeros_like(states[0][1])
    acc = torch.zeros_like(states[0][2])
    for mi, li, ai in states:
        w = torch.exp(mi - m)
        l_sum = l_sum + w * li
        acc = acc + w[..., None] * ai
    return m, l_sum, acc


def finish_state(state, shape, dtype):
    """The output of a final state: acc / l (zeros where l = 0), as
    ``shape`` in ``dtype``."""
    _, l_sum, acc = state
    out = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(shape).to(dtype)


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
    (state,) = paged_attention_states(
        q, k_pages, v_pages, page_table, q_pos, (0, page_table.shape[1]),
        k_scale=k_scale, v_scale=v_scale, extra_k=extra_k, extra_v=extra_v,
        extra_pos=extra_pos, mask_value=mask_value)
    return finish_state(state, q.shape, q.dtype)


def paged_verify_attention_plain(q, k_pages, v_pages, page_table, q_pos, *,
                                 k_scale=None, v_scale=None,
                                 mask_value: float = DEFAULT_MASK_VALUE):
    """The multi-query page loop in PyTorch: q [B, S, H, dh] with one
    position per query (``q_pos`` [B, S]). A page is skipped for a slot
    when it is unallocated or lies wholly past the slot's last query;
    inside a page each row masks keys past its own position, and a row
    at position -1 adds no mass, so it emits zeros."""
    (state,) = paged_attention_states(
        q, k_pages, v_pages, page_table, q_pos, (0, page_table.shape[1]),
        k_scale=k_scale, v_scale=v_scale, mask_value=mask_value)
    return finish_state(state, q.shape, q.dtype)


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


def _check_head_dim(dh):
    """The kernel reads a key row with dh/8 lanes of one warp."""
    lanes = dh // 8
    if dh % 8 or not 1 <= lanes <= 32 or lanes & (lanes - 1):
        raise ValueError(f"paged attention kernel takes head_dim 8 x 2^k "
                         f"up to 256, got {dh}")


def _launch(q, fn, *args):
    """``fn`` on q's device: a ``torch.cuda.device`` context only when
    that is not the current device (entering one costs more host time
    than the launch)."""
    dev = q.get_device()
    if dev == torch.cuda.current_device():
        KERNEL.launch(fn, *args)
    else:
        with torch.cuda.device(dev):
            KERNEL.launch(fn, *args)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, q_pos, *,
                                k_scale=None, v_scale=None, extra_k=None,
                                extra_v=None, extra_pos=None):
    """Launch the decode kernel of ``csrc/paged_attention.cu`` on the
    current stream, cut as :func:`attention_plan` says; with ``extra_k``
    the ring-fold launcher. Takes bf16 ``q`` and ring, bf16 or packed
    int32 pools, on one CUDA device; raises on anything else, and on a
    failed build or launch."""
    b, h, dh = q.shape
    hkv, g, page_size, packed = _dims(h, dh, k_pages, k_scale, v_scale)
    _check_head_dim(dh)
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
    n_pp = page_table.shape[1]
    plan = attention_plan(b, hkv, g, dh, n_pp, page_size, 1,
                          extra_k.shape[1] if ring else 0, packed)
    head = (ptr(q), ptr(k_pages), ptr(v_pages),
            ptr(k_scale if packed else None),
            ptr(v_scale if packed else None), ptr(page_table), ptr(q_pos))
    dims = (b, n_pp, page_size, hkv, g, dh)
    tail = (1.0 / (dh ** 0.5), int(packed), plan.splits, plan.rt,
            stream_handle(q))
    if ring:
        _launch(q, "paged_decode_ring_attention_launch", *head,
                *(ptr(t) for t in ring), ptr(out), *dims, extra_k.shape[1],
                *tail)
    else:
        _launch(q, "paged_decode_attention_launch", *head, ptr(out), *dims,
                *tail)
    return out


def paged_verify_attention_cuda(q, k_pages, v_pages, page_table, q_pos, *,
                                k_scale=None, v_scale=None):
    """Launch the verify kernel of ``csrc/paged_attention.cu`` on the
    current stream over the S*G query rows of each (slot, kv-head), cut
    as :func:`attention_plan` says. Same operand rules as the decode
    kernel; ``q_pos`` is int32 [B, S]."""
    b, sq, h, dh = q.shape
    hkv, g, page_size, packed = _dims(h, dh, k_pages, k_scale, v_scale)
    _check_head_dim(dh)
    _check_cuda(q, k_pages, v_pages, page_table, q_pos, k_scale, v_scale,
                packed)
    if tuple(q_pos.shape) != (b, sq):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} vs q {tuple(q.shape)}")
    out = torch.empty((b, sq, h, dh), dtype=torch.bfloat16, device=q.device)
    if b == 0 or sq == 0:
        return out
    n_pp = page_table.shape[1]
    plan = attention_plan(b, hkv, sq * g, dh, n_pp, page_size, sq, 0, packed)
    _launch(q, "paged_verify_attention_launch", ptr(q), ptr(k_pages),
            ptr(v_pages), ptr(k_scale if packed else None),
            ptr(v_scale if packed else None), ptr(page_table), ptr(q_pos),
            ptr(out), b, n_pp, page_size, hkv, g, dh, sq, 1.0 / (dh ** 0.5),
            int(packed), plan.splits, plan.rt, stream_handle(q))
    return out
