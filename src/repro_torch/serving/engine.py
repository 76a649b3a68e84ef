"""Batched serving engine: paged KV pool + one ragged decode step per tick.

The PyTorch port of ``repro/serving/engine.py``, all four families. The
scheduling contract is the reference's:

  * fixed ``max_batch`` decode slots; host-side slot state (position,
    last token, active flag, page table) lives in numpy and goes to the
    device once per tick;
  * admission runs ONE bucket-padded batched prefill over the requests
    it admits, a row each (no row for a slot it leaves empty), writing
    K/V straight into their pages. A prompt with
    ``len(prompt) >= max_len`` is rejected with ``error`` set;
  * every tick runs ONE position-ragged decode step over the whole slot
    set; attention reads the page pool through the page table with the
    fused paged decode kernel; sampling happens on the device;
  * finished slots free at once and are refilled from the queue;
  * each layer owns ``num_pages`` KV pages of ``page_size`` tokens (bf16,
    or SAMD-packed int8 lanes when ``quant.kv_bits == 8``), refcounted
    and prefix-shared: admission maps a prompt's leading full blocks that
    are resident onto the same pages, and a prompt that ends inside a
    resident block gets a copy-on-write fork of it;
  * ``admission="reserve"`` (default) reserves each request's worst-case
    growth at admission, so mid-decode grants never fail;
    ``"optimistic"`` does not, and a dry pool PREEMPTS the youngest
    resident request (recompute-resume, token-identical); only a request
    that cannot fit the pool alone is retired ``truncated``;
  * ``prefix_retain=N`` parks up to N refcount-0 prefix pages in an LRU
    pool so sharing survives non-overlapping residencies;
  * ``max_queue`` bounds the queue (overflow is rejected with ``error``);
  * every request carries four stamps on the engine's ``clock``
    (``time.monotonic`` unless one is given): ``t_submit``, ``t_admit``,
    ``t_first_token`` and ``t_retire``, the last three taken after the
    host read of the tokens they time (``t_admit`` after the admitting
    prefill's); ``serving/server.py`` derives TTFT, TPOT and e2e from
    them;
  * ``repro_torch.tracing``, when on, records the tick's phases as spans
    (``engine.step``, ``.admit``, ``.prefill``, ``.grant_pages``,
    ``.decode``, ``.sync``, ``.advance``) and each request's wait in the
    queue (``request.queue``, submission to the start of the prefill
    that admits it); ``stats`` counts the prompt tokens batched prefills
    took against the rows x bucket they computed;
  * ``verify=True`` (default) certifies every (bits, K) the packed
    weights accumulate over, target and draft, with the lane-safety
    analysis before the engine serves: an unsafe quantization raises
    ``LaneSafetyError`` in the constructor;
  * ``speculative=K`` > 0 runs one self-speculative tick instead of the
    decode step: the draft (the same weights SAMD-packed by
    ``draft_quant``, default 4-bit; a quantized target is its own draft
    and takes no ``draft_quant``) proposes up to K tokens per slot with K
    single-token forwards over a tick-local ring (pool read only, below
    the window), and the target verifies them in ONE multi-token forward
    through the paged verify kernel (``self._draft_step``, then
    ``self._verify_step``); each slot consumes 1 to K+1 tokens a tick.
    Greedy output is token-identical to plain decode; temperature > 0
    verifies by rejection sampling. Lookahead pages come from the
    reservation or the free list and never preempt (``_spec_lens``).

Modes, resolved as the reference resolves them:

  * ``paged_attn="fused"`` (default) runs decode attention through the
    fused paged decode kernel (and the speculative ring fold and verify
    kernels); ``"gather"`` gathers each slot's pages into a dense view
    (the reference path);
  * ``kv_mode="ring"`` keeps a fixed per-slot KV ring [max_batch,
    max_len] instead of the page pool: batched prefill writes a fresh
    ring and replaces the admitted slots' rows, the ragged decode step
    writes each row at its own column. No pages, no prefix sharing, no
    speculative decoding. ``"auto"`` (default) is ``"paged"`` for the
    attention families (dense, moe) under ragged decode, else ``"ring"``.
    The recurrent families (rwkv6, hybrid_mamba2) always run the ring:
    their state is O(1) a slot, each admission is one ``_prefill_one``
    that resets its slot's row, and the ragged step advances every
    slot's state each tick (the hybrid's shared attention keeps a ring
    on its attention layers);
  * ``decode_mode="per_row"`` is the reference's equivalence baseline:
    one exact-length prefill (``_prefill_one``) and one ``forward`` per
    active slot per tick (``_decode_rows_reference``) over the ring,
    counted in ``per_row_prefill_calls`` / ``per_row_forward_calls``.

The KV cache (``self.cache``) is written in place by every step (the
reference donates it to its jitted steps instead).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.analysis import contracts
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import (
    build_template, copy_paged_page, forward, init_cache, init_paged_cache,
)
from repro_torch.models.quantize import quantize_params
from repro_torch.models.spec import init_from_spec
from repro_torch.quant.config import QuantConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [T] int32
    max_tokens: int = 16
    eos_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    truncated: bool = False     # force-retired (cache/page-pool exhaustion)
    # error != None: rejected before prefill ("queue full ...", "prompt
    # length ...", "request needs ... pages") or retired when
    # run_to_completion's tick budget ran out ("tick budget exhausted")
    error: Optional[str] = None
    # set while a preempted request waits for recompute-resume
    resume_prompt: Optional[np.ndarray] = None
    # stamps on the engine's clock, None until the event happens:
    #   t_submit      ``submit`` (arrival at the engine)
    #   t_admit       first admission, taken after the admitting prefill's
    #                 host read of its first token; kept on resume
    #   t_first_token first generated token (prefill's sample)
    #   t_retire      retirement, any outcome (done/truncated/rejected)
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_retire: Optional[float] = None
    _seq: int = -1

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_tokens:
            return True
        return bool(self.generated and self.eos_id is not None
                    and self.generated[-1] == self.eos_id)


class PageAllocator:
    """Host-side refcounted free list over the global KV page pool (the
    reference's allocator, ported as is).

    * ALLOCATION: ``alloc`` grants pages at refcount 1; ``release`` drops
      one ref per page and returns the pages whose refcount reached zero.
    * SHARING: ``share`` bumps the refcount of a held page.
    * RESERVATIONS: pages promised to admitted requests for their decode
      growth; they stay in the free list but no admission may take them.
    * RETENTION (``retain_limit`` > 0): refcount-0 pages released with
      ``retain=True`` park in an LRU pool; they count as available and
      are evicted LRU-first (``on_evict`` tells the owner) when a grant
      outgrows the free list; ``revive`` re-references one.
    """

    def __init__(self, num_pages: int, retain_limit: int = 0):
        self.num_pages = num_pages
        self.retain_limit = int(retain_limit)
        self._free = list(range(num_pages - 1, -1, -1))
        self._retained: collections.OrderedDict = collections.OrderedDict()
        self.refcount = np.zeros(num_pages, np.int32)
        self.reserved = 0
        self.on_evict = None  # callable(list[int]) -> None, or None

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def retained_pages(self) -> int:
        return len(self._retained)

    @property
    def held_pages(self) -> int:
        """Pages with at least one holder (retained pages are not held)."""
        return int((self.refcount > 0).sum())

    @property
    def available(self) -> int:
        """Pages an admission may take or reserve right now."""
        return len(self._free) + len(self._retained) - self.reserved

    def _evict(self, n: int) -> None:
        pages = [self._retained.popitem(last=False)[0] for _ in range(n)]
        self._free.extend(pages)
        if self.on_evict is not None:
            self.on_evict(pages)

    def _grant(self, n: int) -> list:
        if len(self._free) < n:
            self._evict(n - len(self._free))
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0, ("double grant", p)
            self.refcount[p] = 1
        return pages

    def alloc(self, n: int, reserve: int = 0) -> Optional[list]:
        """Take ``n`` pages and reserve ``reserve`` more, or None (taking
        nothing) unless all ``n + reserve`` are available."""
        if n + reserve > self.available:
            return None
        self.reserved += reserve
        return self._grant(n)

    def claim_reserved(self, n: int = 1) -> list:
        """Turn reserved pages into real ones (never fails)."""
        assert (
            0 <= n <= self.reserved
            <= len(self._free) + len(self._retained)
        )
        self.reserved -= n
        return self._grant(n)

    def cancel_reservation(self, n: int) -> None:
        self.reserved -= n
        assert self.reserved >= 0

    def share(self, page: int) -> None:
        assert self.refcount[page] >= 1, ("share of unheld page", page)
        self.refcount[page] += 1

    def is_retained(self, page: int) -> bool:
        return page in self._retained

    def revive(self, page: int) -> None:
        del self._retained[page]
        assert self.refcount[page] == 0, ("revive of held page", page)
        self.refcount[page] = 1

    def release(self, pages, retain: bool = False) -> list:
        """Drop one reference per page; returns the pages actually FREED
        (retained ones are not)."""
        freed = []
        for p in pages:
            p = int(p)
            assert self.refcount[p] >= 1, ("release of unheld page", p)
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                if retain and self.retain_limit > 0:
                    if len(self._retained) >= self.retain_limit:
                        self._evict(1)
                    self._retained[p] = None
                else:
                    self._free.append(p)
                    freed.append(p)
        return freed

    def reset(self) -> None:
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._retained.clear()
        self.refcount[:] = 0
        self.reserved = 0


def _leaves(tree) -> list:
    """The tensors of a nested dict / list cache, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _row_views(tree, i: int):
    """The cache with every tensor cut to row ``i`` (views: writes land
    in the engine's cache)."""
    if isinstance(tree, dict):
        return {k: _row_views(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_row_views(v, i) for v in tree]
    return tree[i:i + 1]


def _bucket_len(max_prompt: int, max_len: int) -> int:
    """Smallest power-of-two prefill bucket >= the longest admitted prompt
    (floor 8, capped at the cache length)."""
    lb = 8
    while lb < max_prompt:
        lb *= 2
    return min(lb, max_len)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params=None, *,
                 quant: QuantConfig | None = None,
                 max_batch: int = 4, max_len: int = 512, seed: int = 0,
                 temperature: float = 0.0,
                 decode_mode: str = "ragged",
                 kv_mode: str = "auto",
                 page_size: int = 16,
                 num_pages: Optional[int] = None,
                 admission: str = "reserve",
                 paged_attn: str = "fused",
                 prefix_sharing: bool = True,
                 prefix_retain: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 speculative: int = 0,
                 draft_quant: QuantConfig | None = None,
                 verify: bool = True,
                 clock=None,
                 device="cuda"):
        """``params`` are unquantized weights (``build_template`` layout;
        random from ``seed`` when None); ``quant`` packs them here, and
        with ``speculative`` > 0 and an unquantized target, ``draft_quant``
        (default ``QuantConfig(bits=4)``; ``enabled=False`` shares the
        target's weights) packs the draft from them too. A quantized
        target is its own draft: ``draft_quant`` with it raises.
        ``clock`` (default ``time.monotonic``) stamps the requests."""
        if decode_mode not in ("ragged", "per_row"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if paged_attn not in ("fused", "gather"):
            raise ValueError(f"unknown paged_attn {paged_attn!r}")
        if speculative < 0:
            raise ValueError(f"speculative must be >= 0, got {speculative}")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        # the page pool needs the batched admission path; the per-row
        # reference path slices per-slot cache rows and recurrent families
        # have O(1) state: both run the ring
        paged_capable = (
            decode_mode == "ragged" and cfg.family in ("dense", "moe")
        )
        if kv_mode == "auto":
            kv_mode = "paged" if paged_capable else "ring"
        if kv_mode not in ("paged", "ring"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        if kv_mode == "paged" and not paged_capable:
            raise ValueError(
                "kv_mode='paged' needs decode_mode='ragged' and an "
                f"attention family, got {decode_mode}/{cfg.family}"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        self.decode_mode = decode_mode
        self.kv_mode = kv_mode
        self.paged_attn = paged_attn
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = float(temperature)
        self.admission = admission
        self.prefix_sharing = bool(prefix_sharing) and kv_mode == "paged"
        if speculative and (kv_mode != "paged" or decode_mode != "ragged"):
            raise ValueError(
                "speculative decoding needs kv_mode='paged' and "
                f"decode_mode='ragged', got {kv_mode}/{decode_mode}"
            )
        self.page_size = page_size
        self.pages_per_slot = -(-max_len // page_size)
        if num_pages is None:
            num_pages = max_batch * self.pages_per_slot
        self.num_pages = num_pages
        template = build_template(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_from_spec(template, gen, device=self.device)
        self.quant = quant or QuantConfig(enabled=False)
        raw_params = params
        if self.quant.enabled:
            params = quantize_params(params, template, self.quant)
        self.params = params
        self._kv_bits = self.quant.kv_bits if self.quant.enabled else None
        self.speculative = int(speculative)
        if self.speculative:
            if self.quant.enabled:
                if draft_quant is not None:
                    raise ValueError(
                        "a quantized target is its own draft: draft_quant "
                        "applies only to an unquantized target")
                self.draft_quant = self.quant
                self._draft_params = self.params
            else:
                dq = draft_quant or QuantConfig(bits=4)
                self.draft_quant = dq
                self._draft_params = (
                    quantize_params(raw_params, template, dq)
                    if dq.enabled else self.params)
            self._draft_step = steps_mod.make_draft_step(
                cfg, max_len, page_size, self.speculative, paged_attn)
            self._verify_step = steps_mod.make_speculative_verify_step(
                cfg, max_len, page_size, self.speculative, paged_attn)
        if verify:
            self._verify_lane_safety()
        # batched prefill needs position-masked padding: attention
        # families on the ragged path (paged or ring); recurrent families
        # and the per-row path prefill one slot at a time
        self._batched_prefill = paged_capable
        if kv_mode == "paged":
            self._decode_step = steps_mod.make_paged_ragged_serve_step(
                cfg, max_len, page_size, paged_attn)
            self._prefill_step = steps_mod.make_paged_prefill_step(
                cfg, page_size)
        else:
            self._decode_step = steps_mod.make_ragged_serve_step(
                cfg, max_len)
            if self._batched_prefill:
                self._prefill_step = steps_mod.make_batched_prefill_step(
                    cfg, max_len, self._kv_bits)
        self.cache = self._init_cache()
        self._gen = torch.Generator(device=self.device).manual_seed(
            seed ^ 0x5EED)
        self.clock = clock if clock is not None else time.monotonic
        self.max_queue = max_queue
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)
        self.slot_next = np.zeros(max_batch, np.int32)
        self.active = np.zeros(max_batch, bool)
        self.finished: list[Request] = []
        self.prefix_retain = (
            int(prefix_retain) if prefix_retain and self.prefix_sharing
            else 0
        )
        self._allocator = PageAllocator(num_pages,
                                        retain_limit=self.prefix_retain)
        self._allocator.on_evict = self._deregister
        self.page_table = np.full((max_batch, self.pages_per_slot), -1,
                                  np.int32)
        self.slot_pages = np.zeros(max_batch, np.int32)     # allocated count
        self.slot_reserved = np.zeros(max_batch, np.int32)  # growth pages
        self._slot_seq = np.zeros(max_batch, np.int64)      # admission order
        self._seq_counter = 0
        # prefix index: token-prefix bytes through a FULL block -> page,
        # plus the reverse maps for deregistration and COW tail matching
        self._prefix_index: dict[bytes, int] = {}
        self._page_key: dict[int, bytes] = {}
        self._page_parent: dict[int, bytes] = {}
        self._page_block: dict[int, np.ndarray] = {}
        self._prefix_children: dict[bytes, set] = {}
        self._prefix_ready: set[int] = set()  # KV written on device
        self.stats = {
            "decode_steps": 0,          # ragged decode invocations
            "prefill_calls": 0,         # batched prefill invocations
            "prefill_tokens_real": 0,   # unshared prompt tokens they took
            "prefill_tokens_computed": 0,  # their rows x bucket, padding in
            "per_row_prefill_calls": 0,  # per-row path: one a request
            "per_row_forward_calls": 0,  # per-row path: one a slot a tick
            "page_grants": 0,           # incremental mid-decode page allocs
            "prefix_hits": 0,           # pages mapped shared at admission
            "prefix_tokens_saved": 0,   # prompt tokens prefill skipped
            "retained_hits": 0,         # refcount-0 retained pages revived
            "cow_forks": 0,             # copy-on-write page copies
            "spec_ticks": 0,            # speculative draft+verify ticks
            "draft_proposed": 0,        # draft tokens offered to verify
            "draft_accepted": 0,        # draft tokens that became output
            "preemptions": 0,           # slots preempted for recompute
            "oop_retired": 0,           # slots truncated on pool exhaustion
            "rejected": 0,              # requests refused before prefill
            "rejected_queue_full": 0,   # subset of rejected: queue bound
            "tick_budget_exhausted": 0,  # stragglers errored at max_ticks
            "peak_pages_used": 0,       # max pages with refcount > 0
        }

    def _verify_lane_safety(self):
        """Certify every (QuantConfig, reduction depth) the packed weights
        accumulate over, the target's and (when speculative) a separately
        packed draft's; raises ``LaneSafetyError`` on an unsafe one."""
        checks = []
        if self.quant.enabled:
            checks.append((self.quant, self.params))
        dq = getattr(self, "draft_quant", None)
        if (
            self.speculative
            and dq is not None
            and dq.enabled
            and dq is not self.quant
        ):
            checks.append((dq, self._draft_params))
        for qcfg, tree in checks:
            for k in contracts.packed_reduction_depths(tree):
                contracts.assert_safe(contracts.check_matmul_config(qcfg, k))

    def _init_cache(self):
        if self.kv_mode == "paged":
            return init_paged_cache(self.cfg, self.num_pages,
                                    self.page_size, kv_bits=self._kv_bits,
                                    device=self.device)
        return init_cache(self.cfg, self.max_batch, self.max_len,
                          kv_bits=self._kv_bits, device=self.device)

    def kv_cache_bytes(self) -> int:
        """Resident bytes of the KV cache and recurrent state (the page
        pool, scratch page included, or the ring and states)."""
        return sum(t.numel() * t.element_size()
                   for t in _leaves(self.cache))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- prefix index ------------------------------------------------------
    def _written_tokens(self, i: int) -> np.ndarray:
        """Tokens written at positions 0..slot_pos-1 of slot ``i``: the
        prompt plus every generated token but the last (sampled, written
        by the NEXT tick), so ``slot_pos == len(prompt) + len(generated)
        - 1`` for every active slot."""
        req = self.slots[i]
        toks = np.asarray(req.prompt, np.int32)
        if req.generated:
            toks = np.concatenate(
                [toks, np.asarray(req.generated[:-1], np.int32)])
        assert len(toks) == int(self.slot_pos[i]), (len(toks), i)
        return toks

    @staticmethod
    def _eff_prompt(req: Request) -> np.ndarray:
        """The tokens this admission makes resident: the prompt, or on
        recompute-resume the prompt + already-generated tokens."""
        src = (
            req.resume_prompt
            if req.resume_prompt is not None
            else req.prompt
        )
        return np.asarray(src, np.int32)

    def _register_block(self, eff: np.ndarray, b: int, page: int) -> bool:
        """Index full block ``b`` of ``eff`` (its page now holds it). Keys
        are the raw token-prefix bytes THROUGH the block, so a hit means
        the donor's whole history matches. False if already indexed."""
        ps = self.page_size
        key = eff[: (b + 1) * ps].tobytes()
        if key in self._prefix_index:
            return False
        parent = eff[: b * ps].tobytes()
        self._prefix_index[key] = page
        self._page_key[page] = key
        self._page_parent[page] = parent
        self._page_block[page] = eff[b * ps:(b + 1) * ps].copy()
        self._prefix_children.setdefault(parent, set()).add(page)
        return True

    def _deregister(self, freed_pages) -> None:
        """Drop index entries for pages whose refcount reached zero."""
        for p in freed_pages:
            key = self._page_key.pop(p, None)
            self._prefix_ready.discard(p)
            if key is None:
                continue
            if self._prefix_index.get(key) == p:
                del self._prefix_index[key]
            parent = self._page_parent.pop(p)
            kids = self._prefix_children.get(parent)
            if kids is not None:
                kids.discard(p)
                if not kids:
                    del self._prefix_children[parent]
            self._page_block.pop(p, None)

    def _match_prefix(self, eff: np.ndarray):
        """Match ``eff``'s leading blocks against resident pages. Returns
        (shared full-block pages, COW fork source or None, prefill
        start); at least one token is always left to prefill."""
        t, ps = len(eff), self.page_size
        shared: list = []
        if not self.prefix_sharing or t == 0:
            return shared, None, 0
        m_max = (t - 1) // ps
        while len(shared) < m_max:
            page = self._prefix_index.get(
                eff[: (len(shared) + 1) * ps].tobytes())
            if page is None:
                break
            shared.append(page)
        m = len(shared)
        fork_src = None
        if m == m_max:
            # a resident block extending the chain whose first r tokens
            # equal the remaining tail; only fork-ready pages (the copy
            # reads the device pool now)
            r = t - m * ps
            tail = eff[m * ps: t]
            for page in self._prefix_children.get(
                    eff[: m * ps].tobytes(), ()):
                if page in self._prefix_ready and np.array_equal(
                        self._page_block[page][:r], tail):
                    fork_src = page
                    break
        start = (t - 1) if fork_src is not None else m * ps
        return shared, fork_src, start

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue ``req``, or reject it with ``error`` set when
        ``max_queue`` requests already wait."""
        if req.t_submit is None:
            req.t_submit = self.clock()
        if (self.max_queue is not None
                and len(self.queue) >= self.max_queue):
            self.stats["rejected_queue_full"] += 1
            self._reject(
                req,
                f"queue full ({len(self.queue)} waiting, "
                f"max_queue={self.max_queue})",
            )
            return
        self.queue.append(req)

    def _reject(self, req: Request, reason: str):
        req.error = reason
        if req.t_retire is None:
            req.t_retire = self.clock()
        self.finished.append(req)
        self.stats["rejected"] += 1

    def _paged_bind(self, slot: int, req: Request, eff: np.ndarray,
                    pending_ready: list):
        """Bind one request's pages to ``slot``: map shared prefix hits,
        COW-fork a matching partial tail, allocate the rest (plus the
        growth reservation). Returns ("ok", prefill_start), ("wait", 0)
        on pool pressure or ("reject", 0) if infeasible."""
        ps = self.page_size
        t = len(eff)
        blocks = max(1, -(-t // ps))
        shared, fork_src, start = self._match_prefix(eff)
        m = len(shared)
        # worst-case growth: a fresh request's first token comes from
        # prefill without a write, so writes reach len + max_tokens - 2; a
        # resumed request also writes its stored last token
        gen_left = req.max_tokens - len(req.generated)
        future = gen_left - (0 if req.resume_prompt is not None else 1)
        horizon_tok = min(t + future, self.max_len)
        horizon = max(blocks, -(-horizon_tok // ps))
        reserve = horizon - blocks if self.admission == "reserve" else 0
        if blocks + reserve > self.num_pages:
            self._reject(
                req,
                f"request needs {blocks + reserve} KV pages; "
                f"pool holds {self.num_pages}",
            )
            return "reject", 0
        # take the shared refs BEFORE the alloc: the alloc may evict
        # retained pages, and none of them may be a hit we map
        retained_hits = 0
        for b, pg in enumerate(shared):
            if self._allocator.is_retained(pg):
                self._allocator.revive(pg)
                retained_hits += 1
            else:
                self._allocator.share(pg)
            self.page_table[slot, b] = pg
        pages = self._allocator.alloc(blocks - m, reserve=reserve)
        if pages is None:
            if shared:
                self._deregister(self._allocator.release(
                    shared, retain=self.prefix_retain > 0))
                self.page_table[slot, :m] = -1
            return "wait", 0
        self.stats["retained_hits"] += retained_hits
        nxt = m
        if fork_src is not None:
            # COW fork: the prefill write at t-1 lands inside this shared
            # block, so the holder gets a private copy first
            dst = pages[0]
            copy_paged_page(self.cache, fork_src, dst)
            self.page_table[slot, m] = dst
            self.stats["cow_forks"] += 1
            pages = pages[1:]
            nxt = m + 1
        for j, pg in enumerate(pages):
            self.page_table[slot, nxt + j] = pg
        self.slot_pages[slot] = blocks
        self.slot_reserved[slot] = reserve
        if start:
            self.stats["prefix_hits"] += m + (fork_src is not None)
            self.stats["prefix_tokens_saved"] += start
        if self.prefix_sharing:
            # newly registered blocks are pages this batch's prefill is
            # about to write; they become fork-ready after the prefill
            for b in range(t // ps):
                page = int(self.page_table[slot, b])
                if self._register_block(eff, b, page):
                    pending_ready.append(page)
        self._note_peak()
        return "ok", start

    def _admit(self):
        if not self.queue:
            return
        with tracing.span("engine.admit") as sp:
            taken = self._admit_batches()
            if sp:
                sp.set(requests=taken)

    def _admit_batches(self) -> int:
        """Bind and prefill queued requests while slots are free; returns
        the requests taken."""
        taken = 0
        while self.queue:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                return taken
            batch: list[Request] = []
            batch_slots: list[int] = []
            batch_effs: list[np.ndarray] = []
            batch_starts: list[int] = []
            pending_ready: list[int] = []
            stalled = False
            while self.queue and len(batch) < len(free):
                req = self.queue.popleft()
                eff = self._eff_prompt(req)
                if len(eff) >= self.max_len:
                    self._reject(
                        req,
                        f"prompt length {len(eff)} >= max_len "
                        f"{self.max_len}",
                    )
                    continue
                slot = free[len(batch)]
                start = 0
                if self.kv_mode == "paged":
                    status, start = self._paged_bind(slot, req, eff,
                                                     pending_ready)
                    if status == "wait":
                        self.queue.appendleft(req)
                        stalled = True
                        break
                    if status == "reject":
                        continue
                batch.append(req)
                batch_slots.append(slot)
                batch_effs.append(eff)
                batch_starts.append(start)
            if not batch:
                return taken
            taken += len(batch)
            if self._batched_prefill:
                self._prefill_batch(batch_slots, batch, batch_effs,
                                    batch_starts)
                self._prefix_ready.update(
                    p for p in pending_ready if p in self._page_key)
            else:
                for slot, req in zip(batch_slots, batch):
                    self._prefill_one(slot, req)
            if stalled:
                return taken
        return taken

    def _prefill_batch(self, slots: list[int], reqs: list[Request],
                       effs: list[np.ndarray], starts: list[int]):
        """Admit N requests with ONE forward over N rows, a row per
        request in admission order: each row carries its UNSHARED
        suffix, right-padded to a shared bucket, written at positions
        ``start..len-1`` through its slot's page table (paged), or its
        whole prompt into a fresh N-row ring whose rows then replace
        their slots' rows (ring)."""
        lens = np.array([len(e) - s for e, s in zip(effs, starts)], np.int64)
        lb = _bucket_len(int(lens.max()), self.max_len)
        nb = len(reqs)
        tokens = np.zeros((nb, lb), np.int64)
        for row, (eff, st) in enumerate(zip(effs, starts)):
            tokens[row, :lens[row]] = eff[st:]
        tokens_t = self._to_device(tokens)
        lens_t = self._to_device(lens)
        if self.kv_mode == "paged":
            # table truncated to the batch's used page columns (pow2
            # bucket), covering the shared prefix blocks the suffix
            # attends to
            max_blocks = max(-(-len(e) // self.page_size) for e in effs)
            width = self._pow2_width(max_blocks)
            args = (self.params, tokens_t, lens_t,
                    self._to_device(np.array(starts, np.int64)),
                    self._to_device(self.page_table[slots, :width]),
                    self.cache, self._gen, self.temperature)
        else:
            args = (self.params, tokens_t, lens_t,
                    self._to_device(np.array(slots, np.int64)), self.cache,
                    self._gen, self.temperature)
        with tracing.span("engine.prefill", device=True) as sp:
            tok0 = self._prefill_step(*args)
        real = int(lens.sum())
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens_real"] += real
        self.stats["prefill_tokens_computed"] += nb * lb
        if sp:
            self._trace_prefill(sp, reqs, rows=nb, bucket=lb, real=real,
                                shared=sum(starts))
        with tracing.span("engine.sync"):
            tok0 = tok0.cpu().numpy()
        for row, (slot, req) in enumerate(zip(slots, reqs)):
            self._finish_admit(slot, req, effs[row], int(tok0[row]))

    def _prefill_one(self, slot: int, req: Request):
        """Exact-length prefill of one request into its slot's row of the
        ring and recurrent state (recurrent families and the per-row
        path). The row is reset first, so the previous occupant's state,
        K/V and positions cannot leak."""
        eff = self._eff_prompt(req)
        fresh = init_cache(self.cfg, 1, self.max_len, kv_bits=self._kv_bits,
                           device=self.device)
        for c, new in zip(_leaves(self.cache), _leaves(fresh)):
            c[slot:slot + 1] = new
        row_cache = _row_views(self.cache, slot)
        tokens = self._to_device(eff.astype(np.int64))[None]
        with tracing.span("engine.prefill", device=True) as sp:
            logits = forward(self.params, tokens, self.cfg, cache=row_cache,
                             cache_index=0)
        self.stats["per_row_prefill_calls"] += 1
        if sp:
            self._trace_prefill(sp, [req], rows=1, bucket=len(eff),
                                real=len(eff), shared=0)
        with tracing.span("engine.sync"):
            tok0 = int(steps_mod.sample_tokens(logits[:, -1], self._gen,
                                               self.temperature)[0])
        self._finish_admit(slot, req, eff, tok0)

    @staticmethod
    def _trace_prefill(sp, reqs: list, **attrs) -> None:
        """A traced prefill's attributes, and for each request it admits
        the first time its wait in the queue: a ``request.queue`` span
        from its submission to the start of this prefill."""
        sp.set(rids=[int(r.rid) for r in reqs], **attrs)
        for r in reqs:
            if r.t_admit is None and r.t_submit is not None:
                tracing.record("request.queue", r.t_submit, sp.t0,
                               parent=sp.id, rid=int(r.rid))

    def _finish_admit(self, slot: int, req: Request, eff: np.ndarray,
                      tok0: int):
        """Prefill's last logits give the FIRST generated token. A resumed
        request discards that sample and continues from its stored last
        token."""
        prompt_len = len(eff)
        if req._seq < 0:
            self._seq_counter += 1
            req._seq = self._seq_counter
        if req.t_admit is None:  # resume keeps the first admission stamp
            req.t_admit = self.clock()
        if req.resume_prompt is not None:
            req.resume_prompt = None
            self.slots[slot] = req
            self.slot_pos[slot] = prompt_len
            self.slot_next[slot] = req.generated[-1]
            self.active[slot] = True
            self._slot_seq[slot] = req._seq
            return
        req.generated.append(tok0)
        if req.t_first_token is None:
            req.t_first_token = self.clock()
        if req.done:
            self._release_pages(slot)
            req.t_retire = self.clock()
            self.finished.append(req)
            return
        self.slots[slot] = req
        self.slot_pos[slot] = prompt_len
        self.slot_next[slot] = tok0
        self.active[slot] = True
        self._slot_seq[slot] = req._seq

    # -- paged allocation --------------------------------------------------
    def _note_peak(self):
        used = self._allocator.held_pages
        if used > self.stats["peak_pages_used"]:
            self.stats["peak_pages_used"] = used

    def _release_pages(self, slot: int):
        """Drop every page reference ``slot`` holds and cancel its unused
        reservation; with retention, last-reference indexed pages park in
        the LRU pool instead of freeing. Nothing to do for the ring."""
        if self.kv_mode != "paged":
            return
        held = self.page_table[slot][self.page_table[slot] >= 0]
        if held.size:
            if self.prefix_retain > 0:
                indexed = [int(p) for p in held if int(p) in self._page_key]
                rest = [int(p) for p in held
                        if int(p) not in self._page_key]
                freed = self._allocator.release(indexed, retain=True)
                freed += self._allocator.release(rest)
            else:
                freed = self._allocator.release(held)
            self._deregister(freed)
        if self.slot_reserved[slot]:
            self._allocator.cancel_reservation(int(self.slot_reserved[slot]))
        self.page_table[slot] = -1
        self.slot_pages[slot] = 0
        self.slot_reserved[slot] = 0

    def _retire_slot(self, i: int, req: Request):
        self._release_pages(i)
        if req.t_retire is None:
            req.t_retire = self.clock()
        self.finished.append(req)
        self.slots[i] = None
        self.active[i] = False

    def _preempt(self, j: int):
        """Release slot ``j``'s pages and re-queue its request for
        recompute-resume (its written tokens become the re-prefill
        prompt)."""
        req = self.slots[j]
        req.resume_prompt = self._written_tokens(j)
        self._release_pages(j)
        self.slots[j] = None
        self.active[j] = False
        self.queue.appendleft(req)
        self.stats["preemptions"] += 1

    def _alloc_or_preempt(self, i: int) -> Optional[int]:
        """One page for slot ``i``'s next write; under pool pressure
        preempt the YOUNGEST resident request until a page frees or ``i``
        itself is the victim. A request alone in a dry pool is retired
        truncated. Returns the page, or None if ``i`` no longer needs
        it."""
        while True:
            pages = self._allocator.alloc(1)
            if pages is not None:
                return pages[0]
            active = np.nonzero(self.active)[0]
            if len(active) <= 1:
                req = self.slots[i]
                req.truncated = True
                self._retire_slot(i, req)
                self.stats["oop_retired"] += 1
                return None
            victim = max(active, key=lambda j: self._slot_seq[j])
            self._preempt(int(victim))
            if victim == i:
                return None

    def _claim_reserved_page(self, i: int) -> Optional[int]:
        """One page from slot ``i``'s growth reservation, or None if it has
        none left (the admission horizon covers every write the request
        can make, speculative lookahead included)."""
        if self.slot_reserved[i] <= 0:
            return None
        page = self._allocator.claim_reserved(1)[0]
        self.slot_reserved[i] -= 1
        return page

    def _bind_next_page(self, i: int, page: int) -> None:
        """Append ``page`` as slot ``i``'s next block: the one place plain
        and lookahead grants do their bookkeeping."""
        blk = int(self.slot_pages[i])
        self.page_table[i, blk] = page
        self.slot_pages[i] = blk + 1
        self.stats["page_grants"] += 1

    def _grant_pages(self):
        """Before the tick's write at ``slot_pos[i]``, make sure the page
        covering it exists and is held by ``i`` alone (COW forks happen
        at admission, so the cursor's page is never shared). Returns the
        pages granted."""
        granted = 0
        for i in np.nonzero(self.active)[0]:
            if not self.active[i]:
                continue  # preempted while serving an earlier grant
            block = int(self.slot_pos[i]) // self.page_size
            if block < int(self.slot_pages[i]):
                page = int(self.page_table[i, block])
                assert self._allocator.refcount[page] == 1, (
                    "write cursor reached a shared page", i, block, page)
                continue
            page = self._claim_reserved_page(int(i))
            if page is None:
                page = self._alloc_or_preempt(int(i))
                if page is None:
                    continue
            self._bind_next_page(int(i), page)
            granted += 1
        self._note_peak()
        return granted

    def _spec_lens(self) -> np.ndarray:
        """Per-slot draft budgets for this tick, with lookahead grants:
        the verify writes positions ``pos..pos + spec_len[i]``, so every
        page covering that span must exist first. The budget is capped
        by K, the request's remaining tokens, the cache end and what the
        pool can grant WITHOUT preempting (lookahead never evicts a
        resident request)."""
        ps = self.page_size
        spec = np.zeros(self.max_batch, np.int32)
        for i in np.nonzero(self.active)[0]:
            req = self.slots[i]
            pos = int(self.slot_pos[i])
            want = max(0, min(self.speculative,
                              req.max_tokens - len(req.generated) - 1,
                              self.max_len - 1 - pos))
            last_block = (pos + want) // ps
            while int(self.slot_pages[i]) <= last_block:
                page = self._claim_reserved_page(int(i))
                if page is None:
                    got = self._allocator.alloc(1)  # lookahead: no preempt
                    if got is None:
                        break
                    page = got[0]
                self._bind_next_page(int(i), page)
            cap = int(self.slot_pages[i]) * ps - 1 - pos
            spec[i] = min(want, max(0, cap))
        self._note_peak()
        return spec

    def _pow2_width(self, pages: int) -> int:
        """Page-table width covering ``pages``: next power of two, capped
        at pages_per_slot."""
        width = 1
        while width < max(1, pages):
            width *= 2
        return min(width, self.pages_per_slot)

    def _active_table(self) -> np.ndarray:
        """Page table truncated to the columns in use this tick (pow2
        bucket): decode attention then scales with the pages slots hold.
        Dropped columns are unallocated or past every write cursor."""
        width = self._pow2_width(int(self.slot_pages.max()))
        return self.page_table[:, :width]

    # -- decode ------------------------------------------------------------
    def _advance_slot(self, i: int, tok: int) -> bool:
        """Consume one generated token for slot ``i``: append, advance
        the cursor, index a page the cursor just completed, and retire
        the slot when done or out of cache. True if it retired."""
        req = self.slots[i]
        req.generated.append(tok)
        self.slot_pos[i] += 1
        self.slot_next[i] = tok
        pos = int(self.slot_pos[i])
        ps = self.page_size
        if self.prefix_sharing and pos % ps == 0:
            b = pos // ps - 1
            page = int(self.page_table[i, b])
            if page >= 0 and self._register_block(
                    self._written_tokens(i), b, page):
                self._prefix_ready.add(page)
        if req.done or pos >= self.max_len:
            if not req.done:
                req.truncated = True
            self._retire_slot(i, req)
            return True
        return False

    def step(self):
        """One engine tick: admit, grant pages, ONE ragged decode step (or
        one speculative draft + verify), retire. Returns False when there
        was nothing to decode."""
        with tracing.span("engine.step") as sp:
            return self._step(sp)

    def _step(self, sp) -> bool:
        self._admit()
        if sp:
            sp.set(active=int(self.active.sum()))
        if not self.active.any():
            return False
        if self.kv_mode == "paged":
            with tracing.span("engine.grant_pages") as gp:
                granted = self._grant_pages()
                if gp:
                    gp.set(pages=granted)
            if not self.active.any():
                return True  # progress: slots were preempted or retired
        if self.speculative:
            return self._step_speculative()
        if self.decode_mode == "ragged":
            args = [
                self.params,
                self._to_device(self.slot_next[:, None].astype(np.int64)),
                self.cache, self._to_device(self.slot_pos),
                self._to_device(self.active),
            ]
            if self.kv_mode == "paged":
                args.append(self._to_device(self._active_table()))
            with tracing.span("engine.decode", device=True) as dp:
                next_ids = self._decode_step(*args, self._gen,
                                             self.temperature)
            self.stats["decode_steps"] += 1
            if dp:
                dp.set(**self._decode_attrs(speculative=False))
            with tracing.span("engine.sync"):
                next_ids = next_ids.cpu().numpy()  # the one host sync per tick
        else:
            next_ids = self._decode_rows_reference()
        with tracing.span("engine.advance") as ap:
            retired = 0
            for i in np.nonzero(self.active)[0]:
                retired += self._advance_slot(int(i), int(next_ids[i]))
            if ap:
                ap.set(retired=retired)
        return True

    def _decode_attrs(self, speculative: bool) -> dict:
        """A traced decode step's attributes: its active rows, the keys
        they attend to (each row's position + 1) and, paged, the distinct
        pages they read and the page slots read, a page several rows read
        counted once at the most slots any row reads of it."""
        rows = np.nonzero(self.active)[0]
        ctx = self.slot_pos[rows].astype(np.int64) + 1
        attrs = {"rows": len(rows), "context_tokens": int(ctx.sum()),
                 "speculative": speculative}
        if self.kv_mode == "paged" and len(rows):
            ps = self.page_size
            blocks = -(-ctx // ps)
            pages = np.concatenate([self.page_table[r, :n]
                                    for r, n in zip(rows, blocks)])
            slots = np.concatenate([np.minimum(ps, c - ps * np.arange(n))
                                    for c, n in zip(ctx, blocks)])
            order = np.lexsort((slots, pages))
            pages, slots = pages[order], slots[order]
            last = np.append(pages[1:] != pages[:-1], True)
            attrs["pages"] = int(last.sum())
            attrs["kv_slots"] = int(slots[last].sum())
        return attrs

    def _step_speculative(self) -> bool:
        """One speculative tick: grant lookahead pages (``spec_len`` [B]
        caps each slot's draft budget, 0..K, so slots near their token
        budget, the cache end or an ungranted page degrade to one-token
        decode), the draft step then the verify step, then consume each
        slot's accepted run plus the verify's own token one at a time,
        stopping where the slot retires. KV the verify wrote past the
        accepted run is overwritten by the next tick's window before any
        query reads it."""
        with tracing.span("engine.grant_pages") as gp:
            granted = self.stats["page_grants"]
            spec_len = self._spec_lens()
            if gp:
                gp.set(pages=self.stats["page_grants"] - granted)
        tokens = self._to_device(self.slot_next[:, None].astype(np.int64))
        pos = self._to_device(self.slot_pos)
        table = self._to_device(self._active_table())
        with tracing.span("engine.decode", device=True) as dp:
            draft_tok, draft_lg = self._draft_step(
                self._draft_params, tokens, self.cache, pos, table,
                self._gen, self.temperature)
            out, n_acc = self._verify_step(
                self.params, tokens, draft_tok, draft_lg, self.cache, pos,
                self._to_device(self.active), table,
                self._to_device(spec_len), self._gen, self.temperature)
        self.stats["decode_steps"] += 1
        self.stats["spec_ticks"] += 1
        if dp:
            dp.set(**self._decode_attrs(speculative=True))
        with tracing.span("engine.sync"):
            out = out.cpu().numpy()  # the one host sync per tick
            n_acc = n_acc.cpu().numpy()
        with tracing.span("engine.advance") as ap:
            retired = 0
            for i in np.nonzero(self.active)[0]:
                self.stats["draft_proposed"] += int(spec_len[i])
                used = 0
                for m in range(int(n_acc[i]) + 1):
                    used = m + 1
                    if self._advance_slot(int(i), int(out[i, m])):
                        retired += 1
                        break
                # drafts count as accepted only when they became output:
                # a slot retiring mid-run discards the rest of its run
                self.stats["draft_accepted"] += min(used, int(n_acc[i]))
            if ap:
                ap.set(retired=retired)
        return True

    def _decode_rows_reference(self) -> np.ndarray:
        """The per-row reference decode: one ``forward`` per active slot
        over a view of its ring row, written at its own column. The
        equivalence baseline; never used by ``decode_mode="ragged"``."""
        out = np.full(self.max_batch, -1, np.int64)
        for i in range(self.max_batch):
            if not self.active[i]:
                continue
            row_cache = _row_views(self.cache, i)
            pos = int(self.slot_pos[i])
            lg = forward(
                self.params,
                self._to_device(self.slot_next[i:i + 1, None].astype(
                    np.int64)),
                self.cfg, positions=self._to_device(
                    self.slot_pos[i:i + 1, None].astype(np.int64)),
                cache=row_cache, cache_index=pos)
            self.stats["per_row_forward_calls"] += 1
            out[i] = int(steps_mod.sample_tokens(lg[:, -1], self._gen,
                                                 self.temperature)[0])
        return out

    def run_to_completion(self, max_ticks: int = 10_000):
        """Tick until every submitted request retired, or ``max_ticks``;
        stragglers are then retired with ``error="tick budget
        exhausted"`` (in-flight ones keep their partial tokens)."""
        ticks = 0
        while (
            self.queue or any(s is not None for s in self.slots)
        ) and ticks < max_ticks:
            self.step()
            ticks += 1
        if self.queue or any(s is not None for s in self.slots):
            reason = "tick budget exhausted"
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                req.error = reason
                self.stats["tick_budget_exhausted"] += 1
                self._retire_slot(i, req)
            while self.queue:
                req = self.queue.popleft()
                req.error = reason
                self.stats["tick_budget_exhausted"] += 1
                if req.t_retire is None:
                    req.t_retire = self.clock()
                self.finished.append(req)
        return self.finished

    def reset(self):
        """Clear every request, slot, page and counter, and start a fresh
        KV pool; the steps and weights stay (benchmark warm-up, then a
        measured run without building anything again)."""
        self.cache = self._init_cache()
        self.queue.clear()
        self.slots = [None] * self.max_batch
        self.slot_pos[:] = 0
        self.slot_next[:] = 0
        self.active[:] = False
        self.finished = []
        self._allocator.reset()
        self.page_table[:] = -1
        self.slot_pages[:] = 0
        self.slot_reserved[:] = 0
        self._slot_seq[:] = 0
        self._seq_counter = 0
        self._prefix_index.clear()
        self._page_key.clear()
        self._page_parent.clear()
        self._page_block.clear()
        self._prefix_children.clear()
        self._prefix_ready.clear()
        for k in self.stats:
            self.stats[k] = 0
