"""Asyncio serving front door: SLO-aware admission over the tick engine
(the port's copy of ``repro/serving/server.py``: the same constructor,
rejection codes, counters and snapshot names, over the port's engine).

``ServingEngine`` is a synchronous tick machine — ``submit`` then
``step`` until done. This module wraps it in the request-level surface a
deployment actually exposes:

* **Bounded admission queue + pluggable scheduling** — requests wait in
  the SERVER's queue (not the engine's) and a
  :class:`~repro_torch.serving.scheduler.SchedulingPolicy` picks which
  one
  takes the next free decode slot: ``fifo`` (arrival order) or ``slo``
  (earliest-deadline-first with a bounded-wait anti-starvation
  guarantee — see scheduler.py).
* **Deadline-aware admission** — before accepting, the request's page
  and compute cost is PRICED through the analytic cost model
  (``launch/analytic_costs.cell_cost``): an infeasible request (prompt
  >= max_len, or more KV pages than the whole pool) is refused up
  front, and — when the server knows its calibrated capacity — a
  request whose predicted completion (backlog + its own service time)
  lands past its deadline is refused AT ADMISSION instead of queueing
  toward a guaranteed SLO miss.
* **Explicit backpressure** — every refusal raises
  :class:`RejectedRequest` with a machine-readable ``code``
  (``queue_full`` / ``infeasible`` / ``slo``) and a human-readable
  ``detail``; nothing ever queues unboundedly.
* **Per-token streaming** — ``submit`` returns a :class:`TokenStream`
  async iterator; the serve loop pushes each generated token the tick
  it appears.
* **Observability** — the engine stamps per-request timestamps
  (arrival, admit, first token, retire); the server aggregates them
  into TTFT/TPOT/e2e histograms and renders a Prometheus-style text
  snapshot (``metrics_snapshot``) on top of the engine's ``.stats``
  counters and page-pool gauges. For a stretch of spans, call
  ``repro_torch.tracing.enable(server.clock)`` and later
  ``tracing.collect()``: the tick (``server.tick``, ``server.publish``)
  and the engine's phases under it, each request's wait in the queue,
  each kernel launch counted by shape; given a profiler's events,
  ``collect`` also puts the spans on the device trace's clock and the
  device's idle time down to them.

The engine tick itself runs via ``asyncio.to_thread`` by default
(``step_in_thread=True``), as in the reference, so arrivals can be taken
while a step computes. Unlike the reference's compiled steps, the port's
step dispatches its forward op by op from Python and holds the
interpreter for most of the tick; the event loop runs only where the
step releases it (kernel launches, the host read of the tokens), so a
submit can land late against its arrival. Everything else happens on the
event loop — there is no lock: server state is only touched between
awaits, and the engine only inside the step or between ticks. An
exception in the step propagates out of the serve task (``stop()``
re-raises it); streams still open then never finish, so a caller bounds
its waits (``asyncio.wait_for``).

Usage::

    server = AsyncServer(engine, policy="slo", max_queue=64,
                         capacity_tokens_per_s=measured,
                         default_slo_s=0.2)
    await server.start()
    try:
        stream = server.submit(prompt, max_tokens=16)   # may raise
        async for tok in stream:
            ...
    except RejectedRequest as rej:
        handle(rej.code, rej.detail)
    await server.stop()
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch import tracing
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.analytic_costs import cell_cost
from repro_torch.serving import metrics as metrics_mod
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import QueueEntry, make_policy

# machine-readable rejection codes (the backpressure contract)
REJECT_QUEUE_FULL = "queue_full"
REJECT_INFEASIBLE = "infeasible"
REJECT_SLO = "slo"


class RejectedRequest(Exception):
    """Admission refusal: ``code`` is machine-readable (one of
    ``queue_full`` / ``infeasible`` / ``slo``), ``detail`` is for
    humans, ``request`` carries the priced-but-refused Request (its
    ``error`` field holds ``"<code>: <detail>"``)."""

    def __init__(self, code: str, detail: str, request: Request):
        self.code = code
        self.detail = detail
        self.request = request
        super().__init__(f"{code}: {detail}")

    def as_dict(self) -> dict:
        return {"code": self.code, "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class RequestCost:
    """Analytic admission price of one request (``price_request``)."""

    pages: int                    # KV pages at the decode horizon
    prefill_flops: float
    decode_flops_per_token: float
    hbm_bytes: float              # prefill + decode traffic estimate
    work_tokens: float            # decode-token equivalents incl prefill
    service_s: Optional[float]    # None when capacity is uncalibrated


def price_request(cfg, quant, prompt_len: int, max_tokens: int, *,
                  page_size: int, max_len: int,
                  capacity_tokens_per_s: Optional[float] = None,
                  ) -> RequestCost:
    """Price a request's page + compute cost through the analytic cost
    model BEFORE admission. The SAMD pitch — predictable per-bit-width
    throughput — is what makes this trustworthy enough to gate on:
    ``cell_cost`` already knows packed-weight byte traffic per bits.

    ``work_tokens`` converts the prefill into decode-token equivalents
    (prefill flops / per-token decode flops), so backlog accounting can
    use ONE unit; ``service_s`` divides by the calibrated aggregate
    decode rate when the server has one."""
    bits = quant.bits if (quant is not None and quant.enabled) else None
    kv_bits = (
        quant.kv_bits if (quant is not None and quant.enabled) else None
    )
    t = max(1, int(prompt_len))
    dec = cell_cost(cfg, ShapeConfig("admission", t, 1, "decode"),
                    bits, kv_bits)
    pre = cell_cost(cfg, ShapeConfig("admission", t, 1, "prefill"),
                    bits, kv_bits)
    horizon = min(prompt_len + max_tokens, max_len)
    pages = max(1, -(-horizon // page_size))
    work_tokens = max_tokens + pre.flops / dec.flops
    service_s = (
        work_tokens / capacity_tokens_per_s
        if capacity_tokens_per_s else None
    )
    return RequestCost(
        pages=pages,
        prefill_flops=pre.flops,
        decode_flops_per_token=dec.flops,
        hbm_bytes=pre.hbm_bytes + max_tokens * dec.hbm_bytes,
        work_tokens=work_tokens,
        service_s=service_s,
    )


_DONE = object()


class TokenStream:
    """Async iterator over one request's generated tokens. Iteration
    ends when the request retires — check ``request.error`` /
    ``request.truncated`` afterwards for the outcome. ``collect()``
    drains the stream into a list."""

    def __init__(self, req: Request, deadline_s: Optional[float] = None):
        self.request = req
        self.deadline_s = deadline_s
        self._queue: asyncio.Queue = asyncio.Queue()
        self._pushed = 0

    def _push_new(self) -> int:
        gen = self.request.generated
        n = len(gen) - self._pushed
        while self._pushed < len(gen):
            self._queue.put_nowait(gen[self._pushed])
            self._pushed += 1
        return n

    def _finish(self) -> None:
        self._queue.put_nowait(_DONE)

    def __aiter__(self):
        return self

    async def __anext__(self):
        tok = await self._queue.get()
        if tok is _DONE:
            raise StopAsyncIteration
        return tok

    async def collect(self) -> list:
        return [tok async for tok in self]


class AsyncServer:
    """The front door. One instance owns one engine; start() spawns the
    serve loop, submit() admits (or refuses) requests, stop() drains."""

    def __init__(self, engine: ServingEngine, *,
                 policy="slo",
                 max_queue: int = 64,
                 default_slo_s: Optional[float] = None,
                 capacity_tokens_per_s: Optional[float] = None,
                 starvation_s: Optional[float] = None,
                 clock=None,
                 step_in_thread: bool = True,
                 idle_sleep_s: float = 0.001):
        assert max_queue >= 0, max_queue
        self.engine = engine
        self.clock = clock if clock is not None else time.monotonic
        # ONE clock: the engine's per-request stamps must be directly
        # comparable with the server's arrival/deadline arithmetic
        engine.clock = self.clock
        self.max_queue = int(max_queue)
        self.default_slo_s = default_slo_s
        self.capacity_tokens_per_s = capacity_tokens_per_s
        if starvation_s is None:
            # default fairness bound: a few SLOs' worth of waiting, or
            # 1s when no SLO is configured
            starvation_s = (
                4.0 * default_slo_s if default_slo_s else 1.0
            )
        if isinstance(policy, str) and policy == "slo":
            self.policy = make_policy(policy, starvation_s=starvation_s)
        else:
            self.policy = make_policy(policy)
        self.step_in_thread = bool(step_in_thread)
        self.idle_sleep_s = float(idle_sleep_s)
        self._waiting: list[QueueEntry] = []
        self._inflight: dict[int, TokenStream] = {}  # id(req) -> stream
        self._finished_seen = 0    # cursor into engine.finished
        self._seq = 0
        self._task: Optional[asyncio.Task] = None
        self._stopping = False
        self._draining = True
        self.finished: list[Request] = []   # front-door-served requests
        self.counters = {
            "submitted": 0,
            "admitted": 0,
            "completed": 0,
            "deadline_missed": 0,
            "rejected_queue_full": 0,
            "rejected_infeasible": 0,
            "rejected_slo": 0,
            "rejected_engine": 0,
        }
        self.histograms = {
            "samd_request_ttft_seconds": metrics_mod.Histogram(),
            "samd_request_tpot_seconds": metrics_mod.Histogram(),
            "samd_request_e2e_seconds": metrics_mod.Histogram(),
        }

    # -- admission ---------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    def _backlog_tokens(self) -> float:
        """Decode-token-equivalent work ahead of a new arrival: every
        waiting entry's priced work plus the remaining decode budget of
        everything in flight (prefill already paid for those)."""
        work = sum(e.cost for e in self._waiting)
        for req in list(self.engine.queue) + self.engine.slots:
            if req is not None:
                work += max(0, req.max_tokens - len(req.generated))
        return work

    def _refuse(self, req: Request, code: str, detail: str):
        self.counters[f"rejected_{code}"] += 1
        req.error = f"{code}: {detail}"
        req.t_retire = self.clock()
        raise RejectedRequest(code, detail, req)

    def submit(self, prompt, max_tokens: int = 16, *,
               eos_id: Optional[int] = None,
               slo_s: Optional[float] = None,
               rid: Optional[int] = None) -> TokenStream:
        """Admit a request (returns its token stream) or raise
        :class:`RejectedRequest`. Synchronous on purpose: the accept /
        refuse decision happens AT submission, before any queueing.
        ``slo_s`` overrides the server default (None + no default =
        no deadline: the request is never slo-refused)."""
        now = self.clock()
        self.counters["submitted"] += 1
        self._seq += 1
        req = Request(
            rid=self._seq if rid is None else rid,
            prompt=np.asarray(prompt, np.int32),
            max_tokens=int(max_tokens),
            eos_id=eos_id,
        )
        req.t_submit = now
        slo = self.default_slo_s if slo_s is None else slo_s
        eng = self.engine
        if len(self._waiting) >= self.max_queue:
            self._refuse(
                req, REJECT_QUEUE_FULL,
                f"{len(self._waiting)} waiting >= max_queue "
                f"{self.max_queue}",
            )
        cost = price_request(
            eng.cfg, eng.quant, len(req.prompt), req.max_tokens,
            page_size=eng.page_size, max_len=eng.max_len,
            capacity_tokens_per_s=self.capacity_tokens_per_s,
        )
        if len(req.prompt) >= eng.max_len:
            self._refuse(
                req, REJECT_INFEASIBLE,
                f"prompt length {len(req.prompt)} >= max_len "
                f"{eng.max_len}",
            )
        if eng.kv_mode == "paged" and cost.pages > eng.num_pages:
            self._refuse(
                req, REJECT_INFEASIBLE,
                f"needs {cost.pages} KV pages; pool holds "
                f"{eng.num_pages}",
            )
        deadline = now + slo if slo is not None else None
        if deadline is not None and self.capacity_tokens_per_s:
            backlog = self._backlog_tokens() + cost.work_tokens
            eta = now + backlog / self.capacity_tokens_per_s
            if eta > deadline:
                self._refuse(
                    req, REJECT_SLO,
                    f"predicted completion +{eta - now:.3f}s exceeds "
                    f"deadline +{slo:.3f}s "
                    f"(backlog {backlog:.0f} token-equivalents at "
                    f"{self.capacity_tokens_per_s:.0f} tok/s)",
                )
        stream = TokenStream(req, deadline_s=deadline)
        self._waiting.append(QueueEntry(
            payload=stream, arrival_s=now, deadline_s=deadline,
            cost=cost.work_tokens, seq=self._seq,
        ))
        self.counters["admitted"] += 1
        return stream

    # -- serve loop --------------------------------------------------------
    async def start(self) -> None:
        assert self._task is None, "server already started"
        self._stopping = False
        self._task = asyncio.create_task(self._serve_loop())

    async def stop(self, drain: bool = True) -> None:
        """Stop the serve loop; ``drain=True`` (default) first serves
        everything already admitted or in flight."""
        self._stopping = True
        self._draining = drain
        if self._task is not None:
            await self._task
            self._task = None

    def _engine_busy(self) -> bool:
        eng = self.engine
        return bool(eng.queue) or any(
            s is not None for s in eng.slots
        )

    async def _serve_loop(self) -> None:
        while True:
            progressed = await self._tick()
            if self._stopping and (
                not self._draining
                or (not self._waiting and not self._engine_busy())
            ):
                return
            if progressed:
                await asyncio.sleep(0)     # let arrivals interleave
            else:
                await asyncio.sleep(self.idle_sleep_s)

    async def _tick(self) -> bool:
        """One front-door iteration: fill free decode slots from the
        policy queue, run one engine tick off-loop, publish tokens and
        retirements. Returns False when there was nothing to do."""
        eng = self.engine
        now = self.clock()
        free = sum(1 for s in eng.slots if s is None) - len(eng.queue)
        while self._waiting and free > 0:
            idx = self.policy.select(self._waiting, now)
            stream = self._waiting.pop(idx).payload
            self._inflight[id(stream.request)] = stream
            eng.submit(stream.request)
            free -= 1
        if not self._engine_busy():
            return False
        with tracing.span("server.tick") as sp:
            if sp:
                sp.set(waiting=len(self._waiting), free=free)
            if self.step_in_thread:
                await asyncio.to_thread(eng.step)
            else:
                eng.step()
            with tracing.span("server.publish") as pp:
                pushed = self._publish()
                if pp:
                    pp.set(tokens=pushed)
        return True

    def _publish(self) -> int:
        """Push this tick's new tokens into their streams and finalize
        retirements (runs on the event-loop thread). Returns the tokens
        pushed."""
        eng = self.engine
        pushed = 0
        for req in eng.slots:
            if req is not None:
                stream = self._inflight.get(id(req))
                if stream is not None:
                    pushed += stream._push_new()
        while self._finished_seen < len(eng.finished):
            req = eng.finished[self._finished_seen]
            self._finished_seen += 1
            stream = self._inflight.pop(id(req), None)
            if stream is None:
                continue  # not front-door traffic (direct engine use)
            pushed += stream._push_new()
            stream._finish()
            self.finished.append(req)
            if req.error is not None:
                # admitted here but refused by the engine (e.g. a race
                # on pool feasibility): surfaced via the stream's
                # request.error, counted separately from completions
                self.counters["rejected_engine"] += 1
                continue
            self.counters["completed"] += 1
            for name, fn in (
                ("samd_request_ttft_seconds", metrics_mod.ttft_s),
                ("samd_request_tpot_seconds", metrics_mod.tpot_s),
                ("samd_request_e2e_seconds", metrics_mod.e2e_s),
            ):
                v = fn(req)
                if v is not None:
                    self.histograms[name].observe(v)
            if (
                stream.deadline_s is not None
                and req.t_retire is not None
                and req.t_retire > stream.deadline_s
            ):
                self.counters["deadline_missed"] += 1
        return pushed

    # -- observability -----------------------------------------------------
    def metrics_snapshot(self) -> str:
        """Prometheus-style text snapshot: front-door counters, engine
        tick counters (``.stats``), page-pool and queue gauges, and the
        TTFT/TPOT/e2e histograms."""
        eng = self.engine
        counters = {
            f"samd_server_{k}_total": v
            for k, v in self.counters.items()
        }
        for k, v in eng.stats.items():
            if k != "peak_pages_used":
                counters[f"samd_engine_{k}_total"] = v
        gauges = {
            "samd_server_queue_depth": len(self._waiting),
            "samd_engine_queue_depth": len(eng.queue),
            "samd_engine_active_slots": int(eng.active.sum()),
            "samd_engine_peak_pages_used":
                eng.stats["peak_pages_used"],
        }
        if eng.kv_mode == "paged":
            alloc = eng._allocator
            gauges["samd_engine_pages_held"] = alloc.held_pages
            gauges["samd_engine_pages_free"] = alloc.free_pages
            gauges["samd_engine_pages_retained"] = alloc.retained_pages
        return metrics_mod.render_prometheus(
            counters, gauges, self.histograms
        )

    def summary(self) -> dict:
        """Latency/outcome summary over everything this server served
        (see ``metrics.summarize``), plus the raw counters."""
        out = metrics_mod.summarize(self.finished,
                                    slo_s=self.default_slo_s)
        out.update({f"server_{k}": v for k, v in self.counters.items()})
        return out
