"""The port's own spans and counters: off by default, kept in memory,
handed out by ``collect()``.

``enable(clock)`` turns the recorder on, ``disable()`` off. While it is
off, each instrumented site costs one test of the module-level boolean
``on``: ``span()`` returns the one shared no-op ``NO_SPAN`` and nothing
is allocated, annotated or recorded. While it is on:

* ``with span(name) as sp:`` records the span's name, id, parent (the
  innermost span open in the caller's context; ``asyncio.to_thread``
  copies the context, so an engine step run on a worker thread nests
  under the server span that awaits it), start and end on the
  recorder's clock, and what the site hands ``sp.set(...)``. With
  ``device=True`` on a card it also records a pair of CUDA events, read
  as device milliseconds at ``collect()`` after one synchronize. Each
  span also opens the annotation ``torch.profiler.record_function(name)``
  opens (its two ops, called directly, which keeps the annotation's start
  within microseconds of the span's), so a profiler running meanwhile
  puts the span in its trace on the device trace's clock.
* ``record(name, t0, t1, ...)`` adds a span whose times the program
  already holds (a request's wait in the queue, from its submission).
* ``count(key, n)`` adds to a counter. The kernel entry points count
  each launch under ``(launcher, shape...)``: one dict increment, not a
  span, since a decode step makes a few hundred launches. Counters are
  updated from the thread that runs the engine step alone.

The spans the serving path opens: ``server.tick`` and ``server.publish``
(``AsyncServer``), ``engine.step``, ``engine.admit``, ``engine.prefill``,
``request.queue``, ``engine.grant_pages``, ``engine.decode``,
``engine.sync``, ``engine.advance`` (``ServingEngine``) and
``model.dequantize`` (``layers.materialize``).
"""
from __future__ import annotations

import contextvars
import heapq
import itertools
import math
import time
from typing import Optional

import numpy as np
import torch

on = False
_recorder: Optional["Recorder"] = None
_open: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tracing_span", default=None)

MATMUL_LAUNCHERS = ("samd_matmul_splitk_launch", "samd_matmul_tile_launch")
ATTENTION_LAUNCHER = "paged_decode_attention_launch"


class _NoSpan:
    """What ``span()`` returns while the recorder is off: every call a
    no-op, and false, so a site can skip work that only feeds a span."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NO_SPAN = _NoSpan()


class Span:
    __slots__ = ("rec", "name", "id", "parent", "t0", "t1", "attrs",
                 "events", "_annotation", "_token")

    def __init__(self, rec: "Recorder", name: str, device: bool = False):
        self.rec, self.name = rec, name
        self.id = next(rec.ids)
        self.parent = self.t0 = self.t1 = None
        self.attrs: dict = {}
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if device and rec.cuda else None)
        self._annotation = self._token = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.parent = _open.get()
        self._token = _open.set(self.id)
        self._annotation = torch.ops.profiler._record_function_enter_new(
            self.name, None)
        # the clock is read next to the annotation's own start: collect()
        # pairs the two
        self.t0 = self.rec.clock()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.t1 = self.rec.clock()
        torch.ops.profiler._record_function_exit._RecordFunction(
            self._annotation)
        _open.reset(self._token)
        self.rec.spans.append(self)
        return False


class Recorder:
    """The records of one stretch between ``enable`` and ``collect``."""

    def __init__(self, clock, cuda: bool):
        self.clock = clock
        self.cuda = cuda
        self.ids = itertools.count(1)
        self.spans: list = []
        self.counts: dict = {}

    def collect(self, events=None) -> dict:
        """Every span (its times, attributes and device milliseconds)
        and counter; each launch counter with the operations and bytes
        of one of its launches. Given the events of a profiled stretch
        (``prof.profiler.kineto_results.events()``), also the offset
        that puts a span on the trace's clock (``clock_offset_ns``, with
        ``clock_residual_ns`` and ``clock_paired``) and the device's idle
        seconds put down to the spans (``idle_by_span``)."""
        if self.cuda and any(s.events is not None for s in self.spans):
            torch.cuda.synchronize()
        spans = sorted(self.spans, key=lambda s: s.t0)
        by_id = {s.id: s for s in spans}
        out = {"spans": [_span_dict(s) for s in spans],
               "counts": [_count_dict(k, n, by_id)
                          for k, n in self.counts.items()]}
        if events is not None:
            events = list(events)
            # every span but the queue waits, which have no annotation
            timed = [s for s in spans if s.name != "request.queue"]
            clock = _clock_offset(timed, events)
            out.update(clock)
            idle = (_idle_by_span(events, timed, clock["clock_offset_ns"])
                    if clock else None)
            if idle is not None:
                out["idle_by_span"] = idle
        return out


def _span_dict(s: Span) -> dict:
    d = {"name": s.name, "id": s.id, "parent": s.parent, "t0": s.t0,
         "t1": s.t1, "attrs": s.attrs}
    if s.events is not None:
        d["device_ms"] = s.events[0].elapsed_time(s.events[1])
    return d


def _launch_cost(key: tuple, spans: dict) -> Optional[tuple]:
    """(operations, bytes) of one launch counted under ``key``, by the
    formulas of the benchmark's yardstick: each input read once, each
    output written once, multiply-adds counted as two. ``spans`` maps
    span ids to spans; a decode attention launch takes its rows, keys
    and page slots read (a page several rows read counted once) from
    the ``engine.decode`` span it ran in."""
    if key[0] in MATMUL_LAUNCHERS:
        _, m, k, n, vpw = key
        return (2.0 * m * k * n,
                math.ceil(k / vpw) * n * 4 + n * 4 + m * k * 2 + m * n * 2)
    if key[0] == ATTENTION_LAUNCHER:
        _, span_id, h, hkv, dh, kv_bytes = key
        s = spans.get(span_id)
        while s is not None and s.name != "engine.decode":
            s = spans.get(s.parent)
        if s is None or "kv_slots" not in s.attrs:
            return None
        a = s.attrs
        return (4.0 * h * dh * a["context_tokens"],
                a["kv_slots"] * hkv * dh * 2 * kv_bytes
                + 2 * a["rows"] * h * dh * 2)
    return None


def _count_dict(key, n: int, spans: dict) -> dict:
    d = {"key": list(key) if isinstance(key, tuple) else key, "count": n}
    cost = _launch_cost(key, spans) if isinstance(key, tuple) else None
    if cost is not None:
        d["flops"], d["bytes"] = cost
    return d


def _is_host(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CPU


def _clock_offset(spans: list, events: list) -> dict:
    """Pair each span inside the profiled stretch with its annotation
    (same name, same order; the profiler records the annotations of the
    threads it was started on): the spans of one name run one after
    another, and those the stretch saw whole are a run of them.
    The run is where the annotations' starts less the spans' starts
    spread least, on the name that is cheapest to search; every
    annotation then pairs with the span of its name nearest to it.
    Gives the median of annotation start less span start (ns) and the
    largest residual about it, or {} when nothing pairs."""
    names = {s.name for s in spans}
    ann: dict = {}
    for e in events:
        if _is_host(e) and e.is_user_annotation() and e.name() in names:
            ann.setdefault(e.name(), []).append(e.start_ns())
    t0s: dict = {}
    for s in spans:
        if s.name in ann:
            t0s.setdefault(s.name, []).append(round(s.t0 * 1e9))
    pairs = [(np.sort(np.asarray(a, np.int64)),
              np.asarray(t0s.get(n, []), np.int64)) for n, a in ann.items()]
    pairs = [(a, s) for a, s in pairs if 0 < len(a) <= len(s)]
    if not pairs:
        return {}
    # a run of one or two pairs with anything: search on at least three
    least = min(3, max(len(a) for a, _ in pairs))
    a, s = min(((a, s) for a, s in pairs if len(a) >= least),
               key=lambda p: (len(p[1]) - len(p[0]) + 1) * len(p[0]))
    best = None
    for k in range(len(s) - len(a) + 1):
        d = a - s[k:k + len(a)]
        mid = int(np.median(d))
        spread = int(np.abs(d - mid).max())
        if best is None or spread < best[0]:
            best = (spread, mid)
    d = np.concatenate([a - _nearest(s, a - best[1]) for a, s in pairs])
    offset = int(np.median(d))
    return {"clock_offset_ns": offset,
            "clock_residual_ns": int(np.abs(d - offset).max()),
            "clock_paired": int(len(d))}


def _nearest(s: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The element of sorted ``s`` nearest each of ``x``."""
    j = np.searchsorted(s, x).clip(0, len(s) - 1)
    i = (j - 1).clip(0)
    return np.where(np.abs(x - s[i]) < np.abs(x - s[j]), s[i], s[j])


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle_by_span(events: list, spans: list, offset: int) -> Optional[dict]:
    """Seconds of the profiled stretch (first event to last, as the
    benchmark's stretch counts it) with nothing on the device, each put
    down to the innermost span that covers it (the one that started
    last), by overlap with the spans placed on the trace's clock by
    ``offset`` (those of threads the profiler did not see too); ``none``
    for idle time outside every span. None when the device did
    nothing."""
    ann = [(round(s.t0 * 1e9) + offset, round(s.t1 * 1e9) + offset, s.name)
           for s in spans]
    dev = []
    lo, hi = math.inf, -math.inf
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if not _is_host(e):
            if e.is_user_annotation():
                continue  # the device-side copy of a host annotation
            dev.append((s, s + d))
        lo, hi = min(lo, s), max(hi, s + d)
    if not dev:
        return None
    busy = _union(dev)
    idle = [(a, b) for a, b in zip([lo] + [e for _, e in busy],
                                   [s for s, _ in busy] + [hi]) if b > a]
    # sweep every boundary in time order; at a tie the order is moot
    # (the stretch between is empty)
    points = []
    for i, (s, e, _) in enumerate(ann):
        points += [(s, 1, i), (e, 0, i)]
    for s, e in idle:
        points += [(s, 3, -1), (e, 2, -1)]
    points.sort()
    out: dict = {}
    heap, ended = [], set()
    idle_now, prev = False, lo
    for t, kind, i in points:
        if idle_now and t > prev:
            while heap and heap[0][1] in ended:
                heapq.heappop(heap)
            name = ann[heap[0][1]][2] if heap else "none"
            out[name] = out.get(name, 0.0) + (t - prev) * 1e-9
        prev = t
        if kind == 1:
            heapq.heappush(heap, (-ann[i][0], i))
        elif kind == 0:
            ended.add(i)
        else:
            idle_now = kind == 3
    return out


def enable(clock=time.perf_counter) -> Recorder:
    """Start a fresh recording on ``clock`` (the engine's, so that span
    times and request stamps compare) and turn the recorder on."""
    global on, _recorder
    _recorder = Recorder(clock, torch.cuda.is_available())
    on = True
    return _recorder


def disable() -> None:
    global on
    on = False


def span(name: str, device: bool = False):
    """A span to enter with ``with``; ``NO_SPAN`` while off."""
    if not on:
        return NO_SPAN
    return Span(_recorder, name, device)


def record(name: str, t0: float, t1: float, parent=None, **attrs) -> None:
    """Add a span of times already taken (no annotation, no events)."""
    if not on:
        return
    s = Span(_recorder, name)
    s.parent, s.t0, s.t1 = parent, t0, t1
    s.attrs.update(attrs)
    _recorder.spans.append(s)


def count(key, n: int = 1) -> None:
    """Add ``n`` to the counter ``key`` (a no-op while off)."""
    if on:
        c = _recorder.counts
        c[key] = c.get(key, 0) + n


def current():
    """The id of the innermost span open in this context, or None."""
    return _open.get()


def collect(events=None) -> dict:
    """Turn the recorder off and hand out its records once (see
    ``Recorder.collect``); {} when nothing was recorded since the last
    call."""
    global _recorder
    disable()
    rec, _recorder = _recorder, None
    return {} if rec is None else rec.collect(events)
