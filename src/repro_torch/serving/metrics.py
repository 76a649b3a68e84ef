"""Serving observability: latency metrics + Prometheus text snapshots (the
port's copy of ``repro/serving/metrics.py``).

The engine stamps four timestamps on every
:class:`~repro_torch.serving.Request` (``t_submit``, ``t_admit``,
``t_first_token``, ``t_retire`` — see ``engine.py``); this module turns
them into the three latencies serving SLOs are written against, and
renders the front door's counters, engine gauges and latency histograms
as a Prometheus-style text snapshot:

* **TTFT** (time to first token): ``t_first_token - t_submit``. Queue
  wait plus prefill — the latency admission policies actually control.
* **TPOT** (time per output token): ``(t_retire - t_first_token) /
  (n_generated - 1)`` — the steady-state decode cadence. None for
  single-token requests (no inter-token gap exists).
* **e2e**: ``t_retire - t_submit``.

All helpers are pure host code over Request objects — tests drive them
with synthetic tick traces and a virtual clock, no device involved.

The text format is the Prometheus exposition subset (``# HELP`` /
``# TYPE`` comments, ``name{label="v"} value`` samples, histograms as
``_bucket``/``_sum``/``_count`` with cumulative ``le`` buckets);
:func:`parse_prometheus` round-trips it so CI can assert a snapshot
stays machine-readable.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np


# -- per-request latencies --------------------------------------------------
def ttft_s(req) -> Optional[float]:
    """Time to first token, or None if the request never produced one."""
    if req.t_first_token is None or req.t_submit is None:
        return None
    return req.t_first_token - req.t_submit


def tpot_s(req) -> Optional[float]:
    """Mean inter-token time over the decode phase, or None when fewer
    than two tokens were generated (no inter-token gap exists)."""
    if (
        req.t_first_token is None
        or req.t_retire is None
        or len(req.generated) < 2
    ):
        return None
    return (req.t_retire - req.t_first_token) / (len(req.generated) - 1)


def e2e_s(req) -> Optional[float]:
    if req.t_retire is None or req.t_submit is None:
        return None
    return req.t_retire - req.t_submit


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy semantics); None on
    empty input instead of nan — absent data must not poison a report."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def summarize(reqs: Iterable, slo_s: Optional[float] = None) -> dict:
    """Aggregate a finished-request list into the serving report dict
    (p50/p99 TTFT / TPOT / e2e in ms, outcome counts, and — when
    ``slo_s`` is given — the e2e deadline-miss count among completed
    requests)."""
    reqs = list(reqs)
    completed = [r for r in reqs if r.error is None]
    rejected = [r for r in reqs if r.error is not None]
    ttfts = [v for r in completed if (v := ttft_s(r)) is not None]
    tpots = [v for r in completed if (v := tpot_s(r)) is not None]
    e2es = [v for r in completed if (v := e2e_s(r)) is not None]

    def ms(v):
        return None if v is None else v * 1e3

    out = {
        "n_requests": len(reqs),
        "completed": len(completed),
        "rejected": len(rejected),
        "reject_rate": len(rejected) / len(reqs) if reqs else 0.0,
        "p50_ttft_ms": ms(percentile(ttfts, 50)),
        "p99_ttft_ms": ms(percentile(ttfts, 99)),
        "p50_tpot_ms": ms(percentile(tpots, 50)),
        "p99_tpot_ms": ms(percentile(tpots, 99)),
        "p50_e2e_ms": ms(percentile(e2es, 50)),
        "p99_e2e_ms": ms(percentile(e2es, 99)),
    }
    if slo_s is not None:
        out["deadline_misses"] = sum(
            1 for r in completed
            if (v := e2e_s(r)) is not None and v > slo_s
        )
    return out


# -- histograms -------------------------------------------------------------
# decade-ish bucket ladder covering 100us..30s — wide enough for both the
# CPU smoke model (ms ticks) and a real accelerator (sub-ms TPOT)
DEFAULT_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram:
    """Prometheus-style cumulative histogram (fixed upper bounds)."""

    def __init__(self, buckets_s: Sequence[float] = DEFAULT_BUCKETS_S):
        self.bounds = tuple(sorted(float(b) for b in buckets_s))
        assert self.bounds, "a histogram needs at least one bucket"
        self.counts = [0] * len(self.bounds)  # per-bound, NOT cumulative
        self.inf_count = 0
        self.sum = 0.0

    @property
    def count(self) -> int:
        return sum(self.counts) + self.inf_count

    def observe(self, value_s: float) -> None:
        self.sum += value_s
        for i, b in enumerate(self.bounds):
            if value_s <= b:
                self.counts[i] += 1
                return
        self.inf_count += 1

    def to_lines(self, name: str) -> list[str]:
        """``_bucket``/``_sum``/``_count`` sample lines with CUMULATIVE
        ``le`` buckets, per the exposition format."""
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{name}_bucket{{le="{b:g}"}} {cum}')
        cum += self.inf_count
        lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{name}_sum {self.sum:.9g}")
        lines.append(f"{name}_count {cum}")
        return lines


def render_prometheus(counters: dict, gauges: dict,
                      histograms: dict) -> str:
    """Render ``name -> value`` counter/gauge dicts plus ``name ->
    Histogram`` into one exposition-format text snapshot. Pure function
    — the server's ``metrics_snapshot()`` is a thin wrapper, so tests
    can cover the format without an engine."""
    lines: list[str] = []
    for name in sorted(counters):
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {counters[name]:g}")
    for name in sorted(gauges):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {gauges[name]:g}")
    for name in sorted(histograms):
        lines.extend(histograms[name].to_lines(name))
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse an exposition-format snapshot back into ``{sample_key:
    value}`` where ``sample_key`` is the metric name plus any literal
    ``{...}`` label suffix (e.g. ``ttft_seconds_bucket{le="0.5"}``).
    Used by tests and the CI smoke job to assert snapshots stay
    machine-readable; raises ValueError on a malformed sample line."""
    out: dict = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        if not key:
            raise ValueError(f"malformed sample line: {raw!r}")
        out[key] = float(value)  # ValueError on a malformed value
    return out
