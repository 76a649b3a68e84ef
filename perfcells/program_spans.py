"""The program's own spans and counters (``repro_torch.tracing``) in a
cell's run, beside the benchmark's wrappers (``spans.py``): the pairing
that shows the two measure the same calls, and the tracer's cost.

``run(cell, seed, seconds, trace, device, t_start)`` runs the harness's
``run_cell`` with the tracer on. In a traced run the harness turns the
tracer on itself, and a ``Traced`` takes the place of ``spans.Spans``:
it pairs each decode and prefill call the wrappers record with the
program's span around that call and counts the program's launches over
the profiled stretch. In an untraced run the tracer runs from just
before the window to the end (what it costs when on).
``readings(...)`` reads from the program's records what the per-layer
metrics that read them read, and more (``idle_by_span``).

    PYTHONPATH=src python3 -m perfcells.program_spans --workload <cell>
        --seed <n> --seconds <s> --trace <0|1> [--dump FILE]

from the checkout's root prints the run's result line with the readings
under ``program`` (needs a card, as ``run.py`` does); ``--dump`` also
writes the tracer's records beside the run's, as ``FILE.program.json``.
"""
import time

T_START = time.perf_counter()

import statistics  # noqa: E402

from perfcells import harness  # noqa: E402
from perfcells import spans as spans_mod  # noqa: E402

# idle time in these spans (or in none) is the tick's host bookkeeping;
# the rest falls in the forward's dispatch (engine.decode, .prefill) or
# while the host waits on the device (engine.sync)
HOST_TICK = ("server.tick", "server.publish", "engine.step", "engine.admit",
             "engine.grant_pages", "engine.advance", "none")


def by_launcher(counts: dict) -> dict:
    """Launches by launcher name (the C name less ``_launch``, as the
    benchmark's trace classes name them)."""
    out: dict = {}
    for key, n in counts.items():
        if isinstance(key, tuple) and key[0].endswith("_launch"):
            name = key[0][:-len("_launch")]
            out[name] = out.get(name, 0) + n
    return out


class Traced(spans_mod.Spans):
    """``Spans`` that pairs its records with the program's."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.decode_pairs = []      # (program span id, index in .decode)
        self.prefill_pairs = []     # (span id, slice of .admitted)
        self.stretch_launches = None
        self.stretch_times = [None, None]   # on the program's clock
        self._at_start: dict = {}
        self._prefill_span = None

    def _step(self):
        from repro_torch import tracing

        # the stretch starts inside this call (as Spans decides) before
        # the step launches anything
        if (tracing.on and self._state == "pending"
                and self.window and self.clock() >= self._from):
            self._at_start = by_launcher(tracing._recorder.counts)
            self.stretch_times[0] = self.clock()
        return super()._step()

    def _stop_stretch(self):
        from repro_torch import tracing

        if tracing.on:
            now = by_launcher(tracing._recorder.counts)
            self.stretch_launches = {
                k: now[k] - self._at_start.get(k, 0) for k in now
                if now[k] > self._at_start.get(k, 0)}
            self.stretch_times[1] = self.clock()
        super()._stop_stretch()

    def _decode_step(self, *args):
        from repro_torch import tracing

        n, span_id = len(self.decode), tracing.current()
        out = super()._decode_step(*args)
        if len(self.decode) > n:
            self.decode_pairs.append((span_id, n))
        return out

    def _prefill_batch(self, slots, reqs, effs, starts):
        n = len(self.admitted)
        self._prefill_span = None
        out = super()._prefill_batch(slots, reqs, effs, starts)
        if len(self.admitted) > n:
            self.prefill_pairs.append((self._prefill_span,
                                       slice(n, len(self.admitted))))
        return out

    def _prefill_step(self, *args):
        from repro_torch import tracing

        self._prefill_span = tracing.current()
        return super()._prefill_step(*args)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float):
    """``harness.run_cell`` with the tracer on; returns (the run, the
    tracer's records, the ``Traced`` of a traced run or None)."""
    from repro_torch import tracing

    if not trace:
        # the harness's hook for a planted fault runs just before the
        # window; the engine reads the harness's clock from then on
        def tracer_on(eng):
            tracing.enable(time.perf_counter)

        try:
            r = harness.run_cell(cell, seed, seconds, False, device,
                                 t_start, fault=tracer_on)
        finally:
            program = tracing.collect()
        return r, program, None
    made = []

    class _Kept(Traced):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    saved = spans_mod.Spans
    spans_mod.Spans = _Kept
    try:
        r = harness.run_cell(cell, seed, seconds, True, device, t_start)
    finally:
        spans_mod.Spans = saved
        tracing.disable()
    return r, r.details["program"], made[0]


def readings(program: dict, run) -> dict:
    """From the program's records: ``queue_wait_ms`` (median over the
    window's requests of their ``request.queue`` span),
    ``prefill_pad_share`` (padding's share of the rows x bucket of the
    ``engine.prefill`` spans), and with a profiled stretch
    ``device_idle_share.host_tick`` (the stretch's idle seconds put down
    to the tick's host bookkeeping, over its length) beside
    ``device_idle_share`` and ``idle_by_span`` itself."""
    spans = program.get("spans", [])
    sent = {s.req.index for s in run.sent}
    out: dict = {}
    waits = [s["t1"] - s["t0"] for s in spans if s["name"] == "request.queue"
             and s["attrs"]["rid"] in sent]
    if waits:
        out["queue_wait_ms"] = 1e3 * statistics.median(waits)
    pre = [s["attrs"] for s in spans if s["name"] == "engine.prefill"]
    computed = sum(a["rows"] * a["bucket"] for a in pre)
    if computed:
        out["prefill_pad_share"] = 100.0 * (
            1.0 - sum(a["real"] for a in pre) / computed)
    stretch = run.details.get("stretch") or {}
    idle = program.get("idle_by_span")
    if idle is not None and stretch.get("window_s"):
        w = stretch["window_s"]
        out["device_idle_share.host_tick"] = 100.0 * sum(
            idle.get(k, 0.0) for k in HOST_TICK) / w
        out["device_idle_share"] = 100.0 * (1.0 - stretch["busy_s"] / w)
        out["idle_by_span"] = idle
    for k in ("clock_residual_ns", "clock_paired"):
        if k in program:
            out[k] = program[k]
    out["spans"] = len(spans)
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    from perfcells import run as run_mod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    run_mod._cache_dirs()

    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfcells: no CUDA device", file=sys.stderr)
        return 1
    r, program, _ = run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_START)
    r.result["program"] = readings(program, r)
    if args.dump:
        harness.dump(r, args.dump)
        path = Path(args.dump).with_suffix(".program.json")
        path.write_text(json.dumps(program, default=float))
    print(json.dumps(r.result, default=float), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
