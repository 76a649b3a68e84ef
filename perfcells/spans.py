"""The benchmark's own spans in a traced run: timing events around the
engine's calls into each layer and the host state each call saw, over
the window up to a closing stretch; over that stretch, under the
profiler, the shapes of every kernel launch. The timing events leave the
stretch out, so the profiler's own cost reaches no metric but those it
reads.

It wraps names the program keeps private, those of
``ServingEngine._decode_step``, ``_prefill_step``, ``_prefill_batch``
and ``step`` that the engine has, and patches
``models.layers.materialize`` and the two kernel entry points of
``kernels.ops``; ``close`` puts every one back. A later change that gives
the program spans of its own replaces these wrappers.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfcells import costs, profiling


# engine attribute -> the wrapper that takes its place
ENGINE_CALLS = {"step": "_step", "_decode_step": "_decode_step",
                "_prefill_step": "_prefill_step",
                "_prefill_batch": "_prefill_batch"}


class HostMark:
    """A host-clock stand-in for a CUDA event on a run without a card (the
    CPU tests): the same calls, host seconds."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    def __init__(self, eng, arch: dict, device, clock, stretch_from: float,
                 stretch_to: float):
        """``stretch_from`` and ``stretch_to`` are seconds from the close
        of the window (``open_window`` gives it)."""
        from repro_torch.kernels import ops
        from repro_torch.kernels import samd_matmul as mm
        from repro_torch.models import layers

        self.eng, self.arch, self.clock = eng, arch, clock
        self._cuda = torch.device(device).type == "cuda"
        self._ops, self._layers, self._mm = ops, layers, mm
        self.window = False          # set by the harness over the window
        self.decode, self.prefill = [], []
        self.admitted = []           # (shared, unshared) prompt tokens
        self.launches: dict = {}     # class -> [bound seconds, count]
        self.stretch = profiling.Stretch()
        self._from, self._to = stretch_from, stretch_to
        self._state = "pending"
        self._dequant = None
        self._admitting = None
        self._expect_attention = (0.0, 0.0)
        self._saved = dict(materialize=layers.materialize,
                           matmul=ops.samd_matmul,
                           attention=ops.paged_decode_attention)
        # a ring-mode engine (the recurrent families) has no
        # _prefill_step: only what the engine has is wrapped
        self._wrapped = [name for name in ENGINE_CALLS if hasattr(eng, name)]
        for name in self._wrapped:
            self._saved[name] = getattr(eng, name)
            setattr(eng, name, getattr(self, ENGINE_CALLS[name]))
        layers.materialize = self._materialize
        ops.samd_matmul = self._matmul
        ops.paged_decode_attention = self._attention

    def close(self) -> None:
        s = self._saved
        for name in self._wrapped:
            setattr(self.eng, name, s[name])
        self._layers.materialize = s["materialize"]
        self._ops.samd_matmul = s["matmul"]
        self._ops.paged_decode_attention = s["attention"]
        self.end_stretch()

    # -- timing ------------------------------------------------------------
    def _event(self):
        if self._cuda:
            return torch.cuda.Event(enable_timing=True)
        return HostMark()

    def _timed(self, fn, *args):
        a, b = self._event(), self._event()
        a.record()
        out = fn(*args)
        b.record()
        return out, (a, b)

    @property
    def _recording(self) -> bool:
        return self._state == "on"

    def _add_launch(self, cls: str, flops: float, nbytes: float, n=1):
        bound, count = self.launches.get(cls, (0.0, 0))
        self.launches[cls] = (bound + n * costs.bound_s(flops, nbytes),
                              count + n)

    def _stop_stretch(self):
        self.stretch.stop()
        self._state = "done"

    # -- wrappers ----------------------------------------------------------
    def open_window(self, t_close: float) -> None:
        self._from, self._to = t_close + self._from, t_close + self._to
        self.window = True

    @property
    def _timing(self) -> bool:
        return self.window and self._state == "pending"

    def _step(self):
        if (self._state == "pending" and self.window
                and self.clock() >= self._from):
            self.stretch.start()
            self._state = "on"
        with torch.profiler.record_function("perfcells.engine_step"):
            out = self._saved["step"]()
        if self._state == "on" and self.clock() >= self._to:
            self._stop_stretch()
        return out

    def end_stretch(self) -> None:
        """Stop the profiler if a step has not; call it on the thread
        that runs the steps."""
        if self._state == "on":
            self._stop_stretch()

    def _decode_step(self, *args):
        if not (self._timing or self._recording):
            return self._saved["_decode_step"](*args)
        eng, a = self.eng, self.arch
        rows = np.nonzero(eng.active)[0]
        contexts = [int(eng.slot_pos[i]) + 1 for i in rows]
        if self._recording and eng.kv_mode == "paged":
            pages = [eng.page_table[i].tolist() for i in rows]
            flops, nbytes = costs.paged_decode_attention(
                contexts, pages, eng.page_size, a["n_heads"],
                a["n_kv_heads"], a["head_dim"])
            self._expect_attention = (flops, nbytes)
        if not self._timing:
            with torch.profiler.record_function("perfcells.decode_step"):
                return self._saved["_decode_step"](*args)
        self._dequant = []
        out, ev = self._timed(self._saved["_decode_step"], *args)
        self.decode.append({"events": ev, "contexts": contexts,
                            "dequant": self._dequant})
        self._dequant = None
        return out

    def _prefill_batch(self, slots, reqs, effs, starts):
        self._admitting = [(int(s), len(e) - int(s))
                           for e, s in zip(effs, starts)]
        if self.window:
            self.admitted.extend(self._admitting)
        try:
            return self._saved["_prefill_batch"](slots, reqs, effs, starts)
        finally:
            self._admitting = None

    def _prefill_step(self, *args):
        if not self._timing:
            with torch.profiler.record_function("perfcells.prefill_step"):
                return self._saved["_prefill_step"](*args)
        out, ev = self._timed(self._saved["_prefill_step"], *args)
        self.prefill.append({"events": ev, "spans": self._admitting})
        return out

    def _materialize(self, w, dtype=torch.bfloat16):
        if self._dequant is None:
            return self._saved["materialize"](w, dtype)
        out, ev = self._timed(self._saved["materialize"], w, dtype)
        self._dequant.append(ev)
        return out

    def _matmul(self, x, packed, scale, k, cfg, **kw):
        if self._recording:
            m = int(np.prod(x.shape[:-1]))
            flops, nbytes = costs.samd_matmul(m, int(k), packed.shape[1],
                                              cfg.values_per_word)
            cls = ("samd_matmul_splitk"
                   if self._mm.launcher_for(m) == self._mm.SPLITK
                   else "samd_matmul_tile")
            self._add_launch(cls, flops, nbytes)
        return self._saved["matmul"](x, packed, scale, k, cfg, **kw)

    def _attention(self, *args, **kw):
        if self._recording and kw.get("extra_k") is None:
            self._add_launch("paged_decode_attention",
                             *self._expect_attention)
        return self._saved["attention"](*args, **kw)

    # -- after the window ----------------------------------------------------
    def timings(self) -> dict:
        """Milliseconds of every recorded call (synchronizes first)."""
        if self._cuda:
            torch.cuda.synchronize()

        def ms(ev):
            return ev[0].elapsed_time(ev[1])

        return {
            "decode": [dict(ms=ms(d["events"]), contexts=d["contexts"],
                            dequant_ms=sum(ms(e) for e in d["dequant"]))
                       for d in self.decode],
            "prefill": [dict(ms=ms(p["events"]), spans=p["spans"])
                        for p in self.prefill],
            "admitted": list(self.admitted),
        }
