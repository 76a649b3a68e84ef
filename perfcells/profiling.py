"""A short stretch of a traced run under ``torch.profiler`` (host and
device activity), reduced to what the per-layer metrics read: the
device's busy seconds and the stretch's length, device time by kernel
name, and the longest idle gaps of the device named by what the host was
doing in them.
"""
from __future__ import annotations

import collections
import re

import torch

# what one launcher of the program's kernels is called in a trace: the
# launchers instantiate one templated body with their own tile shapes
KERNEL_CLASSES = {
    "samd_matmul_splitk": re.compile(r"samd_mma_kernel<\d+, 2, 1, 4, 4>"),
    "samd_matmul_tile": re.compile(r"samd_mma_kernel<\d+, 4, 2, 8, 3>"),
    "paged_decode_attention": re.compile(
        r"paged_attention_kernel<false, false,"),
}
NAME_CHARS = 120


def kernel_class(name: str):
    for cls, pat in KERNEL_CLASSES.items():
        if pat.search(name):
            return cls
    return None


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Stretch:
    """Start and stop ``torch.profiler`` from one thread (it may be
    another than the one that makes the Stretch); ``summarize`` the
    events after ``stop``."""

    def __init__(self):
        self._prof = None
        self.events = None
        # the profiler's first session initializes it, and it has to do
        # so on the thread that imported torch
        with torch.profiler.profile(activities=_activities()):
            pass

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.start()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.events = list(self._prof.profiler.kineto_results.events())
        self._prof = None


def _union(intervals):
    """Disjoint, sorted [start, end) covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(events, top: int = 10) -> dict:
    """Reduce the stretch's events: ``busy_s`` and ``window_s`` (device
    activity's union, and first event to last of any kind),
    ``kernels`` {class: [seconds, count]} for the program's kernels,
    ``device_ops`` and ``idle_gaps`` (the ``top`` entries of each, as
    [name, seconds]). Empty when no device activity was recorded."""
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((s, s + d, e.name(), e.is_user_annotation()))
        elif not e.is_user_annotation():
            # the device-side copy of a host annotation is no device work
            dev.append((s, s + d, e.name()))
    if not dev:
        return {}
    t_lo = min(min(s for s, _, _ in dev), min((s for s, *_ in host),
                                               default=dev[0][0]))
    t_hi = max(max(e for _, e, _ in dev), max((e for _, e, *_ in host),
                                               default=dev[0][1]))
    busy = _union([(s, e) for s, e, _ in dev])
    by_name = collections.Counter()
    kernels = {}
    for s, e, name in dev:
        by_name[name] += e - s
        cls = kernel_class(name)
        if cls is not None:
            sec, n = kernels.get(cls, (0.0, 0))
            kernels[cls] = (sec + (e - s) * 1e-9, n + 1)
    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
            for i in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    host.sort()
    idle = []
    for length, g0, g1 in gaps[:top]:
        mid = (g0 + g1) / 2
        cover = [h for h in host if h[0] <= mid < h[1]]
        marks = [h[2] for h in cover if h[3]]
        ops = [h for h in cover if not h[3]]
        inner = min(ops, key=lambda h: h[1] - h[0])[2] if ops else "idle"
        label = " > ".join(marks[-1:] + [inner])
        idle.append([_short(label), length * 1e-9])
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "window_s": (t_hi - t_lo) * 1e-9,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "device_ops": [[_short(n), t * 1e-9]
                       for n, t in by_name.most_common(top)],
        "idle_gaps": idle,
    }
