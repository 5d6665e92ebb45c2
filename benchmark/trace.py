"""The traced window: torch.profiler over a steady slice of work, reduced to
what the per-layer readers and the result's `breakdown` read.

  busy_s     the union of the device's operation intervals (kernels, copies,
             sets) inside the slice
  window_s   the slice's wall time, from before the work to after the final
             synchronize
  kernel_s   device seconds by operation name
  idle_gaps  the longest intervals in which the device ran nothing, cut where
             a span opens or closes and each piece named by the innermost span
             the benchmark had open around it on the host (`span` below), or
             "outside spans"

Spans are torch.profiler.record_function ranges that the benchmark opens
around its calls into the program; the profiler puts them on the device's
time base, so a gap is placed against them directly.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

SPAN_PREFIX = "bench:"


@contextmanager
def span(name: str):
    """A named host span in the trace (a no-op cost when no profiler runs)."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(device_ops, spans, window: tuple[float, float], top: int = 10) -> dict:
    """device_ops: [(name, start_us, end_us)]; spans: [(name, start_us, end_us)]
    on the same clock; window: (start_us, end_us) of the slice."""
    w0, w1 = window
    ops = [(n, max(a, w0), min(b, w1)) for n, a, b in device_ops if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in ops])
    kernel_s: dict[str, float] = {}
    for n, a, b in ops:
        kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) / 1e6
    idle, t = [], w0
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if w1 > t:
        idle.append((t, w1))

    def label(mid: float) -> str:
        inner = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        return min(inner)[1] if inner else "outside spans"

    # each idle interval cut where a span opens or closes, the pieces named by
    # the innermost span around them, neighbours of one name merged again
    edges = sorted({x for _, s, e in spans for x in (s, e)})
    gaps: list[list] = []
    for a, b in idle:
        cuts = [a] + [x for x in edges if a < x < b] + [b]
        for x, y in zip(cuts, cuts[1:]):
            name = label((x + y) / 2)
            if gaps and gaps[-1][0] == name and gaps[-1][2] == x:
                gaps[-1][2] = y
            else:
                gaps.append([name, x, y])
    gaps.sort(key=lambda g: g[1] - g[2])
    return dict(busy_s=sum(b - a for a, b in busy) / 1e6, window_s=(w1 - w0) / 1e6,
                kernel_s=kernel_s,
                device_ops=[[n, s] for n, s in sorted(kernel_s.items(),
                                                     key=lambda kv: -kv[1])[:top]],
                idle_gaps=[[n, (b - a) / 1e6] for n, a, b in gaps[:top]])


def profile_slice(fn, device) -> dict:
    """Run fn() under torch.profiler with the device synchronized on both
    sides, and reduce its trace (reduce_events). `source` says where the
    device times came from; where the profiler recorded no device operation,
    busy_s is None and the caller times the work another way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    events = prof.events()
    device_ops, spans, window = [], [], None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):   # a span's own device-side mark
                device_ops.append((e.name, a, b))
        elif e.name.startswith(SPAN_PREFIX):
            if e.name == SPAN_PREFIX + "window":
                window = (a, b)
            else:
                spans.append((e.name[len(SPAN_PREFIX):], a, b))
    if not device_ops or window is None:
        return dict(busy_s=None, window_s=wall, kernel_s={}, device_ops=[], idle_gaps=[],
                    source="none")
    out = reduce_events(device_ops, spans, window)
    out["source"] = "torch.profiler"
    return out
