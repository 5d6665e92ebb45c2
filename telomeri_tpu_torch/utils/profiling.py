"""Profiler traces, the program's named spans, and its counters: the port of
telomeri_tpu/utils/profiling.py, with the spans and counters added.

`scaffold --trace DIR` (or TELOMERI_TRACE=DIR in the environment) wraps the
whole run in torch.profiler, with CPU activity and, where torch sees a CUDA
device, CUDA activity (kernels by name, copies, collectives), and writes one
Chrome trace per process into DIR: run.rank<R>.<pid>.pt.trace.json, readable
in Perfetto or chrome://tracing.

span(name, **ids) names a piece of the program's host work in that trace, as
"telomeri:<name>" with the ids among the event's args (the trace records them,
since maybe_trace records shapes). The spans nest (stage.run_walks >
walk.dispatch > walk.section > kernel.walk_scan, with the profiler's own
aten::empty events of the outputs' allocation inside) and sit on the profiler's
clock beside the device's kernels, so an interval in which the device ran
nothing is put against the innermost span open on the host. With no profiler
running a span costs one flag check and records nothing.

A span is a RecordFunction of the FUNCTION scope ("cpu_op" in the trace), not
torch.profiler.record_function's USER scope: the profiler mirrors each
USER-scope range onto the device's timeline as an annotation over the kernels
launched inside it, and a reader that takes every device-side event for work
would count those. The program's spans leave the device's timeline as it is.

count(name, n) adds to a host integer, always on; counters() reads them all,
reset_counters(prefix) sets those under a prefix to 0. run_pipeline writes
what one run added under "counters" in metrics.json. The names:

  walk.dispatches     run_walks_prepared calls (one a section set or chunk)
  walk.walks          plan rows dispatched, padding rows included
  walk.steps_scanned  W x S over every scan run
  walk.steps_taken    steps the walks took, from the records on the host
  bytes.h2d, bytes.d2h  bytes copied to and from a device at the upload and
                        download spans (a CPU run copies none)
  launch.<kernel>     kernel launches (kernels.launch_counts)
  walk.pick_plane_builds  pick planes built for the MC kernel (the span
                      walk.pick_plane): once per table, not once per dispatch
  bytes.pick_plane    the bytes of those planes (N x H x 32 each)
  walk.cum_span_words the sum of the rows' spans over those planes' tables
                      (kernels/walk_table.py row_header): over N x H, the
                      share of a cum block an MC step on the card reads
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext

import torch

PREFIX = "telomeri:"

# whether a torch profiler records this thread: the walk dispatch and the kernel
# wrappers test it once and take a path with no span at all when it is false,
# since on the card's host even a closed span (a call and a with-statement)
# costs about 2 us a site in a dispatch
profiler_running = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_OFF = nullcontext()   # stateless, so one instance serves every closed span


def span(name: str, **ids):
    """Context manager: a "telomeri:<name>" range in a running profiler's
    trace, the ids (ints or strings) among its args; nothing otherwise."""
    if not profiler_running():
        return _OFF
    return _Range(PREFIX + name, (), ids)


_COUNTS: dict[str, int] = {}


def count(name: str, n: int = 1) -> int:
    """Add n to the counter `name` (a new counter starts at 0); its new value."""
    v = _COUNTS[name] = _COUNTS.get(name, 0) + n
    return v


def counters() -> dict[str, int]:
    """Every counter's value, by name."""
    return dict(_COUNTS)


def reset_counters(prefix: str = "") -> None:
    """Set every counter whose name starts with `prefix` to 0."""
    for name in _COUNTS:
        if name.startswith(prefix):
            _COUNTS[name] = 0


def counters_since(before: dict[str, int]) -> dict[str, int]:
    """What each counter added since `before` (a counters() reading)."""
    return {k: v - before.get(k, 0) for k, v in _COUNTS.items()}


def count_copy(tensors, src, dst) -> None:
    """Add the bytes of `tensors` (tensors or arrays) to bytes.h2d or
    bytes.d2h where they were copied from device `src` to `dst` across the
    host's boundary; a copy that stays on the host or on a device counts none."""
    on_host = torch.device(src).type == "cpu"
    if on_host != (torch.device(dst).type == "cpu"):
        count("bytes.h2d" if on_host else "bytes.d2h", sum(a.nbytes for a in tensors))


@contextmanager
def _trace(trace_dir: str):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from telomeri_tpu_torch.utils.logging import log

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(trace_dir, f"run.rank{rank}.{os.getpid()}.pt.trace.json")
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    prof.export_chrome_trace(path)
    log.info("torch.profiler trace -> %s", path)


def maybe_trace(trace_dir: str | None):
    """Context manager: a torch.profiler trace into trace_dir (or
    $TELOMERI_TRACE) when either is set, else nothing."""
    trace_dir = trace_dir or os.environ.get("TELOMERI_TRACE")
    if not trace_dir:
        return nullcontext()
    return _trace(trace_dir)
