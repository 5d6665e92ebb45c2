"""Profiler traces of the walk stage: the port of telomeri_tpu/utils/profiling.py.

`scaffold --trace DIR` (or TELOMERI_TRACE=DIR in the environment) wraps the
walk stage in torch.profiler, with CPU activity and, where torch sees a CUDA
device, CUDA activity (kernels by name, copies, collectives), and writes one
Chrome trace per process into DIR: walks.rank<R>.<pid>.pt.trace.json, readable
in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext

import torch

from telomeri_tpu_torch.utils.logging import log


@contextmanager
def _trace(trace_dir: str):
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(trace_dir, f"walks.rank{rank}.{os.getpid()}.pt.trace.json")
    with profile(activities=activities) as prof:
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
