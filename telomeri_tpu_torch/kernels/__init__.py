"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

  walk_scan.py    all-MC walk scan  (replaces kernels/walk_vmem.py::_walk_kernel)
  walk_events.py  MC event resolution (walk/engine.py::_resolve_mc_events: no
                  Pallas twin, XLA compiles it inside the walk program)
  greedy_scan.py  greedy / mixed scan with the visited list
                  (walk/engine.py::_kind_core: likewise)
  scoring.py      SI / OS / ES scores (replaces kernels/scoring.py::_score_kernel
                                       and ::_score_kernel_os_es2)
  build.py        nvcc build of csrc/*.cu (with csrc/*.cuh) into one ctypes
                  library, at first use

A wrapper runs the plain version for CPU tensors and launches its kernel for
CUDA tensors, counting each launch (launch_counts / reset_launch_counts).
"""

from __future__ import annotations

from telomeri_tpu_torch.kernels import greedy_scan, scoring, walk_events, walk_scan

_COUNTS = (walk_scan.launches, walk_events.launches, greedy_scan.launches, scoring.launches)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for name in counts:
            counts[name] = 0
