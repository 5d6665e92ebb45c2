"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

  walk_scan.py  all-MC walk scan    (replaces kernels/walk_vmem.py::_walk_kernel)
  scoring.py    SI / OS / ES scores (replaces kernels/scoring.py::_score_kernel
                                     and ::_score_kernel_os_es2)
  build.py      nvcc build of csrc/*.cu into one ctypes library, at first use

A wrapper runs the plain version for CPU tensors and launches its kernel for
CUDA tensors, counting each launch (launch_counts / reset_launch_counts).
"""

from __future__ import annotations

from telomeri_tpu_torch.kernels import scoring, walk_scan


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {**walk_scan.launches, **scoring.launches}


def reset_launch_counts() -> None:
    for counts in (walk_scan.launches, scoring.launches):
        for name in counts:
            counts[name] = 0
