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
CUDA tensors, counting each launch in the program's counter launch.<kernel>
(utils/profiling.py; launch_counts / reset_launch_counts read and reset them)
inside its span kernel.<name>.
"""

from __future__ import annotations

from telomeri_tpu_torch.utils.profiling import count, counters, reset_counters

# what the wrappers count, by kernel (scoring's two variants apart)
KERNELS = ("walk_scan", "resolve_events", "greedy_scan", "score_os_es2", "score_overlaps")
for _name in KERNELS:
    count("launch." + _name, 0)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    now = counters()
    return {k: now["launch." + k] for k in KERNELS}


def reset_launch_counts() -> None:
    reset_counters("launch.")
