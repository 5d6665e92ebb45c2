"""A kernel's share of its roofline over the traced calls, in percent.

The least time the chip could take for the work the traced calls needed
(`need`: bytes and operations that the judgement counted from the reference's
pass over the same calls, benchmark/roofline.py) over the device seconds of
the operations whose names contain one of `kernels`. Nothing is returned where
the trace holds no such operation or no count was made: a kernel taken off the
path leaves its share silent, never 0.
"""

from __future__ import annotations

from .. import roofline


def read(observed: dict, kernels=(), need: str = "") -> float | None:
    counts = (observed.get("need") or {}).get(need)
    kernel_s = (observed.get("profile") or {}).get("kernel_s") or {}
    took = sum(s for name, s in kernel_s.items() if any(k in name for k in kernels))
    if not counts or took <= 0:
        return None
    least, _ = roofline.bound_s(*counts)
    return 100.0 * least / took
