"""Seconds a whole assembly spent in some of the pipeline's stages.

The program times its stages itself (Metrics.timings, one dict an assembly);
this reads the mean over the window's assemblies of the sum of the named
stages and of every stage whose name starts with one of `prefixes`.
"""

from __future__ import annotations


def read(observed: dict, stages=(), prefixes=()) -> float | None:
    runs = observed.get("stage_timings")
    if not runs:
        return None
    picked = [sum(t for name, t in run.items()
                  if name in stages or any(name.startswith(p) for p in prefixes))
              for run in runs]
    return sum(picked) / len(picked)
