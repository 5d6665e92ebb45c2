"""Structured logging + stage timing (SURVEY.md §6 "Metrics / logging / observability").

The C++ reference logs progress to stdout (SURVEY.md §3 row 15); we additionally keep
machine-readable per-stage metrics that the CLI serialises next to its output.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from contextlib import contextmanager

log = logging.getLogger("telomeri_tpu_torch")


def setup_logging(verbose: bool = False) -> None:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S"))
    log.handlers[:] = [h]
    log.setLevel(logging.DEBUG if verbose else logging.INFO)


class Metrics:
    """Accumulates scalar metrics, per-stage wall-clock timings and the
    counters a run added (utils/profiling.py count)."""

    def __init__(self) -> None:
        self.values: dict[str, float | int | str] = {}
        self.timings: dict[str, float] = {}
        self.counters: dict[str, int] = {}

    def set(self, key: str, value) -> None:
        self.values[key] = value

    @contextmanager
    def stage(self, name: str):
        """Time a stage, as the span stage.<name> of a running profiler."""
        # imported here: the host-only commands import this module, and not torch
        from telomeri_tpu_torch.utils.profiling import span

        t0 = time.perf_counter()
        log.info("stage %s: start", name)
        try:
            with span("stage." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            log.info("stage %s: %.3fs", name, dt)

    def as_dict(self) -> dict:
        return {"metrics": self.values, "timings_s": self.timings, "counters": self.counters}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
