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
    """Accumulates scalar metrics and per-stage wall-clock timings."""

    def __init__(self) -> None:
        self.values: dict[str, float | int | str] = {}
        self.timings: dict[str, float] = {}

    def set(self, key: str, value) -> None:
        self.values[key] = value

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        log.info("stage %s: start", name)
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            log.info("stage %s: %.3fs", name, dt)

    def as_dict(self) -> dict:
        return {"metrics": self.values, "timings_s": self.timings}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
