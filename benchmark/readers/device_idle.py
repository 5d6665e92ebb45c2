"""The device's idle share of the traced window, in percent: 100 x (1 - the
seconds in which a device operation ran / the window's seconds)."""

from __future__ import annotations


def read(observed: dict) -> float | None:
    prof = observed.get("profile") or {}
    busy, window = prof.get("busy_s"), prof.get("window_s")
    if busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)
