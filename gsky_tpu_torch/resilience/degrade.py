"""Partial-failure policy: partial mosaics instead of hard failures.

Counterpart of `gsky_tpu/resilience/degrade.py::check_partial`, trimmed:
a stage that failed on ``failed`` of ``total`` inputs either records the
degradation (at or below the max-failure fraction) or raises
`TooManyFailures`.  The port has no request scope or response header
yet, so `mark_degraded` only counts reasons.
"""

from __future__ import annotations

import os
import threading
from collections import Counter

DEFAULT_MAX_FAILURE_FRACTION = 0.5

_lock = threading.Lock()
degraded = Counter()      # reason -> times a stage degraded


class TooManyFailures(RuntimeError):
    """Partial-failure fraction exceeded the degradation budget."""

    def __init__(self, message: str, site: str = ""):
        super().__init__(message)
        self.site = site


def max_failure_fraction() -> float:
    """GSKY_DEGRADE_MAX_FRACTION, clamped to [0, 1] (default 0.5)."""
    raw = os.environ.get("GSKY_DEGRADE_MAX_FRACTION", "")
    try:
        v = float(raw) if raw else DEFAULT_MAX_FAILURE_FRACTION
    except ValueError:
        v = DEFAULT_MAX_FAILURE_FRACTION
    return min(max(v, 0.0), 1.0)


def mark_degraded(reason: str) -> None:
    """Count one degradation of ``reason``."""
    with _lock:
        degraded[reason] += 1


def check_partial(failed: int, total: int, site: str) -> None:
    """No failures: no-op.  Failures at or below the max fraction: mark
    the stage degraded and continue with what decoded.  Above it (or
    total loss): raise `TooManyFailures`."""
    if failed <= 0 or total <= 0:
        return
    if failed >= total or failed / total > max_failure_fraction():
        raise TooManyFailures(
            f"{failed}/{total} {site} failures exceed the degradation "
            f"budget ({max_failure_fraction():.0%})", site=site)
    mark_degraded(site)
