"""Partial-failure policy: partial mosaics instead of hard failures.

Counterpart of `gsky_tpu/resilience/degrade.py`.  The OWS handler opens
a `request_scope`; a stage that absorbs a partial failure calls
`mark_degraded` with a short reason, and the handler labels a 200 with
the sorted reasons in an ``X-GSKY-Degraded`` header.  The scope is a
`contextvars.ContextVar`: a worker thread sees its request only when
the work was submitted with `contextvars.copy_context().run`.  Each
reason is also counted process-wide in `degraded`.

`check_partial` is the policy: a stage that failed on ``failed`` of
``total`` inputs either records the degradation (at or below the
max-failure fraction) or raises `TooManyFailures`.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from collections import Counter
from typing import List, Optional, Tuple

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


class RequestState:
    """The degradation reasons of one request, in the order marked."""

    __slots__ = ("reasons",)

    def __init__(self) -> None:
        self.reasons: List[str] = []


_current: contextvars.ContextVar[Optional[RequestState]] = \
    contextvars.ContextVar("request_degrade_state", default=None)


@contextlib.contextmanager
def request_scope():
    """One request's `RequestState`, current until the block ends."""
    state = RequestState()
    token = _current.set(state)
    try:
        yield state
    finally:
        _current.reset(token)


def mark_degraded(reason: str) -> None:
    """Count one degradation of ``reason`` and record it on the current
    request (outside a request scope, only the count)."""
    with _lock:
        degraded[reason] += 1
    state = _current.get()
    if state is not None and reason not in state.reasons:
        state.reasons.append(reason)


def degraded_reasons() -> Tuple[str, ...]:
    """The current request's reasons (none outside a scope)."""
    state = _current.get()
    return tuple(state.reasons) if state is not None else ()


def check_partial(failed: int, total: int, site: str) -> None:
    """No failures: no-op.  Failures at or below the max fraction: mark
    the request degraded and continue with what decoded.  Above it (or
    total loss): raise `TooManyFailures`."""
    if failed <= 0 or total <= 0:
        return
    if failed >= total or failed / total > max_failure_fraction():
        raise TooManyFailures(
            f"{failed}/{total} {site} failures exceed the degradation "
            f"budget ({max_failure_fraction():.0%})", site=site)
    mark_degraded(site)
