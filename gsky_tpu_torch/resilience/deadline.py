"""Per-request deadline budgets.

Counterpart of `gsky_tpu/resilience/deadline.py`.  A request gets one
budget (a layer's ``wms_timeout``, ``wcs_timeout`` x tiles) when the
OWS handler opens its `deadline_scope`; every downstream stage draws
its timeout from what is left of it: `clamp_timeout` bounds the MAS
client's HTTP timeout, the handler waits on the render no longer than
`Deadline.remaining`.  The deadline travels in a
`contextvars.ContextVar`: a worker thread sees it when its work was
submitted with `contextvars.copy_context().run`, and the clock keeps
running, since the `Deadline` object is shared.  An exhausted clamp is
counted in `registry`.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Optional

from .registry import registry


class DeadlineExceeded(TimeoutError):
    """The request's deadline budget is exhausted (a ``TimeoutError``,
    so that a timeout handler takes it)."""


class Deadline:
    __slots__ = ("budget", "_t0", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget = float(budget_s)
        self._clock = clock
        self._t0 = clock()

    def remaining(self) -> float:
        return self.budget - (self._clock() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, timeout: Optional[float] = None) -> float:
        """The smaller of ``timeout`` and the remaining budget; raises
        `DeadlineExceeded` when nothing is left."""
        rem = self.remaining()
        if rem <= 0.0:
            registry.count_deadline()
            raise DeadlineExceeded(
                f"deadline budget of {self.budget:.1f}s exhausted")
        return rem if timeout is None else min(float(timeout), rem)


_current: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("gsky_torch_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    return _current.get()


@contextlib.contextmanager
def deadline_scope(deadline):
    """Make ``deadline`` (a Deadline or a budget in seconds) current."""
    if not isinstance(deadline, Deadline):
        deadline = Deadline(deadline)
    token = _current.set(deadline)
    try:
        yield deadline
    finally:
        _current.reset(token)


def clamp_timeout(timeout: Optional[float]) -> Optional[float]:
    """Clamp ``timeout`` against the current deadline, if one is set."""
    dl = _current.get()
    if dl is None:
        return timeout
    return dl.clamp(timeout)
