"""Per-request deadline budgets.

Counterpart of `gsky_tpu/resilience/deadline.py`, the part the MAS
client calls: `clamp_timeout` bounds a downstream timeout by what is
left of the current `Deadline`, which travels in a
`contextvars.ContextVar`.  Opening deadlines in the OWS handlers is
ROADMAP A.16; until then no request sets one and `clamp_timeout`
returns its argument.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Optional


class DeadlineExceeded(TimeoutError):
    """The request's deadline budget is exhausted."""


class Deadline:
    __slots__ = ("budget", "_t0", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget = float(budget_s)
        self._clock = clock
        self._t0 = clock()

    def remaining(self) -> float:
        return self.budget - (self._clock() - self._t0)

    def clamp(self, timeout: Optional[float] = None) -> float:
        """The smaller of ``timeout`` and the remaining budget; raises
        `DeadlineExceeded` when nothing is left."""
        rem = self.remaining()
        if rem <= 0.0:
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
