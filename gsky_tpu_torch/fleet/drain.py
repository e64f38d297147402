"""Graceful drain: stop accepting, finish in-flight, then exit.

Counterpart of `gsky_tpu/fleet/drain.py`.

One :class:`DrainController` guards a serving surface (a worker node's
RPC dispatch, the OWS request handler).  Normal operation tracks every
in-flight task through :meth:`track`; a drain (SIGTERM) flips the
accept gate — new work is refused with :class:`Draining` — and
:meth:`wait_drained` blocks until the in-flight count reaches zero (or
the timeout lapses, for a supervisor that will SIGKILL anyway).

Zero-dropped-request restarts fall out: the load balancer / fleet
router sees ``Draining`` refusals (or the draining heartbeat state) and
re-routes new work, while everything already admitted completes and is
delivered before the process exits.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional


class Draining(ConnectionError):
    """New work refused: this process is draining.

    A ``ConnectionError`` subclass deliberately, like
    :class:`resilience.faults.InjectedFault`: callers' existing
    transport-failure handling (failover to the next node, retry
    classification) applies unchanged.
    """

    retryable = True

    def __init__(self, what: str = "server"):
        super().__init__(f"{what} is draining")


class DrainController:
    def __init__(self, name: str = "server"):
        self.name = name
        self._cond = threading.Condition()
        self._inflight = 0
        self._draining = False
        self.refused = 0
        self.completed = 0
        self.abandoned = 0
        self.drained_at: Optional[float] = None

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    @contextlib.contextmanager
    def track(self):
        """Admit one task for its lifetime; raises :class:`Draining`
        instead when the gate is closed."""
        with self._cond:
            if self._draining:
                self.refused += 1
                raise Draining(self.name)
            self._inflight += 1
        try:
            yield
        finally:
            with self._cond:
                self._inflight -= 1
                self.completed += 1
                if self._inflight == 0:
                    self._cond.notify_all()

    def start_drain(self) -> None:
        """Close the accept gate (idempotent)."""
        with self._cond:
            if not self._draining:
                self._draining = True
                self.drained_at = time.monotonic()
            if self._inflight == 0:
                self._cond.notify_all()

    def wait_drained(self, timeout_s: float = 30.0) -> bool:
        """Block until every in-flight task finished; True on success,
        False when the timeout lapsed with work still running."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            return True

    def drain(self, timeout_s: float = 30.0) -> bool:
        self.start_drain()
        return self.wait_drained(timeout_s)

    def abandon_inflight(self) -> int:
        """Grace-deadline failover: the drain timed out with work still
        running, and the process is about to exit (supervisor SIGKILL,
        preemption deadline).  Count the stranded tasks explicitly —
        their callers will see a transport failure, which the fleet
        router classifies as retryable and fails over — instead of
        exiting with silent in-flight loss.  Returns the count."""
        with self._cond:
            n = self._inflight
            self.abandoned += n
            return n

    def stats(self) -> dict:
        with self._cond:
            return {"draining": self._draining,
                    "inflight": self._inflight,
                    "refused": self.refused,
                    "completed": self.completed,
                    "abandoned": self.abandoned}
