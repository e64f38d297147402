"""Per-backend circuit breakers (closed / open / half-open).

Counterpart of `gsky_tpu/resilience/breaker.py`.  A breaker guards one
backend (one MAS address, one range host, one worker node).  While
*closed* every call is allowed; after ``failure_threshold``
consecutive failures it *opens* and rejects calls at once; after ``reset_timeout`` seconds it is
*half-open* and admits one probe at a time: a successful probe closes
it, a failed one opens it for another cooldown.  `get_breaker` shares
one breaker per name, so every client of one backend sees one health,
and registers it with `registry`, whose `stats` reads each one's
`snapshot`.  State listeners (`add_listener`) let the fleet router
fold a trip into node health.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List

from .registry import note_event, registry


class BackendUnavailable(RuntimeError):
    """A backend stayed unreachable after retries."""

    def __init__(self, message: str, site: str = "",
                 retry_after: float = 5.0):
        super().__init__(message)
        self.site = site
        self.retry_after = retry_after


class BreakerOpen(BackendUnavailable):
    """Rejected without calling the backend: its breaker is open."""


class CircuitBreaker:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 register: bool = True):
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self.opens = 0
        self.successes = 0
        self.failures = 0
        self.probes = 0
        self.rejections = 0
        self._listeners: List[Callable] = []
        if register:
            registry.register_breaker(self)

    def add_listener(self, fn: Callable) -> None:
        """Subscribe ``fn(breaker, old_state, new_state)`` to state
        transitions, fired outside the breaker's lock: the fleet router
        takes an OPEN as an immediate dead-node report."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def _notify(self, old: str, new: str, listeners) -> None:
        for fn in listeners:
            try:
                fn(self, old, new)
            except Exception:
                logging.getLogger("gsky.resilience.breaker").exception(
                    "breaker %s listener failed", self.name)

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == self.OPEN and \
                    self._clock() - self._opened_at >= self.reset_timeout:
                return self.HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """May a call proceed now?  Half-open admits one probe at a
        time; its outcome decides the next state."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.reset_timeout:
                    self.rejections += 1
                    return False
                self._state = self.HALF_OPEN
                self._probing = False
            if self._probing:
                self.rejections += 1
                return False
            self._probing = True
            self.probes += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            self.successes += 1
            self._consecutive = 0
            self._probing = False
            old = self._state
            self._state = self.CLOSED
            listeners = list(self._listeners) if old != self.CLOSED else ()
        if listeners:
            self._notify(old, self.CLOSED, listeners)

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self._consecutive += 1
            old = self._state
            if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probing = False
                self.opens += 1
            new = self._state
            tripped = new == self.OPEN and old != self.OPEN
            listeners = list(self._listeners) if new != old else ()
        if tripped:
            note_event("breaker_open", site=self.name)
        if listeners:
            self._notify(old, new, listeners)

    def retry_after(self) -> float:
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.reset_timeout -
                       (self._clock() - self._opened_at))

    def open_error(self) -> BreakerOpen:
        return BreakerOpen(
            f"circuit breaker {self.name!r} is open",
            site=self.name, retry_after=max(1.0, self.retry_after()))

    def snapshot(self) -> Dict:
        with self._lock:
            state = self._state
            if state == self.OPEN and \
                    self._clock() - self._opened_at >= self.reset_timeout:
                state = self.HALF_OPEN
            return {
                "state": state,
                "consecutive_failures": self._consecutive,
                "opens": self.opens,
                "successes": self.successes,
                "failures": self.failures,
                "probes": self.probes,
                "rejections": self.rejections,
            }


_BREAKERS: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def get_breaker(name: str, **kwargs) -> CircuitBreaker:
    """Shared breaker for ``name``, created on first use."""
    with _breakers_lock:
        br = _BREAKERS.get(name)
        if br is None:
            br = _BREAKERS[name] = CircuitBreaker(name, **kwargs)
        return br


def reset_breakers() -> None:
    """Drop every shared breaker (test hook)."""
    with _breakers_lock:
        _BREAKERS.clear()
