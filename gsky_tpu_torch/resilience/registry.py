"""Process-wide counters for the resilience layer.

Counterpart of `gsky_tpu/resilience/registry.py`.  One shared registry
collects retry counts, exhaustions, injected-fault counts, deadline
exhaustions and degraded-response totals, plus a handle on every
circuit breaker made through ``get_breaker``.  `stats` is the block
``/debug`` and the ``/metrics`` collectors read.  Retries, exhausted
budgets, degraded responses, exhausted deadlines and breaker trips are
also `note_event`s: a point event on the request's trace and a tick of
``gsky_trace_events_total``.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..obs import event
from ..obs.metrics import TRACE_EVENTS


def note_event(kind: str, **attrs) -> None:
    """A point event on the current trace's root and a tick of
    ``gsky_trace_events_total{kind}``."""
    TRACE_EVENTS.labels(kind=kind).inc()
    event(kind, **attrs)


class ResilienceRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._retries: Dict[str, int] = {}
        self._exhausted: Dict[str, int] = {}
        self._faults: Dict[str, int] = {}
        self._breakers: Dict[str, object] = {}
        self.degraded_responses = 0
        self.deadline_exhausted = 0

    # ---- counters ----------------------------------------------------
    def count_retry(self, site: str) -> None:
        with self._lock:
            self._retries[site] = self._retries.get(site, 0) + 1
        note_event("retry", site=site)

    def count_exhausted(self, site: str) -> None:
        with self._lock:
            self._exhausted[site] = self._exhausted.get(site, 0) + 1
        note_event("retry_exhausted", site=site)

    def count_fault(self, site: str) -> None:
        with self._lock:
            self._faults[site] = self._faults.get(site, 0) + 1

    def count_degraded(self) -> None:
        with self._lock:
            self.degraded_responses += 1
        note_event("degraded")

    def count_deadline(self) -> None:
        with self._lock:
            self.deadline_exhausted += 1
        note_event("deadline_exceeded")

    # ---- breakers ----------------------------------------------------
    def register_breaker(self, breaker) -> None:
        with self._lock:
            self._breakers[breaker.name] = breaker

    def unregister_breakers(self) -> None:
        with self._lock:
            self._breakers.clear()

    # ---- reporting ---------------------------------------------------
    def stats(self) -> Dict:
        with self._lock:
            breakers = dict(self._breakers)
            out = {
                "retries": dict(self._retries),
                "retry_exhausted": dict(self._exhausted),
                "faults_injected": dict(self._faults),
                "degraded_responses": self.degraded_responses,
                "deadline_exhausted": self.deadline_exhausted,
            }
        # each breaker's snapshot takes its own lock, never inside ours
        out["breakers"] = {n: b.snapshot() for n, b in breakers.items()}
        return out

    def reset(self) -> None:
        with self._lock:
            self._retries.clear()
            self._exhausted.clear()
            self._faults.clear()
            self._breakers.clear()
            self.degraded_responses = 0
            self.deadline_exhausted = 0


registry = ResilienceRegistry()
