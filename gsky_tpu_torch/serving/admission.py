"""Per-service-class admission control with load shedding.

Counterpart of `gsky_tpu/serving/admission.py`.  The pipelines behind
the gateway have finite concurrency (device memory, decode threads,
wave lanes); past that point more requests in flight only grow the
queueing delay until every one times out at once.  Admission bounds
the renders in flight per service class (WMS tiles are cheap and many,
WCS exports heavy, WPS drills heavier), queues a short overflow, and
sheds a request that has waited past ``GSKY_ADMIT_QUEUE_S``: an OGC
503 with ``Retry-After`` costs the client a retry, not a timeout.

Two modes, as in the reference:

* **Fixed** (``GSKY_ADMIT_ADAPTIVE=0``): one ``threading.Semaphore``
  per class sized by ``GSKY_ADMIT_*``.
* **Adaptive** (default): an AIMD controller per class compares the
  latency of recent renders with a slow-moving baseline, cuts the
  in-flight limit by 0.7 when the recent EWMA leaves the knee (above
  ``GSKY_ADMIT_RATIO`` x baseline) and adds one back while latency is
  healthy.  ``GSKY_ADMIT_*`` is the ceiling; the floor is ceiling/8
  (at least 1).  Memory pressure (`resilience.pressure`) clamps the
  effective limit (x0.5 elevated, x0.25 critical).  Waiters queue in a
  weighted-fair per-tenant queue with priority aging: each grant goes
  to the waiter whose tenant has had the least weight-normalised
  service, less an aging credit (``GSKY_ADMIT_AGING`` per second
  waited).  Tenant weights: ``GSKY_TENANT_WEIGHTS``
  (``"bulk:0.25,premium:4"``; default 1.0).

Limits come from ``GSKY_ADMIT_{WMS,WCS,WPS,DAP4}`` (32, 8, 4, 8) and
are read again when a controller is built or `reconfigure` runs on a
config reload, never latched at import.

The reference's server is asyncio and awaits its permits from a worker
thread; the port's is threaded, so `admit` is a plain context manager
over a ``threading.Condition``-style wait in the request's own thread.
A queued request whose cancel token fires (`resilience.cancel`: its
client went away) gives its place back and raises `RequestCancelled`;
it is counted in ``cancelled``.  A shed request carries the least
loaded healthy node of the live fleet routers as
``AdmissionShed.alt_node`` (`fleet.least_loaded_node`, None without a
``worker_nodes`` fleet), which the OWS layer sends as
``X-GSKY-Alt-Node``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

from ..fleet import least_loaded_node
from ..resilience.cancel import RequestCancelled, current_token
from ..resilience.pressure import pressure_state

# how often a queued request looks at its cancel token
_POLL_S = 0.05


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# class -> (env knob, default ceiling).  Resolved at controller build
# and on reload, not at import.
_LIMIT_KNOBS = {
    "WMS": ("GSKY_ADMIT_WMS", 32),
    "WCS": ("GSKY_ADMIT_WCS", 8),
    "WPS": ("GSKY_ADMIT_WPS", 4),
    "DAP4": ("GSKY_ADMIT_DAP4", 8),
}


def default_limits() -> Dict[str, int]:
    return {svc: _env_int(env, d) for svc, (env, d) in _LIMIT_KNOBS.items()}


def default_queue_deadline_s() -> float:
    return _env_float("GSKY_ADMIT_QUEUE_S", 5.0)


def _tenant_weights() -> Dict[str, float]:
    """GSKY_TENANT_WEIGHTS="bulk:0.25,premium:4" -> {..}; default 1.0."""
    out: Dict[str, float] = {}
    spec = os.environ.get("GSKY_TENANT_WEIGHTS", "")
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause or ":" not in clause:
            continue
        name, _, w = clause.rpartition(":")
        try:
            out[name.strip()] = max(0.01, float(w))
        except ValueError:
            continue
    return out


class AdmissionShed(Exception):
    """A request waited past the queue deadline: HTTP 503 with
    ``Retry-After`` at the OWS layer.  ``alt_node``, when set, names the
    least loaded healthy worker node at shed time (``X-GSKY-Alt-Node``),
    so that a balancer in front of several gateways can steer the retry
    to spare capacity."""

    def __init__(self, service_class: str, retry_after: int,
                 alt_node: Optional[str] = None):
        super().__init__(
            f"{service_class} service at capacity; retry after "
            f"{retry_after}s")
        self.service_class = service_class
        self.retry_after = retry_after
        self.alt_node = alt_node


class _ClassState:
    __slots__ = ("limit", "ceiling", "floor", "sem", "in_use", "queued",
                 "shed", "admitted", "cancelled", "adjustments",
                 "baseline_s", "recent_s", "last_adjust_t", "waiters",
                 "tenant_served", "tenant_queued")

    def __init__(self, limit: int):
        self.limit = limit               # current (adaptive) limit
        self.ceiling = limit             # configured GSKY_ADMIT_* value
        self.floor = max(1, limit // 8)
        self.sem = threading.Semaphore(limit)   # fixed-mode primitive
        self.in_use = 0
        self.queued = 0
        self.shed = 0
        self.admitted = 0
        self.cancelled = 0               # permits released by cancel
        self.adjustments = 0             # AIMD limit changes
        self.baseline_s = 0.0            # slow latency EWMA
        self.recent_s = 0.0              # fast latency EWMA
        self.last_adjust_t = 0.0
        self.waiters: list = []          # adaptive-mode fair queue
        self.tenant_served: Dict[str, float] = {}
        self.tenant_queued: Dict[str, int] = {}


class _Waiter:
    __slots__ = ("tenant", "event", "state", "t_enq")
    WAITING, GRANTED, ABANDONED = 0, 1, 2

    def __init__(self, tenant: str, clock: float):
        self.tenant = tenant
        self.event = threading.Event()
        self.state = _Waiter.WAITING
        self.t_enq = clock


class AdmissionController:
    def __init__(self, limits: Optional[Dict[str, int]] = None,
                 queue_deadline_s: Optional[float] = None,
                 adaptive: Optional[bool] = None):
        self._lock = threading.Lock()
        self.adaptive = (os.environ.get("GSKY_ADMIT_ADAPTIVE", "1") != "0"
                         if adaptive is None else adaptive)
        self._explicit_limits = dict(limits) if limits else None
        self._explicit_deadline = queue_deadline_s
        self._classes: Dict[str, _ClassState] = {}
        self.queue_deadline_s = 0.0
        self.reconfigure()

    def reconfigure(self) -> None:
        """Read the limits and the queue deadline from the environment
        again: at build time and on a config reload, so that
        ``GSKY_ADMIT_*`` changes land without a restart.  Live counters
        carry over; ceilings, floors and fixed-mode semaphores are
        rebuilt from the fresh values."""
        merged = default_limits()
        if self._explicit_limits:
            merged.update(self._explicit_limits)
        with self._lock:
            self.queue_deadline_s = (
                default_queue_deadline_s()
                if self._explicit_deadline is None
                else self._explicit_deadline)
            for svc, n in merged.items():
                st = self._classes.get(svc)
                if st is None:
                    self._classes[svc] = _ClassState(n)
                elif st.ceiling != n:
                    st.ceiling = n
                    st.floor = max(1, n // 8)
                    st.limit = min(max(st.limit, st.floor), n)
                    st.sem = threading.Semaphore(n)
                    st.adjustments += 1

    def _state(self, service_class: str) -> _ClassState:
        st = self._classes.get(service_class)
        if st is None:      # unknown class: fail open under WMS limits
            st = self._classes.get("WMS")
            if st is None:
                with self._lock:
                    st = self._classes.setdefault(
                        service_class, _ClassState(32))
        return st

    # ---- adaptive machinery -------------------------------------------

    def _effective_limit(self, st: _ClassState) -> int:
        """The AIMD limit, clamped further under memory pressure."""
        limit = st.limit
        try:
            p = pressure_state()
        except Exception:
            p = 0
        if p >= 2:
            limit = max(1, int(limit * 0.25))
        elif p == 1:
            limit = max(1, int(limit * 0.5))
        return limit

    def observe(self, service_class: str, latency_s: float) -> None:
        """Fold one completed render's latency into the class's AIMD
        controller.  Multiplicative decrease when the fast EWMA leaves
        the knee (recent > ratio x baseline), additive recovery toward
        the ceiling while latency tracks the baseline."""
        if not self.adaptive:
            return
        st = self._state(service_class)
        ratio = _env_float("GSKY_ADMIT_RATIO", 1.5)
        interval = _env_float("GSKY_ADMIT_INTERVAL_S", 1.0)
        now = time.monotonic()
        with self._lock:
            if st.baseline_s <= 0.0:
                st.baseline_s = st.recent_s = latency_s
            else:
                st.recent_s += 0.3 * (latency_s - st.recent_s)
                st.baseline_s += 0.05 * (latency_s - st.baseline_s)
            if now - st.last_adjust_t < interval:
                return
            threshold = max(st.baseline_s * ratio, st.baseline_s + 0.05)
            if st.recent_s > threshold and st.limit > st.floor:
                st.limit = max(st.floor, int(st.limit * 0.7))
                st.adjustments += 1
                st.last_adjust_t = now
            elif st.recent_s <= st.baseline_s * 1.1 \
                    and st.limit < st.ceiling:
                st.limit += 1
                st.adjustments += 1
                st.last_adjust_t = now

    def _grant_waiters(self, st: _ClassState) -> None:  # caller holds the lock
        """Weighted-fair scheduler: while capacity is free, grant the
        waiter whose tenant has the least weight-normalised service,
        minus an aging credit so long-queued tenants always drain.
        Caller holds the lock."""
        weights = _tenant_weights()
        aging = _env_float("GSKY_ADMIT_AGING", 0.5)
        now = time.monotonic()
        while st.waiters and st.in_use < self._effective_limit(st):
            best = None
            best_score = None
            for w in st.waiters:
                if w.state != _Waiter.WAITING:
                    continue
                wt = weights.get(w.tenant, 1.0)
                score = (st.tenant_served.get(w.tenant, 0.0) / wt
                         - aging * (now - w.t_enq))
                # FIFO within a tenant: earlier enqueue wins ties
                if best_score is None or score < best_score or \
                        (score == best_score and w.t_enq < best.t_enq):
                    best, best_score = w, score
            if best is None:
                break
            best.state = _Waiter.GRANTED
            st.waiters.remove(best)
            st.in_use += 1
            st.admitted += 1
            self._charge(st, best.tenant)
            best.event.set()

    def _charge(self, st: _ClassState, tenant: str) -> None:
        """One unit of service against the tenant's ledger, decaying
        the whole ledger so old consumption stops mattering (caller
        holds the lock)."""
        served = st.tenant_served
        served[tenant] = served.get(tenant, 0.0) + 1.0
        if served[tenant] > 1e6:            # keep the floats bounded
            for t in list(served):
                served[t] *= 0.5
        # decay: every charge fades everyone slightly, so fairness is
        # about the recent past, not the process lifetime
        for t in list(served):
            served[t] *= 0.995
            if served[t] < 1e-3:
                del served[t]

    def _release_adaptive(self, st: _ClassState,
                          cancelled: bool = False) -> None:
        with self._lock:
            st.in_use -= 1
            if cancelled:
                st.cancelled += 1
            self._grant_waiters(st)

    def _shed(self, st: _ClassState, service_class: str) -> AdmissionShed:
        with self._lock:
            st.shed += 1
        try:
            alt = least_loaded_node()
        except Exception:  # a router torn down mid-scan: no hint
            alt = None
        return AdmissionShed(
            service_class,
            retry_after=max(1, int(round(self.queue_deadline_s))),
            alt_node=alt)

    @staticmethod
    def _wait(wait_fn, deadline_s: float, tok) -> bool:
        """``wait_fn(timeout)`` until it succeeds or ``deadline_s``
        passes, looking at the cancel token between slices; raises
        `RequestCancelled` when it fires."""
        end = time.monotonic() + max(0.0, deadline_s)
        while True:
            left = end - time.monotonic()
            step = left if tok is None else min(left, _POLL_S)
            if wait_fn(max(0.0, step)):
                return True
            if tok is not None:
                tok.check("admission")
            if time.monotonic() >= end:
                return False

    @contextlib.contextmanager
    def _admit_adaptive(self, st: _ClassState, service_class: str,
                        tenant: str):
        granted = False
        tok = current_token()
        with self._lock:
            if not st.waiters and st.in_use < self._effective_limit(st):
                st.in_use += 1
                st.admitted += 1
                self._charge(st, tenant)
                granted = True
            else:
                w = _Waiter(tenant, time.monotonic())
                st.waiters.append(w)
                st.queued += 1
                st.tenant_queued[tenant] = \
                    st.tenant_queued.get(tenant, 0) + 1
        if not granted:
            try:
                self._wait(w.event.wait, self.queue_deadline_s, tok)
            except RequestCancelled:
                with self._lock:
                    if w.state == _Waiter.WAITING:
                        w.state = _Waiter.ABANDONED
                        try:
                            st.waiters.remove(w)
                        except ValueError:
                            pass
                        st.cancelled += 1
                    else:       # granted in the race: hand it back
                        st.in_use -= 1
                        st.cancelled += 1
                        self._grant_waiters(st)
                raise
            else:
                with self._lock:
                    if w.state == _Waiter.GRANTED:
                        granted = True
                    else:
                        w.state = _Waiter.ABANDONED
                        try:
                            st.waiters.remove(w)
                        except ValueError:
                            pass
            finally:
                with self._lock:
                    st.queued -= 1
                    n = st.tenant_queued.get(tenant, 1) - 1
                    if n <= 0:
                        st.tenant_queued.pop(tenant, None)
                    else:
                        st.tenant_queued[tenant] = n
        if not granted:
            raise self._shed(st, service_class)
        t0 = time.monotonic()
        try:
            yield
        except RequestCancelled:
            self._release_adaptive(st, cancelled=True)
            raise
        except BaseException:
            self._release_adaptive(st)
            raise
        else:
            self._release_adaptive(
                st, cancelled=tok is not None and tok.cancelled())
            self.observe(service_class, time.monotonic() - t0)

    @contextlib.contextmanager
    def _admit_fixed(self, st: _ClassState, service_class: str):
        sem = st.sem        # a reconfigure swaps it; release this one
        ok = sem.acquire(blocking=False)
        if not ok:
            with self._lock:
                st.queued += 1
            try:
                ok = self._wait(lambda t: sem.acquire(True, t),
                                self.queue_deadline_s, current_token())
            except RequestCancelled:
                with self._lock:
                    st.cancelled += 1
                raise
            finally:
                with self._lock:
                    st.queued -= 1
        if not ok:
            raise self._shed(st, service_class)
        with self._lock:
            st.in_use += 1
            st.admitted += 1
        try:
            yield
        finally:
            with self._lock:
                st.in_use -= 1
            sem.release()

    def admit(self, service_class: str, tenant: str = ""):
        """A context manager bounding one render in flight; raises
        `AdmissionShed` when the request waited past the queue deadline.
        ``tenant`` (API key, client address) keys the adaptive mode's
        weighted-fair queue; the fixed mode ignores it."""
        st = self._state(service_class)
        if self.adaptive:
            return self._admit_adaptive(st, service_class,
                                        tenant or "anon")
        return self._admit_fixed(st, service_class)

    @property
    def total_shed(self) -> int:
        with self._lock:
            return sum(st.shed for st in self._classes.values())

    @property
    def total_adjustments(self) -> int:
        with self._lock:
            return sum(st.adjustments for st in self._classes.values())

    @property
    def total_cancelled(self) -> int:
        with self._lock:
            return sum(st.cancelled for st in self._classes.values())

    def stats(self) -> Dict:
        with self._lock:
            tenants = {}
            for svc, st in self._classes.items():
                for t, n in st.tenant_queued.items():
                    tenants[f"{t}/{svc}"] = n
            return {
                "queue_deadline_s": self.queue_deadline_s,
                "adaptive": self.adaptive,
                "classes": {
                    svc: {"limit": st.limit, "ceiling": st.ceiling,
                          "effective_limit": self._effective_limit(st)
                          if self.adaptive else st.limit,
                          "in_use": st.in_use,
                          "queued": st.queued, "admitted": st.admitted,
                          "shed": st.shed, "cancelled": st.cancelled,
                          "adjustments": st.adjustments,
                          "recent_ms": round(st.recent_s * 1e3, 2),
                          "baseline_ms": round(st.baseline_s * 1e3, 2)}
                    for svc, st in self._classes.items()},
                "tenants": tenants}
