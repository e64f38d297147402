"""Host memory-pressure watchdog feeding admission, caches and brownout.

Counterpart of `gsky_tpu/resilience/pressure.py`.  A process-wide
**pressure state**:

    0  nominal
    1  elevated  - brownout: degrade quality before availability
                   (overview substitution, the cheapest PNG effort,
                   half the animation frames, ``X-GSKY-Degraded:
                   brownout``); admission limits tighten; the prefetch
                   planner declines
    2  critical  - also empty the scene, drill-stack and response
                   caches, trim the page pools, and decline new page
                   staging (a declined tile takes kernel B2) before a
                   MemoryError or a device OOM kills the process

Two inputs, both cheap to read: host ``MemAvailable`` (``/proc/meminfo``)
and page-pool occupancy: the pinned pages over capacity of the fullest
live `pipeline.pages.PagePool` (the port has one pool per executor, not
one process-wide pool).  The reference reads resident pages over
capacity; but a page pool is an LRU, full of evictable pages once it is
warm, so that signal reads a warm server as critical for good (on the
card, `chip_smoke.py` phase 18 browned out and declined every tile to
B2 after its pools filled).  Pinned pages are the ones no eviction can
free: the pool is full in the sense that matters when they fill it.  The monitor is pull-based: no
polling thread; ``state()`` recomputes at most once per
``GSKY_PRESSURE_POLL_S`` when someone asks, so an idle process pays
nothing and tests stay deterministic.  Rising pressure applies at once;
recovery is hysteretic (the raw signal must stay clear for
``GSKY_PRESSURE_CLEAR_S``) so brownout does not flap at a threshold.

Knobs::

    GSKY_PRESSURE=0              disable entirely (state is always 0)
    GSKY_PRESSURE_AVAIL_MB=256   elevated below this MemAvailable
    GSKY_PRESSURE_CRIT_MB=128    critical below this MemAvailable
    GSKY_PRESSURE_POOL=0.90      elevated at this page-pool occupancy
    GSKY_PRESSURE_POOL_CRIT=0.97 critical at this page-pool occupancy
    GSKY_PRESSURE_POLL_S=0.5     recompute interval
    GSKY_PRESSURE_CLEAR_S=3.0    sustained-clear window for recovery
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _pool_occupancy() -> Optional[float]:
    """Pinned fraction of the fullest live page pool whose device tensor
    exists, or None when there is none (a pool is never allocated just
    to measure it)."""
    try:
        from ..pipeline import pages
        fracs = []
        for pool in pages.live_pools():
            st = pool.stats()
            cap = st.get("capacity") or 0
            if cap > 0 and pool.allocated:
                fracs.append(min(1.0, st.get("pinned", 0) / cap))
        return max(fracs) if fracs else None
    except Exception:  # a pool being torn down says nothing
        return None


def mem_available_bytes(meminfo_path: str = "/proc/meminfo"
                        ) -> Optional[int]:
    """Host ``MemAvailable`` in bytes, or None where it cannot be read."""
    try:
        with open(meminfo_path) as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError):
        return None
    return None


def _mem_available() -> Optional[int]:
    return mem_available_bytes()


class PressureMonitor:
    """Lazy-recomputing pressure state with hysteretic recovery and
    critical-transition cache relief.  Readers are injectable so tests
    drive the exact threshold-crossing sequences."""

    def __init__(self,
                 avail_reader: Callable[[], Optional[int]] = _mem_available,
                 pool_reader: Callable[[], Optional[float]] = _pool_occupancy,
                 clock: Callable[[], float] = time.monotonic):
        self.avail_reader = avail_reader
        self.pool_reader = pool_reader
        self.clock = clock
        self._lock = threading.Lock()
        self._state = 0
        self._forced: Optional[int] = None
        self._last_check = -1e9
        self._clear_since: Optional[float] = None
        self._floor_state = 0
        self._floor_until = -1e9
        self.transitions = 0
        self.trims = 0
        self.escalations = 0
        self._last_avail: Optional[int] = None
        self._last_pool: Optional[float] = None

    # -- config (re-read per recompute: live-tunable via environment) --

    @staticmethod
    def _enabled() -> bool:
        return os.environ.get("GSKY_PRESSURE", "1") != "0"

    def _raw_state(self) -> int:  # gskylint: holds-lock
        avail = self.avail_reader()
        pool = self.pool_reader()
        self._last_avail = avail
        self._last_pool = pool
        crit_b = _env_float("GSKY_PRESSURE_CRIT_MB", 128.0) * (1 << 20)
        elev_b = _env_float("GSKY_PRESSURE_AVAIL_MB", 256.0) * (1 << 20)
        pool_e = _env_float("GSKY_PRESSURE_POOL", 0.90)
        pool_c = _env_float("GSKY_PRESSURE_POOL_CRIT", 0.97)
        if (avail is not None and avail < crit_b) or \
                (pool is not None and pool >= pool_c):
            return 2
        if (avail is not None and avail < elev_b) or \
                (pool is not None and pool >= pool_e):
            return 1
        return 0

    # -- relief actions -------------------------------------------------

    def _relieve(self) -> None:
        """Critical transition: drop rebuildable device and host caches
        now (a cold cache beats a dead process): every live scene cache,
        every drill-stack cache, the process gateway's response cache,
        and the colder half of every page pool's unpinned pages.  Each
        sink is best-effort and imported lazily (pressure never fails a
        request).  Runs outside ``self._lock`` (a clear can be slow), so
        the counter bump takes it."""
        with self._lock:
            self.trims += 1
        try:
            from ..pipeline.scene_cache import live_caches
            for cache in live_caches():
                cache.clear()
        except Exception:  # sink absent - relief is best-effort
            pass
        try:
            from ..pipeline.drill_cache import clear_all
            clear_all()
        except Exception:  # sink absent - relief is best-effort
            pass
        try:
            from ..serving import default_gateway
            default_gateway.cache.clear()
        except Exception:  # sink absent - relief is best-effort
            pass
        try:
            from ..pipeline.pages import live_pools
            for pool in live_pools():
                pool.trim(0.5)
        except Exception:  # sink absent - relief is best-effort
            pass

    # -- state ----------------------------------------------------------

    def force(self, state: Optional[int]) -> None:
        """Pin the state (tests, the smoke run, operator drills);
        ``force(None)`` resumes measurement."""
        relieve = False
        with self._lock:
            self._forced = state
            if state is not None and state != self._state:
                self.transitions += 1
                relieve = state >= 2 > self._state
                self._state = state
            self._clear_since = None
        if relieve:
            self._relieve()

    def escalate(self, level: int = 1,
                 hold_s: Optional[float] = None) -> None:
        """One-shot escalation (the device guard's OOM relief calls
        it): floor the reported state at ``level`` for ``hold_s``
        (default the CLEAR window) and run the cache relief *now*.
        Unlike :meth:`force` this does not pin measurement — a genuine
        critical reading still wins, and the floor expires on its own."""
        hold = _env_float("GSKY_PRESSURE_CLEAR_S", 3.0) \
            if hold_s is None else hold_s
        with self._lock:
            self.escalations += 1
            self._floor_state = max(1, min(2, int(level)))
            self._floor_until = self.clock() + max(0.0, hold)
        self._relieve()

    def state(self) -> int:
        if not self._enabled():
            return 0
        step_to_crit = False
        with self._lock:
            if self._forced is not None:
                return self._forced
            now = self.clock()
            if now - self._last_check >= _env_float(
                    "GSKY_PRESSURE_POLL_S", 0.5):
                self._last_check = now
                raw = self._raw_state()
                prev = self._state
                if raw >= prev:
                    # rising (or holding): apply immediately
                    if raw > prev:
                        self._state = raw
                        self.transitions += 1
                    self._clear_since = None
                    step_to_crit = raw >= 2 > prev
                else:
                    # falling: require a sustained clear window
                    if self._clear_since is None:
                        self._clear_since = now
                    elif now - self._clear_since >= _env_float(
                            "GSKY_PRESSURE_CLEAR_S", 3.0):
                        self._state = raw
                        self.transitions += 1
                        self._clear_since = None
            out = self._state
            if self._floor_state and now < self._floor_until:
                out = max(out, self._floor_state)
        if step_to_crit:
            self._relieve()
        return out

    def stats(self) -> Dict:
        with self._lock:
            return {
                "state": self._state if self._enabled() else 0,
                "forced": self._forced,
                "mem_available_mb": None if self._last_avail is None
                else round(self._last_avail / (1 << 20), 1),
                "pool_occupancy": None if self._last_pool is None
                else round(self._last_pool, 3),
                "transitions": self.transitions,
                "trims": self.trims,
                "escalations": self.escalations,
            }

    def reset(self) -> None:
        with self._lock:
            self._state = 0
            self._forced = None
            self._last_check = -1e9
            self._clear_since = None
            self._floor_state = 0
            self._floor_until = -1e9
            self.transitions = 0
            self.trims = 0
            self.escalations = 0
            self._last_avail = None
            self._last_pool = None


_default = PressureMonitor()


def default_monitor() -> PressureMonitor:
    return _default


def pressure_state() -> int:
    """The process pressure state right now (0 / 1 / 2)."""
    return _default.state()


def brownout_level() -> int:
    """0 when nominal; the pressure state (1 or 2) when the server
    should degrade quality before availability."""
    return _default.state()


def staging_allowed() -> bool:
    """Whether a page pool may stage new pages: critical pressure
    declines staging, so a paged render takes the bucketed leg (kernel
    B2) instead of growing device residency into an OOM."""
    return _default.state() < 2
