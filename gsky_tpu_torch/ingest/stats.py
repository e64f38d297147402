"""Ingest accounting: one thread-safe ledger for both read paths.

Counterpart of `gsky_tpu/ingest/stats.py`.  The ranged path
(`source.fetch_ranges`) records each coalesced request and the bytes it
fetched (compressed, on-disk bytes: what an object store bills) and
each window served ranged; the whole path (the handle's read, and the
scene cache's full-scene loads) records the logical bytes it
materialised; a ranged read that failed and fell back to the handle's
read counts in ``fallbacks``; the prefetch planner (`ingest.prefetch`)
records its outcomes (hit, miss, wasted).  Ranged-read seconds spent
while a device dispatch is in flight (`dispatch_inflight`, around the
staged tile path's and the export engine's dispatches) count as
overlapped: ``overlap_ratio`` is overlapped over total.  `snapshot`
reads the ledger, `reset` zeroes it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

_lock = threading.Lock()


class _Ledger:
    def __init__(self) -> None:
        self.ranged_reads = 0          # coalesced range requests issued
        self.ranged_read_bytes = 0     # bytes fetched by those requests
        self.ranged_windows = 0        # logical windows served ranged
        self.whole_reads = 0           # whole-path reads (scene/window)
        self.whole_read_bytes = 0      # logical bytes those materialised
        self.read_s = 0.0              # wall seconds in ranged fetches
        self.overlap_s = 0.0           # ... of which dispatch-overlapped
        self.dispatch_inflight = 0     # device dispatches in flight now
        self.fallbacks = 0             # ranged attempts read plainly
        self.prefetch = {"hit": 0, "miss": 0, "wasted": 0}


_L = _Ledger()


def record_ranged(requests: int, nbytes: int, seconds: float = 0.0) -> None:
    with _lock:
        _L.ranged_reads += int(requests)
        _L.ranged_read_bytes += int(nbytes)
        _L.read_s += float(seconds)
        if _L.dispatch_inflight > 0:
            _L.overlap_s += float(seconds)


def record_ranged_window() -> None:
    with _lock:
        _L.ranged_windows += 1


def record_whole(nbytes: int) -> None:
    with _lock:
        _L.whole_reads += 1
        _L.whole_read_bytes += int(nbytes)


def record_fallback() -> None:
    with _lock:
        _L.fallbacks += 1


def record_prefetch(outcome: str, n: int = 1) -> None:
    with _lock:
        if outcome in _L.prefetch:
            _L.prefetch[outcome] += int(n)


@contextlib.contextmanager
def dispatch_inflight():
    """Mark one device dispatch in flight for the overlap accounting."""
    with _lock:
        _L.dispatch_inflight += 1
    try:
        yield
    finally:
        with _lock:
            _L.dispatch_inflight -= 1


def snapshot() -> Dict:
    with _lock:
        return {
            "ranged_reads": _L.ranged_reads,
            "ranged_read_bytes": _L.ranged_read_bytes,
            "ranged_windows": _L.ranged_windows,
            "whole_reads": _L.whole_reads,
            "whole_read_bytes": _L.whole_read_bytes,
            "read_s": round(_L.read_s, 6),
            "overlap_s": round(_L.overlap_s, 6),
            "overlap_ratio": round(
                (_L.overlap_s / _L.read_s) if _L.read_s > 0 else 0.0, 6),
            "dispatch_inflight": _L.dispatch_inflight,
            "fallbacks": _L.fallbacks,
            "prefetch": dict(_L.prefetch),
        }


def reset() -> None:
    """Zero the ledger (tests and the smoke run's phases); the in-flight
    dispatch count survives: it tracks live context managers."""
    global _L
    with _lock:
        inflight = _L.dispatch_inflight
        _L = _Ledger()
        _L.dispatch_inflight = inflight
