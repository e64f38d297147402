"""Flight recorder: keep the traces you will wish you had.

Counterpart of `gsky_tpu/obs/recorder.py`.

An always-on in-memory ring holds the last N completed traces; a
separate reservoir keeps the slowest and any degraded / erroring /
deadline-exceeded ones so a burst of fast requests cannot evict the one
trace that explains an SLO page.  ``/debug/trace`` lists both,
``/debug/trace/<id>`` returns the full span tree, and everything dumps
as JSONL.

File export is optional: ``GSKY_TRACE_FILE`` names a JSONL sink,
``GSKY_TRACE_SAMPLE`` (0..1, default 0 — explicit opt-in) samples the
healthy traffic written there.  SLO violations (``GSKY_TRACE_SLO_S``,
default 2s) are always written when a file is configured, sampled or
not.
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import random
import threading
from typing import Any, Dict, List, Optional


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None,
                 reservoir: Optional[int] = None,
                 slo_s: Optional[float] = None,
                 trace_file: Optional[str] = None,
                 sample: Optional[float] = None):
        self.capacity = capacity if capacity is not None else \
            _env_int("GSKY_TRACE_RING", 64)
        self.reservoir_cap = reservoir if reservoir is not None else \
            _env_int("GSKY_TRACE_RESERVOIR", 16)
        self.slo_s = slo_s if slo_s is not None else \
            _env_float("GSKY_TRACE_SLO_S", 2.0)
        self.trace_file = trace_file if trace_file is not None else \
            os.environ.get("GSKY_TRACE_FILE") or None
        self.sample = sample if sample is not None else \
            _env_float("GSKY_TRACE_SAMPLE", 0.0)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, self.capacity))
        # min-heap of (dur_s, seq, trace): the fastest "interesting"
        # trace is evicted first once the reservoir is full
        self._reservoir: List[tuple] = []
        self._seq = 0
        self.recorded = 0
        self.evicted = 0
        self.slo_violations = 0
        self._file_lock = threading.Lock()

    # -- classification ----------------------------------------------
    def _interesting(self, trace: Dict[str, Any]) -> bool:
        if (trace.get("dur_s") or 0.0) >= self.slo_s:
            return True
        status = trace.get("status")
        if isinstance(status, int) and status >= 500:
            return True
        if trace.get("degraded"):
            return True
        attrs = trace.get("attrs") or {}
        return bool(attrs.get("deadline_exceeded") or attrs.get("error"))

    # -- recording ----------------------------------------------------
    def record(self, trace: Dict[str, Any]) -> None:
        dur = float(trace.get("dur_s") or 0.0)
        slow = dur >= self.slo_s
        interesting = self._interesting(trace)
        with self._lock:
            self.recorded += 1
            if len(self._ring) == self._ring.maxlen:
                self.evicted += 1
            self._ring.append(trace)
            if slow:
                self.slo_violations += 1
            if interesting:
                self._seq += 1
                entry = (dur, self._seq, trace)
                if len(self._reservoir) < self.reservoir_cap:
                    heapq.heappush(self._reservoir, entry)
                elif self._reservoir and dur > self._reservoir[0][0]:
                    heapq.heapreplace(self._reservoir, entry)
        if self.trace_file and (
                slow or (self.sample > 0 and random.random() < self.sample)):
            self._write_file(trace)

    def _write_file(self, trace: Dict[str, Any]) -> None:
        try:
            line = json.dumps(trace, default=str)
            with self._file_lock:
                with open(self.trace_file, "a", encoding="utf-8") as fh:
                    fh.write(line + "\n")
        except Exception:  # trace file write is best-effort telemetry
            pass

    # -- query --------------------------------------------------------
    def lookup(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for t in reversed(self._ring):
                if t.get("trace_id") == trace_id:
                    return t
            for _, _, t in self._reservoir:
                if t.get("trace_id") == trace_id:
                    return t
        return None

    def traces(self) -> List[Dict[str, Any]]:
        """All retained traces, ring first (oldest→newest), then any
        reservoir-only ones (slowest-last)."""
        with self._lock:
            out = list(self._ring)
            seen = {t.get("trace_id") for t in out}
            extra = [t for _, _, t in sorted(self._reservoir)
                     if t.get("trace_id") not in seen]
        return out + extra

    def slowest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            best = None
            for t in self._ring:
                if best is None or (t.get("dur_s") or 0) > \
                        (best.get("dur_s") or 0):
                    best = t
            for _, _, t in self._reservoir:
                if best is None or (t.get("dur_s") or 0) > \
                        (best.get("dur_s") or 0):
                    best = t
        return best

    def summary(self) -> List[Dict[str, Any]]:
        out = []
        for t in self.traces():
            dur = t.get("dur_s") or 0.0
            out.append({
                "trace_id": t.get("trace_id"),
                "name": t.get("name"),
                "t0": t.get("t0"),
                "dur_ms": round(dur * 1000.0, 3),
                "status": t.get("status"),
                "spans": len(t.get("spans") or ()),
                "processes": sorted({s.get("process") or "?"
                                     for s in t.get("spans") or ()}),
                "degraded": t.get("degraded") or [],
                "slow": dur >= self.slo_s,
            })
        return out

    def dump_jsonl(self) -> str:
        return "\n".join(json.dumps(t, default=str)
                         for t in self.traces()) + "\n"

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "recorded": self.recorded,
                "retained": len(self._ring),
                "reservoir": len(self._reservoir),
                "evicted": self.evicted,
                "slo_violations": self.slo_violations,
                "slo_s": self.slo_s,
                "capacity": self.capacity,
            }


_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_recorder() -> FlightRecorder:
    global _DEFAULT
    rec = _DEFAULT
    if rec is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = FlightRecorder()
            rec = _DEFAULT
    return rec


def reset_recorder() -> None:
    """Test hook: drop the singleton so env knobs are re-read."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
