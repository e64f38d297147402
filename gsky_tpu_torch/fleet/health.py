"""Fleet membership + heartbeat health with phi-accrual suspicion.

Counterpart of `gsky_tpu/fleet/health.py`, the same states, thresholds
and probe loop.

Every worker node gets a :class:`NodeHealth` record fed by heartbeats
(successful RPCs, periodic ``worker_info`` probes) and failure reports
(transport errors, breaker trips).  Instead of a binary alive/dead
timeout, suspicion is *accrued*: phi grows continuously with the time
since the last heartbeat, scaled by the node's own observed heartbeat
cadence (the phi-accrual failure detector of Hayashibara et al., as
deployed in Cassandra/Akka).  Two thresholds map phi onto three states:

- ``healthy``   — phi < suspect_phi: full routing weight
- ``suspect``   — suspect_phi <= phi < dead_phi: deprioritised (routed
  only when no healthy candidate remains)
- ``dead``      — phi >= dead_phi (or an explicit report): not routed;
  its ring arc re-routes to the next nodes until it heartbeats again

A fourth, explicit state — ``draining`` — is entered when the node
*says* it is draining (SIGTERM handshake): not routable, but not a
failure either.

The monitor is passive by default (the caller feeds heartbeats from
its real RPC traffic); :meth:`HealthMonitor.start` adds an active
probe thread for idle periods.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

log = logging.getLogger("gsky.fleet.health")

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
DRAINING = "draining"

# phi of a node that has NEVER heartbeated: optimistic (routable) so a
# cold fleet can bootstrap, but below dead so a first failure can kill it
_PHI_UNKNOWN = 0.0
_LOG10E = math.log10(math.e)


class NodeHealth:
    """Heartbeat history + explicit reports for one node."""

    __slots__ = ("node", "last_beat", "mean_interval", "beats",
                 "failures", "reported_dead", "draining")

    def __init__(self, node: str):
        self.node = node
        self.last_beat: Optional[float] = None
        # EWMA of inter-heartbeat intervals; seeded by the first probe
        self.mean_interval: Optional[float] = None
        self.beats = 0
        self.failures = 0
        self.reported_dead = False
        self.draining = False


class HealthMonitor:
    """Phi-accrual health over a node set.

    ``probe(node)`` (optional) returns truthy when the node answered —
    used by the active probe loop; heartbeats can equally be fed from
    real traffic via :meth:`record_heartbeat`.
    """

    def __init__(self, nodes: Sequence[str],
                 probe: Optional[Callable[[str], bool]] = None,
                 interval_s: float = 2.0,
                 suspect_phi: float = 3.0, dead_phi: float = 8.0,
                 min_interval_s: float = 0.5,
                 clock: Callable[[], float] = time.monotonic):
        self.probe = probe
        self.interval_s = float(interval_s)
        self.suspect_phi = float(suspect_phi)
        self.dead_phi = float(dead_phi)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._nodes: Dict[str, NodeHealth] = {
            n: NodeHealth(n) for n in nodes}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- feeding -------------------------------------------------------------

    def record_heartbeat(self, node: str) -> None:
        now = self._clock()
        with self._lock:
            nh = self._nodes.get(node)
            if nh is None:
                nh = self._nodes[node] = NodeHealth(node)
            if nh.last_beat is not None:
                dt = max(now - nh.last_beat, 1e-6)
                if nh.mean_interval is None:
                    nh.mean_interval = dt
                else:
                    nh.mean_interval += 0.2 * (dt - nh.mean_interval)
            nh.last_beat = now
            nh.beats += 1
            nh.reported_dead = False
            nh.draining = False

    def record_failure(self, node: str, fatal: bool = False) -> None:
        """An explicit failure report (transport error, breaker trip).
        ``fatal=True`` (connection refused, breaker open) marks the node
        dead immediately instead of waiting for phi to accrue."""
        with self._lock:
            nh = self._nodes.get(node)
            if nh is None:
                nh = self._nodes[node] = NodeHealth(node)
            nh.failures += 1
            if fatal:
                nh.reported_dead = True

    def record_draining(self, node: str) -> None:
        with self._lock:
            nh = self._nodes.get(node)
            if nh is not None:
                nh.draining = True

    # -- membership ----------------------------------------------------------

    def ensure(self, nodes: Sequence[str]) -> None:
        """Track ``nodes`` (fresh optimistic records for unknown ones)."""
        with self._lock:
            for n in nodes:
                if n not in self._nodes:
                    self._nodes[n] = NodeHealth(n)

    def forget(self, nodes: Sequence[str]) -> int:
        """Drop departed nodes' records entirely.  Without this, a
        flapping fleet grows one phi tracker per address ever seen.
        Returns how many
        records were actually removed."""
        removed = 0
        with self._lock:
            for n in nodes:
                if self._nodes.pop(n, None) is not None:
                    removed += 1
        return removed

    def set_nodes(self, nodes: Sequence[str]) -> None:
        """Reconcile the tracked set: add unknown nodes, purge the rest."""
        keep = set(nodes)
        with self._lock:
            for n in list(self._nodes):
                if n not in keep:
                    del self._nodes[n]
            for n in keep:
                if n not in self._nodes:
                    self._nodes[n] = NodeHealth(n)

    # -- reading -------------------------------------------------------------

    def phi(self, node: str, now: Optional[float] = None) -> float:
        """Suspicion level: ``-log10 P(heartbeat gap >= observed gap)``
        under an exponential inter-arrival model — phi 3 means the
        silence is ~1000x the node's typical gap tail."""
        with self._lock:
            nh = self._nodes.get(node)
            if nh is None or nh.last_beat is None:
                return _PHI_UNKNOWN
            mean = max(nh.mean_interval or self.interval_s,
                       self.min_interval_s)
        t = (now if now is not None else self._clock()) - nh.last_beat
        return max(t, 0.0) / mean * _LOG10E

    def state(self, node: str, now: Optional[float] = None) -> str:
        with self._lock:
            nh = self._nodes.get(node)
            if nh is None:
                return DEAD
            if nh.draining:
                return DRAINING
            if nh.reported_dead:
                return DEAD
        p = self.phi(node, now)
        if p >= self.dead_phi:
            return DEAD
        if p >= self.suspect_phi:
            return SUSPECT
        return HEALTHY

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def routable(self, node: str) -> bool:
        return self.state(node) in (HEALTHY, SUSPECT)

    def healthy(self, node: str) -> bool:
        return self.state(node) == HEALTHY

    def snapshot(self) -> Dict[str, Dict]:
        now = self._clock()
        out: Dict[str, Dict] = {}
        for n in self.nodes():
            with self._lock:
                nh = self._nodes[n]
                beats, fails = nh.beats, nh.failures
            out[n] = {"state": self.state(n, now),
                      "phi": round(self.phi(n, now), 2),
                      "beats": beats, "failures": fails}
        return out

    # -- active probing ------------------------------------------------------

    def start(self) -> None:
        if self.probe is None or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="gsky-fleet-health")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            for n in self.nodes():
                if self._stop.is_set():
                    return
                try:
                    ok = self.probe(n)
                except Exception:
                    ok = False
                if ok == DRAINING:
                    # answered, but only to say goodbye: keep the beat
                    # history warm yet route nothing new at it
                    self.record_heartbeat(n)
                    self.record_draining(n)
                elif ok:
                    self.record_heartbeat(n)
                else:
                    self.record_failure(n)
