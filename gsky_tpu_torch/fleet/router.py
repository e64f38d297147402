"""Fleet router: health-gated consistent-hash routing + hedge policy.

Counterpart of `gsky_tpu/fleet/router.py`, with its knobs and defaults.

One :class:`FleetRouter` fronts one node set (one ``worker_nodes``
list).  It owns the hash ring, the health monitor and the hedge
policy, tracks per-node in-flight load for bounded-load routing, and
keeps the locality ledger (did a repeat tile key land on the same node
as last time?) that the fleet soak asserts on.

Env knobs (all ``GSKY_FLEET_*``):

- ``GSKY_FLEET=0``            disable keyed routing (legacy round-robin)
- ``GSKY_FLEET_VNODES``       virtual nodes per ring member (64)
- ``GSKY_FLEET_BOUND``        bounded-load factor c (1.25; 0 = off)
- ``GSKY_FLEET_PROBE_S``      active heartbeat period (2.0; 0 = passive)
- ``GSKY_FLEET_SUSPECT_PHI`` / ``GSKY_FLEET_DEAD_PHI``  (3 / 8)
- ``GSKY_FLEET_HEDGE=0``      disable hedged dispatch
- ``GSKY_FLEET_HEDGE_BUDGET`` hedge tokens earned per primary (0.1)
- ``GSKY_FLEET_HEDGE_MS``     floor of the adaptive hedge delay (50)
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Callable, Dict, List, Optional

from .health import HealthMonitor
from .hedge import HedgePolicy
from .ring import HashRing


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


# process-wide router registry: /debug's `fleet` block and the
# admission controller's least-loaded-shard advisor read through it
_ROUTERS: "weakref.WeakSet[FleetRouter]" = weakref.WeakSet()
_routers_lock = threading.Lock()


def register_router(router: "FleetRouter") -> None:
    with _routers_lock:
        _ROUTERS.add(router)


def routers() -> List["FleetRouter"]:
    with _routers_lock:
        return list(_ROUTERS)


def fleet_stats() -> Dict:
    """The /debug ``fleet`` block: one entry per live router."""
    out: Dict = {}
    for r in routers():
        out[r.name] = r.stats()
    return out


def least_loaded_node() -> Optional[str]:
    """The least-loaded healthy node across every registered router —
    the shed-target hint admission control attaches to its 503s."""
    best = None
    best_load = None
    for r in routers():
        for node in r.ring.nodes:
            if not r.monitor.healthy(node):
                continue
            load = r.load_of(node)
            if best_load is None or load < best_load:
                best, best_load = node, load
    return best


class FleetRouter:
    def __init__(self, nodes, name: str = "worker",
                 probe: Optional[Callable[[str], object]] = None,
                 vnodes: Optional[int] = None,
                 bound: Optional[float] = None,
                 hedge: Optional[HedgePolicy] = None,
                 monitor: Optional[HealthMonitor] = None):
        self.name = name
        self.enabled = os.environ.get("GSKY_FLEET", "1") != "0"
        self.ring = HashRing(
            nodes, vnodes=vnodes if vnodes is not None
            else _env_int("GSKY_FLEET_VNODES", 64))
        self.bound = bound if bound is not None \
            else _env_float("GSKY_FLEET_BOUND", 1.25)
        self.monitor = monitor or HealthMonitor(
            nodes, probe=probe,
            interval_s=_env_float("GSKY_FLEET_PROBE_S", 2.0),
            suspect_phi=_env_float("GSKY_FLEET_SUSPECT_PHI", 3.0),
            dead_phi=_env_float("GSKY_FLEET_DEAD_PHI", 8.0))
        self.hedge_enabled = os.environ.get(
            "GSKY_FLEET_HEDGE", "1") != "0"
        self.hedge = hedge or HedgePolicy(
            budget=_env_float("GSKY_FLEET_HEDGE_BUDGET", 0.1),
            min_delay_s=_env_float("GSKY_FLEET_HEDGE_MS", 50.0) / 1e3)
        self._lock = threading.Lock()
        self._load: Dict[str, int] = {}
        # locality ledger: route key -> node it last ran on
        self._last_node: Dict[str, str] = {}
        self.locality_hits = 0
        self.locality_misses = 0
        self.routed = 0
        self.rerouted = 0
        self.rr_fallback = 0
        register_router(self)

    # -- membership ----------------------------------------------------------

    def set_nodes(self, nodes) -> None:
        """Reconcile membership (fleet scale/replace): rebuild the
        ring (generation bump), track new nodes in the health monitor,
        and purge departed nodes from the phi trackers, the per-node
        in-flight map and the locality ledger — without the purge a
        flapping fleet grows unbounded state."""
        old = set(self.ring.nodes)
        self.ring.set_nodes(nodes)
        new = set(self.ring.nodes)
        self.monitor.ensure(sorted(new - old))
        gone = old - new
        if not gone:
            return
        self.monitor.forget(sorted(gone))
        with self._lock:
            for n in gone:
                self._load.pop(n, None)
            self._last_node = {k: v for k, v in self._last_node.items()
                               if v not in gone}

    # -- load accounting -----------------------------------------------------

    def load_of(self, node: str) -> int:
        with self._lock:
            return self._load.get(node, 0)

    def task_started(self, node: str) -> None:
        with self._lock:
            self._load[node] = self._load.get(node, 0) + 1

    def task_finished(self, node: str) -> None:
        with self._lock:
            self._load[node] = max(self._load.get(node, 0) - 1, 0)

    # -- routing -------------------------------------------------------------

    def candidates(self, key: Optional[str]) -> List[str]:
        """Ordered dispatch candidates for a task.

        With a key (and routing enabled): the ring preference walk,
        healthy nodes first, bounded-load spill applied, suspect nodes
        kept behind every healthy one, dead/draining nodes last (they
        are still *attemptable* when nothing else is left — one failed
        RPC beats refusing a request the node might serve).
        """
        nodes = self.ring.nodes
        if not nodes:
            return []
        if key is None or not self.enabled:
            return nodes
        with self._lock:
            load = dict(self._load)
        healthy = self.ring.route(
            key, eligible=self.monitor.healthy, load=load,
            bound=self.bound)
        pref = self.ring.preference(key)
        suspect = [n for n in pref
                   if n not in set(healthy) and self.monitor.routable(n)]
        rest = [n for n in pref
                if n not in set(healthy) and n not in set(suspect)]
        return healthy + suspect + rest

    def peers_for(self, key: str, n: Optional[int] = None,
                  exclude: Optional[str] = None) -> List[str]:
        """Ring-adjacent peer selection for the cache fabric
        (`fabric/`): the key's preference walk filtered to
        currently-routable nodes, optionally excluding the asking node
        itself.  Unlike :meth:`candidates` this never pads with dead
        nodes — a fabric fill is an optimisation, so an unroutable
        peer is simply not asked."""
        out = [m for m in self.ring.preference(key)
               if m != exclude and self.monitor.routable(m)]
        return out if n is None else out[:n]

    def record_locality(self, key: str, node: str) -> None:
        with self._lock:
            prev = self._last_node.get(key)
            if prev is not None:
                if prev == node:
                    self.locality_hits += 1
                else:
                    self.locality_misses += 1
            # bound the ledger: locality is about *recent* repeats
            if len(self._last_node) > 65536:
                self._last_node.clear()
            self._last_node[key] = node
            self.routed += 1

    def record_reroute(self) -> None:
        with self._lock:
            self.rerouted += 1

    def record_rr(self) -> None:
        with self._lock:
            self.rr_fallback += 1
            self.routed += 1

    def node_result(self, node: str, ok: bool,
                    latency_s: Optional[float] = None,
                    fatal: bool = False,
                    draining: bool = False) -> None:
        """Fold one RPC outcome into health + hedge state."""
        if draining:
            # answered, but only to say goodbye: keep the beat history
            # warm (not a failure) yet route nothing new at it
            self.monitor.record_heartbeat(node)
            self.monitor.record_draining(node)
            return
        if ok:
            self.monitor.record_heartbeat(node)
            if latency_s is not None:
                self.hedge.observe(latency_s)
        else:
            self.monitor.record_failure(node, fatal=fatal)

    def locality_rate(self) -> Optional[float]:
        with self._lock:
            total = self.locality_hits + self.locality_misses
            if total == 0:
                return None
            return self.locality_hits / total

    def close(self) -> None:
        """Stop the probe; a closed router leaves the registry, so that
        its nodes are neither a shed hint nor a /debug entry."""
        self.monitor.stop()
        with _routers_lock:
            _ROUTERS.discard(self)

    def stats(self) -> Dict:
        with self._lock:
            loc_total = self.locality_hits + self.locality_misses
            out = {
                "enabled": self.enabled,
                "ring": {"nodes": self.ring.nodes,
                         "generation": self.ring.generation,
                         "vnodes": self.ring.vnodes,
                         "bound": self.bound},
                "load": dict(self._load),
                "routed": self.routed,
                "rerouted": self.rerouted,
                "rr_fallback": self.rr_fallback,
                "locality": {
                    "hits": self.locality_hits,
                    "misses": self.locality_misses,
                    "rate": round(self.locality_hits / loc_total, 4)
                    if loc_total else None},
            }
        out["health"] = self.monitor.snapshot()
        hs = self.hedge.stats()
        hs["delay_s"] = round(self.hedge.delay_s(), 4)
        hs["enabled"] = self.hedge_enabled
        out["hedge"] = hs
        return out
