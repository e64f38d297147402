"""Fleet fault tolerance: membership + health, consistent-hash
routing with bounded load, hedged dispatch, graceful drain.

Counterpart of `gsky_tpu/fleet/` without its elastic half
(``elastic.py``: the autoscaler, preemption and the journal hand-off,
ROADMAP A.20).  Pure Python, copied rather than imported, so that the
port imports nothing of the JAX package.

- :class:`HealthMonitor` accrues phi-suspicion per node from
  heartbeats (real RPC traffic and/or active ``worker_info`` probes)
  and maps it onto healthy / suspect / dead / draining states.
- :class:`HashRing` keys canonical tile keys onto nodes with virtual
  nodes and a deterministic preference walk; ``route()`` adds the
  bounded-load spill.
- :class:`HedgePolicy` + :func:`hedged_call` duplicate stragglers past
  an adaptive p99 delay, within a token-bucket hedge budget.
- :class:`DrainController` + :class:`Draining` implement the SIGTERM
  stop-accepting / finish-in-flight / exit protocol on both the worker
  node and the OWS server.
- :class:`FleetRouter` composes the above per node set;
  :func:`fleet_stats` aggregates every live router for /debug.
"""

from .drain import DrainController, Draining
from .health import (DEAD, DRAINING, HEALTHY, SUSPECT, HealthMonitor,
                     NodeHealth)
from .hedge import HedgePolicy, hedged_call
from .ring import HashRing
from .router import (FleetRouter, fleet_stats, least_loaded_node,
                     register_router, routers)


def tile_route_key(layer: str, srs: str, bbox, width: int,
                   height: int) -> str:
    """Canonical routing key for a tile/drill task: the same key the
    serving cache uses to identify a rendered tile, minus volatile
    parts (time is deliberately excluded so an animation over one tile
    stays on one shard's warm scene cache)."""
    bb = ",".join(f"{float(v):.6f}" for v in bbox)
    return f"{layer}|{srs}|{bb}|{int(width)}x{int(height)}"


__all__ = [
    "DEAD", "DRAINING", "HEALTHY", "SUSPECT",
    "DrainController", "Draining",
    "FleetRouter", "HashRing", "HealthMonitor", "HedgePolicy",
    "NodeHealth",
    "fleet_stats", "hedged_call", "least_loaded_node",
    "register_router", "routers", "tile_route_key",
]
