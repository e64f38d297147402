"""Fleet fault tolerance: membership + health, consistent-hash
routing with bounded load, hedged dispatch, graceful drain, and the
elastic fleet.

Counterpart of `gsky_tpu/fleet/`.  Pure Python, copied rather than
imported, so that the port imports nothing of the JAX package.

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
- `elastic`: :class:`Autoscaler` over a :class:`NodeProvider`
  (:class:`LocalSubprocessProvider` starts worker processes) driven by
  a :class:`DemandSignal`, preemption with a warm journal hand-off to
  the ring successor (:func:`successor_for`), and
  :func:`elastic_stats` for /debug; dormant unless ``GSKY_ELASTIC=1``.
"""

from .drain import DrainController, Draining
from .elastic import (Autoscaler, DemandSignal, LocalSubprocessProvider,
                      NodeProvider, elastic_stats, successor_for)
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
    "Autoscaler", "DemandSignal", "DrainController", "Draining",
    "FleetRouter", "HashRing", "HealthMonitor", "HedgePolicy",
    "LocalSubprocessProvider", "NodeHealth", "NodeProvider",
    "elastic_stats", "fleet_stats", "hedged_call", "least_loaded_node",
    "register_router", "routers", "successor_for", "tile_route_key",
]
