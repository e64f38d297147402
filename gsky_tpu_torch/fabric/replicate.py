"""Popularity-weighted replication of hot pages across shards: the plan.

Counterpart of `gsky_tpu/fabric/replicate.py`'s planner.  The
reference's `replicate_to_pool`, which pulls a node's planned replicas
over the page RPC, has no caller there, and the port leaves it, its
gate (``GSKY_FABRIC_REPLICATE``), its ``GSKY_FABRIC_REPLICAS`` knob and
its gauge (``gsky_fabric_replica_pages``) out until one exists
(ROADMAP C.18).

The page-peering tier (`fabric/pagerpc.py`) makes any resident page
fetchable — but a page resident on exactly one worker still dies with
that worker, and serving traffic is Zipf-shaped: losing the head of
the distribution is a fleet-wide miss storm, losing the tail is
nothing.  The plan turns the pool journal's heat ranking
(`device_guard/journal.py::replay_scored`) into replica sets:

* every page gets a deterministic replica set — the first ``r`` nodes
  of its consistent-hash preference walk (`fleet/ring.py`), where
* ``r`` scales with popularity: the hottest page gets the full
  `REPLICAS` copies, a page at a fraction ``f`` of the top score gets
  ``1 + round(f * (R - 1))`` — Zipf-head content survives any single
  node, tail content costs one slot.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

from ..fleet.ring import HashRing

Key = Tuple[int, int, int]

# target copies for the hottest content: survive any one node
REPLICAS = 2


def replicas_for(score: float, top_score: float, replicas: int) -> int:
    """Popularity-weighted copy count: linear in the page's share of
    the top heat score, floored at one copy."""
    if top_score <= 0 or replicas <= 1:
        return 1
    frac = max(0.0, min(1.0, float(score) / float(top_score)))
    return 1 + int(round(frac * (replicas - 1)))


def replication_targets(ring: HashRing, key: Key,
                        n: int) -> List[str]:
    """The deterministic replica set: first ``n`` distinct nodes of the
    key's preference walk."""
    return ring.preference(json.dumps([int(k) for k in key]), n)


def plan(scored: Sequence[Tuple[int, int, int, float]],
         nodes: Sequence[str], self_node: str,
         replicas: Optional[int] = None,
         budget_pages: Optional[int] = None) -> List[Key]:
    """Pages ``self_node`` should hold, hottest first.

    ``scored`` is `journal.replay_scored()` output (hottest-first).
    ``budget_pages`` caps the plan so replication never floods a pool
    past its own working set."""
    nodes = sorted(set(nodes))
    if self_node not in nodes or not scored:
        return []
    ring = HashRing(nodes, vnodes=32)
    r = REPLICAS if replicas is None else max(1, int(replicas))
    top = max(s for _, _, _, s in scored)
    out: List[Key] = []
    for serial, pi, pj, score in scored:
        key = (int(serial), int(pi), int(pj))
        n = replicas_for(score, top, r)
        if self_node in replication_targets(ring, key, n):
            out.append(key)
            if budget_pages is not None and len(out) >= budget_pages:
                break
    return out
