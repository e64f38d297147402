"""Consistent-hash ring with bounded-load routing.

Counterpart of `gsky_tpu/fleet/ring.py`: the same hash, so the same
node names and keys give the same preference walks in both packages.

The ring maps canonical tile keys onto worker nodes so that repeat
requests for the same tile land on the same shard — keeping that
shard's scene cache, page pool and built kernels hot — while a
node death moves only that node's arc of the keyspace (~K/n keys for K
keys over n nodes), not a full reshuffle the way modulo hashing would.

Hashing is ``md5`` over stable strings (never Python ``hash()``:
``PYTHONHASHSEED`` would silently change placement between processes),
with ``vnodes`` virtual points per node to even out arc lengths.

Bounded load (the "consistent hashing with bounded loads" result used
by production CDN front-ends): a node already carrying more than
``bound`` times its fair share of the observed in-flight load is
skipped and the key *spills* to the next node on its preference walk —
a deterministic order, so two gateways under the same load picture
spill the same way.  This keeps one hot tile from melting its home
shard while preserving locality for everything else.
"""

from __future__ import annotations

import bisect
import hashlib
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence


def _hash64(s: str) -> int:
    """Stable 64-bit hash of a string (first 8 md5 bytes)."""
    return int.from_bytes(
        hashlib.md5(s.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring over named nodes.

    ``generation`` increments on every membership change so observers
    (metrics, the soak) can tell a rebalance happened.
    """

    def __init__(self, nodes: Sequence[str], vnodes: int = 64):
        self.vnodes = max(int(vnodes), 1)
        self._lock = threading.Lock()
        self.generation = 0
        self._nodes: List[str] = []
        self._points: List[int] = []
        self._owners: List[str] = []
        self.set_nodes(nodes)

    def set_nodes(self, nodes: Sequence[str]) -> None:
        """Replace the membership; a no-op when the set is unchanged."""
        uniq = sorted(set(nodes))
        with self._lock:
            if uniq == self._nodes:
                return
            pts: List[tuple] = []
            for n in uniq:
                for v in range(self.vnodes):
                    pts.append((_hash64(f"{n}#{v}"), n))
            pts.sort()
            self._nodes = uniq
            self._points = [p for p, _ in pts]
            self._owners = [o for _, o in pts]
            self.generation += 1

    @property
    def nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def preference(self, key: str, n: Optional[int] = None) -> List[str]:
        """The first ``n`` DISTINCT nodes clockwise from ``key``'s point
        — position 0 is the key's home shard, positions 1.. are its
        deterministic failover/spill order."""
        with self._lock:
            if not self._nodes:
                return []
            want = len(self._nodes) if n is None else min(n, len(self._nodes))
            h = _hash64(key)
            i = bisect.bisect_right(self._points, h)
            out: List[str] = []
            seen = set()
            for k in range(len(self._points)):
                owner = self._owners[(i + k) % len(self._points)]
                if owner not in seen:
                    seen.add(owner)
                    out.append(owner)
                    if len(out) >= want:
                        break
            return out

    def owner(self, key: str) -> Optional[str]:
        pref = self.preference(key, 1)
        return pref[0] if pref else None

    def successor(self, node: str) -> Optional[str]:
        """The next DISTINCT node clockwise from ``node``'s primary
        vnode point — the shard that inherits the largest share of
        ``node``'s arc when it leaves, and therefore the natural heir
        for its page-residency journal on preemption.
        Deterministic across processes for a given membership."""
        with self._lock:
            if node not in self._nodes or len(self._nodes) < 2:
                return None
            h = _hash64(f"{node}#0")
            i = bisect.bisect_right(self._points, h)
            for k in range(len(self._points)):
                owner = self._owners[(i + k) % len(self._points)]
                if owner != node:
                    return owner
        return None

    def route(self, key: str,
              eligible: Optional[Callable[[str], bool]] = None,
              load: Optional[Dict[str, int]] = None,
              bound: float = 0.0) -> List[str]:
        """Ordered candidates for ``key``: the preference walk filtered
        to ``eligible`` nodes, with over-loaded nodes (more than
        ``bound`` x the fair share of the total observed load) demoted
        behind the rest — spilled, in the same deterministic walk order.

        With no eligible node at all, returns the unfiltered preference
        walk so the caller can still attempt (and fail over) rather
        than refusing outright.
        """
        pref = self.preference(key)
        if eligible is not None:
            ok = [n for n in pref if eligible(n)]
            pref = ok or pref
        if not load or bound <= 0.0 or len(pref) <= 1:
            return pref
        total = sum(max(load.get(n, 0), 0) for n in pref)
        if total <= 0:
            return pref
        # fair share rounded up: a bound of 1.25 over 2 nodes with 4
        # in-flight allows ceil(1.25 * 4 / 2) = 3 per node
        cap = math.ceil(bound * total / len(pref))
        under = [n for n in pref if load.get(n, 0) < cap]
        over = [n for n in pref if load.get(n, 0) >= cap]
        return (under + over) if under else pref
