"""Cache fabric: lateral peer sharing between gateways and workers.

Counterpart of `gsky_tpu/fabric/`, copied (the port imports nothing of
the JAX package), its worker RPCs over gRPC (`worker.client.dial`)
and its gateway tier on threads.  Two tiers, both off unless
``GSKY_FABRIC=1``:

* **Gateway tier** (`fabric/replay.py`): on a response-cache miss the
  consistent-hash ring (`fleet/ring.py`) names an owner gateway; a
  non-owner asks it for the encoded bytes (``GET /fabric/replay``) and
  replays them instead of rendering.  A miss on one gateway becomes a
  hit on every other.
* **Worker tier** (`fabric/pagerpc.py`, `fabric/replicate.py`): pages
  are keyed ``(serial, pi, pj)`` by content (a scene's serial is a
  hash of its file's identity, `pipeline.scene_cache.content_serial`),
  and the pool journal records each page's heat, so a worker filling
  its pool asks its peers for the hot pages, hottest first, over a
  batched ``page_fetch`` RPC instead of decoding the scenes again;
  replicate.py plans where the Zipf head's pages should live (a plan
  with no caller yet).

Every peer interaction is bounded by the request's deadline, guarded by
a breaker a peer and falls back entry by entry to the local render or
the cold stage: a dead peer costs one bounded probe, never a 5xx.

Knobs, read at each call: ``GSKY_FABRIC`` (0, the gate of both
tiers), ``GSKY_FABRIC_SELF`` (this gateway's base URL),
``GSKY_FABRIC_PEERS`` (the other gateways') and
``GSKY_FABRIC_PAGE_PEERS`` (workers' ``host:port``).  A peer RPC is
bounded by `TIMEOUT_S`; the reference's per-tier gates, its timeout,
batch size and replica count knobs are constants here (ROADMAP C.18).
"""

from __future__ import annotations

import os
from typing import Dict, List

# the bound on one peer RPC, cut further to what is left of the
# request's deadline (`resilience.clamp_timeout`)
TIMEOUT_S = 2.0


def fabric_enabled() -> bool:
    """The gate: ``GSKY_FABRIC=0`` (the default) leaves every fabric
    path dormant, byte for byte the fabric-less server."""
    return os.environ.get("GSKY_FABRIC", "0").strip().lower() not in (
        "0", "false", "off", "no", "")


def self_addr() -> str:
    """This gateway's advertised base URL on the replay ring."""
    return os.environ.get("GSKY_FABRIC_SELF", "").strip()


def peer_addrs() -> List[str]:
    """The peer gateways' base URLs (comma-separated; a ring, so their
    order does not matter)."""
    raw = os.environ.get("GSKY_FABRIC_PEERS", "")
    return [p.strip() for p in raw.split(",") if p.strip()]


def page_peer_addrs() -> List[str]:
    """The peer workers' ``host:port`` for the page-fetch RPC."""
    raw = os.environ.get("GSKY_FABRIC_PAGE_PEERS", "")
    return [p.strip() for p in raw.split(",") if p.strip()]


def fabric_stats(replay_fabric=None) -> Dict:
    """The ``/debug`` ``fabric`` block."""
    from . import pagerpc
    doc: Dict = {"enabled": fabric_enabled()}
    if replay_fabric is not None:
        doc["replay"] = replay_fabric.stats()
    doc["pages"] = pagerpc.stats()
    return doc
