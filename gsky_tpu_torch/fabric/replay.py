"""Gateway tier: peer replay of fully encoded responses.

Counterpart of `gsky_tpu/fabric/replay.py`, on threads where the
reference's gateway is asynchronous.  A `ReplayFabric` puts every
gateway (itself and ``GSKY_FABRIC_PEERS``) on the consistent-hash ring
of `fleet/ring.py`.  The ring names an owner for each canonical
response key; a non-owner that misses its `serving.ResponseCache` asks
the owner (then, if that fails, the next gateway on the ring) for the
encoded bytes before it renders.  Owners render each key first, so one
gateway's miss becomes every gateway's hit.

Wire format (``GET {peer}/fabric/replay?key={sha1}``)::

    200  body = the entry's bytes, and
         Content-Type:            the entry's content type
         ETag:                    "sha256[:32]" of the body
         X-Gsky-Fabric-Status:    the origin's HTTP status (always 200)
         X-Gsky-Fabric-Age:       seconds the entry has been cached
         X-Gsky-Fabric-Max-Age:   the origin's TTL in seconds
         X-Gsky-Fabric-Ns/-Layer/-Fp: the cache identity (namespace,
                                  layer, the layer config's fingerprint)
         X-Gsky-Fabric-Keep:      JSON of the headers a replay keeps
    404  no fresh entry (or the fabric off, or the peer under brownout)

The receiver checks the ETag against the body's digest and takes
``max_age - age`` as what is left of the TTL: the rebuilt entry expires
at the origin's deadline, so the Age grows across hops (RFC 9111).  A
peer serves no stale or degraded entry.

A fetch runs on a small bounded pool of threads, its wait cut to what
is left of the request's deadline (`resilience.clamp_timeout`); one
fetch a key is in flight at a time (`serving.SingleFlight`), and a
breaker a peer (``fabric:{peer}``) skips a dead one.  Every failure
returns None: the caller renders, so the fabric only ever removes work.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from . import TIMEOUT_S, fabric_enabled
from ..fleet.ring import HashRing
from ..obs.metrics import FABRIC_REPLAY
from ..resilience import (BreakerOpen, DeadlineExceeded, clamp_timeout,
                          get_breaker)
from ..serving.response_cache import CachedResponse, make_entry
from ..serving.singleflight import SingleFlight

_H = "X-Gsky-Fabric"

# fetch outcomes, counted in gsky_fabric_replay_total{outcome}
OUTCOMES = ("hit", "miss", "error", "deadline", "breaker_open",
            "owner_local", "disabled")

# threads a fabric fetches on
FETCH_WORKERS = 4


def encode_entry(ent: CachedResponse) -> Tuple[Dict[str, str], bytes]:
    """The headers and body that serve ``ent`` to a peer."""
    age = max(0, int(ent.max_age - (ent.expires - time.monotonic())))
    headers = {
        "ETag": ent.etag,
        f"{_H}-Status": str(ent.status),
        f"{_H}-Age": str(age),
        f"{_H}-Max-Age": str(ent.max_age),
        f"{_H}-Ns": ent.namespace,
        f"{_H}-Layer": ent.layer,
        f"{_H}-Fp": ent.layer_fp,
    }
    if ent.headers:
        headers[f"{_H}-Keep"] = json.dumps(list(ent.headers))
    return headers, ent.body


def entry_from_response(status: int, headers: Dict[str, str],
                        body: bytes) -> Optional[CachedResponse]:
    """A peer's answer checked and rebuilt into a cache entry, or None
    for anything unusable: not 200, no fabric headers, an ETag that is
    not the body's digest, no TTL left."""
    if status != 200 or not body:
        return None
    hdr = {k.lower(): v for k, v in headers.items()}
    if hdr.get(f"{_H}-NoStore".lower()):
        return None
    try:
        origin_status = int(hdr.get(f"{_H}-Status".lower(), "0"))
        age = int(hdr.get(f"{_H}-Age".lower(), "0"))
        max_age = int(hdr.get(f"{_H}-Max-Age".lower(), "0"))
    except (TypeError, ValueError):
        return None
    if origin_status != 200:
        return None
    remaining = max_age - max(0, age)
    if remaining <= 0:
        return None
    etag = hdr.get("etag", "")
    if etag != '"' + hashlib.sha256(body).hexdigest()[:32] + '"':
        return None          # the bytes were cut or changed in transit
    keep: Tuple[Tuple[str, str], ...] = ()
    raw_keep = hdr.get(f"{_H}-Keep".lower())
    if raw_keep:
        try:
            keep = tuple((str(k), str(v))
                         for k, v in json.loads(raw_keep))
        except (ValueError, TypeError):
            keep = ()
    ent = make_entry(
        body=body,
        content_type=hdr.get("content-type", "application/octet-stream"),
        status=origin_status,
        namespace=hdr.get(f"{_H}-Ns".lower(), ""),
        layer=hdr.get(f"{_H}-Layer".lower(), ""),
        layer_fp=hdr.get(f"{_H}-Fp".lower(), ""),
        max_age=max_age, headers=keep)
    # it expires at the origin's deadline, not ours: the Age accrues
    ent.expires = time.monotonic() + remaining
    return ent


def _http_fetch(url: str, timeout: float
                ) -> Tuple[int, Dict[str, str], bytes]:
    """The default transport: one blocking GET."""
    req = urllib.request.Request(url, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers.items()), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers.items() if exc.headers
                              else []), b""


class ReplayFabric:
    """One gateway's handle on the replay ring.  ``transport``, a
    callable ``(url, timeout) -> (status, headers, body)``, can be
    swapped (tests)."""

    def __init__(self, self_addr: str, peers: List[str],
                 timeout_s: Optional[float] = None,
                 transport: Optional[Callable] = None,
                 max_attempts: int = 2):
        self.self_addr = self_addr
        members = sorted({self_addr, *peers})
        self.ring = HashRing(members, vnodes=32)
        self._timeout_s = timeout_s
        self.transport = transport or _http_fetch
        self.flight = SingleFlight()
        self.max_attempts = max_attempts
        self._lock = threading.Lock()
        self.outcomes: Dict[str, int] = {}
        self._ewma_ms: Dict[str, float] = {}   # a peer's RPC latency
        self._pool: Optional[cf.ThreadPoolExecutor] = None

    # -- membership ---------------------------------------------------

    def set_peers(self, peers: List[str]) -> None:
        """New ring membership (a change bumps ``ring.generation`` and
        re-homes every key at once)."""
        self.ring.set_nodes(sorted({self.self_addr, *peers}))

    def owner(self, key: str) -> Optional[str]:
        return self.ring.owner(key)

    def is_owner(self, key: str) -> bool:
        return self.owner(key) == self.self_addr

    def candidates(self, key: str) -> List[str]:
        """The ring's preference walk for ``key`` without this gateway,
        at most ``max_attempts`` long."""
        walk = self.ring.preference(key, self.max_attempts + 1)
        return [p for p in walk if p != self.self_addr][:self.max_attempts]

    # -- bookkeeping --------------------------------------------------

    def _count(self, outcome: str) -> None:
        with self._lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        FABRIC_REPLAY.labels(outcome=outcome).inc()

    def _latency(self, peer: str, ms: float) -> None:
        with self._lock:
            prev = self._ewma_ms.get(peer)
            self._ewma_ms[peer] = ms if prev is None \
                else 0.8 * prev + 0.2 * ms

    def stats(self) -> Dict:
        with self._lock:
            return {"self": self.self_addr,
                    "members": list(self.ring.nodes),
                    "generation": self.ring.generation,
                    "outcomes": dict(self.outcomes),
                    "peer_ewma_ms": {p: round(v, 3) for p, v
                                     in self._ewma_ms.items()}}

    def close(self) -> None:
        """Stop the fetch threads (a fetch in flight runs out)."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- the fetch ----------------------------------------------------

    def fetch(self, key: str) -> Optional[CachedResponse]:
        """The peers' entry for ``key``, or None; never raises.  The
        owner returns None at once (its render seeds the fleet); a
        non-owner walks the ring's preference, one bounded probe a
        peer behind its breaker."""
        if not fabric_enabled():
            self._count("disabled")
            return None
        if self.is_owner(key):
            self._count("owner_local")
            return None
        peers = self.candidates(key)
        if not peers:
            self._count("miss")
            return None

        def fetch_all():
            for peer in peers:
                ent = self._fetch_one(peer, key)
                if ent is not None:
                    return ent
            return None

        try:
            ent, _joined = self.flight.do(f"fabric:{key}", fetch_all)
        except DeadlineExceeded:
            self._count("deadline")
            return None
        except Exception:   # a transport fault must not become a 5xx
            self._count("error")
            return None
        self._count("hit" if ent is not None else "miss")
        return ent

    def _submit(self, url: str, timeout: float) -> cf.Future:
        with self._lock:
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(
                    FETCH_WORKERS, thread_name_prefix="gsky-fabric")
            return self._pool.submit(self.transport, url, timeout)

    def _fetch_one(self, peer: str,
                   key: str) -> Optional[CachedResponse]:
        brk = get_breaker(f"fabric:{peer}")
        if not brk.allow():
            self._count("breaker_open")
            return None
        # no budget left: DeadlineExceeded ends the whole walk, not just
        # this peer's probe
        timeout = clamp_timeout(self._timeout_s
                                if self._timeout_s is not None
                                else TIMEOUT_S)
        url = (peer.rstrip("/") + "/fabric/replay?key="
               + urllib.parse.quote(key, safe=""))
        t0 = time.monotonic()
        try:
            status, headers, body = self._submit(url, timeout).result(
                timeout + 0.5)
        except BreakerOpen:
            self._count("breaker_open")
            return None
        except Exception:
            brk.record_failure()
            self._count("error")
            return None
        self._latency(peer, (time.monotonic() - t0) * 1000.0)
        if status >= 500:
            brk.record_failure()
            self._count("error")
            return None
        brk.record_success()
        return entry_from_response(status, headers, body)


def default_fabric() -> Optional["ReplayFabric"]:
    """A fabric from the environment (``GSKY_FABRIC_SELF`` and
    ``GSKY_FABRIC_PEERS``), or None when either is unset."""
    from . import peer_addrs, self_addr
    me, peers = self_addr(), peer_addrs()
    if not me or not peers:
        return None
    return ReplayFabric(me, peers)
