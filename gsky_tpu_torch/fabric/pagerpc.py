"""Worker tier: batched content-keyed page fetch between pools.

Counterpart of `gsky_tpu/fabric/pagerpc.py`.  Pages are keyed
``(serial, pi, pj)`` by content (`pipeline.scene_cache.content_serial`
names a scene by its file's identity, in every process), so a page
staged on any worker is the same page anywhere else, and a peer's pool
is a fill source.  A worker rebuilding its pool (a warm boot, the
successor of a preempted node, ``rehydrate()``) asks its peers for the
journal's hot set, hottest first, instead of decoding scenes again.

Wire format: one worker RPC (``operation="page_fetch"`` on gRPC's
``/gskyrpc.GDAL/Process``, `worker.client.dial`):

* the request, in ``Task.path``::

      {"v": 1, "pages": [[serial, pi, pj], ...], "max_bytes": N}

* the answer: ``Result.raster`` holds the pages' f32 bytes one after
  another; ``Result.info_json`` the manifest::

      {"v": 1, "page_shape": [PR, PC],
       "pages": [{"serial": s, "pi": i, "pj": j,
                  "off": byte_offset, "len": byte_len, "crc": crc32},
                 ...]}

  A page the peer does not hold is absent.  The receiver checks each
  page's CRC32 and length before staging it and drops a mismatch: a
  page matches its key exactly or does not exist.

A batch stays under `BATCH_BYTES` (8 MiB), well inside the carrier's
64 MB cap; a breaker a peer (``fabric-page:{addr}``) keeps a
dead one from stalling recovery.  A failed fetch leaves its pages to
the cold path (the scene cache and storage).
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import TIMEOUT_S, page_peer_addrs
from ..fleet.ring import HashRing
from ..resilience import get_breaker

Key = Tuple[int, int, int]

_lock = threading.Lock()
_stats: Dict[str, float] = {"fills": 0, "served": 0, "rpc_errors": 0,
                            "integrity_drops": 0, "breaker_skips": 0}
_ewma_ms: Dict[str, float] = {}


def _count(name: str, n: int = 1) -> None:
    with _lock:
        _stats[name] = _stats.get(name, 0) + n


def _latency(peer: str, ms: float) -> None:
    with _lock:
        prev = _ewma_ms.get(peer)
        _ewma_ms[peer] = ms if prev is None else 0.8 * prev + 0.2 * ms


def stats() -> Dict:
    with _lock:
        return {**{k: int(v) for k, v in _stats.items()},
                "peer_ewma_ms": {p: round(v, 3)
                                 for p, v in _ewma_ms.items()}}


# the bytes one page_fetch answer may carry
BATCH_BYTES = 8 << 20


# -- the wire codec -----------------------------------------------------

def encode_request(keys: Sequence[Key],
                   max_bytes: Optional[int] = None) -> str:
    return json.dumps({
        "v": 1,
        "pages": [[int(s), int(pi), int(pj)] for s, pi, pj in keys],
        "max_bytes": int(max_bytes if max_bytes is not None
                         else BATCH_BYTES)})


def serve_page_fetch(pool, doc: Dict) -> Tuple[Dict, bytes]:
    """The serving half: the requested resident pages on the host, as
    ``(manifest, blob)``.  Pages not held are left out; the request's
    byte budget cuts the list in its order (hottest first, so the
    coldest tail goes)."""
    budget = int(doc.get("max_bytes") or BATCH_BYTES)
    keys: List[Key] = []
    for item in doc.get("pages") or []:
        try:
            keys.append((int(item[0]), int(item[1]), int(item[2])))
        except (TypeError, ValueError, IndexError):
            continue
    # pages are one size: the budget is a page count, at least one
    page_bytes = pool.page_rows * pool.page_cols * 4
    chunks: List[bytes] = []
    entries: List[Dict] = []
    off = 0
    for (serial, pi, pj), page in pool.read_pages(
            keys, max(1, budget // page_bytes)):
        raw = np.ascontiguousarray(page, np.float32).tobytes()
        entries.append({"serial": serial, "pi": pi, "pj": pj,
                        "off": off, "len": len(raw),
                        "crc": zlib.crc32(raw)})
        chunks.append(raw)
        off += len(raw)
    _count("served", len(entries))
    manifest = {"v": 1,
                "page_shape": [pool.page_rows, pool.page_cols],
                "pages": entries}
    return manifest, b"".join(chunks)


def decode_result(info_json: str, blob: bytes
                  ) -> Dict[Key, np.ndarray]:
    """The client half: manifest + blob -> {key: (PR, PC) f32 page}.
    A page whose CRC or extent is wrong is dropped and counted, never
    raised."""
    try:
        manifest = json.loads(info_json or "{}")
    except ValueError:
        return {}
    try:
        pr, pc = (int(manifest["page_shape"][0]),
                  int(manifest["page_shape"][1]))
    except (KeyError, TypeError, ValueError, IndexError):
        return {}
    want = pr * pc * 4
    out: Dict[Key, np.ndarray] = {}
    for ent in manifest.get("pages") or []:
        try:
            key = (int(ent["serial"]), int(ent["pi"]), int(ent["pj"]))
            off, ln, crc = int(ent["off"]), int(ent["len"]), int(ent["crc"])
        except (KeyError, TypeError, ValueError):
            continue
        raw = blob[off:off + ln]
        if ln != want or len(raw) != ln or zlib.crc32(raw) != crc:
            _count("integrity_drops")
            continue
        out[key] = np.frombuffer(raw, np.float32).reshape(pr, pc)
    return out


# -- the transport ------------------------------------------------------

def _rpc_fetch(peer: str, keys: Sequence[Key], max_bytes: int,
               timeout: float) -> Dict[Key, np.ndarray]:
    """One ``page_fetch`` RPC to one peer worker over gRPC, its answer
    capped at ``max_bytes`` and 1 MiB more; raises on a transport or
    peer error (the caller's breaker counts it)."""
    from ..worker import gskyrpc as pb
    from ..worker.client import dial
    ch, call = dial(peer, max_msg=max_bytes + (1 << 20))
    try:
        res = call(pb.Task(operation="page_fetch",
                           path=encode_request(keys, max_bytes)),
                   timeout=timeout)
    finally:
        ch.close()
    if res.error:
        raise RuntimeError(res.error)
    return decode_result(res.info_json, res.raster)


def fetch_pages(peer: str, keys: Sequence[Key],
                max_bytes: Optional[int] = None,
                timeout: Optional[float] = None,
                fetch: Optional[Callable] = None
                ) -> Dict[Key, np.ndarray]:
    """``keys`` from ``peer`` behind its breaker; {} on any failure
    (never raises)."""
    brk = get_breaker(f"fabric-page:{peer}")
    if not brk.allow():
        _count("breaker_skips")
        return {}
    mb = int(max_bytes if max_bytes is not None else BATCH_BYTES)
    t0 = time.monotonic()
    try:
        got = (fetch or _rpc_fetch)(
            peer, keys, mb,
            timeout if timeout is not None else TIMEOUT_S)
    except Exception:   # any peer failure falls back to the cold path
        brk.record_failure()
        _count("rpc_errors")
        return {}
    brk.record_success()
    _latency(peer, (time.monotonic() - t0) * 1000.0)
    return got


# -- the pool fill ------------------------------------------------------

def _batches(keys: List[Key], page_bytes: int,
             cap: int) -> List[List[Key]]:
    per = max(1, cap // max(1, page_bytes))
    return [keys[i:i + per] for i in range(0, len(keys), per)]


def _stage_from(pool, peer: str, keys: List[Key], page_bytes: int,
                cap: int, fetch: Optional[Callable]) -> Tuple[int, List[Key]]:
    """Ask ``peer`` for ``keys`` in batches and stage what comes back:
    (pages staged, keys still missing)."""
    got: Dict[Key, np.ndarray] = {}
    for batch in _batches(keys, page_bytes, cap):
        got.update(fetch_pages(peer, batch, cap, fetch=fetch))
    filled, missing = 0, []
    for key in keys:
        page = got.get(key)
        if page is not None and pool.stage_page(*key, page):
            filled += 1
        else:
            missing.append(key)
    return filled, missing


def fill_from_peers(pool, entries: Sequence[Key],
                    peers: Optional[List[str]] = None,
                    fetch: Optional[Callable] = None,
                    prefer: Optional[str] = None) -> int:
    """Fill ``pool`` from peers, hottest first.

    ``entries`` is the journal's hottest-first page list.  ``prefer``
    names one peer asked for every key first: the warm hand-off sets it
    to the preempted node, whose pool holds the shipped hot set while
    its grace window lasts.  Then each key still missing is asked of
    its ring-preferred peer, and what that round missed of the next one
    on the ring.  Returns the pages staged."""
    peers = list(peers if peers is not None else page_peer_addrs())
    if not peers and prefer:
        peers = [prefer]
    if not peers or not entries:
        return 0
    ring = HashRing(peers, vnodes=32)
    page_bytes = pool.page_rows * pool.page_cols * 4
    cap = BATCH_BYTES
    want: List[Key] = [(int(s), int(pi), int(pj))
                       for s, pi, pj in entries]
    filled = 0
    if prefer:
        filled, want = _stage_from(pool, prefer, want, page_bytes, cap,
                                   fetch)
    for rnd in (0, 1):          # the preference walk: owner, then next
        if not want:
            break
        missing: List[Key] = []
        by_peer: Dict[str, List[Key]] = {}
        for key in want:
            pref = ring.preference(json.dumps(key), rnd + 1)
            if len(pref) <= rnd:
                continue
            by_peer.setdefault(pref[rnd], []).append(key)
        for peer, keys in by_peer.items():
            n, miss = _stage_from(pool, peer, keys, page_bytes, cap, fetch)
            filled += n
            missing += miss
        want = missing
    _count("fills", filled)
    return filled
