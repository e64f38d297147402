"""Byte-budgeted LRU cache of encoded OWS responses.

Counterpart of `gsky_tpu/serving/response_cache.py`.  It sits in front
of the pipelines and replays the finished bytes (PNG, JPEG, GeoTIFF,
with their content type) of a request it has answered: the only tier
whose hit costs no device time.

The key is canonical, built from the parsed request (layer, resolved
style, CRS, bbox quantised to the tile grid, size, format, times, extra
dimensions), so equivalent KVP spellings (1.1.1 lon/lat against 1.3.0
lat/lon, case, parameter order) share an entry.  A fingerprint of the
layer's resolved config is part of every key: a reload that changes a
layer gives it a new fingerprint, so its old entries never hit again,
even before `invalidate` drops them.

Entries live ``cache_max_age`` seconds (the layer's) and are evicted
least recently used by body bytes against ``GSKY_RESPONSE_CACHE_BYTES``
(256 MB); a body over ``GSKY_RESPONSE_CACHE_MAX_ENTRY`` (32 MB) is not
kept.  An expired entry stays replayable for
``GSKY_RESPONSE_CACHE_STALE_S`` (600 s) by `get_stale`, for a backend
that fails.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


DEFAULT_CACHE_BYTES = _env_int("GSKY_RESPONSE_CACHE_BYTES", 256 << 20)
DEFAULT_MAX_ENTRY_BYTES = _env_int("GSKY_RESPONSE_CACHE_MAX_ENTRY",
                                   32 << 20)
# seconds past its TTL an entry stays replayable for stale-on-error
# serving; 0 keeps none
DEFAULT_STALE_GRACE = _env_int("GSKY_RESPONSE_CACHE_STALE_S", 600)


def quantise_bbox(xmin: float, ymin: float, xmax: float, ymax: float,
                  width: int, height: int) -> Tuple[int, int, int, int]:
    """The bbox snapped to 1/256 of a pixel of the requested grid:
    spellings of one tile that differ in float formatting collide,
    tiles a resampling kernel can tell apart do not."""
    qx = max((xmax - xmin), 1e-12) / max(width, 1) / 256.0
    qy = max((ymax - ymin), 1e-12) / max(height, 1) / 256.0
    return (int(round(xmin / qx)), int(round(ymin / qy)),
            int(round(xmax / qx)), int(round(ymax / qy)))


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if not f.name.startswith("_")
                and f.name != "timestamp_token"}  # volatile MAS token
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def layer_fingerprint(layer) -> str:
    """A digest of the layer's resolved config (styles, palettes,
    scaling, dates: all that shapes its bytes), memoised on the layer.
    A reload builds new layers, so a changed one gets a new digest."""
    fp = getattr(layer, "_serving_fp", None)
    if fp is None:
        doc = json.dumps(_plain(layer), sort_keys=True,
                         separators=(",", ":"), default=repr)
        fp = hashlib.sha1(doc.encode()).hexdigest()[:16]
        try:
            object.__setattr__(layer, "_serving_fp", fp)
        except (AttributeError, TypeError):
            pass
    return fp


def canonical_key(**parts) -> str:
    """The digest of a request's canonical parts."""
    doc = json.dumps({k: _plain(v) for k, v in sorted(parts.items())},
                     sort_keys=True, separators=(",", ":"), default=repr)
    return hashlib.sha1(doc.encode()).hexdigest()


@dataclass
class CachedResponse:
    body: bytes
    content_type: str
    status: int
    etag: str
    namespace: str
    layer: str
    layer_fp: str
    max_age: int
    expires: float                        # time.monotonic() deadline
    headers: Tuple[Tuple[str, str], ...] = ()   # Content-Disposition
    stale: bool = False     # past its TTL, kept for stale-on-error only


def make_entry(body: bytes, content_type: str, status: int,
               namespace: str, layer: str, layer_fp: str, max_age: int,
               headers: Tuple[Tuple[str, str], ...] = ()
               ) -> CachedResponse:
    """An entry for ``body``; its strong ETag is 32 hex digits of the
    body's SHA-256, quoted."""
    etag = '"' + hashlib.sha256(body).hexdigest()[:32] + '"'
    return CachedResponse(
        body=body, content_type=content_type, status=status,
        etag=etag, namespace=namespace, layer=layer, layer_fp=layer_fp,
        max_age=max_age, expires=time.monotonic() + max_age,
        headers=headers)


class ResponseCache:
    """Thread-safe LRU of `CachedResponse` by canonical key, bounded by
    the bytes of its bodies."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES,
                 max_entry_bytes: int = DEFAULT_MAX_ENTRY_BYTES,
                 stale_grace: int = DEFAULT_STALE_GRACE):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, CachedResponse]" = OrderedDict()
        self._bytes = 0
        self.max_bytes = max_bytes
        self.max_entry_bytes = max_entry_bytes
        self.stale_grace = stale_grace
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.invalidations = 0
        self.stale_hits = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self) -> int:
        return self._bytes

    def get(self, key: str) -> Optional[CachedResponse]:
        """A fresh entry (a hit), or None (a miss).  An expired entry is
        marked stale, counted once as an expiration and kept for
        `get_stale` until its grace ends."""
        now = time.monotonic()
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            if now >= ent.expires:
                if not ent.stale:
                    ent.stale = True
                    self.expirations += 1
                if now >= ent.expires + self.stale_grace:
                    self._drop(key)
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent

    def peek(self, key: str) -> Optional[CachedResponse]:
        """A fresh entry, without touching the hit and miss counts or
        the LRU order: a fabric peer's probe (``/fabric/replay``) must
        neither skew this cache's stats nor keep an entry warm."""
        now = time.monotonic()
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or ent.stale or now >= ent.expires:
                return None
            return ent

    def get_stale(self, key: str) -> Optional[CachedResponse]:
        """An entry for stale-on-error replay: fresh, or expired within
        the grace.  Counts a stale hit, not a hit or a miss."""
        now = time.monotonic()
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            if now >= ent.expires + self.stale_grace:
                self._drop(key)
                return None
            self.stale_hits += 1
            self._entries.move_to_end(key)
            return ent

    def put(self, key: str, ent: CachedResponse) -> bool:
        """Keep ``ent`` (False for a body over the per-entry cap or the
        budget, or a TTL of 0), evicting the least recently used."""
        n = len(ent.body)
        if n > self.max_entry_bytes or n > self.max_bytes \
                or ent.max_age <= 0:
            return False
        with self._lock:
            if key in self._entries:
                self._drop(key)
            self._entries[key] = ent
            self._bytes += n
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                old = next(iter(self._entries))
                self._drop(old)
                self.evictions += 1
            return True

    def _drop(self, key: str) -> None:  # gskylint: holds-lock
        """Remove ``key``; the caller holds the lock."""
        ent = self._entries.pop(key, None)
        if ent is not None:
            self._bytes -= len(ent.body)

    def invalidate(self, namespace_fps: Dict[str, Set[str]]) -> int:
        """Drop every entry whose namespace is gone or whose layer
        fingerprint is not among its namespace's fresh ones; the count
        dropped."""
        dropped = 0
        with self._lock:
            for key in list(self._entries):
                ent = self._entries[key]
                fps = namespace_fps.get(ent.namespace)
                if fps is None or ent.layer_fp not in fps:
                    self._drop(key)
                    dropped += 1
            self.invalidations += dropped
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> Dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "expirations": self.expirations,
                    "invalidations": self.invalidations,
                    "stale_hits": self.stale_hits}
