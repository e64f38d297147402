"""The serving gateway: the tier between `server/ows.py` and the
pipelines.

Counterpart of `gsky_tpu/serving/`: the response cache
(`response_cache`: an LRU of encoded responses by canonical key, with
per-layer TTLs and invalidation on reload) and single-flight
(`singleflight`: N concurrent identical requests, one render).  The
HTTP cache contract (ETag, 304, Cache-Control, Age) is the server's.
Admission control is not ported yet (ROADMAP A.16): the gateway has no
``admission``.  The gateway holds bytes and launches nothing on the
card.

`default_gateway` is the process-wide instance every `OWSServer` uses
unless it is given its own, or None.
"""

from __future__ import annotations

from typing import Dict, Optional

from .response_cache import (CachedResponse, ResponseCache, canonical_key,
                             layer_fingerprint, make_entry, quantise_bbox)
from .singleflight import SingleFlight

__all__ = [
    "CachedResponse", "ResponseCache", "ServingGateway", "SingleFlight",
    "canonical_key", "default_gateway", "layer_fingerprint",
    "make_entry", "quantise_bbox",
]


class ServingGateway:
    """A response cache and single-flight, composed."""

    def __init__(self, cache: Optional[ResponseCache] = None,
                 flight: Optional[SingleFlight] = None):
        self.cache = cache or ResponseCache()
        self.flight = flight or SingleFlight()

    def invalidate_for_configs(self, configs) -> int:
        """The config reload hook: drop the cached responses of layers
        that changed or went (their fingerprints already orphan them;
        this returns their bytes now)."""
        fps = {ns: {layer_fingerprint(l) for l in cfg.layers}
               for ns, cfg in configs.items()}
        return self.cache.invalidate(fps)

    def stats(self) -> Dict:
        return {"response_cache": self.cache.stats(),
                "singleflight": {"leaders": self.flight.leaders,
                                 "joined": self.flight.joined,
                                 "inflight": self.flight.inflight}}


default_gateway = ServingGateway()
