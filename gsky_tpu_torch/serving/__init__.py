"""The serving gateway: the tier between `server/ows.py` and the
pipelines.

Counterpart of `gsky_tpu/serving/`: the response cache
(`response_cache`: an LRU of encoded responses by canonical key, with
per-layer TTLs and invalidation on reload) and single-flight
(`singleflight`: N concurrent identical requests, one render) and
admission (`admission`: per-service-class concurrency with a queue-wait
deadline that sheds overload as 503 + ``Retry-After``).  The HTTP cache
contract (ETag, 304, Cache-Control, Age) is the server's.  The gateway
holds bytes and permits and launches nothing on the card.

`default_gateway` is the process-wide instance every `OWSServer` uses
unless it is given its own, or None.
"""

from __future__ import annotations

from typing import Dict, Optional

from .admission import AdmissionController, AdmissionShed
from .response_cache import (CachedResponse, ResponseCache, canonical_key,
                             layer_fingerprint, make_entry, quantise_bbox)
from .singleflight import SingleFlight

__all__ = [
    "AdmissionController", "AdmissionShed", "CachedResponse", "ResponseCache", "ServingGateway", "SingleFlight",
    "canonical_key", "default_gateway", "layer_fingerprint",
    "make_entry", "quantise_bbox",
]


class ServingGateway:
    """A response cache, single-flight and admission, composed."""

    def __init__(self, cache: Optional[ResponseCache] = None,
                 flight: Optional[SingleFlight] = None,
                 admission: Optional[AdmissionController] = None):
        self.cache = cache or ResponseCache()
        self.flight = flight or SingleFlight()
        self.admission = admission or AdmissionController()

    def invalidate_for_configs(self, configs) -> int:
        """The config reload hook: drop the cached responses of layers
        that changed or went (their fingerprints already orphan them;
        this returns their bytes now), and let admission read its
        ``GSKY_ADMIT_*`` knobs again."""
        try:
            self.admission.reconfigure()
        except Exception:  # reconfigure is best-effort on reload
            pass
        fps = {ns: {layer_fingerprint(l) for l in cfg.layers}
               for ns, cfg in configs.items()}
        return self.cache.invalidate(fps)

    def cache_counters(self) -> Dict:
        """The compact counter block every metrics record carries."""
        return {"hits": self.cache.hits, "misses": self.cache.misses,
                "inflight_joined": self.flight.joined,
                "shed": self.admission.total_shed}

    def stats(self) -> Dict:
        return {"response_cache": self.cache.stats(),
                "singleflight": {"leaders": self.flight.leaders,
                                 "joined": self.flight.joined,
                                 "inflight": self.flight.inflight},
                "admission": self.admission.stats()}


default_gateway = ServingGateway()
