"""Ingest: ranged chunk reads and staged scene loads.

Counterpart of `gsky_tpu/ingest/`:

* `source`  — byte-range sources (local pread, HTTP Range with a
  connection pool and retries, S3 with SigV4 when listed in
  ``GSKY_INGEST_SOURCES``), range coalescing and the `fetch_ranges`
  funnel every ranged read goes through;
* `stats`   — the ledger both read paths report to;
* `staging` — the pool of page-grid-sized host buffers a scene load
  decodes into and uploads from;
* `prefetch` — the planner that predicts a client's next GetMap keys
  (pan, zoom, scan) and warms their scenes and pages ahead of it.

``GSKY_INGEST=0`` turns ranged reads and staged loads off per call:
every reader then takes the handle's whole-file path, which gives the
same bytes.
"""

from __future__ import annotations

import os

from . import stats
from .prefetch import PrefetchPlanner, default_planner, \
    reset_default_planner
from .source import (ByteSource, HTTPRangeSource, LocalFileSource,
                     S3RangeSource, coalesce_ranges, fetch_ranges,
                     open_source, reset_sources, source_for)
from .staging import StagingPool, default_staging_pool, reset_staging_pool

__all__ = ["ByteSource", "HTTPRangeSource", "LocalFileSource",
           "PrefetchPlanner", "S3RangeSource", "StagingPool",
           "coalesce_ranges", "default_planner", "default_staging_pool",
           "fetch_ranges", "ingest_enabled", "open_source",
           "reset_default_planner", "reset_sources", "reset_staging_pool",
           "source_for", "stats", "window_route_frac"]


def ingest_enabled() -> bool:
    """``GSKY_INGEST`` (default on; "0" turns it off), read per call."""
    return os.environ.get("GSKY_INGEST", "1") != "0"


def window_route_frac() -> float:
    """``GSKY_INGEST_WINDOW_FRAC``: the share of a raster under which a
    request for a scene not resident streams through the ranged window
    path instead of loading the whole scene.  Default 0: off (a
    declined scene sends the fused route to the modular one)."""
    try:
        return float(os.environ.get("GSKY_INGEST_WINDOW_FRAC", 0.0))
    except (TypeError, ValueError):
        return 0.0
