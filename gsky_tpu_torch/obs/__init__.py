"""Observability: request-scoped tracing, a flight recorder, and a
dependency-free Prometheus registry.

Counterpart of `gsky_tpu/obs/`.  Three concerns, one seam:

* ``trace``: a ContextVar-carried ``trace_id``/``span_id`` created at
  the OWS request boundary and carried through the gateway, the render
  thread, the tile stages, the batcher, the wave scheduler and the
  export engine.
* ``recorder``: an always-on in-memory ring of the last N complete
  traces plus a reservoir of the slowest/degraded ones, dumped as JSONL
  on demand (``/debug/trace``) or to a file on SLO violation.
* ``prom``: counters, gauges, and log-bucketed histograms rendered in
  Prometheus text exposition format at ``/metrics``.  Histograms are
  observed at the points that feed ``/debug``; the rest is collected
  at scrape time from the live stats objects (``metrics``).

``GSKY_TRACE=0`` disables tracing (spans become no-ops after one
ContextVar read); ``GSKY_TRACE_FILE`` + ``GSKY_TRACE_SAMPLE`` enable
sampled JSONL file export.  ``tsan`` is the opt-in lockset race
sanitizer (``GSKY_TSAN=1``).  The worker RPC carries the trace to the
worker node (`trace_metadata`, gRPC metadata ``x-gsky-trace``;
`remote_trace` there) and its spans back (`adopt_spans`), and observes
``gsky_worker_rpc_seconds``.
"""

from .trace import (  # noqa: F401
    Span,
    Trace,
    adopt_spans,
    bind,
    current_context,
    current_span_id,
    current_trace,
    current_trace_id,
    event,
    record_span,
    remote_trace,
    set_attr,
    span,
    start_trace,
    TRACE_METADATA_KEY,
    trace_enabled,
    trace_metadata,
    traceparent,
)
from .recorder import (  # noqa: F401
    FlightRecorder,
    default_recorder,
    reset_recorder,
)
from .prom import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
    log_buckets,
    parse_exposition,
    reset_registry,
)
from . import metrics  # noqa: F401  (registers default metric families)
from .metrics import (  # noqa: F401
    BATCH_FLUSHES,
    ENCODE_SECONDS,
    REQUESTS,
    REQUEST_SECONDS,
    RPC_SECONDS,
    STAGE_SECONDS,
    TRACE_EVENTS,
    render_metrics,
)
