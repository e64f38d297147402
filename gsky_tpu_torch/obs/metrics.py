"""Default metric families and scrape-time collectors.

Counterpart of `gsky_tpu/obs/metrics.py`.  Two sourcing rules keep
``/metrics`` honest:

* Distributions (request latency, stage durations, encode times, wave
  occupancy) are observed at the measurement points that already feed
  ``/debug``: the `server.metrics` fold-in, the batcher, the wave
  scheduler and the request's encode.
* Counters and level gauges that already live in stats objects
  (caches, resilience registry, batcher, page pool, admission, ingest
  ledger, wave scheduler, flight recorder) are collected at scrape time
  from those objects, so there is one counter, not two copies.

The port's executors, page pools, scene caches and wave schedulers are
one per server or device, not one per process: a collector sums their
counters over the live ones (the batch knee, a cap that only moves
down, is the smallest).  A collector reports nothing while its
subsystem has not booted (no live object); it does not catch the
errors of one that has, so a renamed field shows as a missing family
(the parity tests compare the family set with the reference's).

``gsky_compiles_total`` counts what the port builds or loads
(`server.prewarm.compile_count`: nvcc builds, library loads and each
kernel symbol's first launch), where the reference counts XLA compiles.
The worker RPC's round trips (``gsky_worker_rpc_seconds``) are observed
by `worker.client`; the ``gsky_fleet_*`` families are collected from the
live fleet routers (`fleet.fleet_stats`).  The cache fabric's
(``gsky_fabric_*``) and the elastic fleet's (``gsky_elastic_*``,
``gsky_preemptions_total``, ``gsky_handoff_pages_total``) render when
the reference's do: the elastic families once elastic has left a trace
in the process (`fleet.elastic.dormant`).  The mesh's
(``gsky_mesh_*``) are observed by `mesh.dispatch` and collected from
its live dispatcher.  ``gsky_plan_block_shape`` counts the output-tile
decisions of `pipeline.autoplan.plan_block`, labelled with the CUDA
tile (``"16x32"``) where the reference's label is its Pallas block.
Left out: ``gsky_fabric_replica_pages``, the gauge of a replication
round that has no caller (C.18).

Everything registers against ``prom.default_registry()``; the server's
``/metrics`` route calls `render_metrics`.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

from .prom import default_registry, log_buckets

_REG = default_registry()

REQUESTS = _REG.counter(
    "gsky_requests_total", "OWS requests by service class and status.",
    ["service", "status"])
REQUEST_SECONDS = _REG.histogram(
    "gsky_request_seconds", "End-to-end OWS request latency.",
    ["service"], buckets=log_buckets(0.002, 120.0))
STAGE_SECONDS = _REG.histogram(
    "gsky_stage_seconds",
    "Per-stage durations (tile pipeline, export pipeline, worker side).",
    ["stage"], buckets=log_buckets(0.0005, 60.0))
RPC_SECONDS = _REG.histogram(
    "gsky_worker_rpc_seconds", "Worker RPC round-trip by op and outcome.",
    ["op", "outcome"], buckets=log_buckets(0.001, 60.0))
ENCODE_SECONDS = _REG.histogram(
    "gsky_encode_seconds", "Encode-pool time by phase (wait vs cpu).",
    ["phase"], buckets=log_buckets(0.0005, 10.0))
BATCH_FLUSHES = _REG.counter(
    "gsky_batch_flushes_total", "Render-batcher flushes by trigger.",
    ["kind"])
WAVE_DISPATCHES = _REG.counter(
    "gsky_wave_dispatches_total",
    "Wave-scheduler device program invocations by result kind.",
    ["kind"])
WAVE_OCCUPANCY = _REG.histogram(
    "gsky_wave_occupancy",
    "Requests coalesced per wave dispatch.",
    buckets=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0])
WAVE_ASSEMBLY_MS = _REG.histogram(
    "gsky_wave_assembly_ms",
    "Wave assembly + dispatch-enqueue time (milliseconds).",
    buckets=log_buckets(0.01, 100.0))
WAVE_GAP_MS = _REG.histogram(
    "gsky_wave_gap_ms",
    "Host-side idle gap between consecutive wave dispatch enqueues "
    "(milliseconds) - the inter-wave stutter the pipelined scheduler "
    "closes (docs/PERF.md 'Continuous device occupancy').",
    buckets=log_buckets(0.01, 1000.0))
WAVE_STAGED = _REG.counter(
    "gsky_wave_staged_total",
    "Wave groups staged ahead of dispatch by the assembly stage "
    "(double-buffered input ring uploads).")
MESH_WAVES = _REG.counter(
    "gsky_mesh_waves_total",
    "Mesh wave dispatches by partition layout.",
    ["layout"])
MESH_CHIP_OCCUPANCY = _REG.histogram(
    "gsky_mesh_chip_occupancy",
    "Wave entries landing on each chip per mesh dispatch.",
    buckets=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0])
MESH_SHARD_SKEW_MS = _REG.histogram(
    "gsky_mesh_shard_skew_ms",
    "Per-chip readback readiness spread per mesh wave (milliseconds).",
    buckets=log_buckets(0.01, 1000.0))
TRACE_EVENTS = _REG.counter(
    "gsky_trace_events_total",
    "Cross-cutting events (retry, breaker_open, hedge, reroute, shed).",
    ["kind"])
PLAN_SUPERBLOCKS = _REG.counter(
    "gsky_plan_superblocks_total",
    "Shared-halo superblocks dispatched by the dataflow autoplanner.")
PLAN_BYTES_SAVED = _REG.counter(
    "gsky_plan_gather_bytes_saved_total",
    "HBM gather bytes the superblock plan avoided vs per-tile windows.")
PLAN_BLOCK_SHAPE = _REG.counter(
    "gsky_plan_block_shape",
    "Cost-model output-tile decisions of kernels B1 and B2 by chosen "
    "tile (rows x cols).",
    ["shape"])
PLAN_ROUTE = _REG.counter(
    "gsky_plan_route_total",
    "Autoplanner group routing between ragged slot pad and bucketed "
    "pulls (the PR 8 crossover).",
    ["path"])
FABRIC_REPLAY = _REG.counter(
    "gsky_fabric_replay_total",
    "Gateway peer-replay fetch outcomes (docs/FABRIC.md): hit/miss/"
    "error/deadline/breaker_open/owner_local/disabled.",
    ["outcome"])
FABRIC_PAGE_FILLS = _REG.counter(
    "gsky_fabric_page_fills_total",
    "Page-pool fills by source: peer (fabric page RPC) vs cold "
    "(decode + stage from storage).",
    ["source"])

Rows = Iterable[Tuple[Dict[str, str], float]]


def _g(name: str, help_: str, rows: Rows):
    return (name, "gauge", help_, list(rows))


def _c(name: str, help_: str, rows: Rows):
    return (name, "counter", help_, list(rows))


def _collect_caches():
    """Hit/miss counters of every cache tier, lifted from the same
    ``cache_stats()`` block each metrics-log record carries, and the
    process-wide gateway's single-flight and admission."""
    from ..server.metrics import cache_stats
    from ..serving import default_gateway
    out: List = []
    hits, misses = [], []
    for cache, st in cache_stats().items():
        hits.append(({"cache": cache}, float(st["hits"])))
        misses.append(({"cache": cache}, float(st["misses"])))
    if hits:
        out.append(_c("gsky_cache_hits_total",
                      "Cache hits by cache tier.", hits))
        out.append(_c("gsky_cache_misses_total",
                      "Cache misses by cache tier.", misses))
    st = default_gateway.stats()
    fl = st["singleflight"]
    out.append(_c("gsky_singleflight_total",
                  "Single-flight render outcomes.",
                  [({"outcome": "leader"}, float(fl["leaders"])),
                   ({"outcome": "joined"}, float(fl["joined"]))]))
    adm = st["admission"]["classes"]
    if adm:
        out.append(_g("gsky_admission_in_use",
                      "In-flight admitted requests.",
                      [({"service": s}, float(c["in_use"]))
                       for s, c in adm.items()]))
        out.append(_g("gsky_admission_queued",
                      "Requests queued at admission.",
                      [({"service": s}, float(c["queued"]))
                       for s, c in adm.items()]))
        out.append(_c("gsky_admission_shed_total",
                      "Requests shed at admission.",
                      [({"service": s}, float(c["shed"]))
                       for s, c in adm.items()]))
    return out


def _collect_fleet():
    # the live routers; none until a ``worker_nodes`` fleet is built
    from ..fleet import fleet_stats
    stats = fleet_stats() or {}
    if not stats:
        return []
    nodes_rows, routed, rerouted, hedge_rows = [], [], [], []
    for name, st in stats.items():
        states: Dict[str, int] = {}
        for h in (st.get("health") or {}).values():
            s = (h or {}).get("state", "unknown")
            states[s] = states.get(s, 0) + 1
        for s, n in states.items():
            nodes_rows.append(({"router": name, "state": s}, float(n)))
        routed.append(({"router": name}, float(st.get("routed", 0))))
        rerouted.append(({"router": name}, float(st.get("rerouted", 0))))
        hg = st.get("hedge") or {}
        for outcome, key in (("fired", "hedges"), ("won", "hedge_wins"),
                             ("denied", "hedges_denied")):
            hedge_rows.append(({"router": name, "outcome": outcome},
                               float(hg.get(key, 0))))
    return [_g("gsky_fleet_nodes",
               "Fleet nodes by router and health state.", nodes_rows),
            _c("gsky_fleet_routed_total",
               "Tasks routed by the fleet router.", routed),
            _c("gsky_fleet_rerouted_total",
               "Tasks rerouted off their preferred node.", rerouted),
            _c("gsky_fleet_hedges_total", "Hedged RPCs by outcome.",
               hedge_rows)]


def _collect_resilience():
    from ..resilience import registry as _rr
    st = _rr.stats()
    out: List = [
        _c("gsky_retries_total", "Retries by site.",
           [({"site": s}, float(n)) for s, n in st["retries"].items()]),
        _c("gsky_retry_exhausted_total",
           "Retry budgets exhausted by site.",
           [({"site": s}, float(n))
            for s, n in st["retry_exhausted"].items()]),
        _c("gsky_degraded_responses_total", "Responses served degraded.",
           [({}, float(st["degraded_responses"]))]),
        _c("gsky_deadline_exhausted_total",
           "Requests that ran out of deadline budget.",
           [({}, float(st["deadline_exhausted"]))])]
    breakers = st["breakers"]
    if breakers:
        out.append(_g("gsky_breaker_open",
                      "Circuit breaker state (1 = open/half-open).",
                      [({"site": s},
                        0.0 if b["state"] == "closed" else 1.0)
                       for s, b in breakers.items()]))
        out.append(_c("gsky_breaker_opens_total",
                      "Circuit breaker trips by site.",
                      [({"site": s}, float(b["opens"]))
                       for s, b in breakers.items()]))
    return out


def _collect_runtime():
    """Builds and loads, the encode pool, the flight recorder."""
    from ..io.png import encode_pool_stats
    from ..server.prewarm import compile_count
    from .recorder import default_recorder
    ep = encode_pool_stats()
    st = default_recorder().stats()
    return [_c("gsky_compiles_total",
               "Kernel builds, library loads and first launches of a "
               "kernel symbol in this process.",
               [({}, float(compile_count()))]),
            _g("gsky_encode_pool_pending",
               "Encode jobs queued or running on the pool.",
               [({}, float(ep["pending"]))]),
            _g("gsky_encode_pool_workers", "Encode-pool worker threads.",
               [({}, float(ep["workers"]))]),
            _c("gsky_encode_pool_encoded_total", "Encode jobs completed.",
               [({}, float(ep["encoded"]))]),
            _c("gsky_encode_pool_errors_total", "Encode jobs that raised.",
               [({}, float(ep["errors"]))]),
            _c("gsky_traces_recorded_total",
               "Traces captured by the flight recorder.",
               [({}, float(st["recorded"]))]),
            _c("gsky_traces_slo_violations_total",
               "Traces past the SLO threshold.",
               [({}, float(st["slo_violations"]))])]


def _collect_batcher():
    """The render batchers' flush counts and padding bill, the
    executors' paged-route split, and the page pools' residency."""
    from ..pipeline import pages
    from ..pipeline.executor import live_executors
    out: List = []
    exs = live_executors()
    if exs:
        sts = [ex.batcher.stats() for ex in exs]
        out.append(_g("gsky_batch_knee",
                      "Adaptive coalesce cap (tiles per flush).",
                      [({}, float(min(s["batch_knee"] for s in sts)))]))
        out.append(_c("gsky_batches_total",
                      "Batch flushes by dispatch kind.",
                      [({"kind": k}, float(sum(s[f] for s in sts)))
                       for k, f in (("windowed", "win_batches"),
                                    ("full", "full_batches"),
                                    ("paged", "paged_batches"))]))
        out.append(_c("gsky_pad_waste_bytes_total",
                      "Bytes moved for pow2/bucket padding instead of "
                      "payload across batch flushes.",
                      [({}, float(sum(s["pad_waste_bytes"]
                                      for s in sts)))]))
        out.append(_c("gsky_paged_dispatches_total",
                      "Executor dispatches served by the paged path vs "
                      "declined to buckets.",
                      [({"outcome": "engaged"},
                        float(sum(ex.paged_engaged for ex in exs))),
                       ({"outcome": "declined"},
                        float(sum(ex.paged_declined for ex in exs)))]))
    pools = [p.stats() for p in pages.live_pools()]
    if pools:
        for name, kind, key, help_ in (
                ("gsky_page_pool_resident", _g, "resident",
                 "Pages resident in the pool."),
                ("gsky_page_pool_capacity", _g, "capacity",
                 "Page pool capacity (pages)."),
                ("gsky_page_pool_staged_total", _c, "staged",
                 "Pages staged into the pool."),
                ("gsky_page_pool_hits_total", _c, "hits",
                 "Page-table hits on already-staged pages."),
                ("gsky_page_pool_evictions_total", _c, "evictions",
                 "LRU page evictions.")):
            out.append(kind(name, help_,
                            [({}, float(sum(s[key] for s in pools)))]))
    return out


def _collect_overload():
    """Adaptive admission limits and per-tenant queue depths, request
    cancellations by pipeline stage, and the memory-pressure state."""
    from ..resilience import cancel_stats
    from ..resilience.pressure import default_monitor
    from ..serving import default_gateway
    out: List = []
    st = default_gateway.admission.stats()
    if st["classes"]:
        out.append(_g("gsky_admit_limit",
                      "Current adaptive admission limit per "
                      "service class.",
                      [({"class": s}, float(c["limit"]))
                       for s, c in st["classes"].items()]))
    if st["tenants"]:
        out.append(_g("gsky_admit_queue_depth",
                      "Requests queued at admission per "
                      "tenant/service-class pair.",
                      [({"tenant_class": k}, float(v))
                       for k, v in st["tenants"].items()]))
    stages = cancel_stats()["stages"]
    if stages:
        out.append(_c("gsky_cancelled_total",
                      "Request cancellations observed per "
                      "pipeline stage.",
                      [({"stage": s}, float(v)) for s, v in stages.items()]))
    out.append(_g("gsky_pressure_state",
                  "Memory-pressure state (0 nominal, 1 brownout, "
                  "2 critical).",
                  [({}, float(default_monitor().stats()["state"]))]))
    return out


def _collect_ingest():
    """Ranged-read volume, prefetch outcomes, and how much of the
    ranged-read time hid under an in-flight device dispatch."""
    from ..ingest import stats as ingest_stats
    st = ingest_stats.snapshot()
    pf = st["prefetch"]
    return [
        _c("gsky_ranged_reads_total",
           "Coalesced byte-range requests issued by the ingest read path.",
           [({}, float(st["ranged_reads"]))]),
        _c("gsky_ranged_read_bytes_total",
           "Bytes fetched through ranged reads.",
           [({}, float(st["ranged_read_bytes"]))]),
        _c("gsky_prefetch_total",
           "Prefetch outcomes: predicted-and-used (hit), "
           "requested-but-not-ready (miss), warmed-but-expired (wasted).",
           [({"outcome": k}, float(pf[k]))
            for k in ("hit", "miss", "wasted")]),
        _g("gsky_ingest_overlap_ratio",
           "Fraction of ranged-read seconds spent while a device "
           "dispatch was in flight.",
           [({}, float(st["overlap_ratio"]))])]


def _collect_waves():
    """The wave schedulers' readback-queue level, request, failover and
    cancellation counts, collected from the live schedulers (one per
    device)."""
    from ..pipeline.waves import wave_stats
    sts = list(wave_stats().values())
    if not sts:
        return []
    return [
        _g("gsky_wave_readback_queue_depth",
           "Wave result blocks awaiting async readback.",
           [({}, float(sum(s["readback_queue_depth"] for s in sts)))]),
        _c("gsky_wave_requests_total",
           "Requests submitted to the wave scheduler.",
           [({}, float(sum(s["requests"] for s in sts)))]),
        _c("gsky_wave_fallbacks_total",
           "Wave entries served via their per-call leg after a device "
           "incident.",
           [({}, float(sum(s["fallbacks"] for s in sts)))]),
        _c("gsky_wave_cancelled_total",
           "Wave entries dropped at assembly or readback for request "
           "cancellation.",
           [({}, float(sum(s["cancelled"] for s in sts)))])]


def _collect_mesh():
    """Mesh serving: the live dispatcher's member count and its entries
    by layout, read at scrape time (one counter, not two copies).  The
    per-wave layout, occupancy and skew distributions are the families
    above, observed where the mesh dispatches."""
    from ..mesh.dispatch import active_mesh
    md = active_mesh()
    if md is None:          # no mesh is built just to report
        return []
    st = md.stats()
    out = [_g("gsky_mesh_chips", "Chips in the serving mesh.",
              [({}, float(st.get("chips", 0)))])]
    ent = st.get("entries_by_layout") or {}
    if ent:
        out.append(_c("gsky_mesh_entries_total",
                      "Wave entries dispatched by layout.",
                      [({"layout": k}, float(v))
                       for k, v in sorted(ent.items())]))
    return out


def _collect_expr():
    """Fused band algebra: compile-cache traffic, distinct fused
    programs, and how expression renders routed.  Rendered only once
    the expression tier has seen traffic."""
    from ..ops.expr import expr_cache_stats
    from ..ops.paged import expr_fused_stats
    cs = expr_cache_stats()
    fs = expr_fused_stats()
    if not (cs["hits"] or cs["misses"] or fs["programs"] or fs["paths"]):
        return []
    out = [_c("gsky_expr_cache_hits_total",
              "Expression compile-cache hits.",
              [({}, float(cs["hits"]))]),
           _c("gsky_expr_cache_misses_total",
              "Expression compile-cache misses (fresh parses).",
              [({}, float(cs["misses"]))]),
           _g("gsky_expr_programs",
              "Distinct expression fingerprints with a fused paged "
              "program this process.",
              [({}, float(fs["programs"]))])]
    if fs["paths"]:
        out.append(_c("gsky_expr_fused_total",
                      "Expression renders by dispatch path.",
                      [({"path": k}, float(v))
                       for k, v in sorted(fs["paths"].items())]))
    return out


def _collect_device():
    """The device guard: the supervisor's state, its incident counters
    and the pages rehydrated into rebuilt pools."""
    from ..device_guard import default_supervisor
    st = default_supervisor().stats()
    return [_g("gsky_device_state",
               "Device supervisor state (0 healthy, 1 suspect, "
               "2 reinitializing, 3 dead).",
               [({}, float(st["state_code"]))]),
            _c("gsky_device_reinits_total",
               "Device teardown+rebuild cycles.",
               [({}, float(st["reinits"]))]),
            _c("gsky_device_hangs_total",
               "Dispatches abandoned by the hang watchdog.",
               [({}, float(st["hangs"]))]),
            _c("gsky_device_incidents_total", "Device incidents by kind.",
               [({"kind": "crash"}, float(st["crashes"])),
                ({"kind": "oom"}, float(st["ooms"])),
                ({"kind": "corrupt"}, float(st["corruptions"]))]),
            _c("gsky_pool_rehydrated_pages_total",
               "Hot pages re-staged into a rebuilt page pool from the "
               "residency journal.",
               [({}, float(st["rehydrated_pages"]))])]


def _collect_tsan():
    """The lockset race sanitizer's race count, once it is on."""
    from .tsan import tsan_stats
    st = tsan_stats()
    if not (st["installed"] or st["enabled"]):
        return []
    return [_c("gsky_tsan_races_total",
               "Data races reported by the lockset sanitizer "
               "(GSKY_TSAN=1).", [({}, float(st["races"]))]),
            _g("gsky_tsan_tracked_vars",
               "Shared variables under lockset tracking.",
               [({}, float(st["tracked_vars"]))])]


# -- temporal serving (animations and streamed DAP4) --------------------
#
# Recorded by the server's animation handler and its streamed DAP4 leg;
# collected at scrape time from this one copy.  A process that never
# served either keeps its exposition without these families.

_TEMPORAL_LOCK = threading.Lock()
_TEMPORAL: Dict[str, float] = {
    "sequences": 0, "frames": 0, "waves": 0, "cancelled": 0,
    "degraded": 0, "dap_streams": 0, "dap_streamed_bytes": 0,
    "dap_peak_buffer_bytes": 0}


def record_anim_sequence(frames: int, waves: int,
                         degraded: bool = False,
                         cancelled: bool = False) -> None:
    """One animation sequence completed: ``frames`` rendered across
    ``waves`` wave dispatches."""
    with _TEMPORAL_LOCK:
        _TEMPORAL["sequences"] += 1
        _TEMPORAL["frames"] += int(frames)
        _TEMPORAL["waves"] += int(waves)
        if degraded:
            _TEMPORAL["degraded"] += 1
        if cancelled:
            _TEMPORAL["cancelled"] += 1


def record_dap_stream(nbytes: int, peak_buffer: int) -> None:
    """One streamed DAP4 response: bytes on the wire and the largest
    resident buffer the rechunker held."""
    with _TEMPORAL_LOCK:
        _TEMPORAL["dap_streams"] += 1
        _TEMPORAL["dap_streamed_bytes"] += int(nbytes)
        _TEMPORAL["dap_peak_buffer_bytes"] = max(
            _TEMPORAL["dap_peak_buffer_bytes"], int(peak_buffer))


def temporal_stats() -> Dict[str, float]:
    """The /debug ``temporal`` block."""
    with _TEMPORAL_LOCK:
        st = dict(_TEMPORAL)
    st["frames_per_wave"] = round(
        st["frames"] / st["waves"], 4) if st["waves"] else 0.0
    return st


def reset_temporal() -> None:
    """Zero the temporal counters."""
    with _TEMPORAL_LOCK:
        for k in _TEMPORAL:
            _TEMPORAL[k] = 0


def _collect_temporal():
    st = temporal_stats()
    if not (st["sequences"] or st["dap_streams"]):
        return []
    return [_c("gsky_anim_sequences_total",
               "Animation sequences served by the temporal wave path, "
               "by outcome.",
               [({"outcome": "ok"},
                 float(st["sequences"] - st["cancelled"])),
                ({"outcome": "cancelled"}, float(st["cancelled"]))]),
            _g("gsky_anim_frames_per_wave",
               "Mean animation frames amortised per wave dispatch "
               "(frames / waves, process lifetime).",
               [({}, float(st["frames_per_wave"]))]),
            _c("gsky_dap_streamed_bytes_total",
               "Bytes streamed by the bounded-RSS DAP4 export leg "
               "(GSKY_DAP_STREAM).",
               [({}, float(st["dap_streamed_bytes"]))])]


def _collect_elastic():
    """The elastic fleet's node counts by lifecycle state, scale
    decisions, preemption notices and hand-off page outcomes, once
    elastic has left a trace in this process (``GSKY_ELASTIC=1``, a
    live autoscaler or a counter off zero): a fixed fleet keeps its
    exposition as it was."""
    from ..fleet import elastic
    if elastic.dormant():
        return []
    out: List = []
    counts: Dict[str, float] = {}
    for a in elastic.autoscalers():
        for state, n in a.node_counts().items():
            counts[state] = counts.get(state, 0) + n
    if counts:
        out.append(_g("gsky_elastic_nodes",
                      "Worker nodes by elastic lifecycle state.",
                      [({"state": s}, float(n))
                       for s, n in sorted(counts.items())]))
    c = elastic.counters()
    out.append(_c("gsky_elastic_decisions_total",
                  "Autoscaler scale decisions by direction.",
                  [({"dir": d}, float(n))
                   for d, n in sorted(c["decisions"].items())]))
    out.append(_c("gsky_preemptions_total",
                  "Preemption notices handled, by whether a grace "
                  "window allowed the drain + journal handoff.",
                  [({"graceful": "true"},
                    float(c["preemptions"]["graceful"])),
                   ({"graceful": "false"},
                    float(c["preemptions"]["nograce"]))]))
    out.append(_c("gsky_handoff_pages_total",
                  "Hot pages inherited on preemption handoff: "
                  "refilled from peer HBM vs left to cold staging.",
                  [({"source": s}, float(n))
                   for s, n in sorted(c["handoff_pages"].items())]))
    return out


for _fn in (_collect_caches, _collect_fleet, _collect_resilience,
            _collect_runtime, _collect_batcher, _collect_overload,
            _collect_ingest, _collect_device, _collect_waves,
            _collect_mesh, _collect_expr, _collect_tsan, _collect_elastic,
            _collect_temporal):
    _REG.register_collector(_fn)


def render_metrics() -> str:
    return default_registry().render()
