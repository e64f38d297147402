"""Structured per-request metrics logging.

Counterpart of `gsky_tpu/server/metrics.py`, with its record schema
(the Go server's `metrics/metrics.go:22-57`):
``{req_time, req_duration, url{raw_url,host,path,query}, remote_addr,
remote_host, remote_port, http_status, indexer{duration,url,geometry,
geometry_area,num_files,num_granules}, rpc{duration,num_tiled_granules,
bytes_read,user_time,sys_time}}`` plus ``device{duration,platform}``,
``trace_id`` and ``cache``.  Durations are nanoseconds.  Query
parameters outside `RESERVED_QUERY_PARAMS` are dropped.  Sink: stdout
(``verbose``) or size-rotated gzip files under ``log_dir``
(``GSKY_MAX_LOG_FILE_SIZE``, ``GSKY_MAX_LOG_FILES``), each record
flushed to the file as it is written; with neither, a record is folded
into the ``/debug`` summary and not serialised.

``device.platform`` is the torch device type the render ran on
("cuda" or "cpu"); ``device.duration`` is the fused render's dispatch
plus its readback, which on the card is where the host waits for the
kernels.
"""

from __future__ import annotations

import datetime as dt
import gzip
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict

from ..obs import current_trace_id, default_recorder
from ..obs.metrics import REQUEST_SECONDS, REQUESTS, STAGE_SECONDS

RESERVED_QUERY_PARAMS = {
    "bbox", "coverage", "crs", "dptol", "height", "identifier",
    "identitytol", "layer", "layers", "limit", "namespace", "nseg",
    "request", "service", "srs", "styles", "time", "until", "version",
    "width", "wkt",
    # without it every DAP4 request aggregates under "?.?"
    "dap4.ce",
}


def _sum_hits(caches) -> Dict[str, int]:
    return {"hits": sum(c.hits for c in caches),
            "misses": sum(c.misses for c in caches)}


def cache_stats() -> Dict:
    """Cumulative hit/miss counters of the process's caches: the scene
    caches (one per executor) and drill-stack caches (one per device),
    summed; the MAS query cache; the serving gateway's response cache.
    Every metrics record carries it, and the ``/metrics`` cache
    families read it."""
    from .. import serving
    from ..index.store import MASStore
    from ..pipeline import drill_cache, scene_cache
    return {
        "scene": _sum_hits(scene_cache.live_caches()),
        "drill_stack": _sum_hits(drill_cache.live_caches()),
        "mas_query": {"hits": MASStore.total_query_hits,
                      "misses": MASStore.total_query_misses},
        "response": serving.default_gateway.cache_counters(),
    }


class MetricsCollector:
    """One request's record, filled in as the request runs and written
    by `log`."""

    def __init__(self, logger: "MetricsLogger"):
        self._logger = logger
        self._t0 = time.time()
        self.info: Dict = {
            "req_time": dt.datetime.now(dt.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z",
            "req_duration": 0,
            "url": {"raw_url": "", "host": "", "path": "", "query": {}},
            "remote_addr": "",
            "remote_host": "",
            "remote_port": "",
            "http_status": 200,
            "indexer": {"duration": 0,
                        "url": {"raw_url": "", "host": "", "path": "",
                                "query": {}},
                        "geometry": "", "geometry_area": 0.0,
                        "num_files": 0, "num_granules": 0},
            "rpc": {"duration": 0, "num_tiled_granules": 0,
                    "bytes_read": 0, "user_time": 0, "sys_time": 0},
            # time the host spent on the fused render's dispatch and
            # readback, and the torch device type it ran on
            "device": {"duration": 0, "platform": ""},
            # joins this record to the flight recorder's trace
            "trace_id": "",
        }

    def set_url(self, raw_url: str, path: str, query: Dict[str, str]):
        self.info["url"] = {
            "raw_url": raw_url, "host": "", "path": path,
            "query": {k: v for k, v in query.items()
                      if k in RESERVED_QUERY_PARAMS},
        }

    def set_remote(self, addr: str):
        self.info["remote_addr"] = addr
        host, port = addr, ""
        if addr.startswith("["):          # [v6]:port
            host, _, rest = addr.partition("]")
            host = host[1:]
            port = rest.lstrip(":")
        elif addr.count(":") == 1:        # v4:port
            host, _, port = addr.partition(":")
        # bare v4 / bare v6: no port
        self.info["remote_host"] = host
        self.info["remote_port"] = port

    def log(self, status: int = 200):
        self.info["http_status"] = status
        self.info["req_duration"] = int((time.time() - self._t0) * 1e9)
        self.info["cache"] = cache_stats()
        if not self.info["trace_id"]:
            self.info["trace_id"] = current_trace_id() or ""
        self._logger.record_summary(self.info)
        self._logger.write(self.info)


class MetricsLogger:
    """The records' sink and the ``/debug`` summary's aggregates."""

    # per-verb rolling latency reservoir (the /debug percentile window)
    _RESERVOIR = 512

    def __init__(self, log_dir: str = "", verbose: bool = False):
        self.log_dir = log_dir
        self.verbose = verbose
        self._lock = threading.Lock()
        self._fp = None
        self._size = 0
        self.max_size = int(os.environ.get("GSKY_MAX_LOG_FILE_SIZE",
                                           50 * 1024 * 1024))
        self.max_files = int(os.environ.get("GSKY_MAX_LOG_FILES", 10))
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self.started = time.time()
        # verb -> {count, errors, lat (recent seconds), device_ms, rpc_ms}
        self._summary: Dict[str, Dict] = {}
        self._summary_lock = threading.Lock()
        # cumulative staged-export (pipeline/export.py) aggregates
        self._export: Dict = {}
        # cumulative staged-tile (pipeline/tile_stages.py) aggregates
        self._tiles: Dict = {}

    def collector(self) -> MetricsCollector:
        return MetricsCollector(self)

    def record_summary(self, info: Dict) -> None:
        """Fold one request into the per-verb aggregates of ``/debug``
        and into ``gsky_requests_total`` / ``gsky_request_seconds``."""
        q = info["url"]["query"]
        if "dap4.ce" in q:
            verb = "DAP4.ce"
        else:
            verb = (str(q.get("service", "?")) + "."
                    + str(q.get("request", "?")))[:48]
        dur_s = info["req_duration"] / 1e9
        status = info["http_status"]
        with self._summary_lock:
            s = self._summary.get(verb)
            if s is None:
                s = self._summary[verb] = {
                    "count": 0, "errors": 0,
                    "lat": deque(maxlen=self._RESERVOIR),
                    "device_ms": 0.0, "rpc_ms": 0.0}
            s["count"] += 1
            if status >= 400:
                s["errors"] += 1
            s["lat"].append(dur_s)
            s["device_ms"] += info["device"]["duration"] / 1e6
            s["rpc_ms"] += info["rpc"]["duration"] / 1e6
        # the same fold point feeds /metrics: one clock
        svc = "DAP4" if "dap4.ce" in q else \
            str(q.get("service", "?")).upper()
        REQUESTS.labels(service=svc, status=str(status)).inc()
        REQUEST_SECONDS.labels(service=svc).observe(dur_s)

    # summed export-stats keys; the rest keep the latest value ("last")
    _EXPORT_SUMS = ("tiles", "granules", "index_queries", "scenes_warmed",
                    "scenes_uncacheable", "windows_decoded",
                    "granule_tile_refs", "dedup_saved", "decode_s",
                    "warp_s", "encode_s", "wall_s")
    _EXPORT_MAXES = ("warp_queue_max", "encode_queue_max")

    def record_export(self, stats: Dict) -> None:
        """Fold one staged export's stats (`ExportPipeline.run`) into
        the ``/debug`` aggregates and ``gsky_stage_seconds``."""
        with self._summary_lock:
            e = self._export
            e["exports"] = e.get("exports", 0) + 1
            for k in self._EXPORT_SUMS:
                if k in stats:
                    e[k] = round(e.get(k, 0) + stats[k], 6)
            for k in self._EXPORT_MAXES:
                if k in stats:
                    e[k] = max(e.get(k, 0), stats[k])
            e["last"] = dict(stats)
        for k in ("decode_s", "warp_s", "encode_s", "wall_s"):
            if k in stats:
                STAGE_SECONDS.labels(
                    stage="export_" + k[:-2]).observe(stats[k])

    # staged-tile spans: per-stage seconds summed, queue high-water
    # marks maxed, the last request's record kept
    _TILE_SUMS = ("plan_s", "index_s", "decode_s", "dispatch_s",
                  "readback_s", "encode_s", "granules")
    _TILE_MAXES = ("decode_queue_max", "dispatch_queue_max",
                   "encode_queue_max")

    def record_tile(self, spans: Dict) -> None:
        """Fold one staged GetMap's stage spans into the ``/debug``
        ``tile_stages`` aggregates and ``gsky_stage_seconds``."""
        with self._summary_lock:
            e = self._tiles
            e["tiles"] = e.get("tiles", 0) + 1
            for k in self._TILE_SUMS:
                if k in spans:
                    e[k] = round(e.get(k, 0) + spans[k], 6)
            for k in self._TILE_MAXES:
                if k in spans:
                    e[k] = max(e.get(k, 0), spans[k])
            e["last"] = dict(spans)
        for k in self._TILE_SUMS:
            if k.endswith("_s") and k in spans:
                STAGE_SECONDS.labels(stage=k[:-2]).observe(spans[k])

    def summary(self) -> Dict:
        """The ``/debug`` document's body: uptime, per-verb counts and
        latency percentiles over the rolling window, cumulative device
        and pipeline time, the staged export and tile aggregates (the
        encode pool's stats among the latter), the cache counters, the
        resilience registry, the device supervisor with its residency
        journal, the wave schedulers and the flight recorder."""
        from .. import device_guard
        from ..io.png import encode_pool_stats
        from ..pipeline.tile_stages import gate_stats
        from ..pipeline.waves import wave_stats
        from ..resilience import registry as _resilience
        out: Dict = {"uptime_s": round(time.time() - self.started, 1),
                     "requests": {}}
        with self._summary_lock:
            for verb, s in self._summary.items():
                lat = sorted(s["lat"])

                def pct(p, lat=lat):
                    return round(
                        lat[min(int(len(lat) * p), len(lat) - 1)] * 1e3,
                        1) if lat else None
                out["requests"][verb] = {
                    "count": s["count"], "errors": s["errors"],
                    "p50_ms": pct(0.5), "p99_ms": pct(0.99),
                    "window": len(lat),
                    "device_ms_total": round(s["device_ms"], 1),
                    "pipeline_ms_total": round(s["rpc_ms"], 1)}
            if self._export.get("exports"):
                out["export_pipeline"] = dict(self._export)
            if self._tiles.get("tiles"):
                out["tile_stages"] = dict(self._tiles)
                out["tile_stages"]["gates"] = gate_stats()
                out["tile_stages"]["encode_pool"] = encode_pool_stats()
        out["cache"] = cache_stats()
        out["resilience"] = _resilience.stats()
        # is the card healthy, and how warm would a rebuilt pool be
        dev = device_guard.default_supervisor().stats()
        dev["journal"] = device_guard.journal.stats()
        out["device"] = dev
        ws = wave_stats()
        if ws:
            out["waves"] = ws
        out["trace"] = default_recorder().stats()
        return out

    def flush(self) -> None:
        """Push buffered records to durable storage."""
        with self._lock:
            if self._fp is not None:
                try:
                    self._fp.flush()
                    os.fsync(self._fp.fileno())
                except OSError:
                    pass
            else:
                try:
                    sys.stdout.flush()
                except ValueError:  # stdout closed at interpreter exit
                    pass

    def write(self, info: Dict):
        if not self.log_dir and not self.verbose:
            return  # no sink: skip serialisation
        line = json.dumps(info, separators=(",", ":"))
        with self._lock:
            if not self.log_dir:
                sys.stdout.write(line + "\n")
                # stdout is block-buffered when piped: without a flush a
                # record sits in the buffer on an idle server
                sys.stdout.flush()
                return
            if self._fp is None or self._size > self.max_size:
                self._rotate()
            self._fp.write((line + "\n").encode())
            # to the OS at once: the port has no drain to flush at
            # shutdown, and a server ended by a signal keeps its records
            self._fp.flush()
            self._size += len(line) + 1

    def _rotate(self):  # gskylint: holds-lock
        if self._fp is not None:
            self._fp.close()
            self._gzip_old()
        stamp = dt.datetime.now(dt.timezone.utc).strftime("%Y%m%dT%H%M%S")
        self._path = os.path.join(self.log_dir, f"gsky_metrics_{stamp}.log")
        self._fp = open(self._path, "ab")
        self._size = 0

    def _gzip_old(self):
        try:
            with open(self._path, "rb") as src, \
                    gzip.open(self._path + ".gz", "wb") as dst:
                dst.write(src.read())
            os.remove(self._path)
        except OSError:
            pass
        logs = sorted(f for f in os.listdir(self.log_dir)
                      if f.endswith(".log.gz"))
        while len(logs) > self.max_files:
            try:
                os.remove(os.path.join(self.log_dir, logs.pop(0)))
            except OSError:
                break
