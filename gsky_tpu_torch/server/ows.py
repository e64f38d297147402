"""The OWS front end: WMS, WCS, DAP4 and WPS, served over HTTP.

Counterpart of `gsky_tpu/server/ows.py`.  `OWSServer` routes ``/ows``
and ``/ows/<namespace>`` to a namespace's config, dispatches on
``service=`` (or the service ``request=`` implies, or a ``dap4.ce``
constraint) and answers with a `Response`; errors come back as an OGC
ServiceException.  `OWSServer.serve` binds it to a socket with the
standard library's threaded HTTP server, one thread a connection.  A
`Response` body is bytes, a file sent from disk (a streamed GeoTIFF, an
output over 256 MB) or a chunk iterator sent with ``Transfer-Encoding:
chunked`` (the streamed DAP4 body).

WMS GetCapabilities, DescribeLayer, GetLegendGraphic (the layer's legend
file, else its palette drawn as a ramp), GetFeatureInfo (`_feature_info`:
the request through the modular route, `pipeline.feature_info`, and the
clicked pixel's values as JSON) and GetMap.

GetMap runs the reference's ladder: size checks, the zoom limit (an
overview layer, or the placeholder tile), then for a style of one to
four bands the fused route and its PNG: by default the staged path
(`pipeline.tile_stages.render_staged`: plan, index, decode, dispatch,
readback), with ``GSKY_TILE_PIPELINE=0`` the serial ladder.  One band:
`TilePipeline.render_composite_byte` (B1/B2; band algebra through B1
and the expression epilogue), with waves on as lanes of the device's
wave.  Three bands: the RGB ladder (`_render_rgb`: the RGBA rung, whose
tile is encoded as RGBA, else the planes rung through B2).  Two or four
bands: the planes rung.  When the fused route declines (a mask band,
granules in several source CRSs, an uncacheable scene, a fusion layer,
no granules, band algebra in a multi-band style), the modular route
(`TilePipeline.process`), byte scaling of up to four bands and the PNG.
A one-band tile takes the style's or the layer's palette.  An
``image/jpeg`` (or ``image/jpg``) tile is the same byte planes, at most
three, through `io.png.encode_jpeg`; an RGBA-rung tile gives it its
red, green and blue.

A TIME list with an animation format (``image/apng``; ``video/mp4`` is
answered with the same APNG, labelled ``X-Gsky-Anim-Container:
apng-stub``) is an animation: one index pass
(`TilePipeline.animation_prep`), every frame a lane of one wave, sent
from ``GSKY_ANIM_WORKERS`` threads, the frames' PNGs spliced into one
APNG (`io.png.ApngAssembler`) whose frame count is the header
``X-Gsky-Anim-Frames``.  A layer the fused composite route does not
serve (a mask band, band algebra) renders each frame on its own
through the modular route.  As in the reference, a multi-band style's
frames go through the composite route too, which composites the bands
into one plane.
``GSKY_ANIM=0`` answers such a request with one image over the range.

WCS GetCoverage (`_getcoverage`) runs the reference's ladder: size and
format checks (width = height = 0 sizes the output from the sources,
`pipeline.extent`), the output cut into tiles of at most
``wcs_max_tile_width`` x ``wcs_max_tile_height`` (`split_bbox`), then a
multi-tile export through the staged export engine
(`pipeline.export.ExportPipeline`; ``GSKY_EXPORT_PIPELINE=0`` renders
tile by tile), a single tile or a fusion layer through the modular
route.  A GeoTIFF over ``WCS_STREAM_PIXELS`` with tiles on the 256 grid
streams its tiles into a `GeoTIFFWriter` on disk; otherwise the
coverage is built in RAM and its nodata (-9999) filled in place, then
written as GeoTIFF, NetCDF or DAP4.  A DAP4 request (``dap4.ce``,
`server.dap4`) is a GetCoverage whose multi-tile coverage, with
``GSKY_DAP_STREAM`` on, is spooled to disk by the engine and streamed.
WPS Execute (`_wps_execute`) drills the process's data sources through
`DrillPipeline.process_split` and answers their CSVs; the XML Execute
document may come as a POST body.

GetMap and GetCoverage go through the serving gateway (`serving`; the
process-wide `default_gateway` unless the server is given its own, or
None): a response cache keyed on the parsed request, then
single-flight, then admission, then the render (`_serve_gated`).  A replay carries
``X-Gsky-Cache`` (miss, hit, join, stale), a strong ``ETag``,
``Cache-Control: max-age=<cache_max_age>`` and ``Age``, and a matching
``If-None-Match`` gets a 304.  An animation, an incomplete request, a
shard, an auto-sized GetCoverage, a layer whose ``cache_max_age`` is 0,
a body sent from a file or as chunks, a degraded render and a joiner's
copy are not cached.  Every request runs in a `request_scope`: a 200
whose render absorbed a partial failure is labelled ``X-GSKY-Degraded``
with its sorted reasons.

Under load, as the reference (`resilience`, `serving.admission`):

- admission per service class (WMS, WCS, WPS, DAP4), keyed by tenant
  (``X-API-Key`` or ``key=``, else the first ``X-Forwarded-For`` hop,
  else the client's address); a cache hit costs no slot.  A request
  that queued past ``GSKY_ADMIT_QUEUE_S`` is shed: 503 ``ServerBusy``
  with ``Retry-After``;
- deadlines: GetMap, an animation (x frames) and GetFeatureInfo get
  ``wms_timeout``, GetCoverage ``wcs_timeout`` x tiles, a WPS drill its
  source's ``wcs_timeout`` (30 s when unset).  The render runs in a
  worker thread under a copy of the request's context and the handler
  waits for what is left of the budget (`_bounded`, the reference's
  ``wait_for`` over ``to_thread``); past it the request's cancel token
  fires and the answer is 504, while the render unwinds at its next
  cancellation check;
- cancellation: every request opens a cancel scope
  (`resilience.cancel`).  The standard library's server does not see a
  client go away, so the handler gives the token a probe of its
  socket (a non-blocking ``MSG_PEEK`` that reads ``b""`` once the peer
  has closed), which ``check_cancel`` runs at most every 50 ms.  A
  cancelled request is answered with nothing and the connection closed;
- a dependency that stayed down through retries (`BackendUnavailable`,
  an open breaker) answers 503 ``ServerBusy`` with ``Retry-After``, and
  the gateway replays a stale entry on it (``X-Gsky-Cache: stale``,
  labelled ``stale-cache``); so does a device incident
  (`device_guard.DeviceGuardError`: a CUDA error, a hang past
  ``GSKY_DEVICE_HANG_S``, a readback that fails the integrity probe, a
  device rebuilding or dead), the server's readbacks (the serial
  ladder's and the modular route's tile, an animation's frames, a
  GetCoverage's float planes) running under
  `device_guard.guarded_readback`;
- brownout under memory pressure (`resilience.pressure`): a GetMap is
  labelled ``X-GSKY-Degraded: brownout``, renders the overview one (or,
  when critical, two) levels coarser where the layer has overviews,
  encodes at the cheapest PNG effort, and an animation keeps every
  second (fourth) frame; a degraded response is never cached;
- prefetch: each resolvable GetMap key feeds the planner
  (`ingest.prefetch`), whose warm callback (`_prefetch_warm`) loads the
  predicted tiles' scenes and stages their pages.

Requests the port cannot serve yet get HTTP 501 with exception code
``OperationNotSupported`` and a message naming the ROADMAP item, as
does any NotImplementedError the pipeline raises.  A namespace's MAS is
its ``mas_address`` over HTTP (`MASClient`), unless the server is given
a ``mas_factory`` (an in-process store).  A WPS process over a VRT
drills through the template it names.

A fleet, as the reference's:

- ``worker_nodes``: the namespace's pipeline gets a `worker.WorkerClient`
  over them (rebuilt, and the old one closed, when a reload changes
  the MAS address or the node list), and every GetMap, GetCoverage and
  GetFeatureInfo tile takes the modular route with its warps on the
  workers and its mosaic here (`TilePipeline`'s remote leg).  A fleet
  whose every node failed answers 503 ``ServerBusy``: nothing renders
  locally in its place;
- ``ows_cluster_nodes``: a GetCoverage of at least twice as many tiles
  as nodes is cut into bands of tile rows; band 0 renders here and each
  peer gets a ``wshard=1`` GetCoverage for its band (`_fetch_shard`,
  over ``http.client`` under the request's deadline), whose GeoTIFF
  merges into the coverage.  A peer that fails has its band rendered
  here, and the answer is labelled ``X-GSKY-Degraded: shard-fallback``;
- admission's shed answers name the fleet's least loaded healthy node
  in ``X-GSKY-Alt-Node``;
- the drain (`shutdown`, on SIGTERM from `server.main`): the accept
  gate of ``/ows`` (`fleet.DrainController`) closes, so a new request
  gets 503 ``ServerBusy`` with ``Retry-After: 5`` and ``Connection:
  close``, the requests in flight finish and their answers are written
  out, the metrics log is flushed and the worker clients closed.  ``/metrics`` and ``/debug`` keep
  answering.

Observability, as the reference's (`obs`): every ``/ows`` request is a
trace (``ows.request``, ``GSKY_TRACE=0`` turns it off) whose spans are
the gateway's (``gateway.lookup``, ``gateway.admission``, ``render``,
``gateway.singleflight``), the staged tile path's (``tile.*``), the
encode's, the batcher's and the export engine's; it ends in the flight
recorder.  Every request is one record of the metrics log
(`server.metrics.MetricsCollector`, logged with its status).  Routes:
``GET /metrics`` (Prometheus text), ``/debug`` (the summary and the
subsystems' stats), ``/debug/trace`` (the recorder's list, ``?format=
jsonl`` its dump, ``?slowest=1`` the slowest trace), ``/debug/trace/<id>``
(one span tree) and ``/debug/profile?seconds=N`` (a `torch.profiler`
capture, CUDA kernels included on a card server, written as a Chrome
trace); ``/debug`` carries the device supervisor's ``device`` block with
its residency journal, the fleet routers' ``fleet`` block (with a
``worker_nodes`` fleet) and the ``drain`` block.  With the staged tile
path on, a tile's PNG or JPEG encode runs on the sized encode pool
(`io.png.encode_pooled`, ``GSKY_PNG_ENCODE_WORKERS``).

The cache fabric's gateway tier (`fabric.replay`), as the reference's:
with ``GSKY_FABRIC=1`` and ``GSKY_FABRIC_SELF`` and
``GSKY_FABRIC_PEERS`` set (or a `ReplayFabric` given), a gateway that
misses its response cache and does not own the key on the ring asks
the owner for the encoded bytes (span ``gateway.fabric``, between the
lookup and the single-flight) and replays them as ``X-Gsky-Cache:
peer`` (``no-store`` while this server is under brownout).  ``GET
/fabric/replay?key=`` serves a peer this gateway's fresh 200 entries
(404 when it has none, and under brownout with
``X-Gsky-Fabric-NoStore``).  ``/debug`` carries the ``fabric`` block
while a fabric is set or the gate is on, and the ``elastic`` block once
the elastic fleet has left a trace in the process.  With both off
every route runs as it did without them.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import contextvars
import dataclasses
import datetime as dt
import http.client
import json
import logging
import os
import shutil
import socket
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, List, Mapping, Optional, \
    Tuple
from urllib.parse import parse_qs, urlencode, urlsplit

import numpy as np
import torch

from .. import device_guard, obs
from ..device import resolve_device
from ..fleet import DrainController, Draining
from ..geo import geometry as geom
from ..geo.crs import parse_crs
from ..geo.transform import BBox, GeoTransform, pixel_resolution, \
    split_bbox, transform_bbox
from ..index.client import MASClient
from ..index.store import parse_time
from ..ingest import ingest_enabled
from ..ingest.prefetch import default_planner
from ..io.geotiff import GeoTIFF, GeoTIFFWriter, write_geotiff
from ..io.netcdf import write_netcdf3
from ..io.png import ApngAssembler, empty_tile_png, encode_jpeg, \
    encode_png, encode_pooled, encode_rgba_png
from ..obs import metrics as obs_metrics
from ..ops import kernel_launches
from ..ops.palette import gradient_palette, with_nodata_entry
from ..ops.scale import scale_params_auto, scale_to_byte
from ..pipeline.drill import DrillPipeline, drill_csv
from ..pipeline.executor import WarpExecutor
from ..pipeline.export import ExportPipeline
from ..pipeline.export import pipeline_enabled as export_pipeline_enabled
from ..pipeline.extent import compute_reprojection_extent
from ..pipeline.feature_info import get_feature_info
from ..pipeline.tile import TilePipeline, evaluate_expressions
from ..pipeline.tile_stages import render_staged, tile_pipeline_enabled
from ..pipeline.types import AxisSelector, GeoDrillRequest, \
    GeoTileRequest, MaskSpec
from ..pipeline.waves import wave_stats
from ..ops.paged import page_shape
from ..pipeline.decode import _pixel_window
from ..resilience import BackendUnavailable, CancelToken, Deadline, \
    DeadlineExceeded, RequestCancelled, TooManyFailures, brownout_level, \
    cancel_scope, check_cancel, deadline_scope, \
    degraded_reasons, mark_degraded, registry, request_scope
from ..serving import AdmissionShed, ServingGateway, canonical_key, \
    default_gateway, layer_fingerprint, make_entry, quantise_bbox
from . import dap4
from . import templates as T
from .config import Config, ConfigWatcher, Layer, get_layer_dates
from .metrics import MetricsCollector, MetricsLogger
from .params import OWSError, infer_service, normalise_query, parse_wcs, \
    parse_wms, parse_wps

log = logging.getLogger("gsky.ows")

# a GeoTIFF coverage of more pixels than this streams its tiles to disk
WCS_STREAM_PIXELS = 16 << 20
# an in-RAM coverage body larger than this is sent from its file
_MAX_BODY_BYTES = 256 * 1024 * 1024
_WCS_FORMATS = ("geotiff", "gtiff", "tiff", "netcdf", "nc",
                "application/x-netcdf", "image/tiff", "dap4")
_TIFF_FORMATS = ("geotiff", "gtiff", "tiff", "image/tiff")
_NETCDF_FORMATS = ("netcdf", "nc", "application/x-netcdf")
# output formats of a TIME animation
_ANIM_FORMATS = ("image/apng", "video/mp4")
_JPEG_FORMATS = ("image/jpeg", "image/jpg")
# host-clock stages of a request (`OWSServer.spans`): "parse" until the
# render starts (query, config, layer, tile request), "render" the
# pipeline through the byte tile's readback, "encode" the PNG or JPEG
STAGES = ("parse", "render", "encode")
# query parameters the cache key holds parsed; any other is part of the
# key as it came
_KEY_CONSUMED = frozenset({
    "service", "request", "version", "layers", "layer", "styles",
    "style", "crs", "srs", "bbox", "width", "height", "format", "time",
    "coverage", "coverageid", "identifier", "subset", "exceptions",
})
_GATEWAY_DEFAULT = object()     # None means no gateway
_FABRIC_DEFAULT = object()      # None means no fabric
# the status of a request whose client went away: nothing is sent
CLIENT_GONE = 499
# the request's tenant, for admission's weighted-fair queue
_TENANT: contextvars.ContextVar[str] = \
    contextvars.ContextVar("gsky_torch_tenant", default="anon")


def anim_enabled() -> bool:
    """GSKY_ANIM=0 serves a TIME list with an animation format as one
    image over the range (default on)."""
    return os.environ.get("GSKY_ANIM", "1") != "0"


def _anim_delay_ms() -> int:
    """A frame's display time in the APNG (GSKY_ANIM_DELAY_MS, default
    500)."""
    try:
        return max(1, int(os.environ.get("GSKY_ANIM_DELAY_MS", "500")))
    except ValueError:
        return 500


def _anim_max_frames() -> int:
    """Most frames an animation renders (GSKY_ANIM_MAX_FRAMES, default
    64; <= 0 no limit): a longer TIME list is cut to it."""
    try:
        return int(os.environ.get("GSKY_ANIM_MAX_FRAMES", "64"))
    except ValueError:
        return 64


def _anim_workers() -> int:
    """Threads that send an animation's frames (GSKY_ANIM_WORKERS,
    default 8): frames in flight together share a wave."""
    try:
        return max(1, int(os.environ.get("GSKY_ANIM_WORKERS", "8")))
    except ValueError:
        return 8


def _host(tile) -> np.ndarray:
    """A byte tile on the host: a wave's result is; a tensor is copied."""
    return tile if isinstance(tile, np.ndarray) else tile.cpu().numpy()


@dataclass
class Response:
    """An answer.  Its body is ``body``, or the file at ``path`` (sent
    from disk, then unlinked), or the bytes ``chunks`` yields (sent with
    ``Transfer-Encoding: chunked``).  `read` gives any of them as bytes;
    `close` releases a file or a stream that is not read."""

    status: int
    content_type: str
    body: bytes = b""
    headers: Dict[str, str] = field(default_factory=dict)
    path: str = ""
    chunks: Optional[Iterator[bytes]] = None

    def read(self) -> bytes:
        try:
            if self.path:
                with open(self.path, "rb") as fp:
                    self.body = fp.read()
            elif self.chunks is not None:
                self.body = b"".join(self.chunks)
        finally:
            self.close()
        return self.body

    def close(self) -> None:
        if self.chunks is not None:
            self.chunks.close()
            self.chunks = None
        if self.path:
            try:
                os.remove(self.path)
            except OSError:
                pass
            self.path = ""


class _Clock:
    """Host-clock stage marks of one request."""

    def __init__(self):
        self.last = time.perf_counter()
        self.spans: Dict[str, float] = {}

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        self.spans[stage] = self.spans.get(stage, 0.0) + now - self.last
        self.last = now


class OWSServer:
    def __init__(self, watcher: ConfigWatcher, mas_factory=None,
                 device="cuda", temp_dir: str = "",
                 gateway=_GATEWAY_DEFAULT,
                 metrics: Optional[MetricsLogger] = None,
                 fabric=_FABRIC_DEFAULT):
        """``mas_factory(address)`` gives a namespace's `MASClient`;
        without one, a namespace's client reaches its ``mas_address``
        over HTTP (timeout ``mas_timeout``).
        ``device`` ("cuda" by default) is where every pipeline renders;
        without CUDA it must be "cpu".  ``temp_dir`` (default the
        system's, which honours TMPDIR) holds coverage files while they
        are written and sent.  ``gateway``: the `ServingGateway` in
        front of GetMap and GetCoverage, by default the process-wide
        `serving.default_gateway`; None serves every request raw.
        ``metrics``: the request records' `MetricsLogger` (by default
        one with no sink, which still feeds ``/debug`` and
        ``/metrics``).  ``fabric``: the cache fabric's `ReplayFabric`,
        by default one built from the environment when ``GSKY_FABRIC``
        is on and its ring is set (`fabric.replay.default_fabric`);
        None has none."""
        self.device = resolve_device(device)
        self.watcher = watcher
        self.gateway: Optional[ServingGateway] = \
            default_gateway if gateway is _GATEWAY_DEFAULT else gateway
        if self.gateway is not None:
            _register_gateway_invalidation(watcher, self.gateway)
        if fabric is _FABRIC_DEFAULT:
            from .. import fabric as fabric_mod
            from ..fabric.replay import default_fabric
            fabric = default_fabric() if fabric_mod.fabric_enabled() \
                else None
        self.fabric = fabric
        self.mas_factory = mas_factory
        self.temp_dir = temp_dir or tempfile.gettempdir()
        self.metrics = metrics or MetricsLogger()
        # one profiler capture at a time: two overlapping captures
        # collide in the profiler
        self._profile_mutex = threading.Lock()
        # the stats of the last multi-tile export (`ExportPipeline.run`)
        self.last_export: Dict[str, object] = {}
        # one executor (scene cache, page pool) for every namespace
        self.executor = WarpExecutor(device=self.device)
        self._pipelines: Dict[str, Tuple[tuple, TilePipeline]] = {}
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        # seconds per stage (STAGES) and the handler's total, summed
        # over requests
        self.spans = dict.fromkeys(STAGES + ("handle",), 0.0)
        # the drain's accept gate of /ows (/metrics and /debug keep
        # answering, so that operators can watch the drain land)
        self.drain = DrainController("ows")
        # HTTP requests not yet written out (`writing`): `shutdown`
        # waits for them after the drain, since a streamed or file body
        # is sent after `handle` has returned
        self._writing = 0
        self._written = threading.Condition()

    # -- plumbing ---------------------------------------------------------

    def _mas(self, cfg: Config) -> MASClient:
        sc = cfg.service_config
        if self.mas_factory is not None:
            return self.mas_factory(sc.mas_address)
        return MASClient(sc.mas_address, timeout=sc.mas_timeout)

    def _pipeline(self, cfg: Config) -> TilePipeline:
        """One pipeline per namespace, rebuilt (and its old worker
        client closed) when a reload changes its MAS address or its
        ``worker_nodes`` (`WatchConfig`, `config.go:1373`)."""
        sc = cfg.service_config
        nskey = sc.namespace or sc.mas_address
        settings = (sc.mas_address, tuple(sc.worker_nodes))
        with self._lock:
            cur = self._pipelines.get(nskey)
            if cur is not None and cur[0] == settings:
                return cur[1]
        # one build at a time, outside the request lock: the workers'
        # probe may take a while, and concurrent first requests must
        # not each build (and register) a fleet client
        with self._build_lock:
            with self._lock:
                cur = self._pipelines.get(nskey)
                if cur is not None and cur[0] == settings:
                    return cur[1]
            remote = None
            if sc.worker_nodes:
                from ..worker import WorkerClient
                remote = WorkerClient(sc.worker_nodes)
                # the concurrency cap from the workers' real pool sizes
                # (`getGrpcPoolSize`, `utils/config.go:1124-1187`)
                remote.autosize()
            pipe = TilePipeline(self._mas(cfg), executor=self.executor,
                                device=self.device, remote=remote)
            with self._lock:
                self._pipelines[nskey] = (settings, pipe)
        if cur is not None and cur[1].remote is not None:
            cur[1].remote.close()
        return pipe

    # -- the serving gateway (response cache, single-flight) ---------------

    def _response_key(self, cfg: Config, op: str, name: str, service: str,
                      p, q: Dict[str, str]):
        """(key, meta) of a render of layer ``name`` the gateway may
        keep, or (None, None) where the layer's ``cache_max_age`` is 0.
        The key (cache and flight) is built from the parsed request, so
        that equivalent KVP spellings (axis order, case, float
        formatting, parameter order) collide; it holds the layer's
        fingerprint.  meta: (namespace, layer, fingerprint, max age)."""
        lay, style = self._resolve_layer(cfg, name, p.styles, service)
        if lay.cache_max_age <= 0:
            return None, None
        fp = layer_fingerprint(lay)
        extras = tuple(sorted(
            (k, v) for k, v in q.items()
            if k not in _KEY_CONSUMED and not k.startswith("dim_")))
        ns = cfg.service_config.namespace
        key = canonical_key(
            ns=ns, op=op, layer=lay.name, style=style.name,
            crs=repr(p.crs),
            bbox=quantise_bbox(p.bbox.xmin, p.bbox.ymin, p.bbox.xmax,
                               p.bbox.ymax, p.width, p.height),
            size=(p.width, p.height), fmt=p.format.lower(),
            times=tuple(p.times),
            axes=tuple(sorted(getattr(p, "axes", {}).items())),
            extras=extras, layer_fp=fp)
        return key, (ns, lay.name, fp, lay.cache_max_age)

    def _admit(self, service_class: str):
        """The gateway's admission for one render of ``service_class``
        (none without a gateway)."""
        if self.gateway is None:
            return contextlib.nullcontext()
        return self.gateway.admission.admit(service_class, _TENANT.get())

    def _serve_gated(self, key: Optional[str], meta,
                     req_headers: Optional[Mapping[str, str]],
                     render: Callable[[], Response],
                     service_class: str,
                     collector: MetricsCollector) -> Response:
        """Response cache, then single-flight, then admission, then
        ``render()``.  A hit renders nothing and takes no admission
        slot; on a miss one request per key renders (under the class's
        admission) and the others share its bytes, or its error.  A
        response sent from a file or as chunks goes to the leader alone;
        joiners render their own.  When the backend is down
        (`BackendUnavailable`) or too many granules failed
        (`TooManyFailures`), an entry past its TTL but within the stale
        grace is replayed, labelled ``no-store``.  The record's
        ``response_cache`` says which of hit, miss, join or stale it
        was."""
        gw = self.gateway
        if gw is None or key is None:
            with self._admit(service_class):
                return render()
        with obs.span("gateway.lookup") as lsp:
            ent = gw.cache.get(key)
            lsp.set(hit=ent is not None)
        if ent is not None:
            collector.info["response_cache"] = "hit"
            return _replay(req_headers, ent, "hit")
        if self.fabric is not None:
            with obs.span("gateway.fabric") as psp:
                pent = self.fabric.fetch(key)
                psp.set(hit=pent is not None)
            if pent is not None:
                gw.cache.put(key, pent)
                collector.info["response_cache"] = "peer"
                return _replay(req_headers, pent, "peer")

        def flight():
            t0, pc0 = time.time(), time.perf_counter()
            with self._admit(service_class):
                obs.record_span("gateway.admission",
                                time.perf_counter() - pc0, t0=t0,
                                service=service_class)
                with obs.span("render", service=service_class):
                    return _freeze_response(render())

        try:
            with obs.span("gateway.singleflight") as fsp:
                frozen, joined = gw.flight.do(key, flight)
                fsp.set(joined=joined)
        except (BackendUnavailable, TooManyFailures):
            stale = gw.cache.get_stale(key)
            if stale is None:
                raise
            mark_degraded("stale-cache")
            collector.info["response_cache"] = "stale"
            return _replay(req_headers, stale, "stale")
        if not isinstance(frozen, tuple):     # a file or a stream
            if joined:
                with self._admit(service_class):
                    return render()
            return frozen
        status, ctype, body, keep = frozen
        ns, layer_name, fp, max_age = meta
        ent = make_entry(body, ctype, status, ns, layer_name, fp, max_age,
                         keep)
        # a degraded (partial) render is not cached: it would replay the
        # holes after the fault cleared
        if status == 200 and not joined and not degraded_reasons():
            gw.cache.put(key, ent)
        tag = "join" if joined else "miss"
        collector.info["response_cache"] = tag
        return _replay(req_headers, ent, tag)

    # -- dispatch -----------------------------------------------------------

    def handle(self, path: str, query, host: str = "",
               body: Optional[bytes] = None,
               headers: Optional[Mapping[str, str]] = None,
               remote: str = "",
               probe: Optional[Callable[[], Optional[str]]] = None,
               raw_url: str = "") -> Response:
        """One request: ``path`` (``/ows`` or ``/ows/<namespace>``, or
        one of the observability routes: ``/metrics``, ``/debug``,
        ``/debug/trace``, ``/debug/trace/<id>``, ``/debug/profile``),
        ``query`` (a mapping of key to value or to a list of values),
        ``host`` (the Host header, for the documents' URLs), ``body``
        (a POST's body: a WPS Execute document), ``headers`` (the
        request's, read for ``If-None-Match``, the tenant and
        ``X-Forwarded-For``), ``remote`` (the client's address, the
        tenant's last resort), ``probe`` (the request's cancel probe: a
        reason once its client has gone) and ``raw_url`` (the request
        line's target, for the metrics record).  A cancelled request's
        status is `CLIENT_GONE`; it is neither logged nor counted."""
        if path == "/metrics":
            return self._metrics()
        if path == "/debug":
            return self._debug()
        if path == "/debug/trace":
            return self._debug_trace(normalise_query(query))
        if path.startswith("/debug/trace/"):
            return self._debug_trace_one(path[len("/debug/trace/"):])
        if path == "/debug/profile":
            return self._debug_profile(normalise_query(query))
        if path == "/fabric/replay":
            return self._fabric_replay(normalise_query(query))
        if path.rstrip("/") == "/ows":
            ns = ""
        elif path.startswith("/ows/"):
            ns = path[len("/ows/"):]
        else:
            return Response(404, "text/plain", b"404: Not Found")
        try:
            with self.drain.track():
                # the trace is born here and ends in the flight recorder
                # (GSKY_TRACE=0: none)
                with obs.start_trace("ows.request", path=path) as otrace:
                    resp = self._handle_ows(ns, path, query, host, body,
                                            headers, remote, probe,
                                            raw_url)
                    if otrace is not None:
                        if resp.status == CLIENT_GONE:
                            otrace.root.attrs.setdefault(
                                "error", "RequestCancelled")
                        else:
                            otrace.status = resp.status
                        deg = resp.headers.get("X-GSKY-Degraded")
                        if deg:
                            otrace.degraded = deg.split(",")
                return resp
        except Draining:
            # refused at the gate: the balancer should close this
            # connection and retry against a peer gateway
            resp = _exception_response(
                OWSError("server is draining", "ServerBusy", status=503),
                {"Retry-After": "5"})
            resp.headers["Connection"] = "close"
            return resp

    # -- the drain (SIGTERM) ------------------------------------------------

    def shutdown(self, timeout_s: Optional[float] = None) -> bool:
        """The drain: close the ``/ows`` accept gate (new requests get a
        fast 503 with ``Retry-After``), let every request in flight run
        to completion and every HTTP answer be written out (at most
        ``timeout_s``, by default ``GSKY_DRAIN_TIMEOUT_S``, 30), flush
        the metrics log, then close the worker clients.  False when work
        outlived the timeout."""
        if timeout_s is None:
            try:
                timeout_s = float(
                    os.environ.get("GSKY_DRAIN_TIMEOUT_S", "30") or 30)
            except ValueError:
                timeout_s = 30.0
        deadline = time.monotonic() + timeout_s
        self.drain.start_drain()
        ok = self.drain.wait_drained(timeout_s)
        with self._written:
            while self._writing:
                left = deadline - time.monotonic()
                if left <= 0:
                    ok = False
                    break
                self._written.wait(left)
        st = self.drain.stats()
        log.info("ows drain %s: completed=%d refused=%d inflight=%d",
                 "complete" if ok else "TIMED OUT",
                 st["completed"], st["refused"], st["inflight"])
        self.metrics.flush()
        self.close()
        return ok

    @contextlib.contextmanager
    def writing(self):
        """One HTTP request, from its read to the last byte of its
        answer (`_Handler`): the drain of `shutdown` waits for it."""
        with self._written:
            self._writing += 1
        try:
            yield
        finally:
            with self._written:
                self._writing -= 1
                if not self._writing:
                    self._written.notify_all()

    def close(self) -> None:
        """Close the namespaces' worker clients and the fabric's fetch
        threads, and let go of the process-wide prefetch planner
        (idempotent)."""
        if self.fabric is not None:
            self.fabric.close()
        # the planner warms through the first server that fed it: the
        # next server binds it, not a closed server's caches
        from ..ingest import prefetch
        prefetch.unbind(self._prefetch_warm)
        with self._lock:
            pipes = [pipe for _, pipe in self._pipelines.values()]
        for pipe in pipes:
            if pipe.remote is not None:
                try:
                    pipe.remote.close()
                except Exception:  # closed during an earlier drain
                    pass

    def _handle_ows(self, ns: str, path: str, query, host: str,
                    body: Optional[bytes],
                    headers: Optional[Mapping[str, str]], remote: str,
                    probe, raw_url: str) -> Response:
        """One ``/ows`` request inside its trace: its metrics record,
        tenant, request and cancel scopes around `_answer`; the record
        is logged with the answer's status."""
        clock = _Clock()
        t0 = clock.last
        req_headers = {k.lower(): v for k, v in (headers or {}).items()}
        q = normalise_query(query)
        collector = self.metrics.collector()
        collector.set_url(raw_url or _raw_url(path, q), path, q)
        collector.set_remote(req_headers.get("x-forwarded-for", remote)
                             .split(",")[0].strip())
        obs.set_attr(verb="DAP4.ce" if "dap4.ce" in q else
                     f"{q.get('service', '?')}.{q.get('request', '?')}",
                     ns=ns)
        tenant_tok = _TENANT.set(_tenant_of(req_headers, query, remote))
        try:
            with request_scope() as rstate, \
                    cancel_scope(CancelToken(probe=probe)) as tok:
                resp = self._answer(ns, q, path, host, clock, body,
                                    req_headers, tok, collector)
                reasons = sorted(set(rstate.reasons))
        finally:
            _TENANT.reset(tenant_tok)
        if reasons and resp.status == 200:
            # a partial result: still a 200, labelled
            resp.headers["X-GSKY-Degraded"] = ",".join(reasons)
            registry.count_degraded()
            collector.info["degraded"] = reasons
        if resp.status != CLIENT_GONE:
            collector.log(resp.status)
        with self._lock:
            for k, v in clock.spans.items():
                self.spans[k] += v
            self.spans["handle"] += time.perf_counter() - t0
        return resp

    def _answer(self, ns: str, q: Dict[str, str], path: str, host: str,
                clock: _Clock, body: Optional[bytes],
                req_headers: Mapping[str, str], tok: CancelToken,
                collector: MetricsCollector) -> Response:
        """`_handle`'s response, or the one its error maps to."""
        try:
            return self._handle(ns, q, path, host, clock, body,
                                req_headers, collector)
        except AdmissionShed as e:
            # shed, do not queue into latency collapse: a fast 503 with
            # Retry-After so that clients back off; with a fleet, the
            # least loaded node's name, so that a balancer can steer the
            # retry
            headers = {"Retry-After": str(e.retry_after)}
            if e.alt_node:
                headers["X-GSKY-Alt-Node"] = e.alt_node
            return _exception_response(
                OWSError(str(e), "ServerBusy", status=503), headers)
        except OWSError as e:
            return _exception_response(e)
        except BackendUnavailable as e:
            # a dependency (the MAS, the worker fleet, a device) stayed
            # down through its retries and failover
            return _exception_response(
                OWSError(f"backend unavailable: {e}", "ServerBusy",
                         status=503),
                {"Retry-After": str(max(1, int(e.retry_after)))})
        except TooManyFailures as e:
            # more granules lost than the degradation budget allows: a
            # refusal that says when to retry, 5 s as a backend's outage
            # does by default (the reference sends none, ROADMAP C.21)
            return _exception_response(
                OWSError(str(e), "ServerBusy", status=503),
                {"Retry-After": "5"})
        except (DeadlineExceeded, TimeoutError):
            # the render may still run: fire the token so that it
            # unwinds at its next check
            tok.cancel("deadline")
            return _exception_response(OWSError("request timed out",
                                                status=504))
        except RequestCancelled as e:
            if e.reason == "deadline":
                return _exception_response(OWSError("request timed out",
                                                    status=504))
            # the client went away: nobody to answer
            return Response(CLIENT_GONE, "")
        except NotImplementedError as e:
            return _exception_response(OWSError(
                str(e), "OperationNotSupported", status=501))
        except Exception as e:  # the last resort: an OGC 500
            return _exception_response(OWSError(
                f"internal error: {e}", status=500))

    def _handle(self, ns: str, q: Dict[str, str], path: str, host: str,
                clock: _Clock, body: Optional[bytes],
                req_headers: Mapping[str, str],
                collector: MetricsCollector) -> Response:
        cfg = self.watcher.get(ns)
        if cfg is None:
            raise OWSError(f"no configuration for namespace {ns!r}",
                           status=404)
        if "dap4.ce" in q:
            with self._admit("DAP4"):
                return self.serve_dap(cfg, q, clock)
        svc = infer_service(q)
        if svc == "WCS":
            return self.serve_wcs(path, cfg, q, host, clock, req_headers,
                                  collector)
        if svc == "WPS":
            return self.serve_wps(path, cfg, q, host, body)
        return self.serve_wms(path, cfg, q, host, clock, req_headers,
                              collector)

    # -- WMS ----------------------------------------------------------------

    def serve_wms(self, path: str, cfg: Config, q: Dict[str, str],
                  host: str, clock: _Clock,
                  req_headers: Optional[Mapping[str, str]],
                  collector: MetricsCollector) -> Response:
        p = parse_wms(q)
        req_name = p.request.lower()
        if req_name == "getcapabilities" or not req_name:
            self._ensure_layer_dates(cfg)
            return _xml(T.wms_capabilities(cfg, path, _host_of(host, cfg)))
        if req_name == "describelayer":
            layers = [cfg.layer(n) for n in p.layers]
            if any(l is None for l in layers):
                raise OWSError("layer not found", "LayerNotDefined")
            return _xml(T.wms_describe_layer(layers, path,
                                             _host_of(host, cfg)))
        if req_name == "getlegendgraphic":
            return self._legend(cfg, q)
        if req_name == "getmap":
            return self._getmap_gated(cfg, p, q, clock, req_headers,
                                      collector)
        if req_name == "getfeatureinfo":
            with self._admit("WMS"):
                return self._feature_info(cfg, p)
        raise OWSError(f"WMS request {p.request!r} not supported",
                       "OperationNotSupported")

    def _ensure_layer_dates(self, cfg: Config) -> None:
        """Fill empty date lists from the index, so that GetCapabilities
        advertises the time dimension of on-demand layers too.
        Advisory: a layer whose dates cannot be had is listed without
        them."""
        lays = [l for l in cfg.layers
                if not l.dates and l.data_source
                and not l.service_disabled("wms")]
        if not lays:
            return
        try:
            mas = self._mas(cfg)
        except OWSError:
            return
        for lay in lays:
            try:
                get_layer_dates(lay, mas)
            except Exception:  # per-layer resolution is advisory
                continue
            for s in lay.styles:
                s.dates = lay.dates
                s.effective_start_date = lay.effective_start_date
                s.effective_end_date = lay.effective_end_date

    def _resolve_layer(self, cfg: Config, name: str, styles: List[str],
                       service: str) -> Tuple[Layer, Layer]:
        lay = cfg.layer(name)
        if lay is None:
            raise OWSError(f"layer {name!r} not found", "LayerNotDefined")
        if lay.service_disabled(service):
            raise OWSError(f"{service} disabled for layer {name!r}",
                           "OperationNotSupported")
        style = lay
        for sname in styles:
            if sname:
                s = lay.style(sname)
                if s is None:
                    raise OWSError(f"style {sname!r} not defined",
                                   "StyleNotDefined")
                style = s
                break
        if not style.rgb_products and lay.styles:
            style = lay.styles[0]
        return lay, style

    @staticmethod
    def _tile_request(lay: Layer, style: Layer, p, width: int,
                      height: int, segments: int) -> GeoTileRequest:
        times = p.times
        start = end = None
        if times:
            start = times[0]
            end = times[-1] if len(times) > 1 else None
        elif lay.effective_end_date:
            start = parse_time(lay.effective_end_date)
        if lay.accum and lay.effective_start_date and start is not None:
            end = end or start
            start = parse_time(lay.effective_start_date)
        axes = []
        for ax in lay.axes_info:
            idx_sels = getattr(p, "axis_idx", {}).get(ax.name)
            if idx_sels:
                # DAP4 index selection [start:step:end]
                for (s, e, st, is_range, is_all) in idx_sels:
                    if is_all:
                        axes.append(AxisSelector(name=ax.name, idx_start=0,
                                                 aggregate=0))
                    elif not is_range:
                        axes.append(AxisSelector(name=ax.name, idx_start=s,
                                                 idx_end=s, aggregate=0))
                    else:
                        axes.append(AxisSelector(
                            name=ax.name, idx_start=s or 0, idx_end=e,
                            idx_step=st or 1, aggregate=0))
                continue
            val = p.axes.get(ax.name, ax.default)
            if isinstance(val, tuple):      # WCS subset=axis(lo,hi)
                lo, hi = val
                axes.append(AxisSelector(name=ax.name, start=lo,
                                         end=hi if hi is not None else lo))
            elif val:
                try:
                    v = float(val)
                except (TypeError, ValueError):
                    continue
                axes.append(AxisSelector(name=ax.name, start=v, end=v))
        mask = None
        m = style.mask or lay.mask
        if m:
            mask = MaskSpec(id=m.id, value=m.value, bit_tests=m.bit_tests,
                            data_source=m.data_source, inclusive=m.inclusive)
        # the layer's own collection wins: styles inherit their parent's
        # data_source at load time, and overview layers carry their own
        return GeoTileRequest(
            collection=lay.data_source or style.data_source,
            bands=style.rgb_products or lay.rgb_products,
            bbox=p.bbox, crs=p.crs, width=width, height=height,
            start_time=start, end_time=end, axes=axes, mask=mask,
            resample=style.resample or lay.resample,
            polygon_segments=segments,
            spatial_extent=tuple(lay.default_geo_bbox)
            if len(lay.default_geo_bbox) >= 4 else None,
            index_tile_x_size=lay.index_tile_x_size,
            index_tile_y_size=lay.index_tile_y_size,
            index_res_limit=lay.index_res_limit,
            grpc_tile_x_size=lay.grpc_tile_x_size,
            grpc_tile_y_size=lay.grpc_tile_y_size)

    def _getmap_gated(self, cfg: Config, p, q: Dict[str, str],
                      clock: _Clock,
                      req_headers: Optional[Mapping[str, str]],
                      collector: MetricsCollector) -> Response:
        """GetMap through the serving gateway.  A request complete
        enough to resolve (layer, bbox, crs, size) is keyed and noted
        for the prefetch planner; an incomplete one goes to `_getmap`
        for its errors; an animation is never cached."""
        key = meta = None
        if p.layers and p.bbox is not None and p.crs is not None \
                and p.width > 0 and p.height > 0:
            self._note_prefetch(cfg, p)
        is_anim = anim_enabled() and len(p.times) > 1 \
            and p.format.lower() in _ANIM_FORMATS
        if self.gateway is not None and p.layers and p.bbox is not None \
                and p.crs is not None and p.width > 0 and p.height > 0 \
                and not is_anim:
            key, meta = self._response_key(cfg, "map", p.layers[0], "wms",
                                           p, q)
        return self._serve_gated(
            key, meta, req_headers,
            lambda: self._getmap(cfg, p, clock, collector), "WMS",
            collector)

    def _note_prefetch(self, cfg: Config, p) -> None:
        """Feed one resolvable GetMap key to the prefetch planner,
        registering the warm callback on first use.  Never raises and
        never blocks: the warming runs on the planner's thread."""
        try:
            if not ingest_enabled():
                return
            planner = default_planner()
            if planner.warm_fn is None:
                planner.warm_fn = self._prefetch_warm
            b = p.bbox
            # the whole TIME selection is in the key: a range must warm
            # the granules the request will mosaic
            t = tuple(p.times) if p.times else None
            planner.observe(
                f"{cfg.service_config.namespace}\x1f{p.layers[0]}",
                (b.xmin, b.ymin, b.xmax, b.ymax), p.width, p.height,
                p.crs.name(), t)
        except Exception:  # prefetch observation is advisory
            pass

    def _prefetch_warm(self, layer_key: str, qb, width: int, height: int,
                       crs_s: str, time_s) -> int:
        """The planner's warm callback: resolve a predicted key as a
        GetMap would (layer, tile request, index query), load its
        distinct scenes into the scene cache and stage the pages the
        tile will read.  Returns the bytes warmed (the planner's budget
        currency): the scenes it loaded.  A scene already resident costs
        nothing (the reference charges its size: at Landsat size one
        warm of four resident scenes spent four minutes of the default
        budget, and the planner declined every later prediction,
        ROADMAP C.24)."""
        ns, _, lname = layer_key.partition("\x1f")
        cfg = self.watcher.get(ns)
        if cfg is None:
            return 0
        lay, style = self._resolve_layer(cfg, lname, [], "wms")
        times = [] if time_s is None else \
            list(time_s) if isinstance(time_s, tuple) else [time_s]
        p = _PrefetchParams(BBox(*qb), parse_crs(crs_s), times)
        req = self._tile_request(lay, style, p, int(width), int(height),
                                 lay.wms_polygon_segments)
        pipe = self._pipeline(cfg)
        if pipe.remote is not None:
            return 0            # the workers hold the scenes
        dst_gt = req.dst_gt()
        warmed = 0
        seen = set()
        for g in pipe.index(req):
            check_cancel("prefetch")
            k = (g.path, g.band, g.var_name, g.time_index)
            if k in seen:
                continue
            seen.add(k)
            resident = pipe.executor.scene_resident(
                g, dst_gt, req.crs, req.height, req.width)
            sc = pipe.executor.warm_scene(g, dst_gt, req.crs, req.height,
                                          req.width)
            if sc is not None:
                if not resident:
                    warmed += sc.dev.numel() * sc.dev.element_size()
                self._prewarm_pages(pipe.executor.pool, sc, req)
        return warmed

    @staticmethod
    def _prewarm_pages(pool, sc, req) -> None:
        """Stage the pages the request's footprint reads (best-effort:
        a pool that declines is fine, the request stages as usual)."""
        try:
            src_bbox = transform_bbox(req.bbox, req.crs, sc.crs)
            win = _pixel_window(sc.gt, src_bbox, sc.width, sc.height, 3)
            if win is None:
                return
            c0, r0, w, h = win
            pr, pc = page_shape()
            i0, i1 = r0 // pr, (r0 + h - 1) // pr
            j0, j1 = c0 // pc, (c0 + w - 1) // pc
            if (i1 - i0 + 1) * (j1 - j0 + 1) > 64:
                return      # a footprint that large is no tile pan
            pool.prewarm(sc.dev, sc.serial, i0, i1, j0, j1)
        except Exception:  # a miss stages on demand
            pass

    def _getmap(self, cfg: Config, p, clock: _Clock,
                collector: MetricsCollector) -> Response:
        if not p.layers:
            raise OWSError("no layers requested", "LayerNotDefined")
        if p.bbox is None or p.crs is None:
            raise OWSError("bbox/crs required", "MissingParameterValue")
        lay, style = self._resolve_layer(cfg, p.layers[0], p.styles, "wms")
        if p.width <= 0 or p.height <= 0:
            raise OWSError("width/height required", "MissingParameterValue")
        if p.width > lay.wms_max_width or p.height > lay.wms_max_height:
            raise OWSError(
                f"requested size exceeds {lay.wms_max_width}x"
                f"{lay.wms_max_height}", "InvalidParameterValue")
        level = _png_level(lay, style)

        # zoom limit: an overview layer, or the "zoom in" placeholder
        source = lay
        if lay.zoom_limit > 0:
            res = pixel_resolution(p.bbox, p.crs, p.width, p.height)
            if res > lay.zoom_limit:
                use = _best_overview(lay, res)
                if use is None:
                    clock.mark("parse")
                    png = _placeholder_tile(lay.nodata_legend_path,
                                            p.width, p.height, level)
                    clock.mark("encode")
                    return _png(png)
                source = use  # the style still scales and colours it

        # brownout: under memory pressure degrade quality before
        # availability: a coarser overview (fewer scenes decoded, fewer
        # pages staged), the cheapest PNG effort (`_png_level`),
        # labelled; a degraded response is never cached
        bl = brownout_level()
        if bl:
            mark_degraded("brownout")
            if source is lay and lay.overviews:
                res = pixel_resolution(p.bbox, p.crs, p.width, p.height)
                use = _best_overview(lay, res * (2.0 ** bl))
                if use is not None:
                    source = use

        fmt = p.format.lower()
        if len(p.times) > 1 and fmt in _ANIM_FORMATS and anim_enabled() \
                and not lay.input_layers:
            return self._getmap_animation(cfg, p, lay, source, style, clock,
                                          collector)
        req = self._tile_request(source, style, p, p.width, p.height,
                                 lay.wms_polygon_segments)
        n_exprs = len(req.band_exprs.expr_names)
        pipe = self._pipeline(cfg)
        auto = scale_params_auto(style.offset_value, style.scale_value,
                                 style.clip_value)
        clock.mark("parse")
        t0 = time.time()
        # one budget for the render: every stage and every downstream
        # timeout draws from what is left of wms_timeout
        with deadline_scope(Deadline(lay.wms_timeout)) as dl:
            scaled, rgba, rec = _bounded(dl, self._render_tile, pipe, req,
                                         lay, style, n_exprs, auto)
        info = collector.info
        info["indexer"]["num_granules"] = rec["granules"]
        info["indexer"]["num_files"] = rec["files"]
        if rec["device_s"] is not None:
            info["device"]["duration"] = int(rec["device_s"] * 1e9)
            info["device"]["platform"] = self.device.type
        spans = rec["spans"]
        if rgba is not None and fmt not in _JPEG_FORMATS:
            clock.mark("render")
            info["rpc"]["duration"] = int((time.time() - t0) * 1e9)
            png = self._encode_tile(encode_rgba_png, rgba,
                                    compress_level=level, spans=spans)
            clock.mark("encode")
            return _png(png)
        if scaled is None:
            clock.mark("render")
            png = empty_tile_png(p.width, p.height, compress_level=level)
            clock.mark("encode")
            return _png(png)
        clock.mark("render")
        info["rpc"]["duration"] = int((time.time() - t0) * 1e9)
        if fmt in _JPEG_FORMATS:
            body = self._encode_tile(encode_jpeg, scaled[:3], spans=spans)
            clock.mark("encode")
            return Response(200, "image/jpeg", body)
        palette = None
        if len(scaled) == 1 and (style.palette or lay.palette):
            spec = style.palette or lay.palette
            palette = with_nodata_entry(
                gradient_palette(spec.colours, spec.interpolate))
        png = self._encode_tile(encode_png, scaled, palette,
                                compress_level=level, spans=spans)
        clock.mark("encode")
        return _png(png)

    def _encode_tile(self, fn, *args, spans: Optional[Dict] = None, **kw):
        """``fn(*args, **kw)``, an encode: with the staged tile path on,
        on the sized encode pool (`io.png.encode_pooled`), the staged
        render's stage spans folded into the ``/debug`` aggregates once
        it is done; under ``GSKY_TILE_PIPELINE=0`` inline in the
        request's thread, as the reference's escape hatch encodes.  The
        same bytes either way."""
        if not tile_pipeline_enabled():
            with obs.span("encode", inline=True):
                return fn(*args, **kw)
        try:
            return encode_pooled(fn, *args, spans=spans, **kw)
        finally:
            if spans is not None:
                self.metrics.record_tile(spans)

    def _render_tile(self, pipe: TilePipeline, req: GeoTileRequest,
                     lay: Layer, style: Layer, n_exprs: int, auto: bool):
        """A GetMap's render, through the fused route when it serves the
        request, else the modular route: (byte planes, rgba, rec), rgba
        the (H, W, 4) tile of the RGBA rung or None, byte planes None
        for a tile with no data.  ``rec``: the record's granule and file
        counts, ``device_s`` the fused route's dispatch plus readback
        (None on the modular route), ``spans`` the staged path's stage
        spans (else None)."""
        scaled = rgba = None
        stats: Dict[str, int] = {}
        rec = {"device_s": None, "spans": None}
        if not lay.input_layers and 1 <= n_exprs <= 4:
            # the fused route: warp, mosaic and byte scale in one
            # dispatch, one readback
            sp = (style.offset_value, style.scale_value, style.clip_value,
                  style.colour_scale, auto)
            staged = tile_pipeline_enabled()
            if staged:
                spans: Dict = {}
                made = render_staged(pipe, req, n_exprs, *sp, stats, spans)
                if made is not None:
                    rec["spans"] = spans
                    rec["device_s"] = spans.get("dispatch_s", 0.0) \
                        + spans.get("readback_s", 0.0)
                    spans["granules"] = stats.get("granules", 0)
            elif n_exprs == 1:
                sb = pipe.render_composite_byte(req, *sp, stats=stats)
                made = None if sb is None else ("composite", sb)
            elif n_exprs == 3:
                made = self._render_rgb(pipe, req, style, auto, stats)
            else:
                sb = pipe.render_bands_byte(req, *sp, stats=stats)
                made = None if sb is None else ("planes", sb)
            if made is not None:
                td = time.perf_counter()
                # the staged path read its tile back under the device
                # guard; the serial ladder's one readback is guarded here
                kind, arr = made[0], made[1] if staged else \
                    device_guard.guarded_readback(
                        "tile.readback", lambda dev=made[1]: _host(dev))
                if not staged:
                    # the serial ladder's one readback
                    rec["device_s"] = time.perf_counter() - td
                if kind == "rgba":
                    rgba = arr                      # (H, W, 4)
                    scaled = [arr[..., 0], arr[..., 1], arr[..., 2]]
                else:
                    scaled = [arr] if arr.ndim == 2 else list(arr)
        if scaled is not None:
            rec.update(granules=stats.get("granules", 0),
                       files=stats.get("files", 0))
            return scaled, rgba, rec
        res = _render_with_fusion(pipe, req, lay)
        rec.update(granules=res.granule_count, files=res.file_count)
        bands = [res.data[n] for n in res.namespaces if n in res.data]
        valids = [res.valid[n] for n in res.namespaces if n in res.valid]
        if not bands:
            return None, None, rec
        return [device_guard.guarded_readback(
                    "tile.readback",
                    lambda b=b, v=v: scale_to_byte(
                        b, v, offset=style.offset_value,
                        scale=style.scale_value, clip=style.clip_value,
                        colour_scale=style.colour_scale,
                        auto=auto).cpu().numpy())
                for b, v in zip(bands[:4], valids[:4])], None, rec

    def _getmap_animation(self, cfg: Config, p, lay: Layer, source: Layer,
                          style: Layer, clock: _Clock,
                          collector: MetricsCollector) -> Response:
        """A TIME animation: one index pass, the frames as lanes of one
        wave (or, for a layer the fused route does not serve, each on
        its own through the modular route), one APNG."""
        times = list(p.times)
        maxf = _anim_max_frames()
        if maxf > 0 and len(times) > maxf:
            times = times[:maxf]
        bl = brownout_level()
        if bl:
            # quality before availability: every second frame (fourth
            # when critical), frame 0 kept; `_getmap` set the label
            times = times[::2] if bl == 1 else times[::4]
        req = self._tile_request(source, style, p, p.width, p.height,
                                 lay.wms_polygon_segments)
        pipe = self._pipeline(cfg)
        auto = scale_params_auto(style.offset_value, style.scale_value,
                                 style.clip_value)
        clock.mark("parse")
        t0 = time.time()
        w0 = _wave_dispatches()
        stats: Dict[str, int] = {}
        # one budget for the sequence, wms_timeout per frame
        with deadline_scope(Deadline(lay.wms_timeout
                                     * max(1, len(times)))) as dl:
            made = _bounded(dl, pipe.animation_prep, req, times, stats)
            if made is not None:
                planes = _bounded(dl, self._anim_frames_wave, pipe, req,
                                  times, made, style, auto)
            else:
                planes = _bounded(dl, self._anim_frames_serial, pipe, req,
                                  times, lay, style, auto)
        clock.mark("render")
        info = collector.info
        info["indexer"]["num_granules"] = stats.get("granules", 0)
        info["indexer"]["num_files"] = stats.get("files", 0)
        info["device"]["platform"] = self.device.type
        palette = None
        if all(len(pl) == 1 for pl in planes) \
                and (style.palette or lay.palette):
            spec = style.palette or lay.palette
            palette = with_nodata_entry(
                gradient_palette(spec.colours, spec.interpolate))
        level = _png_level(lay, style)
        pngs = [self._encode_tile(encode_png, pl, palette,
                                  compress_level=level) for pl in planes]
        # dispatch amortisation, telemetry only: concurrent requests
        # inflate the delta
        wave_n = max(1, _wave_dispatches() - w0)
        info["rpc"]["duration"] = int((time.time() - t0) * 1e9)
        asm = ApngAssembler(len(pngs), delay_ms=_anim_delay_ms())
        body = b"".join(asm.frame(b_) for b_ in pngs) + asm.trailer()
        obs_metrics.record_anim_sequence(
            len(pngs), wave_n, degraded=bool(degraded_reasons()))
        clock.mark("encode")
        headers = {"X-Gsky-Anim-Frames": str(len(planes))}
        if p.format.lower() == "video/mp4":
            # no mp4 muxer: the same APNG, labelled as such
            headers["X-Gsky-Anim-Container"] = "apng-stub"
        return Response(200, "image/apng", body, headers)

    @staticmethod
    def _render_rgb(pipe: TilePipeline, req: GeoTileRequest, style: Layer,
                    auto: bool, stats: Dict[str, int]):
        """The serial RGB ladder over one index pass: ("rgba", (H, W,
        4)), ("planes", (3, H, W)) or None."""
        return pipe.render_rgb_auto(req, style.offset_value,
                                    style.scale_value, style.clip_value,
                                    style.colour_scale, auto, stats)

    @staticmethod
    def _anim_frames_wave(pipe: TilePipeline, req: GeoTileRequest, times,
                          made, style: Layer, auto: bool):
        """Each frame's fused dispatch on its own granule set, sent from
        ``GSKY_ANIM_WORKERS`` threads so that the frames meet in one
        wave.  One [byte plane] list per frame; a frame with no granule,
        or whose scenes the fused route does not serve, is all nodata."""
        def one(i):
            fr = dataclasses.replace(req, start_time=times[i],
                                     end_time=None)
            out = None
            if made[i] is not None:
                out = pipe.composite_dispatch(
                    fr, made[i], style.offset_value, style.scale_value,
                    style.clip_value, style.colour_scale, auto)
                if out is None:
                    out = pipe.render_composite_byte(
                        fr, style.offset_value, style.scale_value,
                        style.clip_value, style.colour_scale, auto)
            if out is None:
                return np.full((req.height, req.width), 255, np.uint8)
            return device_guard.guarded_readback(
                "anim.readback", lambda: _host(out))

        n = len(times)
        with cf.ThreadPoolExecutor(max_workers=min(n, _anim_workers()),
                                   thread_name_prefix="gsky-anim") as ex:
            # each frame in a copy of the request's context
            futs = [ex.submit(contextvars.copy_context().run, one, i)
                    for i in range(n)]
            return [[f.result()] for f in futs]

    @staticmethod
    def _anim_frames_serial(pipe: TilePipeline, req: GeoTileRequest, times,
                            lay: Layer, style: Layer, auto: bool):
        """Each frame through the modular route on its own index pass."""
        frames = []
        for t in times:
            fr = dataclasses.replace(req, start_time=t, end_time=None)
            res = _render_with_fusion(pipe, fr, lay)
            bands = [res.data[n] for n in res.namespaces if n in res.data]
            valids = [res.valid[n] for n in res.namespaces
                      if n in res.valid]
            if not bands:
                frames.append([np.full((fr.height, fr.width), 255,
                                       np.uint8)])
                continue
            frames.append([device_guard.guarded_readback(
                "anim.readback", lambda b=b, v=v: scale_to_byte(
                    b, v, offset=style.offset_value,
                    scale=style.scale_value, clip=style.clip_value,
                    colour_scale=style.colour_scale,
                    auto=auto).cpu().numpy())
                for b, v in zip(bands[:4], valids[:4])])
        return frames

    def _feature_info(self, cfg: Config, p) -> Response:
        """GetFeatureInfo: the values at pixel (i, j) of the request's
        render (``feature_info_bands`` when the layer names them), "n/a"
        where invalid, and the newest ``feature_info_max_dates`` of the
        contributing dates, as a GeoJSON FeatureCollection."""
        if not p.layers:
            raise OWSError("no layers requested", "LayerNotDefined")
        lay, style = self._resolve_layer(cfg, p.layers[0], p.styles, "wms")
        if p.bbox is None or p.x is None or p.y is None:
            raise OWSError("bbox/i/j required", "MissingParameterValue")
        req = self._tile_request(lay, style, p, p.width or 256,
                                 p.height or 256, lay.wms_polygon_segments)
        req = dataclasses.replace(
            req, bands=list(lay.feature_info_bands or req.bands),
            _exprs=None)
        if not (0 <= p.x < req.width and 0 <= p.y < req.height):
            raise OWSError(f"i/j ({p.x},{p.y}) outside "
                           f"{req.width}x{req.height}", "InvalidPoint")
        with deadline_scope(Deadline(lay.wms_timeout)) as dl:
            fi = _bounded(dl, get_feature_info, self._pipeline(cfg), req,
                          p.x, p.y)
        props = {k: (v if v is not None else "n/a")
                 for k, v in fi.values.items()}
        if lay.feature_info_max_dates != 0:
            props["available_dates"] = fi.dates[-abs(
                lay.feature_info_max_dates):]
        doc = {"type": "FeatureCollection", "features": [{
            "type": "Feature", "properties": props, "geometry": None}]}
        return Response(200, "application/json", json.dumps(doc).encode())

    def _legend(self, cfg: Config, q: Dict[str, str]) -> Response:
        """GetLegendGraphic: the style's or the layer's legend file, else
        its palette as a ``legend_height`` x ``legend_width`` ramp, top
        255 to bottom 0; 404 without either."""
        name = q.get("layer") or q.get("layers", "")
        lay = cfg.layer(name)
        if lay is None:
            raise OWSError(f"layer {name!r} not found", "LayerNotDefined")
        style = lay.style(q.get("style", "") or q.get("styles", "")) or lay
        path = style.legend_path or lay.legend_path
        if path and os.path.exists(path):
            with open(path, "rb") as fp:
                return _png(fp.read())
        spec = style.palette or lay.palette
        if spec is None:
            raise OWSError("no legend available", status=404)
        lut = gradient_palette(spec.colours, spec.interpolate)
        h, w = style.legend_height, style.legend_width
        img = np.zeros((h, w, 4), np.uint8)
        ramp = np.linspace(254, 0, h).astype(np.uint8)
        img[:] = lut[ramp][:, None, :]
        return _png(encode_rgba_png(img,
                                    compress_level=_png_level(lay, style)))

    # -- DAP4 -------------------------------------------------------------

    def serve_dap(self, cfg: Config, q: Dict[str, str],
                  clock: _Clock) -> Response:
        """A ``dap4.ce`` constraint expression: a GetCoverage with DAP4
        output, streamed when the coverage is multi-tile."""
        try:
            ce = dap4.parse_constraint_expr(q["dap4.ce"])
        except ValueError as e:
            raise OWSError(f"Failed to parse dap4.ce: {e}",
                           "InvalidParameterValue")
        return self._getcoverage(cfg, dap4.dap_to_wcs(ce, cfg), clock,
                                 dap_stream=True)

    # -- WCS ----------------------------------------------------------------

    def serve_wcs(self, path: str, cfg: Config, q: Dict[str, str],
                  host: str, clock: _Clock,
                  req_headers: Optional[Mapping[str, str]],
                  collector: MetricsCollector) -> Response:
        p = parse_wcs(q)
        req_name = p.request.lower()
        if req_name == "getcapabilities" or not req_name:
            return _xml(T.wcs_capabilities(cfg, path, _host_of(host, cfg)))
        if req_name == "describecoverage":
            layers = [cfg.layer(n) for n in p.coverages] if p.coverages \
                else [l for l in cfg.layers if not l.service_disabled("wcs")]
            if any(l is None for l in layers):
                raise OWSError("coverage not found", "CoverageNotDefined")
            return _xml(T.wcs_describe_coverage(layers,
                                                _host_of(host, cfg)))
        if req_name == "getcoverage":
            return self._getcoverage_gated(path, cfg, p, q, clock,
                                           req_headers, collector,
                                           is_shard=bool(q.get("wshard")))
        raise OWSError(f"WCS request {p.request!r} not supported",
                       "OperationNotSupported")

    def _getcoverage_gated(self, path: str, cfg: Config, p,
                           q: Dict[str, str], clock: _Clock,
                           req_headers: Optional[Mapping[str, str]],
                           collector: MetricsCollector,
                           is_shard: bool) -> Response:
        """GetCoverage through the serving gateway.  A shard's request
        (``wshard=1``) and an auto-sized one (width or height 0) are not
        keyed; a body over the per-entry cap is not kept."""
        key = meta = None
        if self.gateway is not None and not is_shard and p.coverages \
                and p.bbox is not None and p.crs is not None \
                and p.width > 0 and p.height > 0:
            key, meta = self._response_key(cfg, "cov", p.coverages[0],
                                           "wcs", p, q)
        return self._serve_gated(
            key, meta, req_headers,
            lambda: self._getcoverage(cfg, p, clock, q=q, path=path,
                                      is_shard=is_shard), "WCS",
            collector)

    def _getcoverage(self, cfg: Config, p, clock: _Clock,
                     dap_stream: bool = False,
                     q: Optional[Dict[str, str]] = None,
                     path: str = "/ows",
                     is_shard: bool = False) -> Response:
        """A GetCoverage's coverage.  ``q`` (the request's query) and
        ``path`` let a GetCoverage over several ``ows_cluster_nodes``
        send its peers their bands; ``is_shard`` (``wshard=1``) is a
        peer's own band, which is not cut again."""
        if not p.coverages:
            raise OWSError("no coverage requested", "CoverageNotDefined")
        lay, style = self._resolve_layer(cfg, p.coverages[0], p.styles,
                                         "wcs")
        if p.bbox is None or p.crs is None:
            raise OWSError("bbox/crs required", "MissingParameterValue")
        width, height = p.width, p.height
        pipe = self._pipeline(cfg)
        base_req = self._tile_request(lay, style, p, 256, 256,
                                      lay.wcs_polygon_segments)
        if p.bands_override:
            # the variables a DAP4 constraint names
            base_req = dataclasses.replace(
                base_req, bands=list(p.bands_override), _exprs=None)
        if width <= 0 or height <= 0:
            width, height = compute_reprojection_extent(pipe.mas, base_req)
            if width <= 0 or height <= 0:
                raise OWSError("no data for requested extent",
                               "CoverageNotDefined")
        if width > lay.wcs_max_width or height > lay.wcs_max_height:
            raise OWSError(
                f"requested size {width}x{height} exceeds "
                f"{lay.wcs_max_width}x{lay.wcs_max_height}",
                "InvalidParameterValue")
        fmt = p.format.lower()
        if fmt not in _WCS_FORMATS:
            raise OWSError(f"format {p.format!r} not supported",
                           "InvalidFormat")

        tiles = split_bbox(p.bbox, width, height, lay.wcs_max_tile_width,
                           lay.wcs_max_tile_height)
        # one budget for the whole export
        dl = Deadline(lay.wcs_timeout * max(1, len(tiles)))
        ns_names = list(base_req.band_exprs.expr_names)
        # a very large GeoTIFF streams its tiles to disk instead of
        # building the whole coverage in RAM
        stream_tif = (fmt in _TIFF_FORMATS
                      and width * height > WCS_STREAM_PIXELS
                      and lay.wcs_max_tile_width % 256 == 0
                      and lay.wcs_max_tile_height % 256 == 0)
        # a multi-tile DAP4 coverage goes through the engine into a disk
        # spool, and its body streams from there
        stream_dap = (fmt == "dap4" and dap_stream
                      and dap4.dap_stream_enabled() and len(tiles) > 1
                      and not lay.input_layers
                      and export_pipeline_enabled())
        in_ram = not (stream_tif or stream_dap)
        out = {n: np.zeros((height, width), np.float32)
               for n in ns_names} if in_ram else {}
        valid = {n: np.zeros((height, width), bool)
                 for n in ns_names} if in_ram else {}
        nodata = -9999.0
        gt = GeoTransform.from_bbox(p.bbox, width, height)
        stamp = dt.datetime.now(dt.timezone.utc).strftime("%Y%m%d%H%M%S")
        writer = stream_path = None
        if stream_tif:
            stream_path = os.path.join(self.temp_dir,
                                       f"wcs_{stamp}_{id(p)}.tif")
            writer = GeoTIFFWriter(stream_path, len(ns_names), height,
                                   width, np.float32, gt, p.crs,
                                   nodata=nodata)
        elif stream_dap:
            stream_path = os.path.join(self.temp_dir,
                                       f"dap_{stamp}_{id(p)}.raw")
            writer = dap4.CoverageSpool(stream_path, len(ns_names),
                                        height, width)
        clock.mark("parse")

        def render_tile(tb, ox, oy, tw, th):
            req = dataclasses.replace(
                base_req, bbox=tb, width=tw, height=th,
                polygon_segments=lay.wcs_polygon_segments)
            res = _render_with_fusion(pipe, req, lay)
            if writer is not None:
                block = np.full((len(ns_names), th, tw), nodata,
                                np.float32)
                for i, n in enumerate(ns_names):
                    if n in res.data:
                        # the float pull, under the device guard
                        d = device_guard.guarded_readback(
                            "export.readback",
                            lambda n=n: _host(res.data[n]))
                        block[i] = np.where(_host(res.valid[n]), d, nodata)
                writer.write_region(ox, oy, block)
                return
            for n in ns_names:
                if n in res.data:
                    out[n][oy:oy + th, ox:ox + tw] = \
                        device_guard.guarded_readback(
                            "export.readback",
                            lambda n=n: _host(res.data[n]))
                    valid[n][oy:oy + th, ox:ox + tw] = _host(res.valid[n])

        # the cluster's scale-out (`ows.go:835-872,930-995,1094-1150`):
        # bands of tile rows, band 0 here, each peer a wshard=1
        # GetCoverage of its band (which is not cut again)
        local_tiles, remote_jobs = list(tiles), []
        nodes = cfg.service_config.ows_cluster_nodes
        if q is not None and not is_shard and not stream_tif \
                and len(nodes) > 1 and len(tiles) >= 2 * len(nodes):
            local_tiles, remote_jobs = _cluster_bands(tiles, nodes, p.bbox,
                                                      height)

        def fetch_shard(node, tiles_in, bb, y0px, y1px):
            """A peer's band into the coverage; on any failure the band
            renders here, and the request is labelled."""
            try:
                self._fetch_shard(node, path, q, bb, width, y0px, y1px,
                                  ns_names, nodata, out, valid,
                                  dl.clamp(lay.wcs_timeout
                                           * max(1, len(tiles_in))))
            except Exception as e:
                log.warning("WCS shard via %s failed (%s); rendering its "
                            "band locally", node, e)
                mark_degraded("shard-fallback")
                errs = []
                for t in tiles_in:
                    check_cancel("export")
                    try:
                        render_tile(*t)
                    except Exception as te:
                        errs.append(te)
                if errs:
                    # a failed fallback tile leaves its hole; the rest
                    # of the coverage still merges
                    log.warning("%d/%d local-fallback tiles failed after "
                                "shard %s failure (first: %s)", len(errs),
                                len(tiles_in), node, errs[0])

        # a multi-tile export of a plain layer goes through the staged
        # engine; a single tile, a fusion layer, or GSKY_EXPORT_PIPELINE=0
        # renders tile by tile
        engine = None
        if len(local_tiles) > 1 and not lay.input_layers \
                and export_pipeline_enabled():
            engine = ExportPipeline(
                pipe, dataclasses.replace(
                    base_req, polygon_segments=lay.wcs_polygon_segments),
                local_tiles, ns_names, p.bbox, width, height,
                nodata=nodata, writer=writer, out=out, valid=valid)

        def render_local():
            if engine is None:
                for t in local_tiles:
                    check_cancel("export")
                    render_tile(*t)
                return None
            return engine.run()

        def render_all():
            if not remote_jobs:
                return render_local()
            # the peers' bands on threads of their own, in the request's
            # context (its deadline, cancel token and degraded marks)
            with cf.ThreadPoolExecutor(
                    len(remote_jobs),
                    thread_name_prefix="gsky-wcs-shard") as shard_pool:
                futs = [shard_pool.submit(
                    contextvars.copy_context().run, fetch_shard, *job)
                    for job in remote_jobs]
                try:
                    stats = render_local()
                finally:
                    for f in futs:
                        f.result()
            return stats

        try:
            with deadline_scope(dl):
                stats = _bounded(dl, render_all)
            if stats is not None:
                with self._lock:
                    self.last_export = stats
                self.metrics.record_export(stats)
        except BaseException:
            # close and unlink a partial stream file or spool
            if engine is not None:
                engine.cancel()
            if writer is not None:
                try:
                    writer.close()
                except Exception:  # a writer the engine already closed
                    pass
                try:
                    os.remove(stream_path)
                except OSError:
                    pass
            raise
        clock.mark("render")
        if stream_dap:
            return Response(200, dap4.CONTENT_TYPE,
                            chunks=_spool_chunks(ns_names, writer))
        if writer is not None:
            writer.close()
            clock.mark("encode")
            return Response(200, "image/geotiff", path=writer.path,
                            headers=_attachment(f"{lay.name}_{stamp}.tif"))
        # nodata in place: the render is done with the canvases
        arrays = {}
        for n in ns_names:
            a = out[n]
            a[~valid[n]] = nodata
            arrays[n] = a
        if fmt == "dap4":
            body = dap4.encode_dap4(ns_names, arrays)
            clock.mark("encode")
            return Response(200, dap4.CONTENT_TYPE, body)
        ext, ctype = (".nc", "application/x-netcdf") \
            if fmt in _NETCDF_FORMATS else (".tif", "image/geotiff")
        resp = Response(200, ctype,
                        headers=_attachment(f"{lay.name}_{stamp}{ext}"),
                        path=os.path.join(self.temp_dir,
                                          f"wcs_{stamp}_{id(p)}{ext}"))
        try:
            if fmt in _NETCDF_FORMATS:
                xs = gt.x0 + (np.arange(width) + 0.5) * gt.dx
                ys = gt.y0 + (np.arange(height) + 0.5) * gt.dy
                write_netcdf3(resp.path, arrays, xs, ys, p.crs, None, nodata)
            else:
                write_geotiff(resp.path,
                              np.stack([arrays[n] for n in ns_names]), gt,
                              p.crs, nodata)
        except BaseException:
            resp.close()            # unlinks the partial file
            raise
        if os.path.getsize(resp.path) <= _MAX_BODY_BYTES:
            resp.read()
        clock.mark("encode")
        return resp

    def _fetch_shard(self, node: str, path: str, q: Dict[str, str],
                     bb: BBox, width: int, y0px: int, y1px: int,
                     ns_names: List[str], nodata: float,
                     out: Dict[str, np.ndarray],
                     valid: Dict[str, np.ndarray],
                     timeout: float) -> None:
        """One peer's band: a ``wshard=1`` GetCoverage of rows
        [y0px, y1px) as GeoTIFF over ``http.client`` (``timeout``: what
        the request's deadline leaves), merged into ``out`` and
        ``valid``.  Raises on any failure."""
        params = {k: str(v) for k, v in q.items()}
        params.update({
            "service": "WCS", "request": "GetCoverage",
            "bbox": f"{bb.xmin},{bb.ymin},{bb.xmax},{bb.ymax}",
            "width": str(width), "height": str(y1px - y0px),
            "format": "geotiff", "wshard": "1"})
        u = urlsplit(node if "://" in node else f"http://{node}")
        conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                          timeout=max(timeout, 0.01))
        try:
            conn.request("GET", u.path.rstrip("/") + path + "?"
                         + urlencode(params))
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"shard node {node}: HTTP {resp.status}")
        fd, spath = tempfile.mkstemp(prefix="shard_", suffix=".tif",
                                     dir=self.temp_dir)
        try:
            with os.fdopen(fd, "wb") as fp:
                fp.write(body)
            with GeoTIFF(spath) as tif:
                bands = [np.asarray(tif.read(bi + 1), np.float32)
                         for bi in range(len(ns_names))]
        finally:
            os.remove(spath)
        for n, a in zip(ns_names, bands):
            out[n][y0px:y1px, :] = a
            valid[n][y0px:y1px, :] = a != nodata

    # -- WPS ----------------------------------------------------------------

    def serve_wps(self, path: str, cfg: Config, q: Dict[str, str],
                  host: str, body: Optional[bytes] = None) -> Response:
        p = parse_wps(q, body or None)
        req_name = (p.request or "").lower()
        if req_name == "getcapabilities" or not req_name:
            return _xml(T.wps_capabilities(cfg, path, _host_of(host, cfg)))
        if req_name == "describeprocess":
            proc = cfg.process(p.identifier)
            if proc is None:
                raise OWSError(f"process {p.identifier!r} not found",
                               "InvalidParameterValue")
            return _xml(T.wps_describe_process(proc))
        if req_name != "execute":
            raise OWSError(f"WPS request {p.request!r} not supported",
                           "OperationNotSupported")
        with self._admit("WPS"):
            return self._wps_execute(cfg, p)

    def _wps_execute(self, cfg: Config, p) -> Response:
        proc = cfg.process(p.identifier)
        if proc is None:
            raise OWSError(f"process {p.identifier!r} not found",
                           "InvalidParameterValue")
        if not p.geometry_json:
            raise OWSError("geometry input required",
                           "MissingParameterValue")
        try:
            g = geom.from_geojson(p.geometry_json)
        except (ValueError, KeyError) as e:
            raise OWSError(f"invalid GeoJSON geometry: {e}")
        if g.kind not in ("Point", "Polygon", "MultiPolygon"):
            raise OWSError(
                f"geometry type {g.kind} not supported; use Point/Polygon/"
                f"MultiPolygon")
        if proc.max_area > 0 and g.area() > proc.max_area:
            raise OWSError(
                f"geometry area exceeds process limit {proc.max_area}")
        csv_blocks = []
        for src in proc.data_sources:
            vrt_xml = ""
            if src.vrt_url:
                # drill through a VRT: load the registered template
                # (`ows.go:1389-1406`)
                vp = src.vrt_url if os.path.isabs(src.vrt_url) \
                    else os.path.join(cfg.base_dir, src.vrt_url)
                try:
                    with open(vp) as fp:
                        vrt_xml = fp.read()
                except OSError as e:
                    raise OWSError(f"VRT template {src.vrt_url!r} "
                                   f"unreadable: {e}")
            dreq = GeoDrillRequest(
                collection=src.data_source, bands=src.rgb_products,
                geometry_wkt=g.to_wkt(),
                start_time=p.start_time, end_time=p.end_time,
                deciles=proc.deciles, approx=proc.approx,
                band_strides=src.band_strides,
                pixel_count="pixel_count" in proc.drill_algorithm,
                vrt_url=src.vrt_url, vrt_xml=vrt_xml,
                mask_namespaces=[src.mask.id] if src.mask else (),
                index_tile_x_size=src.index_tile_x_size,
                index_tile_y_size=src.index_tile_y_size)
            dp = DrillPipeline(self._mas(cfg), device=self.device)
            with deadline_scope(Deadline(src.wcs_timeout or 30)) as ddl:
                res = _bounded(ddl, dp.process_split, dreq, proc.year_step)
            csv_blocks.append(drill_csv(res, list(res.values)))
        return _xml(T.wps_execute_response(p.identifier, csv_blocks))

    # -- observability ------------------------------------------------------

    def _metrics(self) -> Response:
        return Response(200, "text/plain; charset=utf-8",
                        obs.render_metrics().encode(),
                        {"X-Prometheus-Exposition": "0.0.4"})

    def _debug(self) -> Response:
        """The metrics summary and the subsystems' stats, the
        reference's ``/debug`` blocks for what the port has; its ``jax``
        block is ``torch`` here, and its ``spmd`` flag a block that also
        names the mesh's members (``chips``, ``devices``, ``virtual``)."""
        from ..fleet import fleet_stats
        from ..ingest import stats as ingest_stats
        from ..ingest import prefetch, staging
        from ..obs.tsan import tsan_stats
        from ..ops.expr import expr_cache_stats, expr_fuse_enabled
        from ..ops.paged import expr_fused_stats
        from ..mesh.dispatch import mesh_stats
        from ..mesh.pools import active_mesh_pools
        from ..parallel.spmd import spmd_enabled
        from ..pipeline import drill_cache
        from ..pipeline.autoplan import plan_stats
        from ..resilience import cancel_stats
        from ..resilience.pressure import default_monitor
        doc = self.metrics.summary()
        cuda = self.device.type == "cuda"
        # the kernel wrappers' launch counts ride with the device (the
        # reference's ``kernels`` block is its Pallas race verdicts)
        doc["torch"] = {
            "backend": self.device.type,
            "devices": torch.cuda.device_count() if cuda else 1,
            "name": torch.cuda.get_device_name(self.device) if cuda else "",
            "kernels": kernel_launches()}
        doc["spmd"] = {"enabled": spmd_enabled(self.device),
                       **self._mesh_members()}
        doc["mesh"] = mesh_stats()
        mp = active_mesh_pools()
        if mp is not None:
            doc["mesh"]["pools"] = mp.stats()
        doc["plan"] = plan_stats()
        doc["expr"] = {"fuse": expr_fuse_enabled(),
                       "cache": expr_cache_stats(), **expr_fused_stats()}
        ex = self.executor
        doc["executor"] = {
            "geo_cache": len(ex._geo_cache),
            "stride_cache": len(ex._stride_cache),
            "dispatches": {"x".join(map(str, k)): n
                           for k, n in ex.bucket_stats.items()},
            "routes": dict(ex.route_counts),
            "batcher": ex.batcher.stats(),
            "paged": {"engaged": ex.paged_engaged,
                      "declined": ex.paged_declined,
                      "gated": ex.paged_gated,
                      "pool": ex.pool.stats()}}
        doc["scene_cache_bytes"] = ex.cache._bytes
        doc["drill_cache_bytes"] = sum(c._bytes
                                       for c in drill_cache.live_caches())
        doc["ingest"] = {"enabled": ingest_enabled(),
                         **ingest_stats.snapshot(),
                         "window_routed": ex.cache.window_routed,
                         "staged_loads": ex.cache.staged_loads}
        if prefetch._default is not None:
            doc["ingest"]["prefetch_planner"] = prefetch._default.stats()
        if staging._default is not None:
            doc["ingest"]["staging"] = staging._default.stats()
        if self.gateway is not None:
            doc["serving"] = self.gateway.stats()
        fs = fleet_stats()
        if fs:
            # per node health, routed, hedged and rerouted counts, ring
            # generation: one entry per live fleet router
            doc["fleet"] = fs
        from .. import fabric as fabric_mod
        if self.fabric is not None or fabric_mod.fabric_enabled():
            doc["fabric"] = fabric_mod.fabric_stats(self.fabric)
        from ..fleet import elastic
        if not elastic.dormant():
            doc["elastic"] = elastic.elastic_stats()
        doc["temporal"] = obs_metrics.temporal_stats()
        doc["drain"] = self.drain.stats()
        doc["cancel"] = cancel_stats()
        doc["pressure"] = default_monitor().stats()
        doc["tsan"] = tsan_stats()
        return _json(doc)

    def _mesh_members(self) -> Dict:
        """The members a mesh of this server's device would have: their
        count and whether they share a device (a virtual mesh)."""
        from ..parallel.mesh import mesh_devices
        devs = mesh_devices(self.device)
        return {"chips": len(devs), "devices": [str(d) for d in devs],
                "virtual": len(set(devs)) < len(devs)}

    def _fabric_replay(self, q: Dict[str, str]) -> Response:
        """The peer endpoint of the fabric's gateway tier: the encoded
        cache entry of a canonical key, or 404.  Only fresh 200 entries
        (`ResponseCache.peek`): stale and degraded bytes never cross;
        under brownout it sheds, so that peers render themselves."""
        from .. import fabric as fabric_mod
        from ..fabric.replay import encode_entry
        key = q.get("key", "")
        gw = self.gateway
        if gw is None or not key or not fabric_mod.fabric_enabled():
            return Response(404, "text/plain",
                            b"fabric replay unavailable")
        if brownout_level():
            return Response(404, "text/plain", b"brownout",
                            {"X-Gsky-Fabric-NoStore": "1"})
        ent = gw.cache.peek(key)
        if ent is None or ent.status != 200:
            return Response(404, "text/plain", b"miss")
        headers, body = encode_entry(ent)
        return Response(200, ent.content_type, body, headers)

    def _debug_trace(self, q: Dict[str, str]) -> Response:
        """The flight recorder: its list (``{"stats", "traces"}``), its
        JSONL dump (``format=jsonl``) or the slowest trace
        (``slowest=1``)."""
        rec = obs.default_recorder()
        if q.get("format") == "jsonl":
            return Response(200, "application/x-ndjson",
                            rec.dump_jsonl().encode())
        if q.get("slowest"):
            slow = rec.slowest()
            if slow is None:
                return Response(404, "text/plain",
                                b"no traces recorded")
            return _json(slow)
        return _json({"stats": rec.stats(), "traces": rec.summary()})

    def _debug_trace_one(self, trace_id: str) -> Response:
        trace = obs.default_recorder().lookup(trace_id)
        if trace is None:
            return Response(404, "text/plain",
                            f"trace {trace_id!r} not retained".encode())
        return _json(trace)

    def _debug_profile(self, q: Dict[str, str]) -> Response:
        """Capture a `torch.profiler` trace for ``seconds`` (default 3,
        clamped to 0.1-30): CPU and, on a card server, CUDA activity,
        the hand-written kernels' launches included.  The Chrome trace
        is written to ``trace.json`` in a new directory under the temp
        dir: ``{"trace_dir", "seconds"}``.  409 while another capture
        runs; 503 with ``{"error"}`` when the capture fails."""
        try:
            seconds = min(max(float(q.get("seconds", "3")), 0.1), 30.0)
        except ValueError:
            seconds = 3.0
        # one capture at a time: overlapping ones collide in the
        # profiler
        if not self._profile_mutex.acquire(blocking=False):
            return _json({"error": "a profile capture is already in "
                                   "progress"}, 409)
        try:
            out_dir = os.path.join(
                self.temp_dir,
                f"gsky_torch_trace_{int(time.time())}_{os.getpid()}")
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                try:
                    time.sleep(seconds)
                finally:
                    # an unstopped profiler would refuse every later
                    # capture for the life of the process
                    prof.stop()
                os.makedirs(out_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(out_dir,
                                                      "trace.json"))
            except Exception as e:  # reported, not a 500
                return _json({"error": f"trace failed: {e}"}, 503)
        finally:
            self._profile_mutex.release()
        return _json({"trace_dir": out_dir, "seconds": seconds})

    # -- HTTP -----------------------------------------------------------------

    def serve(self, host: str = "127.0.0.1",
              port: int = 8080) -> "_HTTPServer":
        """Bind ``host``:``port`` (0 = an ephemeral port) and serve the
        routes in a daemon thread, one thread a connection.  Returns the
        server: its port is ``server_address[1]``; stop it with
        ``shutdown()`` and ``server_close()``."""
        httpd = _HTTPServer((host, port), self)
        httpd.thread.start()
        return httpd


class _HTTPServer(ThreadingHTTPServer):
    """The standard library's threaded server bound to one `OWSServer`,
    with the thread that runs its loop."""

    daemon_threads = True
    # the listen backlog (the standard library's default is 5): 16
    # clients connecting at once overflowed it, and each dropped SYN
    # cost its client a 1 s retransmit
    request_queue_size = 128

    def __init__(self, address, ows: OWSServer):
        super().__init__(address, _Handler)
        self.ows = ows
        self.thread = threading.Thread(target=self.serve_forever,
                                       name="gsky-ows-http", daemon=True)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self, body: Optional[bytes] = None):
        with self.server.ows.writing():
            self._answer(body)

    def _answer(self, body: Optional[bytes]):
        url = urlsplit(self.path)
        resp = self.server.ows.handle(
            url.path, parse_qs(url.query, keep_blank_values=True),
            self.headers.get("Host", ""), body, self.headers,
            remote=self.client_address[0],
            probe=_socket_probe(self.connection), raw_url=self.path)
        if resp.status == CLIENT_GONE:
            # the client went away: nothing to send
            self.close_connection = True
            resp.close()
            return
        try:
            self.send_response(resp.status)
            if resp.content_type:           # a 304 has none
                self.send_header("Content-Type", resp.content_type)
            for k, v in resp.headers.items():
                self.send_header(k, v)
            if resp.chunks is not None:
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for chunk in resp.chunks:
                    if chunk:
                        self.wfile.write(b"%x\r\n" % len(chunk))
                        self.wfile.write(chunk)
                        self.wfile.write(b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            elif resp.path:
                self.send_header("Content-Length",
                                 str(os.path.getsize(resp.path)))
                self.end_headers()
                with open(resp.path, "rb") as fp:
                    shutil.copyfileobj(fp, self.wfile, 1 << 20)
            else:
                self.send_header("Content-Length", str(len(resp.body)))
                self.end_headers()
                self.wfile.write(resp.body)
        except BaseException:
            # the status line may be out: the connection cannot carry
            # another response
            self.close_connection = True
            raise
        finally:
            resp.close()

    def do_POST(self):
        # the query string routes a POST; its body is a WPS Execute
        # document
        n = int(self.headers.get("Content-Length") or 0)
        self.do_GET(self.rfile.read(n) if n else None)

    def log_message(self, fmt, *args):
        pass


def _register_gateway_invalidation(watcher: ConfigWatcher,
                                   gateway: ServingGateway) -> None:
    """Subscribe ``gateway``'s invalidation to ``watcher``'s reloads,
    once per (watcher, gateway): servers built over one watcher and
    gateway add no listener.  The listener holds the gateway weakly and
    removes itself once the gateway is gone."""
    registered = getattr(watcher, "_serving_gateways", None)
    if registered is None:
        registered = watcher._serving_gateways = weakref.WeakSet()
    if gateway in registered:
        return
    registered.add(gateway)
    gw_ref = weakref.ref(gateway)

    def _listener(configs):
        gw = gw_ref()
        if gw is None:
            watcher.remove_listener(_listener)
            return
        gw.invalidate_for_configs(configs)

    watcher.add_listener(_listener)


def _replay(req_headers: Optional[Mapping[str, str]], ent,
            cache_status: str) -> Response:
    """A response from cached bytes, with the HTTP cache contract: a
    strong ETag, If-None-Match answered 304, the layer's Cache-Control
    and the entry's Age (so that a client's cache does not stretch the
    layer's TTL).  A stale replay is ``no-store`` and carries none; a
    peer's replay (``peer``) is ``no-store`` under brownout."""
    headers = {"X-Gsky-Cache": cache_status}
    if cache_status == "stale":
        headers["Cache-Control"] = "no-store"
        headers.update(ent.headers)
        return Response(ent.status, ent.content_type, ent.body, headers)
    if ent.status == 200:
        age = int(max(0.0, min(
            ent.max_age - (ent.expires - time.monotonic()), ent.max_age)))
        headers["ETag"] = ent.etag
        headers["Cache-Control"] = f"max-age={ent.max_age}"
        headers["Age"] = str(age)
        inm = (req_headers or {}).get("if-none-match", "")
        if inm and _etag_match(inm, ent.etag):
            return Response(304, "", b"", headers)
    if cache_status == "peer" and brownout_level():
        # a peer's bytes replayed under local brownout: served, but no
        # cache downstream keeps a degraded-mode answer
        headers["Cache-Control"] = "no-store"
    headers.update(ent.headers)
    return Response(ent.status, ent.content_type, ent.body, headers)


def _freeze_response(resp: Response):
    """(status, content type, body, kept headers) of a response whose
    body is in memory; a file or a stream passes through as it is."""
    if resp.path or resp.chunks is not None:
        return resp
    keep = tuple((k, resp.headers[k]) for k in ("Content-Disposition",)
                 if k in resp.headers)
    return (resp.status, resp.content_type, bytes(resp.body), keep)


def _etag_match(header: str, etag: str) -> bool:
    if header.strip() == "*":
        return True
    for tok in header.split(","):
        tok = tok.strip()
        if tok.startswith("W/"):
            tok = tok[2:]
        if tok == etag:
            return True
    return False


def _cluster_bands(tiles, nodes, bbox: BBox, height: int):
    """(local tiles, peer jobs) of a GetCoverage over ``nodes``: its tile
    rows cut into one contiguous band per node, the first band local,
    each other one a (node, tiles, band bbox, y0, y1) job of the node in
    its place (`ows.go:835-872`)."""
    row_starts = sorted({t[2] for t in tiles})
    per = max(1, -(-len(row_starts) // len(nodes)))
    groups = [row_starts[i * per:(i + 1) * per] for i in range(len(nodes))]
    local_rows = set(groups[0])
    local = [t for t in tiles if t[2] in local_rows]
    resy = (bbox.ymax - bbox.ymin) / height
    jobs = []
    for node, grp in zip(nodes[1:], groups[1:]):
        if not grp:
            continue
        rows = set(grp)
        tiles_in = [t for t in tiles if t[2] in rows]
        y0px = grp[0]
        y1px = max(t[2] + t[4] for t in tiles_in)
        bb = BBox(bbox.xmin, bbox.ymax - y1px * resy, bbox.xmax,
                  bbox.ymax - y0px * resy)
        jobs.append((node, tiles_in, bb, y0px, y1px))
    return local, jobs


def _render_with_fusion(pipe: TilePipeline, req: GeoTileRequest,
                        lay: Layer):
    """A plain layer renders through `process`; a fusion layer
    (``input_layers``) renders each input layer and composes first-valid
    in order: earlier inputs win, later ones fill their holes."""
    if not lay.input_layers:
        return pipe.process(req)
    data_env: Dict[str, torch.Tensor] = {}
    valid_env: Dict[str, torch.Tensor] = {}
    total_granules = total_files = 0
    for dep in lay.input_layers:
        dep_mask = None
        if dep.mask is not None:
            dep_mask = MaskSpec(id=dep.mask.id, value=dep.mask.value,
                                bit_tests=dep.mask.bit_tests,
                                data_source=dep.mask.data_source,
                                inclusive=dep.mask.inclusive)
        dreq = dataclasses.replace(
            req, collection=dep.data_source, bands=list(dep.rgb_products),
            mask=dep_mask or req.mask,
            resample=dep.resample or req.resample, _exprs=None)
        res = pipe.process(dreq)
        total_granules += res.granule_count
        total_files += res.file_count
        for n in res.namespaces:
            if n not in data_env:
                data_env[n] = res.data[n]
                valid_env[n] = res.valid[n]
            else:
                fill = ~valid_env[n] & res.valid[n]
                data_env[n] = torch.where(fill, res.data[n], data_env[n])
                valid_env[n] = valid_env[n] | res.valid[n]
    return evaluate_expressions(req.band_exprs, data_env, valid_env,
                                req.height, req.width, pipe.device,
                                total_granules, total_files)


def _best_overview(lay: Layer, res: float) -> Optional[Layer]:
    """The coarsest overview whose zoom_limit still admits the request's
    resolution."""
    best = None
    for ov in lay.overviews:
        if ov.zoom_limit <= 0 or res <= ov.zoom_limit:
            if best is None or ov.zoom_limit > best.zoom_limit:
                best = ov
    return best


def _placeholder_tile(image_path: str, width: int, height: int,
                      compress_level=None) -> bytes:
    img_bytes = None
    if image_path and os.path.exists(image_path):
        with open(image_path, "rb") as fp:
            img_bytes = fp.read()
    return empty_tile_png(width, height, img_bytes,
                          compress_level=compress_level)


def _png_level(lay: Layer, style: Optional[Layer] = None):
    """The PNG zlib level: the style's when it sets one, else the
    layer's, else None (GSKY_PNG_LEVEL, then the encoder's default).
    Under brownout every PNG takes the cheapest effort, 0: more bytes
    on the wire beat CPU spent compressing while memory is short."""
    if brownout_level():
        return 0
    for src in (style, lay):
        if src is not None and src.png_compress_level >= 0:
            return src.png_compress_level
    return None


def _host_of(host: str, cfg: Config) -> str:
    if cfg.service_config.ows_hostname:
        h = cfg.service_config.ows_hostname
        return h if h.startswith("http") else f"http://{h}"
    return f"http://{host}"


def _spool_chunks(ns_names: List[str], spool) -> Iterator[bytes]:
    """The streamed DAP4 body of a spooled coverage; the spool is closed
    (and its file unlinked) when the body ends or is dropped.  A body
    streamed to its end is counted (`obs.metrics.record_dap_stream`)."""
    stats: Dict = {}
    try:
        yield from dap4.stream_dap4(ns_names, spool, stats=stats)
    finally:
        spool.close()
    obs_metrics.record_dap_stream(stats.get("bytes", 0),
                                  stats.get("peak_buffer", 0))


def _wave_dispatches() -> int:
    """Wave launches so far, over every device's scheduler."""
    return sum(w["dispatches"] for w in wave_stats().values())


def _raw_url(path: str, q: Mapping[str, str]) -> str:
    """A request target rebuilt from its path and query, for a caller
    that did not pass the one it received."""
    return f"{path}?{urlencode(q)}" if q else path


def _attachment(fname: str) -> Dict[str, str]:
    return {"Content-Disposition": f'attachment; filename="{fname}"'}


def _json(doc, status: int = 200) -> Response:
    return Response(status, "application/json",
                    json.dumps(doc, default=str).encode())


def _xml(doc: str) -> Response:
    return Response(200, "text/xml", doc.encode())


def _png(data: bytes) -> Response:
    return Response(200, "image/png", data)


def _exception_response(e: OWSError,
                        headers: Optional[Dict[str, str]] = None
                        ) -> Response:
    return Response(e.status, "application/vnd.ogc.se_xml",
                    T.service_exception(str(e), e.code).encode(),
                    dict(headers or {}))


def _bounded(dl: Deadline, fn, *args):
    """``fn(*args)`` in a worker thread, under a copy of the request's
    context (its deadline, cancel token and degradation state), waited
    for no longer than what is left of ``dl``: the reference's
    ``wait_for(to_thread(...), dl.remaining())``.  Raises
    `DeadlineExceeded` when the budget runs out first; the worker then
    unwinds at its next cancellation check, once the handler fires the
    token."""
    fut: cf.Future = cf.Future()
    ctx = contextvars.copy_context()

    def run():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(ctx.run(fn, *args))
        except BaseException as e:  # the handler maps it
            fut.set_exception(e)

    threading.Thread(target=run, name="gsky-render", daemon=True).start()
    try:
        return fut.result(timeout=max(0.0, dl.remaining()))
    except cf.TimeoutError:
        raise DeadlineExceeded(
            f"deadline budget of {dl.budget:.1f}s exhausted") from None


@dataclass
class _PrefetchParams:
    """The parts of a parsed GetMap a predicted key carries."""

    bbox: BBox
    crs: object
    times: List[float]
    axes: Dict = field(default_factory=dict)
    axis_idx: Dict = field(default_factory=dict)


def _tenant_of(req_headers: Mapping[str, str], query, remote: str) -> str:
    """The tenant of admission's weighted-fair queue: the API key when
    one is given (``X-API-Key`` or ``key=``), else the first
    ``X-Forwarded-For`` hop, else the client's address."""
    key = req_headers.get("x-api-key")
    if not key and query:
        v = query.get("key") if hasattr(query, "get") else None
        key = v[0] if isinstance(v, list) and v else v
    if key:
        return f"key:{str(key)[:32]}"
    fwd = req_headers.get("x-forwarded-for")
    if fwd:
        return fwd.split(",")[0].strip() or "anon"
    return remote or "anon"


def _socket_probe(sock) -> Callable[[], Optional[str]]:
    """A cancel probe of a client's socket: "client-disconnect" once the
    peer has closed (a non-blocking peek reads ``b""`` or fails)."""
    def probe() -> Optional[str]:
        try:
            data = sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT)
        except (BlockingIOError, InterruptedError):
            return None             # open, nothing more sent
        except OSError:
            return "client-disconnect"
        return "client-disconnect" if data == b"" else None
    return probe
