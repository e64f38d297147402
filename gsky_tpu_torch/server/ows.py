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
single-flight, then the render (`_serve_gated`).  A replay carries
``X-Gsky-Cache`` (miss, hit, join, stale), a strong ``ETag``,
``Cache-Control: max-age=<cache_max_age>`` and ``Age``, and a matching
``If-None-Match`` gets a 304.  An animation, an incomplete request, a
shard, an auto-sized GetCoverage, a layer whose ``cache_max_age`` is 0,
a body sent from a file or as chunks, a degraded render and a joiner's
copy are not cached.  Every request runs in a `request_scope`: a 200
whose render absorbed a partial failure is labelled ``X-GSKY-Degraded``
with its sorted reasons.

Requests the port cannot serve yet get HTTP 501 with exception code
``OperationNotSupported`` and a message naming the ROADMAP item, as
does any NotImplementedError the pipeline raises: among them a
GetCoverage in a config of several ``ows_cluster_nodes`` (peer shards,
A.10) and a date query that needs the HTTP MAS client (A.8).  A WPS
process over a VRT drills through the template it names.  Not ported: admission,
deadlines (GetMap, GetFeatureInfo and WPS run unbounded), brownout,
the metrics collector, drain, the cache fabric and remote workers.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextvars
import dataclasses
import datetime as dt
import json
import os
import shutil
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, List, Mapping, Optional, \
    Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from ..device import resolve_device
from ..geo import geometry as geom
from ..geo.transform import GeoTransform, pixel_resolution, split_bbox
from ..index.store import parse_time
from ..io.geotiff import GeoTIFFWriter, write_geotiff
from ..io.netcdf import write_netcdf3
from ..io.png import ApngAssembler, empty_tile_png, encode_jpeg, \
    encode_png, encode_rgba_png
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
from ..resilience import TooManyFailures, degraded_reasons, \
    mark_degraded, request_scope
from ..serving import ServingGateway, canonical_key, default_gateway, \
    layer_fingerprint, make_entry, quantise_bbox
from . import dap4
from . import templates as T
from .config import Config, ConfigWatcher, Layer, get_layer_dates
from .params import OWSError, infer_service, normalise_query, parse_wcs, \
    parse_wms, parse_wps

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


def _unported(what: str, item: str) -> OWSError:
    """The answer to a request the port cannot serve yet: HTTP 501
    naming the ROADMAP item that will serve it."""
    return OWSError(f"{what} is not ported yet (ROADMAP {item})",
                    "OperationNotSupported", status=501)


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
                 gateway=_GATEWAY_DEFAULT):
        """``mas_factory(address)`` gives a namespace's `MASClient` (the
        port's client is in-process: there is no HTTP MAS client yet).
        ``device`` ("cuda" by default) is where every pipeline renders;
        without CUDA it must be "cpu".  ``temp_dir`` (default the
        system's, which honours TMPDIR) holds coverage files while they
        are written and sent.  ``gateway``: the `ServingGateway` in
        front of GetMap and GetCoverage, by default the process-wide
        `serving.default_gateway`; None serves every request raw."""
        self.device = resolve_device(device)
        self.watcher = watcher
        self.gateway: Optional[ServingGateway] = \
            default_gateway if gateway is _GATEWAY_DEFAULT else gateway
        if self.gateway is not None:
            _register_gateway_invalidation(watcher, self.gateway)
        self.mas_factory = mas_factory
        self.temp_dir = temp_dir or tempfile.gettempdir()
        # the stats of the last multi-tile export (`ExportPipeline.run`)
        self.last_export: Dict[str, object] = {}
        # one executor (scene cache, page pool) for every namespace
        self.executor = WarpExecutor(device=self.device)
        self._pipelines: Dict[str, Tuple[str, TilePipeline]] = {}
        self._lock = threading.Lock()
        # seconds per stage (STAGES) and the handler's total, summed
        # over requests
        self.spans = dict.fromkeys(STAGES + ("handle",), 0.0)

    # -- plumbing ---------------------------------------------------------

    def _mas(self, cfg: Config):
        if self.mas_factory is None:
            raise _unported("an HTTP MAS client", "A.8")
        return self.mas_factory(cfg.service_config.mas_address)

    def _pipeline(self, cfg: Config) -> TilePipeline:
        """One pipeline per namespace, rebuilt when a reload changes its
        MAS address."""
        sc = cfg.service_config
        if sc.worker_nodes:
            raise _unported("remote worker nodes", "A.10")
        nskey = sc.namespace or sc.mas_address
        with self._lock:
            cur = self._pipelines.get(nskey)
            if cur is not None and cur[0] == sc.mas_address:
                return cur[1]
            pipe = TilePipeline(self._mas(cfg), executor=self.executor,
                                device=self.device)
            self._pipelines[nskey] = (sc.mas_address, pipe)
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

    def _serve_gated(self, key: Optional[str], meta,
                     req_headers: Optional[Mapping[str, str]],
                     render: Callable[[], Response]) -> Response:
        """Response cache, then single-flight, then ``render()``.  A hit
        renders nothing; on a miss one request per key renders and the
        others share its bytes, or its error.  A response sent from a
        file or as chunks goes to the leader alone; joiners render their
        own.  On `TooManyFailures` an entry past its TTL but within the
        stale grace is replayed, labelled ``no-store``."""
        gw = self.gateway
        if gw is None or key is None:
            return render()
        ent = gw.cache.get(key)
        if ent is not None:
            return _replay(req_headers, ent, "hit")
        try:
            frozen, joined = gw.flight.do(
                key, lambda: _freeze_response(render()))
        except TooManyFailures:
            stale = gw.cache.get_stale(key)
            if stale is None:
                raise
            mark_degraded("stale-cache")
            return _replay(req_headers, stale, "stale")
        if not isinstance(frozen, tuple):     # a file or a stream
            return render() if joined else frozen
        status, ctype, body, keep = frozen
        ns, layer_name, fp, max_age = meta
        ent = make_entry(body, ctype, status, ns, layer_name, fp, max_age,
                         keep)
        # a degraded (partial) render is not cached: it would replay the
        # holes after the fault cleared
        if status == 200 and not joined and not degraded_reasons():
            gw.cache.put(key, ent)
        return _replay(req_headers, ent, "join" if joined else "miss")

    # -- dispatch -----------------------------------------------------------

    def handle(self, path: str, query, host: str = "",
               body: Optional[bytes] = None,
               headers: Optional[Mapping[str, str]] = None) -> Response:
        """One request: ``path`` (``/ows`` or ``/ows/<namespace>``),
        ``query`` (a mapping of key to value or to a list of values),
        ``host`` (the Host header, for the documents' URLs), ``body``
        (a POST's body: a WPS Execute document), ``headers`` (the
        request's, read for ``If-None-Match``)."""
        clock = _Clock()
        t0 = clock.last
        req_headers = {k.lower(): v for k, v in (headers or {}).items()}
        with request_scope() as rstate:
            try:
                resp = self._handle(path, query, host, clock, body,
                                    req_headers)
            except OWSError as e:
                resp = _exception_response(e)
            except TooManyFailures as e:
                # more granules lost than the degradation budget allows
                resp = _exception_response(OWSError(str(e), "ServerBusy",
                                                    status=503))
            except NotImplementedError as e:
                resp = _exception_response(OWSError(
                    str(e), "OperationNotSupported", status=501))
            except Exception as e:  # the last resort: an OGC 500
                resp = _exception_response(OWSError(
                    f"internal error: {e}", status=500))
            reasons = sorted(set(rstate.reasons))
        if reasons and resp.status == 200:
            # a partial result: still a 200, labelled
            resp.headers["X-GSKY-Degraded"] = ",".join(reasons)
        with self._lock:
            for k, v in clock.spans.items():
                self.spans[k] += v
            self.spans["handle"] += time.perf_counter() - t0
        return resp

    def _handle(self, path: str, query, host: str, clock: _Clock,
                body: Optional[bytes] = None,
                req_headers: Optional[Mapping[str, str]] = None) -> Response:
        if path.rstrip("/") == "/ows":
            ns = ""
        elif path.startswith("/ows/"):
            ns = path[len("/ows/"):]
        else:
            return Response(404, "text/plain", b"404: Not Found")
        q = normalise_query(query)
        cfg = self.watcher.get(ns)
        if cfg is None:
            raise OWSError(f"no configuration for namespace {ns!r}",
                           status=404)
        if "dap4.ce" in q:
            return self.serve_dap(cfg, q, clock)
        svc = infer_service(q)
        if svc == "WCS":
            return self.serve_wcs(path, cfg, q, host, clock, req_headers)
        if svc == "WPS":
            return self.serve_wps(path, cfg, q, host, body)
        return self.serve_wms(path, cfg, q, host, clock, req_headers)

    # -- WMS ----------------------------------------------------------------

    def serve_wms(self, path: str, cfg: Config, q: Dict[str, str],
                  host: str, clock: _Clock,
                  req_headers: Optional[Mapping[str, str]] = None) -> Response:
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
            return self._getmap_gated(cfg, p, q, clock, req_headers)
        if req_name == "getfeatureinfo":
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
            index_res_limit=lay.index_res_limit)

    def _getmap_gated(self, cfg: Config, p, q: Dict[str, str],
                      clock: _Clock,
                      req_headers: Optional[Mapping[str, str]]
                      ) -> Response:
        """GetMap through the serving gateway.  A request complete
        enough to resolve (layer, bbox, crs, size) is keyed; an
        incomplete one goes to `_getmap` for its errors; an animation
        is never cached.  (The reference also notes the key for its
        prefetch planner here; that comes with the ingest of ROADMAP
        A.8.)"""
        key = meta = None
        is_anim = anim_enabled() and len(p.times) > 1 \
            and p.format.lower() in _ANIM_FORMATS
        if self.gateway is not None and p.layers and p.bbox is not None \
                and p.crs is not None and p.width > 0 and p.height > 0 \
                and not is_anim:
            key, meta = self._response_key(cfg, "map", p.layers[0], "wms",
                                           p, q)
        return self._serve_gated(key, meta, req_headers,
                                 lambda: self._getmap(cfg, p, clock))

    def _getmap(self, cfg: Config, p, clock: _Clock) -> Response:
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

        fmt = p.format.lower()
        if len(p.times) > 1 and fmt in _ANIM_FORMATS and anim_enabled() \
                and not lay.input_layers:
            return self._getmap_animation(cfg, p, lay, source, style, clock)
        req = self._tile_request(source, style, p, p.width, p.height,
                                 lay.wms_polygon_segments)
        n_exprs = len(req.band_exprs.expr_names)
        pipe = self._pipeline(cfg)
        auto = scale_params_auto(style.offset_value, style.scale_value,
                                 style.clip_value)
        clock.mark("parse")

        scaled = rgba = None
        if not lay.input_layers and 1 <= n_exprs <= 4:
            # the fused route: warp, mosaic and byte scale in one
            # dispatch, one readback
            sp = (style.offset_value, style.scale_value, style.clip_value,
                  style.colour_scale, auto)
            if tile_pipeline_enabled():
                made = render_staged(pipe, req, n_exprs, *sp)
            elif n_exprs == 1:
                sb = pipe.render_composite_byte(req, *sp)
                made = None if sb is None else ("composite", sb)
            elif n_exprs == 3:
                made = self._render_rgb(pipe, req, style, auto)
            else:
                sb = pipe.render_bands_byte(req, *sp)
                made = None if sb is None else ("planes", sb)
            if made is not None:
                kind, arr = made[0], _host(made[1])
                if kind == "rgba":
                    rgba = arr                      # (H, W, 4)
                    scaled = [arr[..., 0], arr[..., 1], arr[..., 2]]
                else:
                    scaled = [arr] if arr.ndim == 2 else list(arr)
        if rgba is not None and fmt not in _JPEG_FORMATS:
            clock.mark("render")
            png = encode_rgba_png(rgba, compress_level=level)
            clock.mark("encode")
            return _png(png)
        if scaled is None:
            res = _render_with_fusion(pipe, req, lay)
            bands = [res.data[n] for n in res.namespaces if n in res.data]
            valids = [res.valid[n] for n in res.namespaces
                      if n in res.valid]
            if not bands:
                clock.mark("render")
                png = empty_tile_png(p.width, p.height,
                                     compress_level=level)
                clock.mark("encode")
                return _png(png)
            scaled = [scale_to_byte(b, v, offset=style.offset_value,
                                    scale=style.scale_value,
                                    clip=style.clip_value,
                                    colour_scale=style.colour_scale,
                                    auto=auto).cpu().numpy()
                      for b, v in zip(bands[:4], valids[:4])]
        clock.mark("render")
        if fmt in _JPEG_FORMATS:
            body = encode_jpeg(scaled[:3])
            clock.mark("encode")
            return Response(200, "image/jpeg", body)
        palette = None
        if len(scaled) == 1 and (style.palette or lay.palette):
            spec = style.palette or lay.palette
            palette = with_nodata_entry(
                gradient_palette(spec.colours, spec.interpolate))
        png = encode_png(scaled, palette, compress_level=level)
        clock.mark("encode")
        return _png(png)

    def _getmap_animation(self, cfg: Config, p, lay: Layer, source: Layer,
                          style: Layer, clock: _Clock) -> Response:
        """A TIME animation: one index pass, the frames as lanes of one
        wave (or, for a layer the fused route does not serve, each on
        its own through the modular route), one APNG."""
        times = list(p.times)
        maxf = _anim_max_frames()
        if maxf > 0 and len(times) > maxf:
            times = times[:maxf]
        req = self._tile_request(source, style, p, p.width, p.height,
                                 lay.wms_polygon_segments)
        pipe = self._pipeline(cfg)
        auto = scale_params_auto(style.offset_value, style.scale_value,
                                 style.clip_value)
        clock.mark("parse")
        made = pipe.animation_prep(req, times)
        if made is not None:
            planes = self._anim_frames_wave(pipe, req, times, made, style,
                                            auto)
        else:
            planes = self._anim_frames_serial(pipe, req, times, lay, style,
                                              auto)
        clock.mark("render")
        palette = None
        if all(len(pl) == 1 for pl in planes) \
                and (style.palette or lay.palette):
            spec = style.palette or lay.palette
            palette = with_nodata_entry(
                gradient_palette(spec.colours, spec.interpolate))
        level = _png_level(lay, style)
        asm = ApngAssembler(len(planes), delay_ms=_anim_delay_ms())
        body = b"".join(asm.frame(encode_png(pl, palette,
                                             compress_level=level))
                        for pl in planes) + asm.trailer()
        clock.mark("encode")
        headers = {"X-Gsky-Anim-Frames": str(len(planes))}
        if p.format.lower() == "video/mp4":
            # no mp4 muxer: the same APNG, labelled as such
            headers["X-Gsky-Anim-Container"] = "apng-stub"
        return Response(200, "image/apng", body, headers)

    @staticmethod
    def _render_rgb(pipe: TilePipeline, req: GeoTileRequest, style: Layer,
                    auto: bool):
        """The serial RGB ladder over one index pass: ("rgba", (H, W,
        4)), ("planes", (3, H, W)) or None."""
        return pipe.render_rgb_auto(req, style.offset_value,
                                    style.scale_value, style.clip_value,
                                    style.colour_scale, auto)

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
            return _host(out)

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
            frames.append([scale_to_byte(
                b, v, offset=style.offset_value, scale=style.scale_value,
                clip=style.clip_value, colour_scale=style.colour_scale,
                auto=auto).cpu().numpy()
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
        fi = get_feature_info(self._pipeline(cfg), req, p.x, p.y)
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
                  req_headers: Optional[Mapping[str, str]] = None) -> Response:
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
            if len(cfg.service_config.ows_cluster_nodes) > 1:
                raise _unported("GetCoverage over ows_cluster_nodes peer "
                                "shards", "A.10")
            return self._getcoverage_gated(cfg, p, q, clock, req_headers,
                                           is_shard=bool(q.get("wshard")))
        raise OWSError(f"WCS request {p.request!r} not supported",
                       "OperationNotSupported")

    def _getcoverage_gated(self, cfg: Config, p, q: Dict[str, str],
                           clock: _Clock,
                           req_headers: Optional[Mapping[str, str]],
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
        return self._serve_gated(key, meta, req_headers,
                                 lambda: self._getcoverage(cfg, p, clock))

    def _getcoverage(self, cfg: Config, p, clock: _Clock,
                     dap_stream: bool = False) -> Response:
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
                        block[i] = np.where(_host(res.valid[n]),
                                            _host(res.data[n]), nodata)
                writer.write_region(ox, oy, block)
                return
            for n in ns_names:
                if n in res.data:
                    out[n][oy:oy + th, ox:ox + tw] = _host(res.data[n])
                    valid[n][oy:oy + th, ox:ox + tw] = _host(res.valid[n])

        # a multi-tile export of a plain layer goes through the staged
        # engine; a single tile, a fusion layer, or GSKY_EXPORT_PIPELINE=0
        # renders tile by tile
        engine = None
        if len(tiles) > 1 and not lay.input_layers \
                and export_pipeline_enabled():
            engine = ExportPipeline(
                pipe, dataclasses.replace(
                    base_req, polygon_segments=lay.wcs_polygon_segments),
                tiles, ns_names, p.bbox, width, height, nodata=nodata,
                writer=writer, out=out, valid=valid)
        try:
            if engine is None:
                for t in tiles:
                    render_tile(*t)
            else:
                stats = engine.run()
                with self._lock:
                    self.last_export = stats
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
            res = dp.process_split(dreq, proc.year_step)
            csv_blocks.append(drill_csv(res, list(res.values)))
        return _xml(T.wps_execute_response(p.identifier, csv_blocks))

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

    def __init__(self, address, ows: OWSServer):
        super().__init__(address, _Handler)
        self.ows = ows
        self.thread = threading.Thread(target=self.serve_forever,
                                       name="gsky-ows-http", daemon=True)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self, body: Optional[bytes] = None):
        url = urlsplit(self.path)
        resp = self.server.ows.handle(
            url.path, parse_qs(url.query, keep_blank_values=True),
            self.headers.get("Host", ""), body, self.headers)
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
    layer's TTL).  A stale replay is ``no-store`` and carries none."""
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
    layer's, else None (GSKY_PNG_LEVEL, then the encoder's default)."""
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
    (and its file unlinked) when the body ends or is dropped."""
    try:
        yield from dap4.stream_dap4(ns_names, spool)
    finally:
        spool.close()


def _attachment(fname: str) -> Dict[str, str]:
    return {"Content-Disposition": f'attachment; filename="{fname}"'}


def _xml(doc: str) -> Response:
    return Response(200, "text/xml", doc.encode())


def _png(data: bytes) -> Response:
    return Response(200, "image/png", data)


def _exception_response(e: OWSError) -> Response:
    return Response(e.status, "application/vnd.ogc.se_xml",
                    T.service_exception(str(e), e.code).encode())
