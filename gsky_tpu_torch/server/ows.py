"""The OWS front end: WMS GetCapabilities and GetMap, served over HTTP.

Counterpart of the WMS half of `gsky_tpu/server/ows.py`.  `OWSServer`
routes ``/ows`` and ``/ows/<namespace>`` to a namespace's config,
dispatches on ``service=`` (or the service ``request=`` implies) and
answers with a `Response`; errors come back as an OGC ServiceException.
`OWSServer.serve` binds it to a socket with the standard library's
threaded HTTP server, one thread a connection.

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
A one-band tile takes the style's or the layer's palette.

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

Requests the port cannot serve yet get HTTP 501 with exception code
``OperationNotSupported`` and a message naming the ROADMAP item, as
does any NotImplementedError the pipeline raises.  Not ported: the
serving gateway (response cache, single-flight, admission), deadlines,
brownout, the metrics collector, drain, the cache fabric and remote
workers.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np
import torch

from ..device import resolve_device
from ..geo.transform import pixel_resolution
from ..index.store import parse_time
from ..io.png import ApngAssembler, empty_tile_png, encode_png, \
    encode_rgba_png
from ..ops.palette import gradient_palette, with_nodata_entry
from ..ops.scale import scale_params_auto, scale_to_byte
from ..pipeline.executor import WarpExecutor
from ..pipeline.tile import TilePipeline, evaluate_expressions
from ..pipeline.tile_stages import render_staged, tile_pipeline_enabled
from ..pipeline.types import AxisSelector, GeoTileRequest, MaskSpec
from ..resilience import TooManyFailures
from . import templates as T
from .config import Config, ConfigWatcher, Layer, get_layer_dates
from .params import OWSError, infer_service, normalise_query, parse_wms

# output formats of a TIME animation
_ANIM_FORMATS = ("image/apng", "video/mp4")
_JPEG_FORMATS = ("image/jpeg", "image/jpg")
# host-clock stages of a request (`OWSServer.spans`): "parse" until the
# render starts (query, config, layer, tile request), "render" the
# pipeline through the byte tile's readback, "encode" the PNG
STAGES = ("parse", "render", "encode")


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
    status: int
    content_type: str
    body: bytes
    headers: Dict[str, str] = field(default_factory=dict)


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
                 device="cuda"):
        """``mas_factory(address)`` gives a namespace's `MASClient` (the
        port's client is in-process: there is no HTTP MAS client yet).
        ``device`` ("cuda" by default) is where every pipeline renders;
        without CUDA it must be "cpu"."""
        self.device = resolve_device(device)
        self.watcher = watcher
        self.mas_factory = mas_factory
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

    # -- dispatch -----------------------------------------------------------

    def handle(self, path: str, query, host: str = "") -> Response:
        """One request: ``path`` (``/ows`` or ``/ows/<namespace>``),
        ``query`` (a mapping of key to value or to a list of values),
        ``host`` (the Host header, for the documents' URLs)."""
        clock = _Clock()
        t0 = clock.last
        try:
            resp = self._handle(path, query, host, clock)
        except OWSError as e:
            resp = _exception_response(e)
        except TooManyFailures as e:
            # more granules lost than the degradation budget allows
            resp = _exception_response(OWSError(str(e), "ServerBusy",
                                                status=503))
        except NotImplementedError as e:
            resp = _exception_response(OWSError(
                str(e), "OperationNotSupported", status=501))
        except Exception as e:  # the last resort: an OGC 500, not a crash
            resp = _exception_response(OWSError(f"internal error: {e}",
                                                status=500))
        with self._lock:
            for k, v in clock.spans.items():
                self.spans[k] += v
            self.spans["handle"] += time.perf_counter() - t0
        return resp

    def _handle(self, path: str, query, host: str,
                clock: _Clock) -> Response:
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
            raise _unported("DAP4", "A.9")
        svc = infer_service(q)
        if svc == "WCS":
            raise _unported("WCS", "A.9")
        if svc == "WPS":
            raise _unported("WPS", "A.15")
        return self.serve_wms(path, cfg, q, host, clock)

    # -- WMS ----------------------------------------------------------------

    def serve_wms(self, path: str, cfg: Config, q: Dict[str, str],
                  host: str, clock: _Clock) -> Response:
        p = parse_wms(q)
        req_name = p.request.lower()
        if req_name == "getcapabilities" or not req_name:
            self._ensure_layer_dates(cfg)
            return _xml(T.wms_capabilities(cfg, path, _host_of(host, cfg)))
        if req_name == "getmap":
            return self._getmap(cfg, p, clock)
        if req_name in ("describelayer", "getlegendgraphic",
                        "getfeatureinfo"):
            raise _unported(f"WMS {p.request}", "A.15")
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
            val = p.axes.get(ax.name, ax.default)
            if val:
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
        if fmt in _JPEG_FORMATS:
            raise _unported("JPEG output", "A.17")
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
                else:
                    scaled = [arr] if arr.ndim == 2 else list(arr)
        if rgba is not None:
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
            return [[a] for a in ex.map(one, range(n))]

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

    def do_GET(self):
        url = urlsplit(self.path)
        resp = self.server.ows.handle(
            url.path, parse_qs(url.query, keep_blank_values=True),
            self.headers.get("Host", ""))
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(resp.body)))
        self.end_headers()
        self.wfile.write(resp.body)

    def do_POST(self):
        # the query string routes a POST too; its body (a WPS Execute
        # document) is read and dropped: WPS is not ported
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(n)
        self.do_GET()

    def log_message(self, fmt, *args):
        pass


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


def _xml(doc: str) -> Response:
    return Response(200, "text/xml", doc.encode())


def _png(data: bytes) -> Response:
    return Response(200, "image/png", data)


def _exception_response(e: OWSError) -> Response:
    return Response(e.status, "application/vnd.ogc.se_xml",
                    T.service_exception(str(e), e.code).encode())
