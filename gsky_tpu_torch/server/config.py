"""The config.json system: namespace tree, layer definitions, defaults,
date generation, reload.

Counterpart of `gsky_tpu/server/config.py`; it parses every field the
reference parses, so one config.json loads in both packages:

- a directory tree is walked for ``config.json`` files; each directory
  holding one becomes a URL namespace, the root file serves the empty
  namespace;
- per-layer date lists come from generators (regular / monthly / yearly
  / mcd43 / geoglam / chirps20) or from the MAS ``?timestamps`` op with
  its cache token (``time_generator: "mas"``);
- SIGHUP reloads the tree in place (`ConfigWatcher`);
- ``{* ... *}`` comments, ``{{ include "path" }}`` and
  ``$gdoc$...$gdoc$`` heredoc strings are expanded before parsing.

A namespace's MAS client is ``mas_factory(mas_address)`` when a factory
is given, else an HTTP `MASClient` to its ``mas_address``.
"""

from __future__ import annotations

import datetime as dt
import json
import logging
import os
import re
import signal
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..index.client import MASClient
from ..index.store import ISO, parse_time
from ..ops.expr import BandExpressions, parse_band_expressions

# defaults (`utils/config.go:36-61`)
DEFAULT_RECV_MSG_SIZE = 10 * 1024 * 1024
DEFAULT_WMS_POLYGON_SEGMENTS = 2
DEFAULT_WCS_POLYGON_SEGMENTS = 10
DEFAULT_WMS_TIMEOUT = 20
DEFAULT_WCS_TIMEOUT = 30
DEFAULT_GRPC_WMS_CONC = 16
DEFAULT_GRPC_WCS_CONC = 16
DEFAULT_GRPC_WPS_CONC = 16
DEFAULT_WMS_MAX_WIDTH = 512
DEFAULT_WMS_MAX_HEIGHT = 512
DEFAULT_WCS_MAX_WIDTH = 50000
DEFAULT_WCS_MAX_HEIGHT = 30000
DEFAULT_WCS_MAX_TILE_WIDTH = 1024
DEFAULT_WCS_MAX_TILE_HEIGHT = 1024
DEFAULT_LEGEND_WIDTH = 160
DEFAULT_LEGEND_HEIGHT = 320
# rendered-response cache TTL + Cache-Control max-age (serving gateway,
# `gsky_tpu/serving/`); 0 disables output caching for the layer
DEFAULT_CACHE_MAX_AGE = 300


def _int_or(v, default: int) -> int:
    if v is None or v == "":
        return default
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


@dataclass
class PaletteSpec:
    name: str = ""
    interpolate: bool = True
    colours: List[tuple] = field(default_factory=list)  # RGBA tuples

    @classmethod
    def from_json(cls, j: Dict) -> "PaletteSpec":
        cols = [(c.get("R", 0), c.get("G", 0), c.get("B", 0),
                 c.get("A", 255)) for c in j.get("colours", [])]
        return cls(j.get("name", ""), j.get("interpolate", True), cols)


@dataclass
class MaskConfig:
    id: str = ""
    value: str = ""
    data_source: str = ""
    inclusive: bool = False
    bit_tests: List[str] = field(default_factory=list)

    @classmethod
    def from_json(cls, j: Dict) -> "MaskConfig":
        return cls(id=j.get("id", ""), value=str(j.get("value", "") or ""),
                   data_source=j.get("data_source", ""),
                   inclusive=bool(j.get("inclusive", False)),
                   bit_tests=[str(b) for b in j.get("bit_tests", [])])


@dataclass
class LayerAxis:
    name: str = ""
    default: str = ""
    values: List[str] = field(default_factory=list)


@dataclass
class Layer:
    name: str = ""
    title: str = ""
    abstract: str = ""
    data_source: str = ""
    start_isodate: str = ""
    end_isodate: str = ""
    step_days: int = 0
    step_hours: int = 0
    step_minutes: int = 0
    accum: bool = False
    time_generator: str = "regular"
    dates: List[str] = field(default_factory=list)
    rgb_products: List[str] = field(default_factory=list)
    mask: Optional[MaskConfig] = None
    offset_value: float = 0.0
    clip_value: float = 0.0
    scale_value: float = 0.0
    colour_scale: int = 0
    palette: Optional[PaletteSpec] = None
    palettes: List[PaletteSpec] = field(default_factory=list)
    legend_path: str = ""
    legend_height: int = DEFAULT_LEGEND_HEIGHT
    legend_width: int = DEFAULT_LEGEND_WIDTH
    # WPS drill-through-VRT template (`ows.go:1395`, resolved against
    # the config dir; rendered per granule by the drill pipeline)
    vrt_url: str = ""
    styles: List["Layer"] = field(default_factory=list)
    input_layers: List["Layer"] = field(default_factory=list)
    overviews: List["Layer"] = field(default_factory=list)
    zoom_limit: float = 0.0
    resample: str = "near"
    wms_timeout: int = DEFAULT_WMS_TIMEOUT
    wcs_timeout: int = DEFAULT_WCS_TIMEOUT
    cache_max_age: int = DEFAULT_CACHE_MAX_AGE
    # PNG zlib level 0-9; -1 = unset (fall through to GSKY_PNG_LEVEL,
    # then the io.png level-1 default)
    png_compress_level: int = -1
    wms_max_width: int = DEFAULT_WMS_MAX_WIDTH
    wms_max_height: int = DEFAULT_WMS_MAX_HEIGHT
    wcs_max_width: int = DEFAULT_WCS_MAX_WIDTH
    wcs_max_height: int = DEFAULT_WCS_MAX_HEIGHT
    wcs_max_tile_width: int = DEFAULT_WCS_MAX_TILE_WIDTH
    wcs_max_tile_height: int = DEFAULT_WCS_MAX_TILE_HEIGHT
    wms_polygon_segments: int = DEFAULT_WMS_POLYGON_SEGMENTS
    wcs_polygon_segments: int = DEFAULT_WCS_POLYGON_SEGMENTS
    band_strides: int = 1
    # P2(b)/P2(c) spatial decomposition knobs (`utils/config.go:172-177`)
    grpc_tile_x_size: float = 0.0
    grpc_tile_y_size: float = 0.0
    # <=0 disables: fraction-of-256 semantics in the tile indexer,
    # degrees in the drill indexer — the reference overloads one field
    index_tile_x_size: float = 0.0
    index_tile_y_size: float = 0.0
    index_res_limit: float = 0.0
    feature_info_max_dates: int = 0
    feature_info_bands: List[str] = field(default_factory=list)
    nodata_legend_path: str = ""
    axes_info: List[LayerAxis] = field(default_factory=list)
    default_geo_bbox: List[float] = field(default_factory=list)
    default_geo_size: List[int] = field(default_factory=list)
    visibility: str = ""
    disable_services: List[str] = field(default_factory=list)
    timestamps_load_strategy: str = ""
    timestamp_token: str = ""
    effective_start_date: str = ""
    effective_end_date: str = ""

    _exprs: Optional[BandExpressions] = None
    _fi_exprs: Optional[BandExpressions] = None

    @property
    def rgb_expressions(self) -> BandExpressions:
        if self._exprs is None:
            self._exprs = parse_band_expressions(self.rgb_products)
        return self._exprs

    @property
    def feature_info_expressions(self) -> BandExpressions:
        if self._fi_exprs is None:
            bands = self.feature_info_bands or self.rgb_products
            self._fi_exprs = parse_band_expressions(bands)
        return self._fi_exprs

    def style(self, name: str) -> Optional["Layer"]:
        if not name:
            return None
        for s in self.styles:
            if s.name == name:
                return s
        return None

    def service_disabled(self, svc: str) -> bool:
        return svc.lower() in {s.lower() for s in self.disable_services}

    @classmethod
    def from_json(cls, j: Dict) -> "Layer":
        def i(key, default=0):
            try:
                return int(j.get(key) or default)
            except (TypeError, ValueError):
                return default

        def f(key, default=0.0):
            try:
                return float(j.get(key) or default)
            except (TypeError, ValueError):
                return default

        lay = cls(
            name=j.get("name", ""),
            title=j.get("title", ""),
            abstract=j.get("abstract", ""),
            data_source=j.get("data_source", ""),
            start_isodate=j.get("start_isodate", ""),
            end_isodate=j.get("end_isodate", ""),
            step_days=i("step_days"),
            step_hours=i("step_hours"),
            step_minutes=i("step_minutes"),
            accum=bool(j.get("accum", False)),
            time_generator=j.get("time_generator", "regular") or "regular",
            dates=list(j.get("dates", []) or []),
            rgb_products=list(j.get("rgb_products", []) or []),
            mask=MaskConfig.from_json(j["mask"]) if j.get("mask") else None,
            offset_value=f("offset_value"),
            clip_value=f("clip_value"),
            scale_value=f("scale_value"),
            colour_scale=i("colour_scale"),
            palette=PaletteSpec.from_json(j["palette"])
            if j.get("palette") else None,
            palettes=[PaletteSpec.from_json(p)
                      for p in j.get("palettes", []) or []],
            legend_path=j.get("legend_path", ""),
            legend_height=i("legend_height", DEFAULT_LEGEND_HEIGHT),
            legend_width=i("legend_width", DEFAULT_LEGEND_WIDTH),
            vrt_url=j.get("vrt_url", ""),
            styles=[Layer.from_json(s) for s in j.get("styles", []) or []],
            input_layers=[Layer.from_json(s)
                          for s in j.get("input_layers", []) or []],
            overviews=[Layer.from_json(s)
                       for s in j.get("overviews", []) or []],
            zoom_limit=f("zoom_limit"),
            resample=j.get("resample", "near") or "near",
            wms_timeout=i("wms_timeout", DEFAULT_WMS_TIMEOUT),
            wcs_timeout=i("wcs_timeout", DEFAULT_WCS_TIMEOUT),
            # not the `i` helper: an explicit 0 (disable caching) must
            # survive, and `0 or default` would swallow it
            cache_max_age=_int_or(j.get("cache_max_age"),
                                  DEFAULT_CACHE_MAX_AGE),
            # _int_or, not `i`: an explicit 0 (store-only PNG) must
            # survive
            png_compress_level=_int_or(j.get("png_compress_level"), -1),
            wms_max_width=i("wms_max_width", DEFAULT_WMS_MAX_WIDTH),
            wms_max_height=i("wms_max_height", DEFAULT_WMS_MAX_HEIGHT),
            wcs_max_width=i("wcs_max_width", DEFAULT_WCS_MAX_WIDTH),
            wcs_max_height=i("wcs_max_height", DEFAULT_WCS_MAX_HEIGHT),
            wcs_max_tile_width=i("wcs_max_tile_width",
                                 DEFAULT_WCS_MAX_TILE_WIDTH),
            wcs_max_tile_height=i("wcs_max_tile_height",
                                  DEFAULT_WCS_MAX_TILE_HEIGHT),
            wms_polygon_segments=i("wms_polygon_segments",
                                   DEFAULT_WMS_POLYGON_SEGMENTS),
            wcs_polygon_segments=i("wcs_polygon_segments",
                                   DEFAULT_WCS_POLYGON_SEGMENTS),
            band_strides=i("band_strides", 1),
            grpc_tile_x_size=f("grpc_tile_x_size"),
            grpc_tile_y_size=f("grpc_tile_y_size"),
            index_tile_x_size=f("index_tile_x_size"),
            index_tile_y_size=f("index_tile_y_size"),
            index_res_limit=f("index_res_limit"),
            feature_info_max_dates=i("feature_info_max_dates"),
            feature_info_bands=list(j.get("feature_info_bands", []) or []),
            nodata_legend_path=j.get("nodata_legend_path", ""),
            axes_info=[LayerAxis(a.get("name", ""), a.get("default", ""),
                                 list(a.get("values", []) or []))
                       for a in j.get("axes", []) or []],
            default_geo_bbox=list(j.get("default_geo_bbox", []) or []),
            default_geo_size=list(j.get("default_geo_size", []) or []),
            visibility=j.get("visibility", ""),
            disable_services=list(j.get("disable_services", []) or []),
            timestamps_load_strategy=j.get("timestamps_load_strategy", ""),
        )
        if not (lay.png_compress_level == -1
                or 0 <= lay.png_compress_level <= 9):
            raise ValueError(
                f"layer {lay.name!r}: png_compress_level must be 0-9, "
                f"got {lay.png_compress_level}")
        return lay


@dataclass
class ProcessConfig:
    identifier: str = ""
    title: str = ""
    abstract: str = ""
    max_area: float = 0.0
    data_sources: List[Layer] = field(default_factory=list)
    approx: bool = True
    deciles: int = 0
    drill_algorithm: str = ""
    # year-stepped drill request splitting (TimeSplitter,
    # `processor/date_splitter.go:19-31`); 0 = no splitting
    year_step: int = 0
    literal_data: List[Dict] = field(default_factory=list)
    complex_data: List[Dict] = field(default_factory=list)

    @classmethod
    def from_json(cls, j: Dict) -> "ProcessConfig":
        da = j.get("drill_algo", "") or ""
        deciles = 9 if "decile" in da else 0
        return cls(
            identifier=j.get("identifier", ""),
            title=j.get("title", ""),
            abstract=j.get("abstract", ""),
            max_area=float(j.get("max_area") or 0.0),
            data_sources=[Layer.from_json(d)
                          for d in j.get("data_sources", []) or []],
            approx=bool(j["approx"]) if j.get("approx") is not None else True,
            deciles=deciles,
            drill_algorithm=da,
            year_step=int(j.get("year_step") or 0),
            literal_data=list(j.get("literal_data", []) or []),
            complex_data=list(j.get("complex_data", []) or []),
        )


@dataclass
class ServiceConfig:
    ows_hostname: str = ""
    mas_address: str = ""
    worker_nodes: List[str] = field(default_factory=list)
    ows_cluster_nodes: List[str] = field(default_factory=list)
    temp_dir: str = ""
    max_grpc_buffer_size: int = 0
    namespace: str = ""
    # MAS index HTTP timeout (seconds)
    mas_timeout: int = 60
    # the JAX package's compilation cache directory: parsed so that one
    # config.json loads in both packages, unused here
    jax_compilation_cache_dir: str = ""


@dataclass
class Config:
    service_config: ServiceConfig = field(default_factory=ServiceConfig)
    layers: List[Layer] = field(default_factory=list)
    processes: List[ProcessConfig] = field(default_factory=list)
    base_dir: str = ""                   # directory of this config.json

    def layer(self, name: str) -> Optional[Layer]:
        for l in self.layers:
            if l.name == name:
                return l
        return None

    def process(self, identifier: str) -> Optional[ProcessConfig]:
        for p in self.processes:
            if p.identifier == identifier:
                return p
        return None


# ---------------------------------------------------------------------------
# Date generators (`utils/config.go:240-486`)
# ---------------------------------------------------------------------------

def _step(layer: Layer) -> dt.timedelta:
    return dt.timedelta(days=layer.step_days, hours=layer.step_hours,
                        minutes=layer.step_minutes)


def generate_dates_regular(start: dt.datetime, end: dt.datetime,
                           step: dt.timedelta) -> List[str]:
    out = []
    if step.total_seconds() <= 0:
        return out
    cur = start
    while cur <= end:
        out.append(cur.strftime(ISO))
        cur = cur + step
    return out


def generate_dates_monthly(start: dt.datetime, end: dt.datetime,
                           step=None) -> List[str]:
    out = []
    cur = start
    while cur <= end:
        out.append(cur.strftime(ISO))
        cur = _add_months(cur, 1)
    return out


def generate_dates_yearly(start: dt.datetime, end: dt.datetime,
                          step=None) -> List[str]:
    out = []
    cur = start
    while cur <= end:
        out.append(cur.strftime(ISO))
        cur = cur.replace(year=cur.year + 1)
    return out


def generate_dates_chirps20(start: dt.datetime, end: dt.datetime,
                            step=None) -> List[str]:
    out = []
    cur = start
    while cur <= end:
        for day in (1, 11, 21):
            out.append(cur.replace(day=day, hour=0, minute=0, second=0,
                                   microsecond=0).strftime(ISO))
        cur = _add_months(cur, 1)
    return out


def generate_dates_mcd43(start: dt.datetime, end: dt.datetime,
                         step: dt.timedelta) -> List[str]:
    """Year-aligned stepping (`GenerateDatesMCD43A4`)."""
    out = []
    if step.total_seconds() <= 0:
        return out
    cur = start
    year = cur.year
    while cur <= end:
        while cur.year == year and cur <= end:
            out.append(cur.strftime(ISO))
            cur = cur + step
        if cur > end:
            break
        year = cur.year
        cur = dt.datetime(year, 1, 1, tzinfo=dt.timezone.utc)
    return out


def _add_months(d: dt.datetime, n: int) -> dt.datetime:
    month = d.month - 1 + n
    year = d.year + month // 12
    month = month % 12 + 1
    day = min(d.day, [31, 29 if year % 4 == 0 and (year % 100 != 0 or
                                                   year % 400 == 0) else 28,
                      31, 30, 31, 30, 31, 31, 30, 31, 30, 31][month - 1])
    return d.replace(year=year, month=month, day=day)


_GENERATORS = {
    "regular": generate_dates_regular,
    "monthly": generate_dates_monthly,
    "yearly": generate_dates_yearly,
    "chirps20": generate_dates_chirps20,
    "mcd43": generate_dates_mcd43,
    "geoglam": generate_dates_mcd43,
}


def get_layer_dates(layer: Layer, mas=None):
    """Populate layer.dates and the effective start/end dates; ``mas``
    is a `MASClient` (for ``time_generator: \"mas\"``) or None."""
    if layer.dates:
        pass  # explicit dates win
    elif layer.time_generator == "mas" and mas is not None:
        resp = mas.timestamps(layer.data_source,
                              time=layer.start_isodate,
                              until=layer.end_isodate,
                              token=layer.timestamp_token)
        stamps = resp.get("timestamps", [])
        if stamps or not layer.timestamp_token:
            layer.dates = stamps
        layer.timestamp_token = resp.get("token", "")
    elif layer.start_isodate:
        start = dt.datetime.fromtimestamp(parse_time(layer.start_isodate),
                                          dt.timezone.utc)
        endiso = layer.end_isodate
        if endiso and endiso.lower() != "now":
            end = dt.datetime.fromtimestamp(parse_time(endiso),
                                            dt.timezone.utc)
        else:
            end = dt.datetime.now(dt.timezone.utc)
        gen = _GENERATORS.get(layer.time_generator, generate_dates_regular)
        layer.dates = gen(start, end, _step(layer))
    if layer.dates:
        layer.effective_start_date = layer.dates[0]
        layer.effective_end_date = layer.dates[-1]


# ---------------------------------------------------------------------------
# Tree loading + reload
# ---------------------------------------------------------------------------

_GDOC_RE = re.compile(r"\$gdoc\$(.*?)\$gdoc\$", re.S)
_JET_COMMENT_RE = re.compile(r"\{\*.*?\*\}", re.S)
_JET_INCLUDE_RE = re.compile(
    r"\{\{-?\s*include\s+\"([^\"]+)\"\s*-?\}\}")


def _expand_template(text: str, base_dir: str, depth: int = 0) -> str:
    """The Jet template pass (`config.go:1067-1085` runs the config
    through jet before gdoc escaping).  Configs in the wild use the
    engine for file composition, so the semantics that matter are
    supported directly: ``{* ... *}`` comments strip, and
    ``{{ include "relative/path" }}`` splices another (recursively
    templated) file.  Unknown ``{{ ... }}`` actions are left verbatim —
    with the reference's empty VarMap they could only error anyway."""
    if depth > 8:
        raise ValueError("config template includes nested too deep")
    text = _JET_COMMENT_RE.sub("", text)

    def repl(m):
        inc = m.group(1)
        p = inc if os.path.isabs(inc) else os.path.join(base_dir, inc)
        with open(p) as fp:
            return _expand_template(fp.read(), os.path.dirname(p),
                                    depth + 1)

    return _JET_INCLUDE_RE.sub(repl, text)


def _preprocess(text: str, base_dir: str = "") -> str:
    """Template pass + $gdoc$...$gdoc$ heredocs -> JSON strings
    (`config.go:1067-1122`; gdoc escaping runs AFTER the template, as
    the reference does)."""
    text = _expand_template(text, base_dir or ".")

    def repl(m):
        return json.dumps(m.group(1))
    return _GDOC_RE.sub(repl, text)


def load_config_file(path: str, namespace: str = "") -> Config:
    with open(path) as fp:
        j = json.loads(_preprocess(fp.read(),
                                   os.path.dirname(os.path.abspath(path))))
    sc = j.get("service_config", {})
    cfg = Config(
        service_config=ServiceConfig(
            ows_hostname=sc.get("ows_hostname", ""),
            mas_address=sc.get("mas_address", ""),
            worker_nodes=list(sc.get("worker_nodes", []) or []),
            ows_cluster_nodes=list(sc.get("ows_cluster_nodes", []) or []),
            temp_dir=sc.get("temp_dir", ""),
            max_grpc_buffer_size=int(sc.get("max_grpc_buffer_size") or 0),
            namespace=namespace,
            mas_timeout=_int_or(sc.get("mas_timeout"), 60),
            jax_compilation_cache_dir=sc.get(
                "jax_compilation_cache_dir", ""),
        ),
        layers=[Layer.from_json(l) for l in j.get("layers", []) or []],
        processes=[ProcessConfig.from_json(p)
                   for p in j.get("processes", []) or []],
        base_dir=os.path.dirname(os.path.abspath(path)),
    )
    # styles inherit layer rendering defaults (`config.go:536-600`)
    for lay in cfg.layers:
        for s in lay.styles:
            if not s.data_source:
                s.data_source = lay.data_source
            if s.zoom_limit == 0.0:
                s.zoom_limit = lay.zoom_limit
    return cfg


def load_config_tree(root: str, mas_factory=None,
                     load_dates: bool = True) -> Dict[str, Config]:
    """Walk `root` for config.json files; sub-directory paths become URL
    namespaces (`LoadAllConfigFiles`, `config.go:488-628`)."""
    out: Dict[str, Config] = {}
    root = os.path.abspath(root)
    for dirpath, _, files in os.walk(root):
        if "config.json" not in files:
            continue
        rel = os.path.relpath(dirpath, root)
        ns = "" if rel == "." else rel.replace(os.sep, "/")
        cfg = load_config_file(os.path.join(dirpath, "config.json"), ns)
        out[ns] = cfg
    if not out:
        raise ValueError(f"no config.json found under {root}")
    if load_dates:
        for cfg in out.values():
            sc = cfg.service_config
            if mas_factory:
                mas = mas_factory(sc.mas_address)
            elif sc.mas_address:
                mas = MASClient(sc.mas_address, timeout=sc.mas_timeout)
            else:
                mas = None
            for lay in cfg.layers:
                if lay.timestamps_load_strategy != "on_demand":
                    try:
                        get_layer_dates(lay, mas)
                    except Exception:  # timestamp prefetch is advisory - dates load on demand
                        pass
                for s in lay.styles:
                    s.dates = lay.dates
                    s.effective_start_date = lay.effective_start_date
                    s.effective_end_date = lay.effective_end_date
    return out


class ConfigWatcher:
    """Holds the live namespace->Config map; SIGHUP reloads
    (`WatchConfig`, `config.go:1373-1398`)."""

    def __init__(self, root: str, mas_factory=None, install_signal=True):
        self.root = root
        self.mas_factory = mas_factory
        self._lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._configs = load_config_tree(root, mas_factory)
        # reload subscribers (the serving gateway's cache invalidation):
        # called with the fresh namespace -> Config map after each swap
        self._listeners: List = []
        if install_signal:
            try:
                signal.signal(signal.SIGHUP, self._on_hup)
            except ValueError:
                pass  # not the main thread

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _on_hup(self, *_):
        # never reload inline: the signal handler interrupts the main
        # thread at an arbitrary point, possibly while it holds a lock
        # the reload or a listener (the response cache's) needs.  A
        # detached thread runs the reload against uninterrupted state
        # instead.
        threading.Thread(target=self._reload_logged,
                         name="gsky-config-reload", daemon=True).start()

    def _reload_logged(self):
        # a failed reload (malformed / mid-write config.json) must keep
        # the previous config live, as the reference's WatchConfig does
        try:
            self.reload()
        except Exception as e:
            logging.getLogger("gsky.config").error(
                "config reload failed, keeping previous config: %s", e)

    def reload(self):
        with self._reload_lock:     # back-to-back SIGHUPs serialize
            configs = load_config_tree(self.root, self.mas_factory)
            with self._lock:
                self._configs = configs
            for fn in list(self._listeners):
                try:
                    fn(configs)
                except Exception:  # a listener's failure is logged
                    logging.getLogger("gsky.config").exception(
                        "config reload listener failed")

    @property
    def configs(self) -> Dict[str, Config]:
        with self._lock:
            return self._configs

    def get(self, namespace: str) -> Optional[Config]:
        return self.configs.get(namespace)
