#!/usr/bin/env python3
"""Soak the PyTorch/CUDA port's in-process OWS server.

The port's counterpart of ``tools/soak.py``: a long-lived server under
concurrent distinct requests, held to the reference's bounds.  Seven
scenarios, each with the pass criteria of its reference counterpart:

``--scenario churn`` (default): sustained GetMap load over distinct
tiles (cache churn, not cache hits), the gateway off, sampling the
process RSS and, on a card, ``torch.cuda.memory_allocated()``.  Every
other tile is at the archive's native resolution (kernel B1 on a card),
the others the reference's quarter-extent tile (B2 where their page
windows decline).  Passes when every request is a 200
PNG, steady-state growth (after the first quarter, which pays kernel
builds and cache fills) stays under ``--max-rss-growth-mb`` and, on a
card, ``--max-device-growth-mb``, ``/debug``'s executor caches stay at
or under their LRU bounds (``geo_cache`` 256, ``stride_cache`` 8192)
and the scene and drill caches' bytes at or under their ``max_bytes``.

``--scenario hot``: a fixed 8 x 8 tile grid with Zipf popularity
against a server without a gateway and then one with it: p50 / p99 a
phase, the response cache's hit rate, single-flight joins and sheds;
the hit-path p50 traced must stay within ``--max-trace-overhead``
percent of a ``GSKY_TRACE=0`` phase; ``/metrics`` passes the strict
parser; the slowest trace's critical path is printed.

``--scenario wcs``: repeated 1024 x 1024 GetCoverage exports through
the staged export engine: every export a 200 GeoTIFF, RSS (and card
memory) bounded, ``/debug``'s ``export_pipeline`` counting the exports
with non-zero stage times.

``--scenario chaos``: mixed GetMap / GetCoverage under injected faults
(``--faults``, seeded) against a gateway-fronted server whose scene
cache is emptied every 2 s: every answer a clean 2xx, a labelled
``X-GSKY-Degraded`` 2xx or an OGC 503/504; no bare 500, no dropped
connection; an expired tile replayed stale while the backends are down;
the resilience counters move.

``--scenario burst``: prewarm, one warm lap, then a storm of distinct
tiles at four widths: every response a 200 PNG, ZERO kernel builds,
loads or first launches during the storm (``gsky_compiles_total``
unchanged), the staged tile path's gates and encode pool overlapping.

``--scenario wave``: a GetMap + WPS drill storm that must coalesce
(device dispatches <= requests / 3, one wave of two or more entries), a
disconnect volley that cancels at least one entry, ZERO pinned pages at
the end, and the wave families in a strict ``/metrics``.

``--scenario dap4``: concurrent ``dap4.ce`` subsets that stream off the
export spool: every one a 200 DAP4 body, ``GSKY_DAP_STREAM=0``
byte-identical, the peak rechunk buffer under twice the chunk ceiling,
RSS (and card memory) bounded.

    python3 tools/soak_torch.py [--scenario churn] [--seconds 120]
        [--conc 8] [--scenes 4] [--scene-shape 1536x1536] [--device cuda]

The archive is written with the port's writers: ``--scenes`` single-band
UTM int16 scenes (the reference's four of 1536 x 1536 by default), one
date each, scene ``i`` under product ``i % 4`` so that every layer keeps
the reference's four products.  Tiles are as wide as the reference's: a
fraction of the extent up to its 1536-px scenes, and of its ground size
over larger ones, placed over that much of the first scene (the churn's
and chaos' tiles of other dates over the whole extent), so that a
scenario asks for the same zoom over data at any size.  ``--device`` is
``cuda`` by default and raises without CUDA; ``--device cpu`` runs the
kernels' plain versions.  As in the command line's server
(`gsky_tpu_torch.server.main`), the process mmaps blocks of 1 MiB or
more (`fix_mmap_threshold`) and, on a card, each server is prewarmed
before it listens.  ``GSKY_TSAN=1`` runs the soak under the port's
lockset sanitizer, and a race fails it.  Prints one JSON line, then
``SOAK PASSED`` or ``SOAK FAILED``; exits 0 or 1.  Imports torch and the
port, never JAX, the JAX package or ``bench.py``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import datetime as dt
import itertools
import json
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

SCENARIOS = ("churn", "hot", "wcs", "chaos", "burst", "wave", "dap4")
N_PRODUCTS = 4                     # the reference's layers list four
GEO_CACHE_MAX = 256                # pipeline/executor.py _GEO_CACHE_MAX
REF_SCENE = 1536                   # the reference soak's scene edge
STRIDE_CACHE_MAX = 8192            # pipeline/executor.py _STRIDE_CACHE_MAX
PNG = b"\x89PNG\r\n\x1a\n"
T0 = dt.date(2020, 1, 10)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Soak the port's in-process OWS server.")
    ap.add_argument("--scenario", choices=SCENARIOS, default="churn")
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--conc", type=int, default=8)
    ap.add_argument("--scenes", type=int, default=4,
                    help="single-band scenes in the archive, one date each")
    ap.add_argument("--scene-shape", default="1536x1536",
                    help="rows x columns of every scene")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--max-rss-growth-mb", type=float, default=256.0)
    ap.add_argument("--max-device-growth-mb", type=float, default=256.0,
                    help="bound on torch.cuda.memory_allocated()'s "
                         "steady-state growth, where RSS is bounded")
    ap.add_argument("--zipf", type=float, default=1.2,
                    help="hot scenario: Zipf exponent of tile popularity")
    ap.add_argument("--max-trace-overhead", type=float, default=2.0,
                    help="hot scenario: max hot-cache p50 regression "
                         "(percent) with tracing on vs GSKY_TRACE=0")
    ap.add_argument("--faults",
                    default="mas:error:0.2,worker:error:0.2,"
                            "decode:error:0.2",
                    help="chaos scenario: GSKY_FAULTS-style spec")
    ap.add_argument("--fault-seed", type=int, default=11)
    args = ap.parse_args(argv)
    try:
        h, w = (int(v) for v in args.scene_shape.lower().split("x"))
    except ValueError:
        ap.error(f"--scene-shape {args.scene_shape!r}: want ROWSxCOLS")
    if h < 64 or w < 64 or args.scenes < 1:
        ap.error("--scenes >= 1 and scenes of at least 64 x 64")
    args.shape = (h, w)
    return args


# -- measurement ---------------------------------------------------------

def rss_mb() -> float:
    with open("/proc/self/status") as fp:
        for line in fp:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def device_mb(device) -> float:
    """``torch.cuda.memory_allocated`` in MiB; 0 off a card."""
    if device.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / float(1 << 20)


class MemWatch:
    """RSS and, on a card, allocated device memory sampled over a run.
    The baseline is the first sample after the first quarter (which
    pays kernel builds and cache fills); growth is the last sample's
    (``peak=False``, as the reference's churn and wcs) or the largest
    sample's (``peak=True``, as its dap4) excess over it."""

    def __init__(self, device, seconds: float):
        self.device = device
        self.t0 = time.time()
        self.quarter = self.t0 + seconds / 4.0
        self.samples = []
        self.base = None
        self.peak = (0.0, 0.0)
        self._lock = threading.Lock()

    def sample(self) -> None:
        rss, dev = rss_mb(), device_mb(self.device)
        now = time.time()
        with self._lock:
            self.samples.append((round(now - self.t0, 1), round(rss, 1),
                                 round(dev, 1)))
            if now >= self.quarter:
                if self.base is None:
                    self.base = (rss, dev)
                self.peak = (max(self.peak[0], rss), max(self.peak[1], dev))

    def report(self, args, peak: bool = False):
        """({"rss", "device"}, ok): growth against the bounds; the
        device bound holds only on a card."""
        self.sample()
        with self._lock:
            base = self.base or (self.samples[-1][1], self.samples[-1][2])
            end = self.peak if peak else self.samples[-1][1:]
            samples = self.samples[:3] + self.samples[-3:]
        rss_growth = max(0.0, end[0] - base[0]) if peak \
            else end[0] - base[0]
        dev_growth = max(0.0, end[1] - base[1]) if peak \
            else end[1] - base[1]
        ok = rss_growth <= args.max_rss_growth_mb
        out = {"samples_s_rss_dev_mb": samples,
               "rss": {"baseline_mb": round(base[0], 1),
                       "growth_mb": round(rss_growth, 1),
                       "bound_mb": args.max_rss_growth_mb}}
        if self.device.type == "cuda":
            ok = ok and dev_growth <= args.max_device_growth_mb
            out["device"] = {
                "allocated_baseline_mb": round(base[1], 1),
                "allocated_growth_mb": round(dev_growth, 1),
                "bound_mb": args.max_device_growth_mb,
                "reserved_mb": round(torch.cuda.memory_reserved(
                    self.device) / float(1 << 20), 1),
                "max_allocated_mb": round(torch.cuda.max_memory_allocated(
                    self.device) / float(1 << 20), 1)}
        out["ok"] = ok
        return out, ok


def fetch_json(host: str, path: str) -> dict:
    with urllib.request.urlopen(f"http://{host}{path}", timeout=60) as r:
        return json.loads(r.read())


def check_metrics(host: str,
                  require=("gsky_requests_total", "gsky_request_seconds",
                           "gsky_stage_seconds")) -> dict:
    """Scrape /metrics through the port's STRICT exposition parser: a
    malformed line or a broken histogram raises, a missing family fails
    the soak."""
    from gsky_tpu_torch.obs.prom import parse_exposition
    with urllib.request.urlopen(f"http://{host}/metrics",
                                timeout=30) as r:
        fams = parse_exposition(r.read().decode())
    return {"families": len(fams),
            "missing": [f for f in require if f not in fams]}


def slowest_trace_report(host: str):
    """The slowest recorded request's waterfall (printed) and a summary
    with its critical path; None when the recorder holds nothing."""
    import trace_view as tv
    try:
        trace = fetch_json(host, "/debug/trace?slowest=1")
    except (OSError, ValueError):
        return None
    print(tv.render(trace), flush=True)
    return {"trace_id": trace.get("trace_id"),
            "dur_ms": round((trace.get("dur_s") or 0.0) * 1e3, 1),
            "critical_path": tv.critical_breakdown(trace)}


def pool_stats(server) -> dict:
    st = server.executor.pool.stats()
    return {k: st[k] for k in ("resident", "pinned", "capacity",
                               "evictions")}


class EnvOverride:
    """Set environment variables for a block, restoring them after."""

    def __init__(self, **values):
        self.values = values
        self.saved = {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- the archive, its index and the servers ------------------------------

def scene_dates(n: int):
    return [T0 + dt.timedelta(days=i) for i in range(n)]


def product(k: int) -> str:
    """The reference's product names: LC08_20200110_T1 ... _T1."""
    return f"LC08_20200{110 + k}_T1"


def iso(d: dt.date) -> str:
    return f"{d.isoformat()}T00:00:00.000Z"


def write_archive(root: str, scenes: int, shape):
    """``scenes`` single-band UTM int16 scenes of ``shape`` (the
    reference's `bench.build_archive` at 4 x 1536 x 1536: uniform
    200-3000, the top-left eighth nodata -999, scene ``i`` shifted a
    third of a scene east and a fifth south of scene ``i - 1`` for the
    first four), written uncompressed with the port's writer and
    crawled into the port's MAS store, scene ``i`` under product
    ``i % 4`` at its own date.  Returns (store, utm CRS, paths)."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    from gsky_tpu_torch.io.geotiff import write_geotiff

    h, w = shape
    utm = parse_crs("EPSG:32755")
    rng = np.random.default_rng(42)
    store = MASStore()
    paths = []
    for i, d in enumerate(scene_dates(scenes)):
        k = i % N_PRODUCTS
        gt = GeoTransform(590000.0 + k * w * 30 // 3, 30.0, 0.0,
                          6105000.0 - k * h * 30 // 5, 0.0, -30.0)
        data = rng.uniform(200, 3000, (h, w)).astype(np.int16)
        data[: h // 8, : w // 8] = -999
        p = os.path.join(root, f"LC08_{d.strftime('%Y%m%d')}_T1.tif")
        write_geotiff(p, data, gt, utm, nodata=-999, compress=False)
        del data
        rec = extract(p)
        if rec.get("error"):
            raise RuntimeError(f"crawl {p}: {rec['error']}")
        for ds in rec["geo_metadata"]:
            ds["namespace"] = product(k)
        store.ingest(rec)
        paths.append(p)
    return store, utm, paths


def write_config(conf_dir: str, root: str, shape, utm):
    """The reference soak's config.json for the port's layers:
    ``landsat``, ``landsat_chaos`` (``cache_max_age`` 3),
    ``landsat_burst`` (one product), the DAP4 frame ``landsat_dap``
    (tiled 2 x 2) and the ``geometryDrill`` process.  Returns the
    extent the requests cover, in EPSG:3857."""
    from gsky_tpu_torch.geo.crs import EPSG3857, EPSG4326
    from gsky_tpu_torch.geo.transform import BBox, transform_bbox

    h, w = shape
    prods = [product(k) for k in range(N_PRODUCTS)]
    core = BBox(590000.0, 6105000.0 - h * 30.0 * 1.3,
                590000.0 + w * 30.0 * 1.3, 6105000.0)
    dap_ll = transform_bbox(core, utm, EPSG4326)
    tiled = {"wcs_max_width": 4096, "wcs_max_height": 4096,
             "wcs_max_tile_width": 256, "wcs_max_tile_height": 256}
    layers = [
        {"name": "landsat", "title": "soak", "data_source": root,
         "rgb_products": prods, "time_generator": "mas", **tiled},
        {"name": "landsat_chaos", "title": "chaos soak",
         "data_source": root, "rgb_products": prods,
         "time_generator": "mas", "cache_max_age": 3, **tiled},
        {"name": "landsat_burst", "title": "burst soak",
         "data_source": root, "rgb_products": prods[:1],
         "time_generator": "mas", **tiled},
        {"name": "landsat_dap", "title": "dap soak", "data_source": root,
         "rgb_products": prods, "time_generator": "mas",
         "default_geo_bbox": [dap_ll.xmin, dap_ll.ymin, dap_ll.xmax,
                              dap_ll.ymax],
         "default_geo_size": [256, 256],
         "wcs_max_width": 4096, "wcs_max_height": 4096,
         "wcs_max_tile_width": 128, "wcs_max_tile_height": 128}]
    processes = [{
        "identifier": "geometryDrill", "title": "Geometry drill",
        "max_area": 10000,
        "data_sources": [{"data_source": root, "rgb_products": prods}],
        "approx": False}]
    os.makedirs(conf_dir, exist_ok=True)
    with open(os.path.join(conf_dir, "config.json"), "w") as fp:
        json.dump({"service_config": {"ows_hostname": "",
                                      "mas_address": ""},
                   "layers": layers, "processes": processes}, fp)
    return transform_bbox(transform_bbox(core, utm, EPSG4326),
                          EPSG4326, EPSG3857)


class SoakEnv:
    """One soak's archive written under ``root``, its in-process MAS,
    config and the servers it boots."""

    def __init__(self, root: str, scenes: int = 4, shape=(1536, 1536),
                 device="cuda"):
        from gsky_tpu_torch.device import resolve_device
        from gsky_tpu_torch.index.client import MASClient
        from gsky_tpu_torch.server.config import ConfigWatcher

        self.device = resolve_device(device)    # raises without CUDA
        self.root, self.scenes, self.shape = root, scenes, shape
        self.store, self.utm, self.paths = write_archive(root, scenes,
                                                         shape)
        self.dates = scene_dates(scenes)
        # the products that hold a scene
        self.products = [product(k)
                         for k in range(min(scenes, N_PRODUCTS))]
        self.mas = MASClient(self.store)
        self.conf_dir = os.path.join(root, "conf")
        self.merc = write_config(self.conf_dir, root, shape, self.utm)
        # a 256-px tile at the archive's 30 m pixels, in EPSG:3857
        # metres
        self.native_w = 256 * 30.0 * self.merc.width \
            / (shape[1] * 30.0 * 1.3)
        # what the scenarios' tile widths are fractions of: the extent,
        # as the reference's, up to the reference's 1536-px scenes;
        # over larger scenes a tile keeps the reference's ground size,
        # so that it asks for the same zoom (and reaches the same
        # kernels) at any archive size
        self.unit = self.merc.width * min(1.0, REF_SCENE / shape[1])
        self.watcher = ConfigWatcher(self.conf_dir,
                                     mas_factory=lambda a: self.mas,
                                     install_signal=False)
        self._served = []

    def server(self, gateway=None):
        """(OWSServer, "host:port") serving this archive on a thread;
        ``gateway`` None serves every request raw.  On a card the
        kernels are built, loaded and launched before it listens, as
        the command line's server does (`server.prewarm`): a first
        request that waited for nvcc took up to 30 s, past the layers'
        20 s WMS deadline."""
        from gsky_tpu_torch.server.metrics import MetricsLogger
        from gsky_tpu_torch.server.ows import OWSServer
        from gsky_tpu_torch.server.prewarm import prewarm_from_watcher
        srv = OWSServer(self.watcher, mas_factory=lambda a: self.mas,
                        device=self.device, gateway=gateway,
                        metrics=MetricsLogger())
        if self.device.type == "cuda":
            prewarm_from_watcher(self.watcher, srv.executor)
        httpd = srv.serve("127.0.0.1", 0)
        self._served.append((srv, httpd))
        return srv, f"127.0.0.1:{httpd.server_address[1]}"

    @property
    def servers(self):
        """The servers booted and not yet closed, oldest first."""
        return [srv for srv, _ in self._served]

    def bbox(self, fx: float, fy: float, w: float,
             whole: bool = False) -> str:
        """A tile ``w`` wide at (``fx``, ``fy``): fractions of the extent
        with ``whole``, else of the `unit` square at the extent's
        top-left corner, where the first scene lies (the extent itself
        up to the reference's 1536-px scenes)."""
        m = self.merc
        if whole:
            x0, y0 = m.xmin + fx * m.width, m.ymin + fy * m.height
        else:
            uh = m.height * self.unit / m.width
            x0, y0 = m.xmin + fx * self.unit, m.ymax - (1.0 - fy) * uh
        return f"{x0},{y0},{x0 + w},{y0 + w}"

    def getmap(self, host: str, layer: str, fx: float, fy: float,
               w: float, date: dt.date, whole: bool = False) -> str:
        return (f"http://{host}/ows?service=WMS&request=GetMap"
                f"&version=1.3.0&layers={layer}&crs=EPSG:3857"
                f"&bbox={self.bbox(fx, fy, w, whole)}&width=256"
                f"&height=256&format=image/png&time={iso(date)}")

    def churn_url(self, host: str, i: int, fx: float, fy: float) -> str:
        """The churn's ``i``-th GetMap at (``fx``, ``fy``) of the whole
        extent (every scene's date lies somewhere in it): a native-
        resolution tile when ``i`` is even, else a quarter of `unit`
        wide, at date ``i`` (cycling)."""
        w = self.unit * 0.25 if i % 2 else self.native_w
        return self.getmap(host, "landsat", fx, fy, w,
                           self.dates[i % len(self.dates)], whole=True)

    def hot_tiles(self):
        """The hot scenario's fixed 8 x 8 grid of (fx, fy)."""
        frac = [0.75 * k / 7 for k in range(8)]
        return [(fx, fy) for fx in frac for fy in frac]

    def hot_url(self, host: str, tile) -> str:
        return self.getmap(host, "landsat", *tile, self.unit * 0.25,
                           self.dates[0])

    def wcs_url(self, host: str, fx: float, fy: float,
                px: int = 1024) -> str:
        """The wcs scenario's export: a window half of `unit` wide at
        ``px`` square (a multi-tile plan in 256 px tiles)."""
        return self.getcoverage(host, "landsat", fx, fy,
                                self.unit * 0.5, px)

    def getcoverage(self, host: str, layer: str, fx: float, fy: float,
                    w: float, px: int) -> str:
        return (f"http://{host}/ows?service=WCS&request=GetCoverage"
                f"&coverage={layer}&crs=EPSG:3857"
                f"&bbox={self.bbox(fx, fy, w)}&width={px}&height={px}"
                f"&format=GeoTIFF&time={iso(self.dates[0])}")

    def drill_url(self, host: str) -> str:
        """WPS geometryDrill over one small polygon inside the first
        scene (lon/lat)."""
        from gsky_tpu_torch.geo.crs import EPSG3857, EPSG4326
        from gsky_tpu_torch.geo.transform import transform_bbox
        ll = transform_bbox(self.merc, EPSG3857, EPSG4326)
        d = 0.03 * min(1.0, (ll.xmax - ll.xmin) / 0.6)
        x0 = ll.xmin + 0.35 * (ll.xmax - ll.xmin)
        y0 = ll.ymax - 0.25 * (ll.ymax - ll.ymin)
        geom = json.dumps({"type": "FeatureCollection", "features": [{
            "type": "Feature", "geometry": {
                "type": "Polygon", "coordinates": [[
                    [x0, y0], [x0 + d, y0], [x0 + d, y0 + d],
                    [x0, y0 + d], [x0, y0]]]}}]})
        return (f"http://{host}/ows?service=WPS&request=Execute"
                f"&identifier=geometryDrill"
                f"&datainputs=geometry={urllib.parse.quote(geom)}")

    def dap_url(self, host: str, i: int) -> str:
        """A ``dap4.ce`` subset rotating product and x clamp; its time
        filter names the product's first date, so it has granules."""
        from gsky_tpu_torch.geo.crs import EPSG3857, EPSG4326
        from gsky_tpu_torch.geo.transform import transform_bbox
        ll = transform_bbox(self.merc, EPSG3857, EPSG4326)
        k = i % len(self.products)
        x_lo = ll.xmin + (0.0, 0.15, 0.3, 0.45)[i % 4] * (ll.xmax - ll.xmin)
        ce = (f"landsat_dap{{{self.products[k]}}} | x >= {x_lo:.6f}, "
              f"time >= {iso(self.dates[k])}")
        return f"http://{host}/ows?dap4.ce=" + urllib.parse.quote(ce)

    def close(self) -> None:
        for srv, httpd in self._served:
            httpd.shutdown()
            httpd.server_close()
            srv.close()
        self._served.clear()


def fetch_png(url: str, errors=None) -> bool:
    """Whether ``url`` answers a 200 PNG; otherwise its status and body
    head, or the exception, go to ``errors`` (a list, its first 5
    kept)."""
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            body = r.read()
            if r.status == 200 and body[:8] == PNG:
                return True
            what = f"{r.status} {body[:200]!r}"
    except urllib.error.HTTPError as e:
        what = f"{e.code} {e.read()[:300].decode(errors='replace')}"
    except (OSError, ValueError) as exc:
        what = f"{exc!r:.200}"
    if errors is not None and len(errors) < 5:
        errors.append(what)
    return False


def storm(conc: int, seconds: float, one) -> None:
    """``one()`` from ``conc`` free-running threads for ``seconds``."""
    t_end = time.time() + seconds

    def worker():
        while time.time() < t_end:
            one()

    ths = [threading.Thread(target=worker, daemon=True)
           for _ in range(conc)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(seconds + 300)


def kernel_counts(dbg: dict) -> dict:
    return (dbg.get("torch") or {}).get("kernels", {})


# -- the scenarios ---------------------------------------------------------
# Each returns (the JSON-able result, passed).

def run_churn(env: SoakEnv, args):
    """Distinct tiles, the gateway off: RSS, card memory and every
    cache held to its bound."""
    from gsky_tpu_torch.pipeline import drill_cache

    server, host = env.server(gateway=None)
    rng = np.random.default_rng(1)
    rng_lock = threading.Lock()
    counter = itertools.count()
    errors: list = []
    lats: list = []

    def one(_):
        # a distinct bbox nearly every request: eviction, the ctrl and
        # stride caches and the window machinery, not the LRU hit path
        with rng_lock:
            i = next(counter)
            fx = float(rng.uniform(0.0, 0.75))
            fy = float(rng.uniform(0.0, 0.75))
        t0 = time.perf_counter()
        ok = fetch_png(env.churn_url(host, i, fx, fy), errors)
        lats.append(time.perf_counter() - t0)
        return ok

    mem = MemWatch(env.device, args.seconds)
    t_end = time.time() + args.seconds
    n_ok = n_bad = 0
    with cf.ThreadPoolExecutor(args.conc) as ex:
        while time.time() < t_end:
            results = list(ex.map(one, range(args.conc * 4)))
            n_ok += sum(results)
            n_bad += len(results) - sum(results)
            mem.sample()
    dbg = fetch_json(host, "/debug")
    exec_caches = dbg.get("executor", {})
    memory, mem_ok = mem.report(args)
    scene_bound = server.executor.cache.max_bytes
    drills = drill_cache.live_caches()
    drill_bound = sum(c.max_bytes for c in drills)
    cache = server.executor.cache
    out = {
        "scenario": "churn", "device": str(env.device),
        "requests_ok": n_ok, "requests_failed": n_bad, "errors": errors,
        "tiles_per_s": round((n_ok + n_bad) / args.seconds, 2),
        "latency_ms": {k: round(float(np.percentile(lats, q)) * 1e3, 1)
                       for k, q in (("p50", 50), ("p99", 99),
                                    ("max", 100))},
        "memory": memory,
        "caches": {k: exec_caches.get(k)
                   for k in ("geo_cache", "stride_cache")},
        "scene_cache_bytes": dbg.get("scene_cache_bytes"),
        "scene_cache_max_bytes": scene_bound,
        "scene_cache": {"hits": cache.hits, "misses": cache.misses,
                        "evictions": cache.evictions,
                        "staged_loads": cache.staged_loads,
                        "window_routed": cache.window_routed},
        "server": {"requests": dbg.get("requests"),
                   "stage_s": {k: round(v, 3) for k, v in
                               server.executor.spans.items()}},
        "drill_cache_bytes": dbg.get("drill_cache_bytes"),
        "drill_cache_max_bytes": drill_bound,
        "pool": pool_stats(server),
        "kernels": kernel_counts(dbg),
    }
    ok = (n_bad == 0 and n_ok > 0 and mem_ok
          and exec_caches.get("geo_cache", 0) <= GEO_CACHE_MAX
          and exec_caches.get("stride_cache", 0) <= STRIDE_CACHE_MAX
          and dbg.get("scene_cache_bytes", 0) <= scene_bound
          and dbg.get("drill_cache_bytes", 0) <= drill_bound)
    return out, ok


def run_hot(env: SoakEnv, args):
    """A Zipf-popular fixed tile grid against a server without and one
    with the gateway, and tracing's cost on the hit path."""
    from gsky_tpu_torch.serving import ServingGateway

    tiles = env.hot_tiles()
    rng = np.random.default_rng(7)
    # rank -> tile: Zipf mass lands on a fixed handful of hot tiles
    ranks = (rng.zipf(args.zipf, size=200_000) - 1) % len(tiles)

    def phase(host: str, seconds: float):
        counter = itertools.count()
        lats, bad = [], [0]
        lock = threading.Lock()

        def one(_):
            k = int(ranks[next(counter) % len(ranks)])
            t0 = time.time()
            ok = fetch_png(env.hot_url(host, tiles[k]))
            d = time.time() - t0
            with lock:
                lats.append(d)
                bad[0] += not ok

        t_end = time.time() + seconds
        with cf.ThreadPoolExecutor(args.conc) as ex:
            while time.time() < t_end:
                list(ex.map(one, range(args.conc * 4)))
        return lats, bad[0]

    def summary(lats, bad, seconds):
        arr = np.array(lats) if lats else np.zeros(1)
        return {"requests": len(lats), "failed": bad,
                "rps": round(len(lats) / max(seconds, 1e-9), 1),
                "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3)}

    half = args.seconds / 2.0
    _, base_host = env.server(gateway=None)
    base = summary(*phase(base_host, half), half)
    gate_srv, gate_host = env.server(gateway=ServingGateway())
    gate = summary(*phase(gate_host, half), half)

    # tracing's cost on the hit path: every tile cached first, then the
    # same Zipf load untraced (GSKY_TRACE=0, read per request) and
    # traced in turns (ABBA BAAB), so that the host's drift falls on
    # both legs alike
    warm_bad = sum(not fetch_png(env.hot_url(gate_host, t)) for t in tiles)
    ov_s = max(6.0, args.seconds * 0.25)
    legs = {"0": ([], 0), None: ([], 0)}
    for trace in ("0", None, None, "0", None, "0", "0", None):
        with EnvOverride(GSKY_TRACE=trace):
            lats, bad = phase(gate_host, ov_s / 4.0)
        legs[trace] = (legs[trace][0] + lats, legs[trace][1] + bad)
    untraced = summary(*legs["0"], ov_s)
    traced = summary(*legs[None], ov_s)
    overhead_pct = round((traced["p50_ms"] - untraced["p50_ms"])
                         / max(untraced["p50_ms"], 1e-9) * 100.0, 2)
    overhead_ok = traced["p50_ms"] <= (
        untraced["p50_ms"] * (1.0 + args.max_trace_overhead / 100.0)
        + 0.1)

    serving = fetch_json(gate_host, "/debug").get("serving", {})
    rc = serving.get("response_cache", {})
    hits, misses = rc.get("hits", 0), rc.get("misses", 0)
    gate["hit_rate"] = round(hits / max(hits + misses, 1), 3)
    gate["singleflight_joined"] = serving.get(
        "singleflight", {}).get("joined", 0)
    gate["shed"] = sum(
        c.get("shed", 0) for c in
        serving.get("admission", {}).get("classes", {}).values())
    metrics = check_metrics(gate_host)
    trace_rep = slowest_trace_report(gate_host)
    out = {"scenario": "hot", "device": str(env.device),
           "tiles": len(tiles), "zipf": args.zipf, "baseline": base,
           "gateway": gate,
           "trace_overhead": {"untraced": untraced, "traced": traced,
                              "p50_overhead_pct": overhead_pct,
                              "ok": overhead_ok},
           "metrics": metrics, "slowest_trace": trace_rep,
           "pool": pool_stats(gate_srv)}
    ok = (base["failed"] == 0 and gate["failed"] == 0 and warm_bad == 0
          and untraced["failed"] == 0 and traced["failed"] == 0
          and gate["hit_rate"] > 0.3 and overhead_ok
          and not metrics["missing"])
    return out, ok


def run_wcs(env: SoakEnv, args):
    """Repeated 1024 x 1024 GetCoverage exports through the staged
    export engine, RSS and card memory bounded."""
    server, host = env.server(gateway=None)
    rng = np.random.default_rng(3)
    rng_lock = threading.Lock()

    def one(_):
        with rng_lock:
            fx = float(rng.uniform(0.0, 0.5))
            fy = float(rng.uniform(0.0, 0.5))
        try:
            with urllib.request.urlopen(env.wcs_url(host, fx, fy),
                                        timeout=300) as r:
                body = r.read()
                return (r.status == 200 and len(body) > 8
                        and body[:4] == b"II*\x00")
        except (OSError, ValueError):
            return False

    mem = MemWatch(env.device, args.seconds)
    t_end = time.time() + args.seconds
    n_ok = n_bad = 0
    lats = []
    with cf.ThreadPoolExecutor(args.conc) as ex:
        while time.time() < t_end:
            t0 = time.time()
            results = list(ex.map(one, range(args.conc)))
            lats.append((time.time() - t0) / max(len(results), 1))
            n_ok += sum(results)
            n_bad += len(results) - sum(results)
            mem.sample()
    dbg = fetch_json(host, "/debug")
    ep = dbg.get("export_pipeline", {})
    memory, mem_ok = mem.report(args)
    out = {
        "scenario": "wcs", "device": str(env.device),
        "exports_ok": n_ok, "exports_failed": n_bad,
        "mean_export_s": round(float(sum(lats) / max(len(lats), 1)), 3),
        "memory": memory,
        "export_pipeline": {k: ep.get(k) for k in
                            ("exports", "tiles", "index_queries",
                             "scenes_warmed", "dedup_saved", "decode_s",
                             "warp_s", "encode_s", "wall_s")},
        "pool": pool_stats(server),
        "kernels": kernel_counts(dbg),
    }
    ok = (n_ok > 0 and n_bad == 0 and mem_ok
          and ep.get("exports", 0) >= n_ok
          and ep.get("index_queries", 0) >= n_ok
          and ep.get("decode_s", 0) > 0
          and ep.get("warp_s", 0) > 0
          and ep.get("encode_s", 0) > 0)
    return out, ok


def classify(url: str, hard=None) -> str:
    """ok (clean 2xx), degraded (2xx with X-GSKY-Degraded), ogc_error
    (an OGC exception, not a 500), hard_5xx (a bare 500, a body that is
    not OGC XML or a 503 without Retry-After) or transport (a dropped
    connection).  A hard answer's status and body head go to ``hard``
    (a list, its first 5 kept)."""
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            degraded = r.headers.get("X-GSKY-Degraded")
            r.read()
            return "degraded" if degraded else "ok"
    except urllib.error.HTTPError as e:
        ctype = e.headers.get("Content-Type", "")
        body = e.read()
        if e.code == 500 or "vnd.ogc.se_xml" not in ctype \
                or (e.code == 503 and not e.headers.get("Retry-After")):
            if hard is not None and len(hard) < 5:
                hard.append(f"{e.code} {ctype} "
                            f"{body[:300].decode(errors='replace')}")
            return "hard_5xx"
        return "ogc_error"
    except (OSError, ValueError) as exc:
        if hard is not None and len(hard) < 5:
            hard.append(f"transport {exc!r:.200}")
        return "transport"


def run_chaos(env: SoakEnv, args):
    """Mixed GetMap / GetCoverage under injected faults: only clean or
    labelled answers, and the resilience machinery firing."""
    from gsky_tpu_torch.resilience import faults
    from gsky_tpu_torch.serving import ServingGateway

    server, host = env.server(gateway=ServingGateway())
    frac = np.linspace(0.0, 0.75, 4)
    hot = [(float(fx), float(fy)) for fx in frac for fy in frac]
    w = env.unit * 0.25
    dates = env.dates[:4]

    def getmap(fx, fy, date, whole=False):
        return env.getmap(host, "landsat_chaos", fx, fy, w, date, whole)

    # the hot tiles warmed fault-free: with cache_max_age 3 they expire
    # mid-run and failed re-renders fall back to a stale replay
    warm_bad = sum(classify(getmap(fx, fy, dates[0])) != "ok"
                   for fx, fy in hot)

    faults.configure(args.faults, seed=args.fault_seed)
    rng = np.random.default_rng(args.fault_seed)
    rng_lock = threading.Lock()
    counter = itertools.count()
    counts: dict = {}
    hard: list = []
    lock = threading.Lock()
    # a warm scene cache would absorb every decode after the first
    # lap, and the decode-site faults would never fire: empty it every
    # 2 s (LRU pressure, compressed)
    stop_churn = threading.Event()

    def churn_scene_cache():
        while not stop_churn.wait(2.0):
            server.executor.cache.clear()

    churner = threading.Thread(target=churn_scene_cache, daemon=True)
    churner.start()

    def one(_):
        i = next(counter)
        with rng_lock:
            fx, fy = (float(v) for v in rng.uniform(0.0, 0.75, 2))
        if i % 6 == 5:
            u = env.getcoverage(host, "landsat_chaos", fx * 2 / 3,
                                fy * 2 / 3, env.unit * 0.4, 512)
        elif i % 3 == 0:
            u = getmap(*hot[i // 3 % len(hot)], dates[0])
        else:
            u = getmap(fx, fy, dates[i % len(dates)], whole=True)
        c = classify(u, hard)
        with lock:
            counts[c] = counts.get(c, 0) + 1

    t_end = time.time() + args.seconds
    try:
        with cf.ThreadPoolExecutor(args.conc) as ex:
            while time.time() < t_end:
                list(ex.map(one, range(args.conc * 4)))
    finally:
        stop_churn.set()
        churner.join(10)
        faults.configure(None)

    # stale-on-error, deterministically: refresh one tile, let its TTL
    # lapse, take the backends down hard: the gateway must answer with
    # the expired bytes as a labelled 200
    u0 = getmap(*hot[0], dates[0])
    refresh_cls = classify(u0)
    time.sleep(3.5)                       # past the TTL, in the grace
    server.executor.cache.clear()
    faults.configure("mas:error:1.0,decode:error:1.0", seed=1)
    try:
        stale_cls = classify(u0)
    finally:
        faults.configure(None)

    res = fetch_json(host, "/debug").get("resilience", {})
    breakers = res.get("breakers", {})
    metrics = check_metrics(host)
    trace_rep = slowest_trace_report(host)
    out = {
        "scenario": "chaos", "device": str(env.device),
        "faults": args.faults, "metrics": metrics,
        "slowest_trace": trace_rep, "warm_failures": warm_bad,
        "responses": counts, "hard_answers": hard,
        "stale_on_error": {"refresh": refresh_cls, "replay": stale_cls},
        "resilience": {
            "retries": res.get("retries", {}),
            "retry_exhausted": res.get("retry_exhausted", {}),
            "faults_injected": res.get("faults_injected", {}),
            "degraded_responses": res.get("degraded_responses", 0),
            "breaker_failures": {n: b.get("failures", 0)
                                 for n, b in breakers.items()}},
        "pool": pool_stats(server),
    }
    ok = (warm_bad == 0
          and counts.get("hard_5xx", 0) == 0
          and counts.get("transport", 0) == 0
          and counts.get("ok", 0) > 0
          and refresh_cls in ("ok", "degraded")
          and stale_cls == "degraded"
          and sum(res.get("retries", {}).values()) > 0
          and sum(res.get("faults_injected", {}).values()) > 0
          and res.get("degraded_responses", 0) > 0
          and not metrics["missing"]
          and any(b.get("failures", 0) > 0 for b in breakers.values()))
    return out, ok


def run_burst(env: SoakEnv, args):
    """Prewarm, a warm lap, then a storm of distinct tiles at four
    widths: no kernel build, load or first launch during the storm, and
    the staged path's stages overlapping."""
    from gsky_tpu_torch.pipeline.waves import reset_waves
    from gsky_tpu_torch.server.prewarm import compile_count, prewarm

    # the staged path and waves on, the wave cap and the prewarm's wave
    # sizes matched, and no superblock plans (`--scenario plan`'s)
    with EnvOverride(GSKY_TILE_PIPELINE=None, GSKY_WAVES=None,
                     GSKY_WAVE_MAX="4", GSKY_PREWARM_WAVE_SIZES="1,2,4",
                     GSKY_PLAN="0"):
        reset_waves()
        try:
            return _burst(env, args, compile_count, prewarm)
        finally:
            reset_waves()


def _burst(env, args, compile_count, prewarm):
    server, host = env.server(gateway=None)
    warm = prewarm(env.watcher.configs, server.executor)
    grid = 6
    frac = np.linspace(0.0, 0.75, grid)
    # the scenes sit in the extent's top ~77%: a y grid that starts
    # high enough keeps even the narrowest tile on data
    frac_y = np.linspace(0.1, 0.75, grid)
    tiles = [(float(fx), float(fy)) for fx in frac for fy in frac_y]
    widths = (0.17, 0.25, 0.33, 0.41)
    layers = ("landsat_burst", "landsat")

    def url_for(layer, fx, fy, wf=0.25):
        return env.getmap(host, layer, fx, fy, env.unit * wf,
                          env.dates[0])

    # the warm lap pays the host caches (geo transforms, scene decode
    # and upload); kernel loads here are reported but allowed
    warm_lap_bad = sum(not fetch_png(url_for(lay, *tiles[0]))
                       for lay in layers)
    warm_lap_compiles = compile_count() - warm["compiles"]

    c0 = compile_count()
    counter = itertools.count()
    bad = [0]
    n_by = {lay: 0 for lay in layers}
    lock = threading.Lock()

    def one(_):
        i = next(counter)
        lay = layers[i % len(layers)]
        wf = widths[i % len(widths)] if lay == "landsat_burst" else 0.25
        fx, fy = tiles[i % len(tiles)]
        # inside the extent: an off-world tile never reaches the stages
        fx, fy = min(fx, 1.0 - wf), min(fy, 1.0 - wf)
        ok = fetch_png(url_for(lay, fx, fy, wf))
        with lock:
            n_by[lay] += 1
            bad[0] += not ok

    t_end = time.time() + args.seconds
    with cf.ThreadPoolExecutor(args.conc) as ex:
        while time.time() < t_end:
            list(ex.map(one, range(args.conc * 4)))
    burst_compiles = compile_count() - c0
    n_done = sum(n_by.values())

    dbg = fetch_json(host, "/debug")
    ts = dbg.get("tile_stages", {})
    gates = ts.get("gates", {})
    pool = ts.get("encode_pool", {})
    overlap_hw = max([g.get("queue_max", 0) for g in gates.values()]
                     + [pool.get("queue_max", 0)])
    paged = (dbg.get("executor") or {}).get("paged") or {}
    ws = wave_stats_of(env.device)
    out = {
        "scenario": "burst", "device": str(env.device),
        "prewarm": warm,
        "warm_lap": {"failed": warm_lap_bad,
                     "compiles": warm_lap_compiles},
        "requests": n_by, "failed": bad[0],
        "burst_compiles": burst_compiles, "widths": widths,
        "paged": {k: paged.get(k) for k in ("engaged", "declined",
                                            "gated")},
        "waves": {k: ws.get(k) for k in
                  ("dispatches", "requests", "occupancy",
                   "staged_waves", "fallbacks")},
        "tile_stages": {
            "tiles": ts.get("tiles", 0),
            "gates": {n: {k: g.get(k) for k in
                          ("limit", "entries", "queue_max")}
                      for n, g in gates.items()},
            "encode_pool": {k: pool.get(k) for k in
                            ("workers", "encoded", "queue_max")}},
        "pool": pool_stats(server),
        "kernels": kernel_counts(dbg),
    }
    # waves on, the dispatch stage hands tiles to the scheduler instead
    # of its gate: either counts as the dispatch stage engaged
    dispatch_ok = (gates.get("dispatch", {}).get("entries", 0) > 0
                   or ws.get("dispatches", 0) > 0)
    ok = (warm["failures"] == 0 and warm_lap_bad == 0
          and n_done > 0 and bad[0] == 0
          and burst_compiles == 0
          and paged.get("engaged", 0) > 0
          and ts.get("tiles", 0) >= n_by["landsat_burst"]
          and gates.get("decode", {}).get("entries", 0) > 0
          and dispatch_ok
          and pool.get("encoded", 0) > 0
          and overlap_hw >= 2)
    return out, ok


def wave_stats_of(device) -> dict:
    """The wave scheduler's stats on ``device`` ({} before its first
    wave request)."""
    from gsky_tpu_torch.pipeline.waves import wave_stats
    for k, v in wave_stats().items():
        if k.split(":")[0] == device.type:
            return v
    return {}


def run_wave(env: SoakEnv, args):
    """A GetMap + WPS drill storm that coalesces into waves, a
    disconnect volley that cancels entries, and no pin left behind."""
    from gsky_tpu_torch.pipeline.waves import reset_waves

    # a wide tick gives concurrent requests a coalescing window
    with EnvOverride(GSKY_WAVES="1", GSKY_WAVE_MAX="8",
                     GSKY_WAVE_TICK_MS="100"):
        reset_waves()
        try:
            return _wave(env, args)
        finally:
            reset_waves()


def _wave(env, args):
    server, host = env.server(gateway=None)
    # distinct bboxes at one pixel shape, layer and time: every tile
    # stages its own page tables but shares the wave statics
    grid = 6
    frac = np.linspace(0.0, 0.6, grid)
    frac_y = np.linspace(0.1, 0.6, grid)
    tiles = [(float(fx), float(fy)) for fx in frac for fy in frac_y]
    w = env.unit * 0.2

    def getmap_url(k):
        return env.getmap(host, "landsat_burst", *tiles[k % len(tiles)],
                          w, env.dates[0])

    drill = env.drill_url(host)
    lock = threading.Lock()
    counter = itertools.count()
    errors: list = []

    def fetch(url: str, kind: str) -> bool:
        # no faults here: every answer must be a flat 200 with its body
        try:
            with urllib.request.urlopen(url, timeout=180) as r:
                body = r.read()
                if r.status != 200:
                    return False
                if kind == "map":
                    return body[:8] == PNG
                return b"ProcessSucceeded" in body
        except (OSError, ValueError) as exc:
            with lock:
                if len(errors) < 5:
                    errors.append(f"{kind}: {exc!r:.200}")
            return False

    warm_ok = fetch(getmap_url(0), "map") and fetch(drill, "wps")
    bad = [0]
    n_req = {"map": 0, "wps": 0}

    def one():
        i = next(counter)
        # drills a clustered minority: three at once share a tick
        kind, url = ("wps", drill) if i % 24 < 3 \
            else ("map", getmap_url(i))
        ok = fetch(url, kind)
        with lock:
            n_req[kind] += 1
            bad[0] += not ok

    storm(max(args.conc, 16), args.seconds, one)

    # requests dropped mid-flight must leave their wave (the
    # scheduler's `cancelled`); staggered holds cover the queued and
    # the in-wave windows
    h, _, p = host.partition(":")

    def disconnect_midflight(hold_s: float):
        path = getmap_url(next(counter)).split(host, 1)[1]
        try:
            s = socket.create_connection((h, int(p)), timeout=10)
            try:
                s.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                           "Connection: close\r\n\r\n").encode())
                time.sleep(hold_s)
            finally:
                s.close()
        except OSError:
            pass            # the volley is best-effort: counted below

    cancelled0 = wave_stats_of(env.device).get("cancelled", 0)
    cancel_seen = volleys = 0
    deadline = time.time() + 30
    while time.time() < deadline and cancel_seen < 1:
        # the reference's holds, and shorter ones: a card answers a
        # tile in tens of milliseconds
        ths = [threading.Thread(target=disconnect_midflight, args=(hold,))
               for hold in (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5,
                            0.8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(15)
        volleys += 1
        time.sleep(1.5)
        cancel_seen = wave_stats_of(env.device).get("cancelled", 0) \
            - cancelled0

    # every page the storm pinned must be back
    pinned = -1
    t_end = time.time() + 15
    while time.time() < t_end:
        pinned = server.executor.pool.stats()["pinned"]
        if pinned == 0:
            break
        time.sleep(0.5)

    ws = wave_stats_of(env.device)
    occ = ws.get("occupancy", {})
    max_occ = max([int(k) for k in occ] or [0])
    dispatches = ws.get("dispatches", 0)
    requests = ws.get("requests", 0)
    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_request_seconds",
        "gsky_wave_dispatches_total", "gsky_wave_occupancy",
        "gsky_wave_requests_total"))
    trace_rep = slowest_trace_report(host)
    dbg = fetch_json(host, "/debug")
    out = {
        "scenario": "wave", "device": str(env.device),
        "warm_ok": warm_ok, "requests": n_req, "failed": bad[0],
        "errors": errors,
        "amortisation_x": round(requests / max(dispatches, 1), 2),
        "cancellation": {"seen": cancel_seen, "volleys": volleys},
        "pool_pinned": pinned, "pool": pool_stats(server),
        "waves": {k: ws.get(k) for k in
                  ("dispatches", "waves", "requests", "occupancy",
                   "cancelled", "fallbacks", "failed")},
        "metrics": metrics, "slowest_trace": trace_rep,
        "kernels": kernel_counts(dbg),
    }
    ok = (warm_ok and sum(n_req.values()) > 0 and bad[0] == 0
          and dispatches >= 1 and requests >= 3 * dispatches
          and max_occ >= 2 and cancel_seen >= 1 and pinned == 0
          and not metrics["missing"])
    return out, ok


def run_dap4(env: SoakEnv, args):
    """Concurrent ``dap4.ce`` subsets streamed off the export spool:
    bounded buffering, bounded RSS and card memory, byte-identical to
    the in-memory encode."""
    from gsky_tpu_torch.obs import metrics as om
    from gsky_tpu_torch.server import dap4

    with EnvOverride(GSKY_DAP_STREAM="1"):
        try:
            return _dap4(env, args, om, dap4)
        finally:
            om.reset_temporal()


def _dap4(env, args, om, dap4):
    server, host = env.server(gateway=None)
    lock = threading.Lock()
    counter = itertools.count()
    errors: list = []

    def fetch(url: str, want_body: bool = False):
        # a flat 200 DAP4 body: its type and a leading DMR that names a
        # Float32 variable
        try:
            with urllib.request.urlopen(url, timeout=180) as r:
                body = r.read()
                if r.status != 200 \
                        or r.headers.get_content_type() != dap4.CONTENT_TYPE \
                        or b"Float32" not in body[:2048]:
                    return None
                return body if want_body else True
        except (OSError, ValueError) as exc:
            with lock:
                if len(errors) < 5:
                    errors.append(f"{exc!r:.200}")
            return None

    # the warm lap and the escape hatch: streamed and GSKY_DAP_STREAM=0
    # bodies of one subset must be equal
    om.reset_temporal()
    warm_streamed = fetch(env.dap_url(host, 0), want_body=True)
    warm_ok = warm_streamed is not None
    streams_warm = om.temporal_stats().get("dap_streams", 0)
    with EnvOverride(GSKY_DAP_STREAM="0"):
        warm_ram = fetch(env.dap_url(host, 0), want_body=True)
    byte_identical = (warm_ok and warm_ram is not None
                      and warm_streamed == warm_ram)

    bad, n_done = [0], [0]
    mem = MemWatch(env.device, args.seconds)

    def one():
        ok = fetch(env.dap_url(host, next(counter)))
        with lock:
            n_done[0] += 1
            bad[0] += not ok
        mem.sample()

    storm(max(args.conc, 8), args.seconds, one)
    st = om.temporal_stats()
    memory, mem_ok = mem.report(args, peak=True)
    # the rechunker holds one chunk plus the row batch in flight: twice
    # the chunk ceiling bounds it with margin
    peak_buf = st.get("dap_peak_buffer_bytes", 0)
    buffer_ok = 0 < peak_buf <= 2 * dap4.MAX_CHUNK
    streamed_ok = (streams_warm >= 1
                   and st.get("dap_streams", 0) > streams_warm
                   and st.get("dap_streamed_bytes", 0) > 0)
    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_request_seconds",
        "gsky_dap_streamed_bytes_total"))
    dbg = fetch_json(host, "/debug")
    out = {
        "scenario": "dap4", "device": str(env.device),
        "warm_ok": warm_ok, "escape_hatch_byte_identical": byte_identical,
        "requests": n_done[0], "failed": bad[0], "errors": errors,
        "memory": memory, "temporal": st, "buffer_ok": buffer_ok,
        "metrics": metrics, "pool": pool_stats(server),
        "kernels": kernel_counts(dbg),
    }
    ok = (warm_ok and byte_identical and n_done[0] > 0 and bad[0] == 0
          and streamed_ok and buffer_ok and mem_ok
          and not metrics["missing"])
    return out, ok


RUNS = {"churn": run_churn, "hot": run_hot, "wcs": run_wcs,
        "chaos": run_chaos, "burst": run_burst, "wave": run_wave,
        "dap4": run_dap4}


def run(args) -> int:
    """One scenario over a fresh archive in a temporary directory: its
    JSON line, then SOAK PASSED or SOAK FAILED; 0 or 1."""
    from gsky_tpu_torch.device import resolve_device
    from gsky_tpu_torch.server.main import fix_mmap_threshold
    resolve_device(args.device)          # no CUDA: raise before writing
    # the process setting of the command line's server
    fix_mmap_threshold()
    root = tempfile.mkdtemp(prefix="gsky_soak_torch_")
    try:
        env = SoakEnv(root, args.scenes, args.shape, args.device)
        try:
            out, ok = RUNS[args.scenario](env, args)
        finally:
            env.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["scenes"], out["scene_shape"] = args.scenes, list(args.shape)
    print(json.dumps(out), flush=True)
    print("SOAK PASSED" if ok else "SOAK FAILED", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    # GSKY_TSAN=1: lockset tracking installed before the server builds
    # its locks; a race report fails the soak
    from gsky_tpu_torch.obs import tsan
    args = parse_args(argv)
    tsan.maybe_install()
    rc = run(args)
    if tsan.installed():
        stats = tsan.tsan_stats()
        print(f"tsan: tracked_vars={stats['tracked_vars']} "
              f"races={stats['races']}", flush=True)
        if tsan.race_count():
            print(tsan.report(), file=sys.stderr)
            print("SOAK FAILED (tsan races)", flush=True)
            return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
