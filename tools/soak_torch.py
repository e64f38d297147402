#!/usr/bin/env python3
"""Soak the PyTorch/CUDA port's in-process OWS server.

The port's counterpart of ``tools/soak.py``: a long-lived server under
concurrent distinct requests, held to the reference's bounds.  Fifteen
scenarios, each with the pass criteria and knobs of its reference
counterpart:

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

``--scenario overload``: the process-wide gateway's adaptive admission
(``GSKY_ADMIT_ADAPTIVE=1``, ``GSKY_ADMIT_WMS=4``,
``GSKY_ADMIT_QUEUE_S=1.0``, ``GSKY_ADMIT_INTERVAL_S=0.2``, tenants
``key:bulk:0.25,key:premium:4``) through a serial warm lap of 6, a
two-tenant storm at ``max(--conc, 10)``, a cooldown, a disconnect
volley (holds 0.3-0.75 s over a 400 ms injected decode and an empty
scene cache), a forced brownout (pressure 1, then 2) and a recovery:
no bare 5xx or dropped connection, 6 warm answers, at least one shed
and every shed a 503 with ``Retry-After``, an AIMD adjustment, a
cancellation and every class drained, a ``brownout`` label, the
effective limit clamped to half, 3 of 3 clean after, and
``gsky_admit_limit``, ``gsky_cancelled_total``, ``gsky_pressure_state``
in a strict ``/metrics``.

``--scenario ingest``: a pan-and-zoom walk (8 steps along a row of a
16 x 16 grid, then 2 halvings) of temporal-range GetMaps over three
legs, each with its own server (closed before the next), ingest
counters, sources, staging pool and planner: whole files
(``GSKY_INGEST=0``), ranged windows (``GSKY_INGEST_WINDOW_FRAC=0.5``)
and the prefetch planner after a priming lap: every answer a 200 PNG,
the ranged leg reading fewer bytes than the whole-file leg, the
planner's hit rate at least 0.5, the ingest families in ``/metrics``.

``--scenario fleet``: three worker nodes (``python -m
gsky_tpu_torch.worker.server -device`` the soak's device, `Nodes`)
behind a ``fleet`` namespace's router: a locality baseline, a node
SIGKILLed under load, revived on its port and re-admitted healthy, a
re-home lap and a recovery; then hedged ``worker_info`` calls against
a node slowed by ``node:slow:250ms``: no bare 5xx, answers during the
kill, a reroute, locality over 1/3 and recovering to 0.9 of it,
``gsky_worker_rpc_seconds``, a trace stitched across the process
boundary, hedged p99 under unhedged.  The nodes' VmRSS and launch
counts are reported, not bounded; every node is killed at the end.

``--scenario occupancy``: a GetMap + WPS drill storm (``landsat_burst``
at the first date, a drill in eight requests) on the wave path
(``GSKY_WAVE_MAX=8``, ``GSKY_WAVE_TICK_MS=10``, ``GSKY_WAVE_QUEUE=2``)
with the synchronous ticker (``GSKY_WAVE_PIPELINE=0``) and pipelined,
each leg ``max(8, --seconds / 2)`` s in four rounds taken in turns, a
fresh scheduler a round: no failed request, 3+ gap samples a leg, a
wave staged ahead of dispatch, the pipelined leg's p99 inter-wave gap
below the synchronous one's (or at most 2 ms), each round's lead-in
(its warm tile's wave to the storm's first) left out of its gaps, no
pin, the wave-gap families in a strict ``/metrics``.

``--scenario algebra``: ``landsat_algebra`` GetMaps in its twelve
sources (``GSKY_EXPR_FUSE=1``, ``GSKY_WAVE_TICK_MS=100``,
``GSKY_PAGE_SLOTS=16``) with an ``algebraDrill`` in sixteen: a warm lap
of every style, no failed request, fused requests, the expression
cache's misses at most the sources and under its hits, at most one
fused program a structure (``programs``: the distinct fingerprints
launched through the fused epilogue, `ops.paged.note_expr_program`;
not compiled programs, since the port's fused epilogue is one CUDA
kernel for every structure), a concurrent volley of six tiles
byte-identical with ``GSKY_EXPR_FUSE=0`` and counted unfused (the
volley's sources those over fewer products first, and some of its
tiles holding data: stricter than the reference, whose volley at the
first date is all nodata, C.27), no pin, the expression families in a
strict ``/metrics``.

``--scenario animation``: APNG sequences of ``landsat`` over every date
(``GSKY_ANIM=1``, ``GSKY_WAVE_TICK_MS=100``), an mp4 request in ten: the
serial warm sequence's frames in at most half as many waves, every
answer a 200 APNG (signature, ``acTL``) of every frame
(``X-Gsky-Anim-Frames``), the mp4 ones labelled ``apng-stub``, a
disconnect volley cancelling a sequence or its lanes, no pin, the
animation families in a strict ``/metrics``.

``--scenario fabric``: two gateway replicas (a response cache and a
``ReplayFabric`` each) over a ``fabric`` namespace of three worker nodes
(`Nodes`, ``GSKY_FABRIC=1``, the other nodes their page peers, a page
journal each): a Zipf storm across both gateways at ``min(--conc, 4)``
for ``max(8, --seconds / 2)`` s, every hot tile fetched from B; A
replaced by a cold replica that fetches each tile twice; a seed lap of
``/ows`` tiles on B stages B's pool, a page peer in this process (the
real worker RPC, `page_peer`) serves it, and a node SIGKILLed and
revived with that peer refills over ``page_fetch``; ``GSKY_FABRIC=0``
against a fabric-less server.  No bare 5xx or dropped connection, a
replay rate of at least 0.5 with answers labelled ``X-Gsky-Cache:
peer``, ``peer_filled`` at least half of the revived node's
``rehydrated``, the escape hatch byte-identical and dormant, the fabric
families in a strict ``/metrics`` and a ``/debug`` ``fabric`` block.

``--scenario elastic``: the autoscaler (``min_nodes=2``,
``max_nodes=4``, thresholds 0.5 / 0.2, ``node_conc=1``, the reference's
arguments) over `LocalSubprocessProvider` nodes (a page journal each,
their page peer the one in this process, up before the first boots:
C.28): a ramp at 2, 4 then 8 clients, two preemptions with a 6 s grace
under load at 4, the floor refilled, a third member at 8 clients
(C.29), a steady phase at 4 and a quiet one, and
``GSKY_ELASTIC=0``.  No bare 5xx or dropped connection, an up and a
down decision, a join gated on readiness, both preemptions noticed,
purged and counted (one graceful at least), the hand-off's ``filled``
at least its ``cold``, the steady p99 under 90 s, the escape hatch
byte-identical with no elastic family or ``/debug`` block, the elastic
families in a strict ``/metrics``.  Both report each node's VmRSS,
each boot's first ``worker_info`` (``boot_pools``) and the nodes'
launches (``node_kernels``).

Each scenario from ``overload`` on names its failed criteria in the
JSON's ``unmet`` and reports, on a card, ``memory_allocated`` and
``memory_reserved`` of the serving process at its start and end.

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

SCENARIOS = ("churn", "hot", "wcs", "chaos", "burst", "wave", "dap4",
             "overload", "ingest", "fleet", "occupancy", "algebra",
             "animation", "fabric", "elastic")
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
    (tiled 2 x 2), the band-algebra layer ``landsat_algebra`` (its
    default ``nd`` and eleven ``name = expr`` styles over the first two
    products) and the ``geometryDrill`` and ``algebraDrill``
    processes.  Returns the extent the requests cover, in EPSG:3857."""
    from gsky_tpu_torch.geo.crs import EPSG3857, EPSG4326
    from gsky_tpu_torch.geo.transform import BBox, transform_bbox

    h, w = shape
    prods = [product(k) for k in range(N_PRODUCTS)]
    p0, p1 = prods[:2]
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
         "wcs_max_tile_width": 128, "wcs_max_tile_height": 128},
        {"name": "landsat_algebra", "title": "algebra soak",
         "data_source": root,
         "rgb_products": [f"nd = ({p0} - {p1}) / ({p0} + {p1})"],
         "time_generator": "mas", "styles": algebra_styles(p0, p1)}]
    processes = [{
        "identifier": "geometryDrill", "title": "Geometry drill",
        "max_area": 10000,
        "data_sources": [{"data_source": root, "rgb_products": prods}],
        "approx": False},
        # the drill minority evaluates band expressions per date
        {"identifier": "algebraDrill", "title": "Band-algebra drill",
         "max_area": 10000,
         "data_sources": [{"data_source": root, "rgb_products": [
             f"nd = ({p0} - {p1}) / ({p0} + {p1})",
             f"dif = abs({p0} - {p1})"]}],
         "approx": False}]
    os.makedirs(conf_dir, exist_ok=True)
    with open(os.path.join(conf_dir, "config.json"), "w") as fp:
        json.dump({"service_config": {"ows_hostname": "",
                                      "mas_address": ""},
                   "layers": layers, "processes": processes}, fp)
    return transform_bbox(transform_bbox(core, utm, EPSG4326),
                          EPSG4326, EPSG3857)


def algebra_styles(p0: str, p1: str):
    """The reference's eleven single-entry ``name = expr`` styles over
    products ``p0`` and ``p1``: ten structures across twelve sources
    with the layer's default, since ``nd_rev`` (renamed variables) and
    ``mask2`` (a shifted constant) are twins of ``nd`` and ``mask1``
    and share their fingerprints."""
    return [{"name": name, "rgb_products": [src]} for name, src in (
        ("nd_rev", f"nd_rev = ({p1} - {p0}) / ({p1} + {p0})"),
        ("mask1", f"mask1 = {p0} > 1200 ? {p1} : {p0}"),
        ("mask2", f"mask2 = {p0} > 1800 ? {p1} : {p0}"),
        ("blend", f"blend = 0.5 * {p0} + 0.5 * {p1}"),
        ("root", f"root = sqrt({p0} * {p1})"),
        ("dif", f"dif = abs({p0} - {p1})"),
        ("logr", f"logr = log({p0} + 1000)"),
        ("gate", f"gate = {p0} > 500 && {p1} > 500 ? {p0} + {p1} : 0"),
        ("quant", f"quant = floor({p0} / 16) * 16"),
        ("clip", f"clip = min(max({p0}, 400), 2600)"),
        ("curve", f"curve = pow({p0} / 3000, 2) * 3000"))]


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
        # on a card each server prewarms before it listens; False skips
        # it (the worker nodes a scenario starts prewarm as the command
        # line's do, unless GSKY_PREWARM=0)
        self.prewarm = True
        self._served = []

    def server(self, gateway=None, metrics=None, fabric=None):
        """(OWSServer, "host:port") serving this archive on a thread;
        ``gateway`` None serves every request raw; ``metrics`` its
        records' sink (a fresh `MetricsLogger` by default); ``fabric``
        its replay ring (a `fabric.replay.ReplayFabric`; None: none).
        On a card the kernels are built, loaded and launched before it
        listens, as the command line's server does (`server.prewarm`):
        a first request that waited for nvcc took up to 30 s, past the
        layers' 20 s WMS deadline."""
        from gsky_tpu_torch.server.metrics import MetricsLogger
        from gsky_tpu_torch.server.ows import OWSServer
        from gsky_tpu_torch.server.prewarm import prewarm_from_watcher
        srv = OWSServer(self.watcher, mas_factory=lambda a: self.mas,
                        device=self.device, gateway=gateway,
                        metrics=metrics or MetricsLogger(), fabric=fabric)
        if self.device.type == "cuda" and self.prewarm:
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

    def overload_url(self, host: str, i: int) -> str:
        """The overload's ``i``-th GetMap: a multiplicative-hash bbox
        (~4096 distinct values an axis, so that every request is an
        uncached render and admission gates real work, not
        response-cache hits, which bypass it) 0.22 of `unit` wide, at
        date ``i`` of the first four."""
        fx = 0.75 * ((i * 2654435761) % 4096) / 4096.0
        fy = 0.75 * ((i * 1597334677) % 4096) / 4096.0
        return self.getmap(host, "landsat", fx, fy, self.unit * 0.22,
                           self.dates[i % min(4, len(self.dates))])

    def fleet_namespace(self, nodes, name: str = "fleet") -> None:
        """Write the namespace ``name`` (its layer ``landsat_<name>``
        over the soak's products, ``worker_nodes`` ``nodes``), in a
        directory of its own so that its nodes reach no other layer, and
        reload; ``nodes`` None removes it."""
        d = os.path.join(self.conf_dir, name)
        if nodes is None:
            shutil.rmtree(d, ignore_errors=True)
        else:
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "config.json"), "w") as fp:
                json.dump({
                    "service_config": {"ows_hostname": "",
                                       "mas_address": "",
                                       "worker_nodes": list(nodes)},
                    "layers": [{
                        "name": f"landsat_{name}",
                        "title": f"{name} soak",
                        "data_source": self.root,
                        "rgb_products": [product(k)
                                         for k in range(N_PRODUCTS)],
                        "time_generator": "mas", "wms_timeout": 120,
                        "wcs_max_width": 4096, "wcs_max_height": 4096,
                        "wcs_max_tile_width": 256,
                        "wcs_max_tile_height": 256}]}, fp)
        self.watcher.reload()

    def fleet_tiles(self, n: int = 3):
        """The fleet's fixed ``n`` x ``n`` grid of (fx, fy) (the
        fabric's is 4 x 4)."""
        frac = np.linspace(0.0, 0.75, n)
        return [(float(fx), float(fy)) for fx in frac for fy in frac]

    def fleet_url(self, host: str, tile, layer: str = "landsat_fleet",
                  ns: str = "/fleet") -> str:
        """A fleet tile, a quarter of `unit` wide at the first date."""
        return (f"http://{host}/ows{ns}?service=WMS&request=GetMap"
                f"&version=1.3.0&layers={layer}&crs=EPSG:3857"
                f"&bbox={self.bbox(*tile, self.unit * 0.25)}&width=256"
                f"&height=256&format=image/png&time={iso(self.dates[0])}")

    def drill_url(self, host: str, identifier: str = "geometryDrill",
                  at=(0.35, 0.25)) -> str:
        """WPS ``identifier`` over one small polygon (lon/lat) whose
        corner lies at ``at``: fractions of the extent from its west
        and its north edge (the reference's geometryDrill inside the
        first scene by default, its algebraDrill at (0.40, 0.45), where
        the first two scenes overlap)."""
        from gsky_tpu_torch.geo.crs import EPSG3857, EPSG4326
        from gsky_tpu_torch.geo.transform import transform_bbox
        ll = transform_bbox(self.merc, EPSG3857, EPSG4326)
        d = 0.03 * min(1.0, (ll.xmax - ll.xmin) / 0.6)
        x0 = ll.xmin + at[0] * (ll.xmax - ll.xmin)
        y0 = ll.ymax - at[1] * (ll.ymax - ll.ymin)
        geom = json.dumps({"type": "FeatureCollection", "features": [{
            "type": "Feature", "geometry": {
                "type": "Polygon", "coordinates": [[
                    [x0, y0], [x0 + d, y0], [x0 + d, y0 + d],
                    [x0, y0 + d], [x0, y0]]]}}]})
        return (f"http://{host}/ows?service=WPS&request=Execute"
                f"&identifier={identifier}"
                f"&datainputs=geometry={urllib.parse.quote(geom)}")

    def algebra_tiles(self):
        """The algebra's 8 x 4 grid of (fx, fy), fractions of the whole
        extent where the first two scenes overlap at any scene size
        (the reference's ``xs`` 0.30-0.58 by 0.04, ``ys`` 0.32-0.68)."""
        xs = np.arange(0.30, 0.62, 0.04)
        ys = (0.32, 0.44, 0.56, 0.68)
        return [(float(fx), float(fy)) for fy in ys for fx in xs]

    def algebra_url(self, host: str, style: str, tile) -> str:
        """A ``landsat_algebra`` GetMap in ``style`` ("" the layer's
        default), 0.12 of `unit` wide, at the first date."""
        return (f"http://{host}/ows?service=WMS&request=GetMap"
                f"&version=1.3.0&layers=landsat_algebra&styles={style}"
                f"&crs=EPSG:3857"
                f"&bbox={self.bbox(*tile, self.unit * 0.12, whole=True)}"
                f"&width=256&height=256&format=image/png"
                f"&time={iso(self.dates[0])}")

    def anim_tiles(self):
        """The animation's 5 x 5 grid of (fx, fy)."""
        frac = np.linspace(0.0, 0.6, 5)
        frac_y = np.linspace(0.1, 0.6, 5)
        return [(float(fx), float(fy)) for fx in frac for fy in frac_y]

    def anim_url(self, host: str, tile, fmt: str = "image/apng") -> str:
        """A ``landsat`` animation over a TIME list of every date, 0.2
        of `unit` wide, in ``fmt``."""
        times = ",".join(iso(d) for d in self.dates)
        return (f"http://{host}/ows?service=WMS&request=GetMap"
                f"&version=1.3.0&layers=landsat&crs=EPSG:3857"
                f"&bbox={self.bbox(*tile, self.unit * 0.2)}&width=256"
                f"&height=256&format={fmt}&time={times}")

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

    def release(self, server) -> None:
        """Stop and close one server this environment booted."""
        for item in [it for it in self._served if it[0] is server]:
            self._served.remove(item)
            _stop(*item)

    def close(self) -> None:
        for item in self._served:
            _stop(*item)
        self._served.clear()


def _stop(srv, httpd) -> None:
    httpd.shutdown()
    httpd.server_close()
    srv.close()


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


def disconnect_volleys(host: str, path_of, holds, seen,
                       deadline_s: float = 30.0):
    """Volleys of requests whose clients hang up after each of
    ``holds`` seconds (``path_of()`` gives each one's path), until
    ``seen()`` counts a cancellation or ``deadline_s`` passes; 1.5 s
    after each volley for the server to notice.  (seen, volleys)."""
    h, _, p = host.partition(":")

    def one(hold_s: float):
        path = path_of()
        try:
            s = socket.create_connection((h, int(p)), timeout=10)
            try:
                s.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                           "Connection: close\r\n\r\n").encode())
                time.sleep(hold_s)
            finally:
                s.close()
        except OSError:
            pass            # the volley is best-effort: counted by seen()

    n_seen = volleys = 0
    deadline = time.time() + deadline_s
    while time.time() < deadline and n_seen < 1:
        ths = [threading.Thread(target=one, args=(hold,)) for hold in holds]
        for t in ths:
            t.start()
        for t in ths:
            t.join(15)
        volleys += 1
        time.sleep(1.5)
        n_seen = seen()
    return n_seen, volleys


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


def classify(url: str, hard=None, need_retry_after: bool = True) -> str:
    """ok (clean 2xx), degraded (2xx with X-GSKY-Degraded), ogc_error
    (an OGC exception, not a 500), hard_5xx (a bare 500, a body that is
    not OGC XML or, with ``need_retry_after``, a 503 without
    Retry-After) or transport (a dropped connection).  A hard answer's
    status and body head go to ``hard`` (a list, its first 5 kept)."""
    return classify_answer(url, hard, need_retry_after)[0]


def classify_answer(url: str, hard=None, need_retry_after: bool = True,
                    timeout: float = 120.0):
    """(`classify`'s class, the answer's ``X-Gsky-Cache``, its body);
    the body is empty unless the class is ok or degraded."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            degraded = r.headers.get("X-GSKY-Degraded")
            body = r.read()
            return ("degraded" if degraded else "ok",
                    r.headers.get("X-Gsky-Cache", ""), body)
    except urllib.error.HTTPError as e:
        ctype = e.headers.get("Content-Type", "")
        body = e.read()
        if e.code == 500 or "vnd.ogc.se_xml" not in ctype \
                or (need_retry_after and e.code == 503
                    and not e.headers.get("Retry-After")):
            if hard is not None and len(hard) < 5:
                hard.append(f"{e.code} {ctype} "
                            f"{body[:300].decode(errors='replace')}")
            return "hard_5xx", "", b""
        return "ogc_error", "", b""
    except (OSError, ValueError) as exc:
        if hard is not None and len(hard) < 5:
            hard.append(f"transport {exc!r:.200}")
        return "transport", "", b""


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
    # the in-wave windows: the reference's, and shorter ones, since a
    # card answers a tile in tens of milliseconds
    cancelled0 = wave_stats_of(env.device).get("cancelled", 0)
    cancel_seen, volleys = disconnect_volleys(
        host, lambda: getmap_url(next(counter)).split(host, 1)[1],
        (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.8),
        lambda: wave_stats_of(env.device).get("cancelled", 0) - cancelled0)

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


# -- overload, ingest, fleet -----------------------------------------------

def card_memory(device):
    """``memory_allocated`` and ``memory_reserved`` of this process in
    MiB on a card; None elsewhere."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return {"allocated_mb": round(device_mb(device), 1),
            "reserved_mb": round(torch.cuda.memory_reserved(device)
                                 / float(1 << 20), 1)}


def settled_pool(server, timeout: float = 15.0) -> dict:
    """`pool_stats` once nothing is pinned, or when ``timeout`` ends."""
    t_end = time.time() + timeout
    while True:
        st = pool_stats(server)
        if st["pinned"] == 0 or time.time() > t_end:
            return st
        time.sleep(0.25)


def status_logger():
    """A `MetricsLogger` that also keeps each logged request's status
    (``status``: raw URL -> HTTP status; a request whose client went
    away is not logged)."""
    from gsky_tpu_torch.server.metrics import MetricsLogger

    class StatusLog(MetricsLogger):
        def __init__(self):
            super().__init__()
            self.status = {}

        def write(self, info):
            self.status[info["url"]["raw_url"]] = info["http_status"]
            super().write(info)

    return StatusLog()


# the reference's overload knobs (`tools/soak.py` run_overload): a small
# WMS ceiling and a short queue deadline so that the storm queues and
# sheds, a fast AIMD cadence, distinct weights for the two tenants
OVERLOAD_KNOBS = {"GSKY_ADMIT_ADAPTIVE": "1", "GSKY_ADMIT_WMS": "4",
                  "GSKY_ADMIT_QUEUE_S": "1.0",
                  "GSKY_ADMIT_INTERVAL_S": "0.2",
                  "GSKY_TENANT_WEIGHTS": "key:bulk:0.25,key:premium:4"}
VOLLEY_HOLDS = (0.3, 0.3, 0.45, 0.45, 0.6, 0.6, 0.75, 0.75)
VOLLEY_FAULTS = "decode:latency:400ms:1.0"
def verdict(out: dict, checks: dict) -> bool:
    """A scenario's pass criteria by name: those that do not hold into
    ``out["unmet"]``; whether every one holds."""
    out["unmet"] = [k for k, held in checks.items() if not held]
    return not out["unmet"]


# the reference's shortest storm, cooldown and critical phases, and
# its wait for the volley's permits to come back (s)
OVERLOAD_MIN_S = {"storm": 8.0, "cooldown": 3.0, "critical": 4.0}
OVERLOAD_DRAIN_S = 20.0


def run_overload(env: SoakEnv, args):
    """Adaptive admission under a two-tenant storm, client disconnects
    handing their permits back, a forced brownout, a clean recovery.
    The server is fronted by the process-wide `default_gateway`, so
    that ``gsky_admit_limit`` reads the admission it uses; the knobs are
    restored and admission reconfigured from them after the run."""
    from gsky_tpu_torch.resilience.pressure import default_monitor
    from gsky_tpu_torch.serving import default_gateway

    adm = default_gateway.admission
    mon = default_monitor()
    try:
        with EnvOverride(**OVERLOAD_KNOBS):
            adm.reconfigure()
            mon.force(None)
            return _overload(env, args, default_gateway, mon)
    finally:
        mon.force(None)
        adm.reconfigure()


def _overload(env, args, gateway, mon):
    from gsky_tpu_torch.resilience import cancel_stats, faults

    adm = gateway.admission
    adjustments0 = adm.total_adjustments
    log = status_logger()
    mem0 = card_memory(env.device)
    server, host = env.server(gateway=gateway, metrics=log)
    counter = itertools.count()
    lock = threading.Lock()
    shed_meta = {"sheds": 0, "missing_retry_after": 0}
    hard: list = []

    def url_for(i: int) -> str:
        return env.overload_url(host, i)

    def classify_shed(url: str, headers=None) -> str:
        # no faults in the storm: every 503 is an admission shed, and
        # it must carry Retry-After
        req = urllib.request.Request(url, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                degraded = r.headers.get("X-GSKY-Degraded")
                r.read()
                return "degraded" if degraded else "ok"
        except urllib.error.HTTPError as e:
            ctype = e.headers.get("Content-Type", "")
            retry = e.headers.get("Retry-After")
            body = e.read()
            if e.code == 500 or "vnd.ogc.se_xml" not in ctype:
                with lock:
                    if len(hard) < 5:
                        hard.append(f"{e.code} {ctype} "
                                    f"{body[:300].decode(errors='replace')}")
                return "hard_5xx"
            if e.code == 503:
                with lock:
                    shed_meta["sheds"] += 1
                    if not retry:
                        shed_meta["missing_retry_after"] += 1
            return "ogc_error"
        except (OSError, ValueError) as exc:
            with lock:
                if len(hard) < 5:
                    hard.append(f"transport {exc!r:.200}")
            return "transport"

    def drive(seconds: float, conc: int, counts: dict):
        tenants = ("premium", "bulk")

        def one(_):
            i = next(counter)
            c = classify_shed(url_for(i),
                              {"X-API-Key": tenants[i % len(tenants)]})
            with lock:
                counts[c] = counts.get(c, 0) + 1

        t_end = time.time() + seconds
        with cf.ThreadPoolExecutor(conc) as ex:
            while time.time() < t_end:
                list(ex.map(one, range(conc * 2)))

    # 1: a serial warm lap sets the AIMD latency baseline low, so that
    # the contended storm after it reads as a knee
    warm_counts: dict = {}
    for _ in range(6):
        c = classify_shed(url_for(next(counter)))
        warm_counts[c] = warm_counts.get(c, 0) + 1

    # 2: a two-tenant storm well past the limit: contended renders
    # inflate service time (decrease), queue waits past the deadline
    # shed as clean 503s
    storm_counts: dict = {}
    t0 = time.time()
    drive(max(args.seconds * 0.4, OVERLOAD_MIN_S["storm"]),
          max(args.conc, 10), storm_counts)
    storm_s = time.time() - t0

    # 3: cooldown, light serial load: room for additive recovery
    cool_counts: dict = {}
    t_end = time.time() + max(args.seconds * 0.15,
                              OVERLOAD_MIN_S["cooldown"])
    while time.time() < t_end:
        c = classify_shed(url_for(next(counter)))
        cool_counts[c] = cool_counts.get(c, 0) + 1
    adjustments = adm.total_adjustments

    # 4: a disconnect volley: renders slowed past the shortest holds
    # (injected decode latency, an empty scene cache), then aborted
    # mid-flight; each request's token must fire and its permit (or
    # queue slot) come back
    h, _, p = host.partition(":")
    fired0 = cancel_stats()["fired"] + adm.total_cancelled
    volley: list = []
    refused = [0]

    def disconnect_midflight(hold_s: float):
        # the default size: an oversized request is refused before
        # admission with nothing to cancel
        path = url_for(next(counter)).split(host, 1)[1]
        with lock:
            volley.append((hold_s, path))
        try:
            s = socket.create_connection((h, int(p)), timeout=10)
            try:
                s.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
                           "Connection: close\r\n\r\n").encode())
                time.sleep(hold_s)
            finally:
                s.close()
        except OSError:
            with lock:
                refused[0] += 1

    server.executor.cache.clear()
    faults.configure(VOLLEY_FAULTS, seed=5)
    try:
        ths = [threading.Thread(target=disconnect_midflight, args=(hold,))
               for hold in VOLLEY_HOLDS]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
    finally:
        faults.reset()
    cancel_seen = 0
    drained = False
    t_end = time.time() + OVERLOAD_DRAIN_S
    while time.time() < t_end:
        cancel_seen = (cancel_stats()["fired"] + adm.total_cancelled
                       - fired0)
        drained = all(c["in_use"] == 0 and c["queued"] == 0
                      for c in adm.stats()["classes"].values())
        if drained and cancel_seen >= 1:
            break
        time.sleep(0.5)
    # each hold's request as the server logged it: the status where the
    # render beat the hold; a request whose token fired is not logged
    # (its answer has no client), so once drained "cancelled"
    holds = [{"hold_s": hold, "answer": log.status.get(
        path, "cancelled" if drained else None)}
        for hold, path in sorted(volley)]

    # 5: a forced brownout: elevated pressure labels fresh renders
    # degraded; critical pressure clamps the effective limit and still
    # answers
    mon.force(1)
    brown_hdr = 0
    brown_counts: dict = {}
    crit_counts: dict = {}
    clamped = False
    wms: dict = {}
    try:
        for _ in range(4):
            req = urllib.request.Request(url_for(next(counter)))
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    tag = r.headers.get("X-GSKY-Degraded") or ""
                    r.read()
                    if "brownout" in tag:
                        brown_hdr += 1
                    k = "degraded" if tag else "ok"
                    brown_counts[k] = brown_counts.get(k, 0) + 1
            except (OSError, ValueError):
                brown_counts["error"] = brown_counts.get("error", 0) + 1
        mon.force(2)
        wms = adm.stats()["classes"]["WMS"]
        clamped = wms["effective_limit"] <= max(1, wms["limit"] // 2)
        drive(max(args.seconds * 0.2, OVERLOAD_MIN_S["critical"]),
              max(args.conc, 8), crit_counts)
    finally:
        mon.force(None)

    # 6: recovery: the falling hysteresis waited out (state(), not
    # stats(), recomputes the falling edge), then serial renders clean
    t_end = time.time() + 15
    while time.time() < t_end and mon.state() != 0:
        time.sleep(0.25)
    rec_ok = sum(classify_shed(url_for(next(counter))) == "ok"
                 for _ in range(3))

    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_request_seconds",
        "gsky_stage_seconds", "gsky_admit_limit", "gsky_cancelled_total",
        "gsky_pressure_state"))
    trace_rep = slowest_trace_report(host)
    dbg = fetch_json(host, "/debug")
    all_counts: dict = {}
    for d in (warm_counts, storm_counts, cool_counts, brown_counts,
              crit_counts):
        for k, v in d.items():
            all_counts[k] = all_counts.get(k, 0) + v
    out = {
        "scenario": "overload", "device": str(env.device),
        "phases": {"warm": warm_counts, "storm": storm_counts,
                   "storm_conc": max(args.conc, 10),
                   "storm_s": round(storm_s, 1),
                   "cooldown": cool_counts, "brownout": brown_counts,
                   "critical": crit_counts, "recovery_ok": rec_ok},
        "sheds": shed_meta, "hard_answers": hard,
        "adjustments": adjustments,
        "adjustments_since_reconfigure": adjustments - adjustments0,
        "cancellation": {"fired": cancel_seen, "drained": drained,
                         "holds": holds, "refused": refused[0]},
        "brownout_labelled": brown_hdr,
        "pressure_clamped": clamped,
        "clamp": {k: wms.get(k) for k in ("limit", "effective_limit")},
        "admission": adm.stats(), "cancel": cancel_stats(),
        "pressure": mon.stats(), "metrics": metrics,
        "slowest_trace": trace_rep,
        "pool": settled_pool(server), "kernels": kernel_counts(dbg),
    }
    if mem0 is not None:
        out["card_memory"] = {"start": mem0,
                              "end": card_memory(env.device)}
    return out, verdict(out, {
        "no_hard_5xx": all_counts.get("hard_5xx", 0) == 0,
        "no_transport": all_counts.get("transport", 0) == 0,
        "some_ok": all_counts.get("ok", 0) > 0,
        "warm_lap": warm_counts.get("ok", 0) == 6,
        "shed": shed_meta["sheds"] >= 1,
        "retry_after": shed_meta["missing_retry_after"] == 0,
        "adjusted": adjustments >= 1,
        # the reference's count includes the reconfigure's own change
        # of ceiling: the controller must have moved after it
        "adjusted_since_reconfigure": adjustments - adjustments0 >= 1,
        "cancelled": cancel_seen >= 1,
        "drained": drained,
        "brownout_labelled": brown_hdr >= 1,
        "clamped": clamped,
        "recovery": rec_ok == 3,
        "metrics": not metrics["missing"]})


INGEST_KEYS = ("GSKY_INGEST", "GSKY_PREFETCH", "GSKY_INGEST_WINDOW_FRAC",
               "GSKY_INGEST_WINDOW_PROMOTE")
INGEST_LEGS = {
    "baseline": {"GSKY_INGEST": "0", "GSKY_PREFETCH": "0",
                 "GSKY_INGEST_WINDOW_FRAC": "0",
                 "GSKY_INGEST_WINDOW_PROMOTE": "0"},
    "ranged": {"GSKY_INGEST": "1", "GSKY_PREFETCH": "0",
               "GSKY_INGEST_WINDOW_FRAC": "0.5",
               "GSKY_INGEST_WINDOW_PROMOTE": "0"},
    "prefetch": {"GSKY_INGEST": "1", "GSKY_PREFETCH": "1",
                 "GSKY_INGEST_WINDOW_FRAC": "0",
                 "GSKY_INGEST_WINDOW_PROMOTE": "0"}}
INGEST_TIME = "2020-01-09T00:00:00.000Z,2020-01-15T00:00:00.000Z"


def ingest_walk(env: SoakEnv):
    """The ingest walk's boxes (EPSG:3857): on a 16 x 16 grid over the
    `unit` square, eight pan steps one tile apart along its middle row,
    then two in-place halvings of the last tile."""
    grid = 16
    uh = env.merc.height * env.unit / env.merc.width
    tw, th = env.unit / grid, uh / grid
    x_min, y_min = env.merc.xmin, env.merc.ymax - uh
    j = grid // 2
    boxes = []
    for i in range(4, 12):                 # pan: one row, a visit a tile
        x0, y0 = x_min + i * tw, y_min + j * th
        boxes.append((x0, y0, x0 + tw, y0 + th))
    x0, y0, x1, y1 = boxes[-1]
    for _ in range(2):                     # zoom: halve in place twice
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        w, h = (x1 - x0) / 2, (y1 - y0) / 2
        x0, y0 = cx - w / 2, cy - h / 2
        x1, y1 = cx + w / 2, cy + h / 2
        boxes.append((x0, y0, x1, y1))
    return boxes


def ingest_url(host: str, bb) -> str:
    """A temporal-range GetMap of ``bb``: the walk touches every scene
    of the range, so the whole-file leg pays each one's residency while
    the ranged leg reads only the chunks it touches."""
    return (f"http://{host}/ows?service=WMS&request=GetMap"
            f"&version=1.3.0&layers=landsat&crs=EPSG:3857"
            f"&bbox={bb[0]},{bb[1]},{bb[2]},{bb[3]}"
            f"&width=256&height=256&format=image/png&time={INGEST_TIME}")


def run_ingest(env: SoakEnv, args):
    """The pan-and-zoom walk over three legs, each with a fresh server
    (its own scene cache and page pool, closed before the next leg
    starts), reset ingest counters, sources, staging pool and planner,
    so that the byte counts compare decode work, not cache luck."""
    boxes = ingest_walk(env)
    # three legs must fit --seconds, and each step leaves the
    # background warm room to land before the next request
    pause = min(0.35, max(0.1, args.seconds / (3.0 * len(boxes) * 2.0)))
    mem0 = card_memory(env.device)
    legs = {name: _ingest_leg(env, boxes, pause, knobs,
                              prefetch_on=name == "prefetch",
                              scrape_ingest=name == "prefetch")
            for name, knobs in INGEST_LEGS.items()}
    base, ranged, prefetch = (legs[k] for k in INGEST_LEGS)
    reduction = (round(1.0 - ranged["bytes_read"]
                       / max(base["bytes_read"], 1), 3)
                 if base["bytes_read"] else None)
    out = {"scenario": "ingest", "device": str(env.device),
           "walk": len(boxes), "pause_s": pause, **legs,
           "bytes_reduction": reduction,
           "tiles_equal_across_legs": all(
               legs[k]["digests"] == base["digests"] for k in legs)}
    if mem0 is not None:
        out["card_memory"] = {"start": mem0,
                              "end": card_memory(env.device)}
    return out, verdict(out, {
        "all_png": all(leg["failed"] == 0 for leg in legs.values()),
        "no_bare_5xx": all(leg["bare_5xx"] == 0 for leg in legs.values()),
        "ranged_windows": ranged["ranged_windows"] > 0,
        "ranged_bytes": ranged["bytes_read"] < base["bytes_read"],
        "hit_rate": prefetch["planner"]["hit_rate"] >= 0.5,
        "metrics": not any(leg["metrics"]["missing"]
                           for leg in legs.values())})


def _ingest_leg(env, boxes, pause, knobs, prefetch_on, scrape_ingest):
    import gc
    import hashlib
    from gsky_tpu_torch.ingest import (default_planner,
                                       reset_default_planner,
                                       reset_sources, reset_staging_pool)
    from gsky_tpu_torch.ingest import stats as ingest_stats

    def reset():
        ingest_stats.reset()
        reset_sources()
        reset_staging_pool()
        reset_default_planner()

    with EnvOverride(**knobs):
        reset()
        server, host = env.server(gateway=None)
        try:
            if prefetch_on:
                # a priming lap: the scenes resident before the walk, so
                # that the background warms race the client's next tile,
                # not a cold decode of every scene
                try:
                    with urllib.request.urlopen(
                            ingest_url(host, boxes[0]), timeout=120) as r:
                        r.read()
                except (OSError, ValueError):
                    pass             # the walk decides
                time.sleep(min(1.0, pause * 4))
            statuses, lats, digests = [], [], []
            for bb in boxes:
                t0 = time.time()
                try:
                    with urllib.request.urlopen(ingest_url(host, bb),
                                                timeout=120) as r:
                        body = r.read()
                        ok = r.status == 200 and body[:8] == PNG
                        statuses.append(r.status if ok else -r.status)
                        digests.append(hashlib.sha256(body).hexdigest()[:16]
                                       if ok else None)
                except urllib.error.HTTPError as e:
                    statuses.append(-e.code)
                    digests.append(None)
                except (OSError, ValueError):
                    statuses.append(0)
                    digests.append(None)
                lats.append(time.time() - t0)
                time.sleep(pause)
            snap = ingest_stats.snapshot()
            extra = ("gsky_ranged_reads_total",
                     "gsky_ranged_read_bytes_total", "gsky_prefetch_total",
                     "gsky_ingest_overlap_ratio") if scrape_ingest else ()
            metrics = check_metrics(host, require=(
                "gsky_requests_total", "gsky_request_seconds") + extra)
            dbg = fetch_json(host, "/debug")
            out = {
                "requests": len(statuses),
                "failed": sum(1 for s in statuses if s != 200),
                "bare_5xx": sum(1 for s in statuses if -600 < s <= -500),
                "p50_ms": round(sorted(lats)[len(lats) // 2] * 1e3, 1),
                "bytes_read": int(snap["ranged_read_bytes"]
                                  + snap["whole_read_bytes"]),
                "ranged_read_bytes": int(snap["ranged_read_bytes"]),
                "whole_read_bytes": int(snap["whole_read_bytes"]),
                "ranged_windows": snap["ranged_windows"],
                "fallbacks": snap["fallbacks"],
                "window_routed": server.executor.cache.window_routed,
                "metrics": metrics, "digests": digests,
                "pool": settled_pool(server),
                "kernels": kernel_counts(dbg),
            }
            if prefetch_on:
                ps = default_planner().stats()
                hits, misses = ps["hit"], ps["miss"]
                ps["hit_rate"] = round(hits / max(hits + misses, 1), 3)
                out["planner"] = ps
        finally:
            env.release(server)
            del server
            reset()
            gc.collect()
    if env.device.type == "cuda":
        # what the card still holds once the leg's server is gone
        out["card_after_close"] = card_memory(env.device)
    return out


# the reference fleet's routing knobs, each set only where unset: 1 s
# active probes, so that a revived node is re-admitted within a few
# beats, and a looser load bound, so that the home node keeps its
# repeat keys at the soak's concurrency
FLEET_KNOBS = {"GSKY_FLEET_PROBE_S": "1.0", "GSKY_FLEET_BOUND": "2.5"}
FLEET_SLOW = "node:slow:250ms:1.0"
FLEET_WARM_S = 420.0          # the first remote tile: every node's first warp
FLEET_BOOT_S = 600.0          # every node listening
FLEET_MIN_S = 6.0             # the reference's shortest load phase


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_info(addr: str, timeout: float = 30.0) -> dict:
    """A node's ``worker_info`` over a fresh channel: its ``info_json``
    with ``platform``, the device type its executor renders on."""
    from gsky_tpu_torch.worker import gskyrpc as pb
    from gsky_tpu_torch.worker.client import dial
    ch, call = dial(addr)
    try:
        res = call(pb.Task(operation="worker_info"), timeout=timeout)
    finally:
        ch.close()
    info = json.loads(res.info_json or "{}")
    info["platform"] = res.worker.platform
    return info


def pid_rss_mb(pid: int):
    """A process's ``VmRSS`` in MiB (None once it has exited)."""
    try:
        with open(f"/proc/{pid}/status") as fp:
            for line in fp:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return None


class Nodes:
    """Worker nodes (``python -m gsky_tpu_torch.worker.server``), each a
    process of its own on ``device`` (``-device``; a node asked for
    cuda raises without CUDA, it never falls back), its output in
    ``log_dir/node-PORT.log``: spawned, killed, revived on the same
    port, waited for (each boot's first ``worker_info`` kept in
    ``first_info``), measured.  `close` kills every one."""

    def __init__(self, log_dir: str, device: str):
        self.log_dir = log_dir
        self.device = device
        self.procs: dict = {}
        self.first_info: dict = {}      # port -> its boot's first answer
        repo = os.path.dirname(HERE)
        self.repo = repo
        self.env = dict(os.environ, PYTHONUNBUFFERED="1",
                        PYTHONPATH=repo + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))

    def spawn(self, port: int, extra_env=None) -> None:
        import subprocess
        e = dict(self.env)
        e.update(extra_env or {})
        with open(self.log_path(port), "ab") as logf:
            self.procs[port] = subprocess.Popen(
                [sys.executable, "-m", "gsky_tpu_torch.worker.server",
                 "-p", str(port), "-host", "127.0.0.1", "-n", "1",
                 "-oom_threshold", "0", "-device", self.device],
                env=e, cwd=self.repo, stdout=logf,
                stderr=subprocess.STDOUT)

    def log_path(self, port: int) -> str:
        return os.path.join(self.log_dir, f"node-{port}.log")

    def log_tail(self, port: int, nbytes: int = 2000) -> str:
        """The end of a node's output."""
        try:
            with open(self.log_path(port), "rb") as fp:
                fp.seek(0, os.SEEK_END)
                fp.seek(max(0, fp.tell() - nbytes))
                return fp.read().decode(errors="replace")
        except OSError:
            return ""

    def info(self, port: int, timeout: float = 30.0) -> dict:
        """`worker_info` of the node on ``port``."""
        return worker_info(f"127.0.0.1:{port}", timeout)

    def wait_ready(self, port: int, deadline_s: float) -> bool:
        """Poll ``worker_info`` until the node answers, False when it
        dies or ``deadline_s`` passes.  A fresh channel an attempt: one
        dialled before the node listens parks in gRPC's reconnect
        backoff and fails every call without dialling again."""
        t_end = time.time() + deadline_s
        while time.time() < t_end:
            if self.procs[port].poll() is not None:
                return False                # died while booting
            try:
                self.first_info[port] = self.info(port, timeout=2.0)
                return True
            except Exception:  # not listening yet: any gRPC error
                time.sleep(0.5)
        return False

    def kill(self, port: int) -> None:
        """SIGKILL, and reap."""
        proc = self.procs[port]
        proc.kill()
        proc.wait(30)

    def rss_mb(self, port: int):
        """The node's ``VmRSS`` in MiB (None once it has exited)."""
        return pid_rss_mb(self.procs[port].pid)

    def close(self) -> None:
        for proc in self.procs.values():
            try:
                proc.kill()
                proc.wait(30)
            except Exception:  # already reaped
                pass


def run_fleet(env: SoakEnv, args):
    """Three worker nodes behind the consistent-hash router of a
    ``fleet`` namespace: a locality baseline, SIGKILL of one node under
    load, its revival on the same port and re-admission, locality
    recovered; then hedged dispatch against a slow node.  The remote
    tiles are mosaicked on this process (B4 on a card).  Every node is
    killed and the namespace removed at the end."""
    knobs = {k: v for k, v in FLEET_KNOBS.items() if k not in os.environ}
    nodes = Nodes(env.root, str(env.device))
    try:
        with EnvOverride(**knobs):
            return _fleet(env, args, nodes)
    finally:
        nodes.close()
        env.fleet_namespace(None)


def _fleet(env, args, nodes):
    from gsky_tpu_torch.fleet import HedgePolicy
    from gsky_tpu_torch.worker import gskyrpc as pb
    from gsky_tpu_torch.worker.client import WorkerClient

    ports = [free_port() for _ in range(3)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    for p in ports:
        nodes.spawn(p)
    boot_end = time.time() + FLEET_BOOT_S
    for p in ports:
        if not nodes.wait_ready(p, max(boot_end - time.time(), 1.0)):
            return {"scenario": "fleet", "device": str(env.device),
                    "error": f"node :{p} never came up",
                    "node_log": nodes.log_tail(p)}, False
    # each boot's decode pool at the node's first answer
    boot_pools = {f"{a} start": nodes.first_info[p].get("pool")
                  for a, p in zip(addrs, ports)}

    env.fleet_namespace(addrs)
    mem0 = card_memory(env.device)
    # no gateway: a response-cache hit would skip the worker RPCs and
    # the locality ledger would measure nothing
    server, host = env.server(gateway=None)

    tiles = env.fleet_tiles()

    def url_for(fx: float, fy: float) -> str:
        return env.fleet_url(host, (fx, fy))

    hard: list = []

    def classify_fleet(url: str) -> str:
        # the reference fleet's classes: a bare 500 or a body that is
        # not OGC XML is hard
        return classify(url, hard, need_retry_after=False)

    def router():
        # the server's own router of the namespace (what /debug's
        # fleet block reports under its name)
        return server._pipeline(env.watcher.get("fleet")).remote.fleet

    def loc():
        st = router().stats()["locality"]
        return st["hits"], st["misses"]

    def hedges():
        hs = router().hedge.stats()
        return hs["primaries"], hs["hedges"], hs["hedge_wins"]

    def delta(a, b):
        return [y - x for x, y in zip(a, b)]

    def rate(h0, m0, h1, m1) -> float:
        return (h1 - h0) / max((h1 - h0) + (m1 - m0), 1)

    def drive(seconds: float, counts: dict):
        counter = itertools.count()
        lock = threading.Lock()

        def one(_):
            c = classify_fleet(url_for(*tiles[next(counter) % len(tiles)]))
            with lock:
                counts[c] = counts.get(c, 0) + 1

        conc = min(args.conc, 4)
        t_end = time.time() + seconds
        with cf.ThreadPoolExecutor(conc) as ex:
            while time.time() < t_end:
                list(ex.map(one, range(conc * 2)))

    def lap(retries: int = 3) -> int:
        bad = 0
        for fx, fy in tiles:
            for _ in range(retries):
                if classify_fleet(url_for(fx, fy)) in ("ok", "degraded"):
                    break
            else:
                bad += 1
        return bad

    # warm: the first warp on each node pays its library load and first
    # launches; retry until the fleet answers
    warm_end = time.time() + FLEET_WARM_S
    while time.time() < warm_end:
        if classify_fleet(url_for(*tiles[0])) == "ok":
            break
        time.sleep(2.0)
    warm_bad = lap()

    # A: the locality baseline under a healthy fleet
    rss = {a: {"baseline_start_mb": nodes.rss_mb(p)}
           for a, p in zip(addrs, ports)}
    counts: dict = {}
    h0, m0 = loc()
    q0 = hedges()
    drive(max(args.seconds * 0.35, FLEET_MIN_S), counts)
    h1, m1 = loc()
    q1 = hedges()
    baseline = rate(h0, m0, h1, m1)

    # B: SIGKILL one node under load; the router eats the failure
    kill_port = ports[1]
    killed = f"127.0.0.1:{kill_port}"
    nodes.kill(kill_port)
    kill_counts: dict = {}
    drive(max(args.seconds * 0.3, FLEET_MIN_S), kill_counts)

    # revive on the same port (the router's channels reconnect), then
    # wait for the health detector to re-admit it; the hedge coda's
    # slow node (outside the namespace) boots meanwhile
    t0 = time.time()
    nodes.spawn(kill_port)
    slow_port = free_port()
    nodes.spawn(slow_port, {"GSKY_FAULTS": FLEET_SLOW})
    revived = nodes.wait_ready(kill_port, 300)
    revive = {"ready_s": round(time.time() - t0, 1)}
    state = None
    if revived:
        boot_pools[f"{killed} revived"] = \
            nodes.first_info[kill_port].get("pool")
        t_end = time.time() + 120
        while time.time() < t_end:
            state = router().stats().get("health", {}).get(
                killed, {}).get("state")
            if state == "healthy":
                break
            time.sleep(1.0)
    revive["healthy_s"] = round(time.time() - t0, 1)

    # one uncounted re-home lap flips each key's last node back to its
    # ring home; the measured phase then shows whether locality
    # recovered, not the one-off re-home misses
    t0 = time.time()
    lap(retries=2)
    revive["rehome_lap_s"] = round(time.time() - t0, 1)
    h2, m2 = loc()
    q2 = hedges()
    drive(max(args.seconds * 0.35, FLEET_MIN_S), counts)
    h3, m3 = loc()
    q3 = hedges()
    recovery = rate(h2, m2, h3, m3)
    fb = router().stats()

    # the worker-RPC family in a strict /metrics, and a trace stitched
    # across the process boundary (worker spans under this trace id)
    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_request_seconds",
        "gsky_stage_seconds", "gsky_worker_rpc_seconds"))
    listing = fetch_json(host, "/debug/trace")
    stitched = [t for t in listing.get("traces", [])
                if "worker" in (t.get("processes") or [])]
    trace_rep = slowest_trace_report(host)
    dbg = fetch_json(host, "/debug")
    for a, p in zip(addrs, ports):
        rss[a]["end_mb"] = nodes.rss_mb(p)
        try:
            rss[a]["kernels"] = nodes.info(p).get("kernels", {})
        except Exception as exc:  # a node that stopped answering
            rss[a]["kernels"] = f"{exc!r:.120}"
    pool = settled_pool(server)
    mem1 = card_memory(env.device)

    # the hedge coda: one fast node kept, one slow one added
    for p in ports[1:]:
        nodes.kill(p)
    hedge = {"ready": nodes.wait_ready(slow_port, 300)}
    if hedge["ready"]:
        boot_pools[f"127.0.0.1:{slow_port} slow"] = \
            nodes.first_info[slow_port].get("pool")
        pair = [addrs[0], f"127.0.0.1:{slow_port}"]
        keys = [f"soak-hedge-{k}" for k in range(64)]

        def p99_ms(client, n=72) -> float:
            lats = []
            for k in range(n):
                t0 = time.time()
                client.process(pb.Task(operation="worker_info"),
                               route_key=keys[k % len(keys)])
                lats.append(time.time() - t0)
            return round(float(np.percentile(lats, 99)) * 1e3, 1)

        uh = WorkerClient(pair)
        uh.fleet.hedge_enabled = False
        try:
            hedge["unhedged_p99_ms"] = p99_ms(uh)
        finally:
            uh.close()
        hc = WorkerClient(pair)
        # a fixed 30 ms hedge delay and a budget that cannot run dry:
        # the soak shows the mechanism, the unit tests its arithmetic
        hc.fleet.hedge = HedgePolicy(min_delay_s=0.03, initial_delay_s=0.03,
                                     budget=1.0, min_samples=10 ** 6)
        try:
            hedge["hedged_p99_ms"] = p99_ms(hc)
            hedge.update({k: hc.fleet.hedge.stats()[k] for k in
                          ("primaries", "hedges", "hedge_wins")})
        finally:
            hc.close()

    out = {
        "scenario": "fleet", "device": str(env.device), "nodes": addrs,
        "killed": killed, "warm_failures": warm_bad,
        "responses": counts, "kill_phase": kill_counts,
        "hard_answers": hard,
        "locality": {"baseline": round(baseline, 3),
                     "recovery": round(recovery, 3),
                     # (hits, misses) and the tile router's (primaries,
                     # hedges, hedge wins) in each measured phase
                     "baseline_hits_misses": [h1 - h0, m1 - m0],
                     "recovery_hits_misses": [h3 - h2, m3 - m2],
                     "baseline_hedging": delta(q0, q1),
                     "recovery_hedging": delta(q2, q3)},
        "rerouted": fb.get("rerouted", 0), "routed": fb.get("routed", 0),
        "revived_state": state, "revive": revive, "hedge": hedge,
        "metrics": metrics,
        "stitched_traces": len(stitched), "slowest_trace": trace_rep,
        "node_rss": rss, "boot_pools": boot_pools, "pool": pool,
        "kernels": kernel_counts(dbg),
    }
    if mem0 is not None:
        out["card_memory"] = {"start": mem0, "end": mem1}
    all_counts: dict = {}
    for d in (counts, kill_counts):
        for k, v in d.items():
            all_counts[k] = all_counts.get(k, 0) + v
    return out, verdict(out, {
        "warm": warm_bad == 0,
        "no_hard_5xx": all_counts.get("hard_5xx", 0) == 0,
        "no_transport": all_counts.get("transport", 0) == 0,
        "some_ok": all_counts.get("ok", 0) > 0,
        "ok_during_kill": kill_counts.get("ok", 0) > 0,
        "rerouted": fb.get("rerouted", 0) > 0,
        "revived_healthy": bool(revived) and state == "healthy",
        # keyed routing must beat the random-assignment null (1/3 over
        # 3 nodes); bounded load and winning hedges keep it under 1.0
        "baseline_locality": baseline > 1.0 / 3.0,
        "recovered_locality": recovery >= 0.9 * baseline,
        "metrics": not metrics["missing"],
        "stitched": len(stitched) > 0,
        "hedge_ready": hedge.get("ready") is True,
        "hedge_wins": hedge.get("hedge_wins", 0) > 0,
        "hedge_budget": (hedge.get("hedges", 0)
                         <= hedge.get("primaries", 0) + 10),
        "hedge_p99": (hedge.get("hedged_p99_ms", 1e9)
                      < hedge.get("unhedged_p99_ms", 0))})


# -- occupancy, algebra, animation ----------------------------------------

def fetch_answer(url: str, errors: list, lock, what: str,
                 timeout: float = 180.0):
    """(status, headers, body) of ``url`` (an HTTP error's too), or None
    when the connection fails: then ``what`` and the exception go to
    ``errors`` (its first 5 kept)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()
    except (OSError, ValueError) as exc:
        with lock:
            if len(errors) < 5:
                errors.append(f"{what}: {exc!r:.200}")
        return None


def wave_kind_ok(ans, kind: str) -> bool:
    """A flat 200 with its body: a PNG for ``map``, a succeeded WPS
    Execute otherwise."""
    if ans is None or ans[0] != 200:
        return False
    return ans[2][:8] == PNG if kind == "map" \
        else b"ProcessSucceeded" in ans[2]


def wave_start(env) -> dict:
    """A wave scenario's opening record: device, card memory."""
    out = {"device": str(env.device)}
    mem0 = card_memory(env.device)
    if mem0 is not None:
        out["card_memory"] = {"start": mem0}
    return out


def wave_end(env, server, host: str, out: dict) -> None:
    """A wave scenario's closing record: the pool once settled, the
    launches, card memory at the end."""
    out["pool"] = settled_pool(server)
    out["pool_pinned"] = out["pool"]["pinned"]
    out["kernels"] = kernel_counts(fetch_json(host, "/debug"))
    if "card_memory" in out:
        out["card_memory"]["end"] = card_memory(env.device)


# the reference's occupancy knobs: a short tick keeps waves frequent
# (many gap samples), queue depth 2 lets assembly run ahead in the
# pipelined leg
OCCUPANCY_KNOBS = {"GSKY_WAVES": "1", "GSKY_WAVE_MAX": "8",
                   "GSKY_WAVE_TICK_MS": "10", "GSKY_WAVE_QUEUE": "2"}
OCCUPANCY_MIN_S = 8.0          # the reference's shortest leg
GAP_FLOOR_MS = 2.0             # back-to-back dispatch: the reference's floor
# GSKY_WAVE_PIPELINE a round: each leg in four rounds, in turns (ABBA
# BAAB), so that the host's drift falls on both legs alike
OCCUPANCY_ROUNDS = ("0", "1", "1", "0", "1", "0", "0", "1")
# criteria read on the host's clock: on a card the gap comparison sits
# inside the host's noise (C.26), so `chip_smoke.py` phase 29 and the
# CPU tests report it and hold the scenario's other criteria
HOST_CLOCK = {"occupancy": ("gap_p99",)}


def run_occupancy(env: SoakEnv, args):
    """The same GetMap + WPS drill storm against one server with the
    synchronous ticker (``GSKY_WAVE_PIPELINE=0``: plan, stack, upload
    and dispatch on one thread) and pipelined (assembly stages wave N+1
    while wave N runs), each leg in four rounds taken in turns, a fresh
    scheduler a round, so that each round's inter-wave gaps are its
    own; a leg's gaps are its rounds' pooled, less each round's lead-in
    (the gap from its warm tile's wave to the storm's first, reported
    as ``lead_in_ms``).  The pipelined p99 gap must be below the
    synchronous one (or at most the 2 ms floor), a wave must have been
    staged ahead of dispatch, no page left pinned.  The reference runs
    each leg once, synchronous first, its lead-in among its gaps
    (C.26)."""
    from gsky_tpu_torch.pipeline.waves import reset_waves

    with EnvOverride(**OCCUPANCY_KNOBS, GSKY_WAVE_PIPELINE="0"):
        reset_waves()
        try:
            return _occupancy(env, args, reset_waves)
        finally:
            reset_waves()


def _occupancy(env, args, reset_waves):
    from gsky_tpu_torch.pipeline.waves import active_waves

    out = {"scenario": "occupancy", **wave_start(env)}
    server, host = env.server(gateway=None)
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
    errors: list = []

    def fetch(url, kind):
        return wave_kind_ok(fetch_answer(url, errors, lock, kind), kind)

    def one_round(seconds: float, leg: dict) -> None:
        counter = itertools.count()

        def one():
            i = next(counter)
            kind, url = ("wps", drill) if i % 24 < 3 \
                else ("map", getmap_url(i))
            ok = fetch(url, kind)
            with lock:
                leg["http"][kind] += 1
                leg["failed"] += not ok

        sched = active_waves(env.device)
        n0 = len(sched.gap_samples()) if sched is not None else 0
        storm(max(args.conc, 12), seconds, one)
        ws = wave_stats_of(env.device)
        sched = sched or active_waves(env.device)
        # the storm's first gap runs from the warm tile's wave to the
        # storm's first: the clients' start, not the scheduler's
        lead = sched.gap_samples()[n0:] if sched is not None else []
        gaps = lead[1:]
        leg["gaps"] += gaps
        for k in ("dispatches", "requests", "staged_waves", "cancelled",
                  "fallbacks", "failed_waves"):
            leg[k] += ws.get("failed" if k == "failed_waves" else k, 0)
        for n, c in ws.get("occupancy", {}).items():
            leg["occupancy"][n] = leg["occupancy"].get(n, 0) + c
        leg["rounds"].append({
            "gap_ms_p99": round(float(np.percentile(gaps, 99)), 3)
            if gaps else None,
            "lead_in_ms": round(lead[0], 3) if lead else None,
            "dispatch_idle_fraction": round(
                ws.get("dispatch_idle_fraction", 0.0), 4)})

    half = max(OCCUPANCY_MIN_S, args.seconds / 2.0)
    n_rounds = OCCUPANCY_ROUNDS.count("0")
    legs = {m: {"http": {"map": 0, "wps": 0}, "failed": 0, "gaps": [],
                "dispatches": 0, "requests": 0, "staged_waves": 0,
                "cancelled": 0, "fallbacks": 0, "failed_waves": 0,
                "occupancy": {}, "rounds": []} for m in ("0", "1")}
    # the warm tile and drill pay scene decode and first launches
    # outside every round's gaps; a warm tile a round pays its fresh
    # scheduler's first wave
    warm_ok = fetch(getmap_url(0), "map") and fetch(drill, "wps")
    for k, mode in enumerate(OCCUPANCY_ROUNDS):
        reset_waves()
        os.environ["GSKY_WAVE_PIPELINE"] = mode
        warm_ok = fetch(getmap_url(k + 1), "map") and warm_ok
        one_round(half / n_rounds, legs[mode])

    def summary(leg):
        g = np.asarray(leg.pop("gaps"))
        q = {f"gap_ms_p{p}": round(float(np.percentile(g, p)), 3)
             if g.size else 0.0 for p in (50, 90, 99)}
        return {**leg, **q, "gap_ms_max": round(float(g.max()), 3)
                if g.size else 0.0, "gap_samples": int(g.size)}

    sync, pipe = summary(legs["0"]), summary(legs["1"])
    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_wave_dispatches_total",
        "gsky_wave_gap_ms", "gsky_wave_staged_total"))
    trace_rep = slowest_trace_report(host)
    sync_p99, pipe_p99 = sync["gap_ms_p99"], pipe["gap_ms_p99"]
    n_done = sum(sync["http"].values()) + sum(pipe["http"].values())
    out.update({
        "warm_ok": warm_ok, "leg_s": half, "rounds": "".join(
            "S" if m == "0" else "P" for m in OCCUPANCY_ROUNDS),
        "synchronous": sync, "pipelined": pipe,
        "gap_p99_reduction_x": (round(sync_p99 / pipe_p99, 2)
                                if pipe_p99 else None),
        "errors": errors, "metrics": metrics, "slowest_trace": trace_rep})
    wave_end(env, server, host, out)
    return out, verdict(out, {
        "warm": warm_ok,
        "served": n_done > 0,
        "no_failures": sync["failed"] == 0 and pipe["failed"] == 0,
        "sync_gap_samples": sync["gap_samples"] >= 3,
        "pipelined_gap_samples": pipe["gap_samples"] >= 3,
        "staged": pipe["staged_waves"] >= 1,
        # under the floor the dispatch stage already enqueues back to
        # back: the host, not the pipeline, bounds a tiny baseline
        "gap_p99": pipe_p99 < sync_p99 or 0 < pipe_p99 <= GAP_FLOOR_MS,
        "unpinned": out["pool_pinned"] == 0,
        "metrics": not metrics["missing"]})


# a wide tick lets concurrent styled tiles of one fingerprint stack into
# one fused wave dispatch
ALGEBRA_KNOBS = {"GSKY_WAVES": "1", "GSKY_WAVE_MAX": "8",
                 "GSKY_WAVE_TICK_MS": "100", "GSKY_EXPR_FUSE": "1",
                 "GSKY_PAGE_SLOTS": "16"}


def run_algebra(env: SoakEnv, args):
    """Fused band algebra: a storm of ``landsat_algebra`` GetMaps in its
    twelve sources (the default and eleven styles) with an
    ``algebraDrill`` minority.  Compiles stay bounded (the compile
    cache misses at most once a source), the fused programs at most one
    a structure (the twins share theirs), the same volley with
    ``GSKY_EXPR_FUSE=0`` is byte-identical, takes the unfused leg and
    holds data, no page left pinned.  ``programs`` counts the distinct fingerprints
    launched through the fused epilogue (`ops.paged.note_expr_program`);
    it counts no compiled program, as the reference's does, since the
    port's fused epilogue is one CUDA kernel for every structure."""
    from gsky_tpu_torch.ops import paged
    from gsky_tpu_torch.ops.expr import reset_expr_cache
    from gsky_tpu_torch.pipeline.waves import reset_waves

    with EnvOverride(**ALGEBRA_KNOBS):
        reset_waves()
        reset_expr_cache()
        paged.reset_expr_fused_stats()
        try:
            return _algebra(env, args, paged)
        finally:
            reset_waves()
            reset_expr_cache()
            paged.reset_expr_fused_stats()


def _algebra(env, args, paged):
    from gsky_tpu_torch.io.png import decode_png
    from gsky_tpu_torch.ops.expr import (expr_cache_stats, fingerprint,
                                         parse_band_expressions)

    out = {"scenario": "algebra", **wave_start(env)}
    # gateway off: a response-cache hit would bypass the pipeline and
    # the bounded-compile claim would measure the cache
    server, host = env.server(gateway=None)
    # the sources as the served config holds them
    cfg = next(c for c in env.watcher.configs.values()
               if c.layer("landsat_algebra") is not None)
    lay = cfg.layer("landsat_algebra")
    styles = [""] + [s.name for s in lay.styles]
    sources = [lay.rgb_products[0]] + [s.rgb_products[0]
                                       for s in lay.styles]
    drill_sources = list(
        cfg.process("algebraDrill").data_sources[0].rgb_products)
    n_structures = len({
        fingerprint(parse_band_expressions([s]).expressions[0]).hash
        for s in sources})
    n_sources = len(set(sources) | set(drill_sources))
    tiles = env.algebra_tiles()
    drill = env.drill_url(host, "algebraDrill", at=(0.40, 0.45))
    lock = threading.Lock()
    counter = itertools.count()
    errors: list = []

    def fetch(url, kind):
        """(ok, body)."""
        ans = fetch_answer(url, errors, lock, kind, timeout=300)
        return wave_kind_ok(ans, kind), (ans[2] if ans else b"")

    # a warm lap: every source once, and one drill
    warm_ok = all([fetch(env.algebra_url(host, s, tiles[k]), "map")[0]
                   for k, s in enumerate(styles)])
    warm_ok = fetch(drill, "drill")[0] and warm_ok

    bad = [0]
    n_req = {"map": 0, "drill": 0}

    def one():
        i = next(counter)
        # the map majority rotates styles, so that concurrent arrivals
        # mix fingerprints and the scheduler groups them by structure
        if i % 16 == 7:
            kind, url = "drill", drill
        else:
            kind, url = "map", env.algebra_url(
                host, styles[i % len(styles)], tiles[i % len(tiles)])
        ok = fetch(url, kind)[0]
        with lock:
            n_req[kind] += 1
            bad[0] += not ok

    storm(max(args.conc, 12), args.seconds, one)
    cs = expr_cache_stats()
    ef = paged.expr_fused_stats()
    fused_n = sum(v for k, v in ef["paths"].items() if k != "unfused")

    # the escape hatch: the same concurrent volley with fusion off, six
    # sources at their warm-lap tiles, those over fewer products first:
    # at the first date only the first product has a granule, so a
    # source over both answers nodata (C.27) and cannot show a fused /
    # unfused difference
    n_vars = [len(parse_band_expressions([s]).var_list) for s in sources]
    probe = [(styles[k], tiles[k]) for k in sorted(
        range(len(styles)), key=lambda k: n_vars[k])[:6]]

    def volley():
        bodies = [None] * len(probe)

        def grab(k, s, t):
            bodies[k] = fetch(env.algebra_url(host, s, t), "map")[1]

        ths = [threading.Thread(target=grab, args=(k, s, t))
               for k, (s, t) in enumerate(probe)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(300)
        return bodies

    bodies_on = volley()
    unfused0 = paged.expr_fused_stats()["paths"].get("unfused", 0)
    with EnvOverride(GSKY_EXPR_FUSE="0"):
        bodies_off = volley()
    unfused1 = paged.expr_fused_stats()["paths"].get("unfused", 0)
    byte_identical = all(bodies_on) and bodies_on == bodies_off
    # stricter than the reference: the compared bodies hold data
    with_data = sum(1 for b in bodies_on if b[:8] == PNG
                    and np.count_nonzero(decode_png(b)[..., 3]))

    ws = wave_stats_of(env.device)
    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_wave_dispatches_total",
        "gsky_expr_fused_total", "gsky_expr_cache_hits_total",
        "gsky_expr_programs"))
    out.update({
        "warm_ok": warm_ok, "requests": n_req, "failed": bad[0],
        "errors": errors, "sources": n_sources,
        "structures": n_structures, "expr_cache": cs,
        "fused": {"programs": ef["programs"], "paths": ef["paths"],
                  "dispatches": fused_n},
        "escape_hatch_byte_identical": byte_identical,
        "escape_hatch_unfused": unfused1 - unfused0,
        "escape_hatch_probe": [s for s, _ in probe],
        "escape_hatch_with_data": with_data,
        "waves": {k: ws.get(k) for k in
                  ("dispatches", "requests", "occupancy", "cancelled",
                   "fallbacks", "failed")},
        "metrics": metrics})
    wave_end(env, server, host, out)
    return out, verdict(out, {
        "warm": warm_ok,
        "served": sum(n_req.values()) > 0,
        "no_failures": bad[0] == 0,
        "fused": fused_n > 0,
        # the misses are the distinct sources compiled: a storm that
        # recompiled per request would blow far past them
        "compiles_bounded": 0 < cs["misses"] <= n_sources
        and cs["hits"] > cs["misses"],
        # at most one program a structure: the twins shared theirs
        "fingerprint_sharing": 1 <= ef["programs"] <= n_structures,
        "escape_hatch_byte_identical": byte_identical,
        "escape_hatch_unfused": unfused1 > unfused0,
        "escape_hatch_has_data": with_data > 0,
        "unpinned": out["pool_pinned"] == 0,
        "metrics": not metrics["missing"]})


# a wide tick gives each sequence's frame lanes a coalescing window
ANIMATION_KNOBS = {"GSKY_WAVES": "1", "GSKY_WAVE_MAX": "8",
                   "GSKY_WAVE_TICK_MS": "100", "GSKY_ANIM": "1"}
# the reference's holds (prep, render and container windows), and
# shorter ones: a card answers a sequence in tens of milliseconds
ANIMATION_HOLDS = (0.005, 0.01, 0.02, 0.05, 0.15, 0.35, 0.7, 1.2, 2.0)


def run_animation(env: SoakEnv, args):
    """Temporal wave serving: APNG sequences over every date whose
    frames share wave dispatches (the serial warm sequence in at most
    half as many waves as frames), an mp4 minority answered as labelled
    APNG, disconnects that cancel a sequence or its lanes, no page left
    pinned."""
    from gsky_tpu_torch.obs import metrics as om
    from gsky_tpu_torch.pipeline.waves import reset_waves

    with EnvOverride(**ANIMATION_KNOBS):
        reset_waves()
        om.reset_temporal()
        try:
            return _animation(env, args, om)
        finally:
            reset_waves()
            om.reset_temporal()


def _animation(env, args, om):
    out = {"scenario": "animation", **wave_start(env)}
    # gateway off: the warm sequence must measure the scheduler
    server, host = env.server(gateway=None)
    n_frames = len(env.dates)
    tiles = env.anim_tiles()
    lock = threading.Lock()
    counter = itertools.count()
    errors: list = []

    def fetch(url, kind) -> bool:
        # a flat 200 APNG (the signature, acTL) of every frame; the mp4
        # stub labelled as APNG bytes
        ans = fetch_answer(url, errors, lock, kind)
        if ans is None or ans[0] != 200:
            return False
        status, headers, body = ans
        if body[:8] != PNG or b"acTL" not in body[:256] \
                or headers.get("X-Gsky-Anim-Frames") != str(n_frames):
            return False
        return kind != "mp4" \
            or headers.get("X-Gsky-Anim-Container") == "apng-stub"

    # the serial warm sequence: with nothing else in flight its wave
    # delta is its own (the storm's deltas are telemetry only); the
    # server records it a beat after the client has read it
    warm_ok = fetch(env.anim_url(host, tiles[0]), "apng")
    st_warm = om.temporal_stats()
    t_w = time.time() + 10
    while time.time() < t_w and st_warm.get("sequences", 0) < 1:
        time.sleep(0.1)
        st_warm = om.temporal_stats()
    warm_frames = int(st_warm.get("frames", 0))
    warm_waves = int(st_warm.get("waves", 0))

    bad = [0]
    n_req = {"apng": 0, "mp4": 0}

    def one():
        i = next(counter)
        kind = "mp4" if i % 10 == 0 else "apng"
        ok = fetch(env.anim_url(host, tiles[i % len(tiles)],
                                "video/mp4" if kind == "mp4"
                                else "image/apng"), kind)
        with lock:
            n_req[kind] += 1
            bad[0] += not ok

    storm(max(args.conc, 8), args.seconds, one)

    # a sequence aborted mid-flight is cancelled in its streaming loop
    # (the sequences' cancelled outcome) or earlier, where its request's
    # token drops its frame lanes from the wave (the scheduler's)
    def cancelled():
        return int(om.temporal_stats().get("cancelled", 0)
                   + wave_stats_of(env.device).get("cancelled", 0))

    c0 = cancelled()

    def path_of():
        i = next(counter)
        return env.anim_url(host, tiles[i % len(tiles)]).split(host, 1)[1]

    cancel_seen, volleys = disconnect_volleys(
        host, path_of, ANIMATION_HOLDS, lambda: cancelled() - c0)
    st = om.temporal_stats()
    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_request_seconds",
        "gsky_anim_sequences_total", "gsky_anim_frames_per_wave",
        "gsky_wave_dispatches_total"))
    trace_rep = slowest_trace_report(host)
    ws = wave_stats_of(env.device)
    out.update({
        "warm_ok": warm_ok, "frames": n_frames,
        "warm_amortisation": {"frames": warm_frames, "waves": warm_waves},
        "requests": n_req, "failed": bad[0], "errors": errors,
        "cancellation": {"seen": cancel_seen, "volleys": volleys},
        "temporal": st,
        "waves": {k: ws.get(k) for k in
                  ("dispatches", "requests", "occupancy", "cancelled",
                   "fallbacks", "failed")},
        "metrics": metrics, "slowest_trace": trace_rep})
    wave_end(env, server, host, out)
    return out, verdict(out, {
        "warm": warm_ok,
        "warm_amortised": warm_frames == n_frames
        and warm_waves * 2 <= warm_frames,
        "served": sum(n_req.values()) > 0,
        "no_failures": bad[0] == 0,
        "sequences": st.get("sequences", 0) >= 1,
        "cancelled": cancel_seen >= 1,
        "unpinned": out["pool_pinned"] == 0,
        "metrics": not metrics["missing"]})


# -- fabric, elastic -------------------------------------------------------

FABRIC_MIN_S = 8.0             # the reference's shortest storm
FABRIC_GRID = 4                # the reference's 4 x 4 hot tiles
# the waits that bound the fabric's legs (s), the reference's: every
# node listening, the first remote tile, the killed node's revival and
# its first page from a peer
FABRIC_WAIT_S = {"boot": 600.0, "warm": 420.0, "revive": 300.0,
                 "refill": 90.0}


class LegClock:
    """Seconds between marks, by leg: where a scenario's time goes."""

    def __init__(self):
        self.t = time.monotonic()
        self.legs: dict = {}

    def mark(self, leg: str) -> None:
        now = time.monotonic()
        self.legs[leg] = round(now - self.t, 1)
        self.t = now


def page_peer(device, executor):
    """(service, RPC server, "host:port"): the real worker RPC over
    ``executor``'s page pool, in this process, on a free port: the page
    peer whose pool this process's renders fill (``page_fetch``,
    ``journal_export`` of this process's journal)."""
    from gsky_tpu_torch.worker.pool import ProcessPool
    from gsky_tpu_torch.worker.server import WorkerService, make_server
    svc = WorkerService(ProcessPool(size=1), device=device,
                        executor=executor)
    srv = make_server(svc, "127.0.0.1:0").start()
    return svc, srv, f"127.0.0.1:{srv.port}"


def close_page_peer(peer) -> None:
    """Stop a `page_peer`, its decode pool and its preemption hook."""
    from gsky_tpu_torch.resilience import faults
    svc, srv, _ = peer
    srv.stop(0)
    svc.close()
    faults.set_preempt_handler(None)


def node_launches(infos: dict) -> dict:
    """Each kernel's launches summed over ``worker_info`` answers."""
    total: dict = {}
    for info in infos.values():
        for k, v in ((info or {}).get("kernels") or {}).items():
            total[k] = total.get(k, 0) + int(v)
    return total


def run_fabric(env: SoakEnv, args):
    """Two gateway replicas on the replay ring over three page-peered
    worker nodes (`Nodes`, a page journal each): a Zipf storm across
    both, gateway A replaced by a cold replica that serves the hot set
    from B's bytes, a node SIGKILLed and revived whose warm boot refills
    its pool from a page peer in this process, and a ``GSKY_FABRIC=0``
    leg byte-identical to a fabric-less server.  The knobs are restored,
    every node killed and the namespace removed at the end."""
    journal = os.path.join(env.root, "fabric-journal.jsonl")
    if os.path.exists(journal):
        os.remove(journal)
    nodes = Nodes(env.root, str(env.device))
    held: dict = {}
    try:
        with EnvOverride(GSKY_FABRIC="1", GSKY_POOL_JOURNAL=journal):
            return _fabric(env, args, nodes, held)
    finally:
        if held.get("peer"):
            close_page_peer(held["peer"])
        nodes.close()
        env.fleet_namespace(None, "fabric")


def _fabric(env, args, nodes, held):
    from gsky_tpu_torch.fabric.replay import ReplayFabric
    from gsky_tpu_torch.serving import ServingGateway

    mem0 = card_memory(env.device)
    clock = LegClock()
    ports = [free_port() for _ in range(3)]
    addrs = [f"127.0.0.1:{p}" for p in ports]

    def node_env(port: int, page_peers: str = "") -> dict:
        # a journal of each node's own (C.18); the page peers are the
        # other nodes, as the reference configures them
        me = f"127.0.0.1:{port}"
        return {"GSKY_FABRIC": "1",
                "GSKY_FABRIC_PAGE_PEERS": page_peers or ",".join(
                    a for a in addrs if a != me),
                "GSKY_POOL_JOURNAL": os.path.join(
                    env.root, f"fabric-journal-{port}.jsonl")}

    for p in ports:
        nodes.spawn(p, node_env(p))
    boot_end = time.time() + FABRIC_WAIT_S["boot"]
    for p in ports:
        if not nodes.wait_ready(p, max(boot_end - time.time(), 1.0)):
            return {"scenario": "fabric", "device": str(env.device),
                    "error": f"node :{p} never came up",
                    "node_log": nodes.log_tail(p)}, False
    boot_pools = {f"{a} start": nodes.first_info[p].get("pool")
                  for a, p in zip(addrs, ports)}
    # the device each boot's executor renders on
    boot_platforms = {f"{a} start": nodes.first_info[p].get("platform")
                      for a, p in zip(addrs, ports)}
    rss = {a: {"start_mb": nodes.rss_mb(p)} for a, p in zip(addrs, ports)}
    clock.mark("boot")
    env.fleet_namespace(addrs, "fabric")

    # the ring wants each replica's address before it listens: boot
    # with placeholders, then set the membership (a generation bump, as
    # a redeploy's)
    fab_a = ReplayFabric("http://pending-a", [])
    fab_b = ReplayFabric("http://pending-b", [])
    srv_a, host_a = env.server(gateway=ServingGateway(), fabric=fab_a)
    srv_b, host_b = env.server(gateway=ServingGateway(), fabric=fab_b)
    url_a, url_b = f"http://{host_a}", f"http://{host_b}"
    fab_a.self_addr = url_a
    fab_a.set_peers([url_b])
    fab_b.self_addr = url_b
    fab_b.set_peers([url_a])

    tiles = env.fleet_tiles(FABRIC_GRID)
    rng = np.random.default_rng(7)
    ranks = (rng.zipf(1.2, size=100_000) - 1) % len(tiles)
    hard: list = []

    def url_for(host: str, k: int) -> str:
        return env.fleet_url(host, tiles[k], "landsat_fabric", "/fabric")

    def fetchc(url: str):
        return classify_answer(url, hard, need_retry_after=False,
                               timeout=180.0)

    # warm: the first remote tile pays each node's first warp
    warm_end = time.time() + FABRIC_WAIT_S["warm"]
    while time.time() < warm_end:
        if fetchc(url_for(host_a, 0))[0] == "ok":
            break
        time.sleep(2.0)
    clock.mark("warm")

    # A: a Zipf storm alternating gateways; both caches fill, and a
    # non-owner's miss replays across the ring
    counts: dict = {}
    cache_outcomes: dict = {}
    counter = itertools.count()
    lock = threading.Lock()

    def one(_):
        i = next(counter)
        host = host_a if i % 2 == 0 else host_b
        c, src, _body = fetchc(url_for(host, int(ranks[i % len(ranks)])))
        with lock:
            counts[c] = counts.get(c, 0) + 1
            if src:
                cache_outcomes[src] = cache_outcomes.get(src, 0) + 1

    conc = min(args.conc, 4)
    t_end = time.time() + max(args.seconds * 0.5, FABRIC_MIN_S)
    with cf.ThreadPoolExecutor(conc) as ex:
        while time.time() < t_end:
            list(ex.map(one, range(conc * 2)))
    # every hot tile resident on B, the survivor, before A goes: the
    # recovery then measures the fabric, not luck
    for k in range(len(tiles)):
        fetchc(url_for(host_b, k))
    clock.mark("storm")

    # B: gateway A dies; a cold replica takes its place and must refill
    # from B's bytes over the ring, not by rendering
    env.release(srv_a)
    fab_a2 = ReplayFabric("http://pending-a2", [])
    _srv_a2, host_a2 = env.server(gateway=ServingGateway(), fabric=fab_a2)
    fab_a2.self_addr = f"http://{host_a2}"
    fab_a2.set_peers([url_b])
    fab_b.set_peers([f"http://{host_a2}"])      # B re-homes too
    recovery_counts: dict = {}
    peer_served = 0
    for k in list(range(len(tiles))) * 2:
        c, src, _body = fetchc(url_for(host_a2, k))
        recovery_counts[c] = recovery_counts.get(c, 0) + 1
        if src == "peer":
            peer_served += 1
    a2 = fab_a2.stats()["outcomes"]
    probed = a2.get("hit", 0) + a2.get("miss", 0) + a2.get("error", 0)
    replay_rate = a2.get("hit", 0) / max(probed, 1)
    clock.mark("recovery")

    # C: page peering.  The default namespace renders in this process
    # (B's executor, the one every namespace of B shares): a seed lap
    # of /ows tiles stages its pool and this process's journal, the
    # real worker RPC serves that pool, and a SIGKILLed node revived
    # with it as its page peer must refill over page_fetch
    for k in list(range(len(tiles))) * 2:      # twice: stage, then heat
        fetchc(env.fleet_url(host_b, tiles[k], "landsat", ""))
    seeded = srv_b.executor.pool.stats()
    held["peer"] = page_peer(env.device, srv_b.executor)
    peer_addr = held["peer"][2]
    kill_port = ports[2]
    killed = addrs[2]
    nodes.kill(kill_port)
    t0 = time.time()
    nodes.spawn(kill_port, node_env(kill_port, page_peers=peer_addr))
    worker_back = nodes.wait_ready(kill_port, FABRIC_WAIT_S["revive"])
    revive = {"ready_s": round(time.time() - t0, 1)}
    refill: dict = {}
    if worker_back:
        boot_pools[f"{killed} revived"] = \
            nodes.first_info[kill_port].get("pool")
        boot_platforms[f"{killed} revived"] = \
            nodes.first_info[kill_port].get("platform")
        t_end = time.time() + FABRIC_WAIT_S["refill"]
        while time.time() < t_end:
            try:
                refill = nodes.info(kill_port).get("pages", {})
            except Exception:  # a node that stopped answering
                refill = {}
            if refill.get("peer_filled", 0) > 0:
                break
            time.sleep(1.0)
        # the poll stops at the first fill, mid-rehydrate: let the warm
        # boot end before the ratio is read
        time.sleep(3.0)
        try:
            refill = nodes.info(kill_port).get("pages", {}) or refill
        except Exception:  # keep the last answer
            pass
    revive["refilled_s"] = round(time.time() - t0, 1)
    clock.mark("seed_and_refill")
    peer_filled = refill.get("peer_filled", 0)
    rehydrated = refill.get("rehydrated", 0)

    # D: the escape hatch.  GSKY_FABRIC=0 answers what a fabric-less
    # server does, byte for byte, and the fabric never probes a peer
    with EnvOverride(GSKY_FABRIC="0"):
        fab_off = ReplayFabric("http://off", [url_b])
        _s, host_off = env.server(gateway=ServingGateway(), fabric=fab_off)
        _s, host_plain = env.server(gateway=ServingGateway())
        c_off, _src, body_off = fetchc(url_for(host_off, 0))
        c_plain, _src, body_plain = fetchc(url_for(host_plain, 0))
    identical = (c_off == c_plain == "ok" and body_off == body_plain
                 and len(body_off) > 0)
    off_outcomes = fab_off.stats()["outcomes"]
    off_dormant = set(off_outcomes) <= {"disabled"}
    clock.mark("escape_hatch")

    # a strict exposition with the fabric's families, its /debug block
    metrics = check_metrics(host_b, require=(
        "gsky_requests_total", "gsky_fabric_replay_total",
        "gsky_fabric_page_fills_total"))
    dbg = fetch_json(host_b, "/debug")
    infos = {}
    for a, p in zip(addrs, ports):
        rss[a]["end_mb"] = nodes.rss_mb(p)
        try:
            infos[a] = nodes.info(p)
        except Exception as exc:  # a node that stopped answering
            infos[a] = {"error": f"{exc!r:.120}"}
        rss[a]["kernels"] = infos[a].get("kernels", infos[a].get("error"))
    pool = settled_pool(srv_b)
    out = {
        "scenario": "fabric", "device": str(env.device), "nodes": addrs,
        "gateways": [host_a, host_b, host_a2], "killed": killed,
        "storm": counts, "storm_cache": cache_outcomes,
        "recovery": recovery_counts, "recovery_peer_served": peer_served,
        "recovery_replay": {"outcomes": a2, "rate": round(replay_rate, 3)},
        "worker_refill": {"back": worker_back,
                          "seeded": seeded.get("staged", 0),
                          "peer_filled": peer_filled,
                          "rehydrated": rehydrated, "revive": revive},
        "fabric_off": {"identical": identical, "outcomes": off_outcomes},
        "hard_answers": hard, "metrics": metrics,
        "debug_fabric": bool(dbg.get("fabric")),
        "node_rss": rss, "boot_pools": boot_pools,
        "boot_platforms": boot_platforms,
        "node_kernels": node_launches(infos), "pool": pool,
        "kernels": kernel_counts(dbg), "legs_s": clock.legs,
    }
    if mem0 is not None:
        out["card_memory"] = {"start": mem0,
                              "end": card_memory(env.device)}
    both = (counts, recovery_counts)
    return out, verdict(out, {
        "storm_ok": counts.get("ok", 0) > 0,
        "no_hard_5xx": sum(d.get("hard_5xx", 0) for d in both) == 0,
        "no_transport": sum(d.get("transport", 0) for d in both) == 0,
        "recovery_ok": recovery_counts.get("ok", 0) > 0,
        # at least half of the peer-owned hot set came back as replays
        "replay_hits": a2.get("hit", 0) > 0,
        "peer_served": peer_served > 0,
        "replay_rate": replay_rate >= 0.5,
        # at least half of the revived node's refill came from a peer
        "worker_back": bool(worker_back),
        "seeded": seeded.get("staged", 0) > 0,
        "peer_filled": peer_filled > 0,
        "refill_from_peers": peer_filled >= rehydrated - peer_filled,
        "escape_identical": identical,
        "escape_dormant": off_dormant,
        "metrics": not metrics["missing"],
        "debug_fabric": bool(dbg.get("fabric"))})


# the elastic fleet's phases: the reference's shortest ramp leg and
# steady phase (s), and the waits that bound its legs (s)
ELASTIC_MIN_S = {"ramp": 4.0, "steady": 8.0}
ELASTIC_WAIT_S = {"boot": 600.0, "warm": 420.0, "up": 60.0, "join": 300.0,
                  "members": 300.0, "purge": 60.0, "refill": 300.0,
                  "third": 240.0, "handoff": 90.0, "down": 120.0,
                  "dormant": 30.0}
ELASTIC_GRACE_S = 6.0          # the preemption notices' grace window
ELASTIC_P99_S = 90.0           # the steady phase's p99 budget


def run_elastic(env: SoakEnv, args):
    """The autoscaler over a preemptible fleet of local node processes
    (`LocalSubprocessProvider`, a page journal each): a ramp to a
    readiness-gated scale-up, two preemptions under load with a warm
    hand-off, the floor refilled, a steady phase and a quiet one that
    must scale down, and a ``GSKY_ELASTIC=0`` leg byte-identical with
    no trace of elastic.  The page peer in this process fronts the pool
    a seed lap filled, and is up before the first node boots (C.28).
    The knobs and the elastic counters are restored, every node killed
    and the namespace removed at the end."""
    from gsky_tpu_torch.fleet import elastic
    journal = os.path.join(env.root, "elastic-journal.jsonl")
    if os.path.exists(journal):
        os.remove(journal)
    knobs = {k: v for k, v in FLEET_KNOBS.items() if k not in os.environ}
    held: dict = {}
    try:
        with EnvOverride(GSKY_FABRIC="1", GSKY_ELASTIC="1",
                         GSKY_POOL_JOURNAL=journal, **knobs):
            return _elastic(env, args, held)
    finally:
        if held.get("autoscaler") is not None:
            held["autoscaler"].stop()
        if held.get("provider") is not None:
            held["provider"].close()
        if held.get("peer"):
            close_page_peer(held["peer"])
        env.fleet_namespace(None, "elastic")
        held.clear()
        elastic.reset_stats()


def _elastic(env, args, held):
    import gc

    from gsky_tpu_torch.fleet import elastic
    from gsky_tpu_torch.serving import ServingGateway

    mem0 = card_memory(env.device)
    clock = LegClock()
    server, host = env.server(gateway=ServingGateway())
    tiles = env.fleet_tiles()
    hard: list = []

    def fetch(url: str):
        c, _src, body = classify_answer(url, hard, need_retry_after=False,
                                        timeout=180.0)
        return c, body

    def seed_url(tile) -> str:
        return env.fleet_url(host, tile, "landsat", "")

    def url_for(tile, salt: int = 0) -> str:
        # the salt moves the bbox by about two response-cache quanta
        # (1/256 px) a step: every request a key of its own, so the load
        # reaches the fleet and its demand signal, within a few pixels,
        # on the same pages
        step = 0.25 / 256.0 / 128.0
        fx = tile[0] + (salt % 997) * step
        fy = tile[1] + (salt // 997 % 997) * step
        return env.fleet_url(host, (fx, fy), "landsat_elastic", "/elastic")

    # the seed lap renders in this process (the default namespace: B1 on
    # a card), twice: stage, then heat; then the real worker RPC fronts
    # that pool and this process's journal, before any node boots, so
    # that every node's warm boot takes the hot set (C.28)
    for tile in tiles * 2:
        fetch(seed_url(tile))
    seeded = server.executor.pool.stats()
    held["peer"] = page_peer(env.device, server.executor)
    peer_addr = held["peer"][2]
    clock.mark("seed")

    first_info: dict = {}       # addr -> its boot's first worker_info
    last_info: dict = {}        # addr -> its last answer
    rss: dict = {}
    repo = os.path.dirname(HERE)
    provider = held["provider"] = elastic.LocalSubprocessProvider(
        extra_env={"PYTHONPATH": repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   "PYTHONUNBUFFERED": "1", "GSKY_FABRIC": "1",
                   "GSKY_FABRIC_PAGE_PEERS": peer_addr},
        pool_size=1, log_dir=env.root, device=str(env.device),
        journal_dir=env.root)

    def probe(addr: str):
        # the autoscaler's readiness probe, each answer kept
        try:
            info = worker_info(addr, timeout=5.0)
        except Exception:  # not answering: booting, or gone
            info = None
        if info is not None:
            if addr not in first_info:
                first_info[addr] = info
                proc = provider._procs.get(addr)
                rss[addr] = {"start_mb": pid_rss_mb(proc.pid)
                             if proc is not None else None}
            last_info[addr] = info
        return info

    initial = [provider.launch() for _ in range(2)]
    boot_end = time.time() + ELASTIC_WAIT_S["boot"]
    for addr in initial:
        while time.time() < boot_end and provider.alive(addr):
            if probe(addr) is not None:
                break
            time.sleep(0.5)
        if addr not in first_info:
            return {"scenario": "elastic", "device": str(env.device),
                    "error": f"{addr} never came up"}, False
    clock.mark("boot")
    env.fleet_namespace(initial, "elastic")

    # warm: the first remote tile pays each node's first warp
    warm_end = time.time() + ELASTIC_WAIT_S["warm"]
    while time.time() < warm_end:
        if fetch(url_for(tiles[0]))[0] == "ok":
            break
        time.sleep(2.0)
    clock.mark("warm")
    # the server's own client of the namespace is the routing surface
    # the autoscaler scales
    client = server._pipeline(env.watcher.get("elastic")).remote
    autoscaler = held["autoscaler"] = elastic.Autoscaler(
        provider, client, name="soak",
        min_nodes=2, max_nodes=4, interval_s=0.5,
        up=0.5, down=0.2, up_ticks=2, down_ticks=4,
        cooldown_s=4.0, ready_timeout_s=150.0, drain_grace_s=8.0,
        # a node's target of 1: the soak's tiles are page-warm, so the
        # worker RPC is a small slice of a request and in flight stays
        # low
        demand=elastic.DemandSignal(admission=server.gateway.admission,
                                    router=client.fleet, node_conc=1),
        probe=probe)
    autoscaler.start()
    t_scaler = time.monotonic()         # the autoscaler's clock

    counts: dict = {}
    lats: dict = {"ramp": [], "preempt": [], "steady": []}
    lock = threading.Lock()
    counter = itertools.count()      # no URL repeats across phases

    def drive_bg(conc: int, phase: str):
        """Load at ``conc`` in the background until its event is set."""
        stop_ev = threading.Event()

        def one(_):
            i = next(counter)
            t0 = time.time()
            c, _b = fetch(url_for(tiles[i % len(tiles)], salt=i))
            with lock:
                counts[c] = counts.get(c, 0) + 1
                if c == "ok":
                    lats[phase].append(time.time() - t0)

        def loop():
            with cf.ThreadPoolExecutor(conc) as ex:
                while not stop_ev.is_set():
                    list(ex.map(one, range(conc)))

        th = threading.Thread(target=loop, daemon=True)
        th.start()
        return stop_ev, th

    def stop(bg) -> None:
        bg[0].set()
        bg[1].join(300)

    def wait_for(pred, timeout_s: float) -> bool:
        t_end = time.time() + timeout_s
        while time.time() < t_end:
            if pred():
                return True
            time.sleep(1.0)
        return bool(pred())

    def decided(direction: str) -> bool:
        return any(d["dir"] == direction for d in autoscaler.decisions)

    # A: the ramp doubles the load twice; demand must cross the
    # scale-up threshold, and the launch joins once its probe is warm
    ramp_s = max(args.seconds * 0.1, ELASTIC_MIN_S["ramp"])
    for conc in (2, 4):
        bg = drive_bg(conc, "ramp")
        time.sleep(ramp_s)
        stop(bg)
    bg = drive_bg(8, "ramp")
    up_seen = wait_for(lambda: decided("up"), ELASTIC_WAIT_S["up"])
    clock.mark("ramp")
    join_seen = wait_for(lambda: decided("join"), ELASTIC_WAIT_S["join"])
    stop(bg)
    clock.mark("join")

    # B: two preemptions under load, a short grace, an explicit
    # successor; every answer must stay clean
    bg = drive_bg(4, "preempt")
    handoff_notes = []
    for victim in initial:
        # the victim leaves a live successor: two members at least
        wait_for(lambda: len(client.nodes) >= 2, ELASTIC_WAIT_S["members"])
        live = list(client.nodes)
        if victim not in live:
            break
        succ = client.fleet.ring.successor(victim) or \
            next((n for n in live if n != victim), None)
        peers = [n for n in live if n != victim] + [peer_addr]
        # the pages its warm boot took from the page peer: the hot set
        # it ships (C.28)
        held_pages = ((probe(victim) or {}).get("pages") or {}).get(
            "peer_filled")
        noticed = provider.preempt(victim, ELASTIC_GRACE_S,
                                   successor=succ, peers=peers)
        gone = wait_for(lambda: victim not in client.nodes,
                        ELASTIC_WAIT_S["purge"])
        handoff_notes.append({"victim": victim, "successor": succ,
                              "victim_peer_filled": held_pages,
                              "noticed": noticed, "purged": gone})
        clock.mark(f"preempt_{len(handoff_notes)}")
    # the floor refilled, then three members for the quiet phase to
    # shed, scaled up by demand at the ramp's top load (C.29)
    refilled = wait_for(lambda: len(client.nodes) >= 2,
                        ELASTIC_WAIT_S["refill"])
    stop(bg)
    clock.mark("refill")
    bg = drive_bg(8, "preempt")
    third = wait_for(lambda: len(client.nodes) >= 3, ELASTIC_WAIT_S["third"])
    stop(bg)
    clock.mark("third")

    def handoff_totals() -> dict:
        # the warm hand-off across the surviving fleet
        tot = {"entries": 0, "filled": 0, "cold": 0, "active": 0}
        for n in list(client.nodes):
            h = ((probe(n) or {}).get("elastic") or {}).get("handoff") or {}
            for k in tot:
                tot[k] += int(h.get(k, 0))
        return tot

    wait_for(lambda: (handoff_totals()["entries"] > 0
                      and handoff_totals()["active"] == 0),
             ELASTIC_WAIT_S["handoff"])
    handoff = handoff_totals()
    clock.mark("handoff")

    # C: steady load on the recovered fleet (its p99), then quiet, which
    # must bring a scale-down
    bg = drive_bg(4, "steady")
    time.sleep(max(args.seconds * 0.2, ELASTIC_MIN_S["steady"]))
    stop(bg)
    clock.mark("steady")
    down_seen = wait_for(lambda: decided("down"), ELASTIC_WAIT_S["down"])
    clock.mark("down")

    # while the subsystem is live: a strict exposition with the elastic
    # families, and the /debug block
    metrics = check_metrics(host, require=(
        "gsky_requests_total", "gsky_elastic_nodes",
        "gsky_elastic_decisions_total", "gsky_preemptions_total",
        "gsky_handoff_pages_total"))
    dbg = fetch_json(host, "/debug")
    decisions = list(autoscaler.decisions)
    counters = elastic.counters()
    ready_joins = [d for d in decisions
                   if d["dir"] == "join" and d["reason"] == "ready"]
    autoscaler.stop()
    final_nodes = list(client.nodes)
    for addr in provider.addrs():
        if provider.alive(addr):
            probe(addr)
            proc = provider._procs.get(addr)
            rss.setdefault(addr, {})["end_mb"] = \
                pid_rss_mb(proc.pid) if proc is not None else None
    pool = settled_pool(server)
    kernels = kernel_counts(dbg)

    # D: the escape hatch.  GSKY_ELASTIC=0: the bytes of a server that
    # never met elastic, no elastic family, no /debug block
    with EnvOverride(GSKY_ELASTIC="0"):
        autoscaler = held["autoscaler"] = None   # the registry is weak
        t_end = time.time() + ELASTIC_WAIT_S["dormant"]
        while True:
            elastic.reset_stats()
            gc.collect()
            # a retiring node's thread may hold the autoscaler a while
            if elastic.dormant() or time.time() > t_end:
                break
            time.sleep(1.0)
        off_dormant_fn = elastic.dormant()
        _s, host_off = env.server(gateway=None)
        _s, host_plain = env.server(gateway=None)
        su = seed_url(tiles[0])
        c_off, body_off = fetch(su.replace(host, host_off))
        c_plain, body_plain = fetch(su.replace(host, host_plain))
        with urllib.request.urlopen(f"http://{host_off}/metrics",
                                    timeout=30) as r:
            off_expo = r.read().decode()
        off_debug = fetch_json(host_off, "/debug")
    clock.mark("escape_hatch")
    identical = (c_off == c_plain == "ok" and body_off == body_plain
                 and len(body_off) > 0)
    off_dormant = (off_dormant_fn and "gsky_elastic" not in off_expo
                   and "gsky_preemptions" not in off_expo
                   and "elastic" not in off_debug)

    p99 = {ph: (round(float(np.percentile(v, 99)), 3) if v else None)
           for ph, v in lats.items()}
    out = {
        "scenario": "elastic", "device": str(env.device),
        "initial": initial, "final_nodes": final_nodes,
        "page_peer": peer_addr, "seeded": seeded.get("staged", 0),
        "responses": counts, "hard_answers": hard, "p99_s": p99,
        # each decision with its time (s) since the autoscaler started
        "decisions": [{**{k: d.get(k) for k in ("dir", "reason", "node")},
                       "t_s": round(d["t"] - t_scaler, 1)}
                      for d in decisions],
        "counters": counters, "handoff": handoff,
        "handoff_notes": handoff_notes, "ready_joins": len(ready_joins),
        "third_member": third,
        "elastic_off": {"identical": identical, "dormant": off_dormant},
        "metrics": metrics, "debug_elastic": bool(dbg.get("elastic")),
        "node_rss": rss,
        "boot_pools": {a: i.get("pool") for a, i in first_info.items()},
        "boot_platforms": {a: i.get("platform")
                           for a, i in first_info.items()},
        "node_kernels": node_launches(last_info), "pool": pool,
        "kernels": kernels, "legs_s": clock.legs,
    }
    if mem0 is not None:
        out["card_memory"] = {"start": mem0,
                              "end": card_memory(env.device)}
    pre = counters["preemptions"]
    return out, verdict(out, {
        "some_ok": counts.get("ok", 0) > 0,
        "no_hard_5xx": counts.get("hard_5xx", 0) == 0,
        "no_transport": counts.get("transport", 0) == 0,
        "scale_up": up_seen and counters["decisions"]["up"] >= 1,
        # the readiness gate: a join that waited for the warm probe,
        # not for its deadline
        "ready_join": join_seen and len(ready_joins) >= 1,
        "scale_down": down_seen and counters["decisions"]["down"] >= 1,
        "preemptions_handled": len(handoff_notes) == 2 and all(
            n["noticed"] and n["purged"] for n in handoff_notes),
        # both seen, at least one in its draining window (a starved
        # host can miss the other's probe beat and call it dead)
        "preemptions_counted": (pre["graceful"] + pre["nograce"] >= 2
                                and pre["graceful"] >= 1),
        "refilled": refilled,
        # at least half of the inherited hot set from peers' pools
        "handoff": handoff["entries"] > 0
        and handoff["filled"] >= handoff["cold"],
        "steady_p99": p99["steady"] is not None
        and p99["steady"] < ELASTIC_P99_S,
        "escape_identical": identical,
        "escape_dormant": off_dormant,
        "metrics": not metrics["missing"],
        "debug_elastic": bool(dbg.get("elastic"))})


RUNS = {"churn": run_churn, "hot": run_hot, "wcs": run_wcs,
        "chaos": run_chaos, "burst": run_burst, "wave": run_wave,
        "dap4": run_dap4, "overload": run_overload, "ingest": run_ingest,
        "fleet": run_fleet, "occupancy": run_occupancy,
        "algebra": run_algebra, "animation": run_animation,
        "fabric": run_fabric, "elastic": run_elastic}


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
