"""The drill pipeline: polygon time-series statistics (WPS Execute).

Counterpart of `gsky_tpu/pipeline/drill.py`:

1. index: MAS ?intersects with the polygon WKT;
2. fast path: crawler-precomputed means / sample counts answer without
   touching files (``approx``);
3. else per file: rasterize the polygon into the file grid (ALL_TOUCHED
   burn), then reduce the masked window of every selected timestep.  A
   file whose stack is resident on the device (`drill_cache`) is
   reduced there: `ops.drill.window_gather`, kernel B3
   (`ops.stats.masked_stats`) for the masked sums and counts, the plain
   reduction in pixel-count mode, ``torch.sort`` for deciles.  A cold
   request (stack not resident yet) and a window larger than its
   bucket read from the host and reduce in numpy, as the reference's
   do.  Strided timesteps are interpolated between the read endpoints;
4. merge: per-date count-weighted means across files, then band
   expressions per date; decile columns become ``ns_d1..9``.

With waves on (``GSKY_WAVES``, default on) a resident-stack reduction
is a lane of the device's wave (`pipeline.waves`): concurrent drills of
one window shape and clip are reduced by one launch of B3's K-block
form, each drill's rows exactly as per call.

Files of every format the port reads are drilled: NetCDF variables,
GeoTIFF, GMT and HDF4 bands (through `io.registry`), curvilinear
(``geo_loc``) swaths, whose polygon membership is a containment test
on their geolocation arrays (`_geoloc_drill_mask`), and VRT granules
(``vrt_xml``: the template rendered per file with its co-registered
mask granules, read through `io.vrt.VRTRaster` and reduced on the
host, as the reference's VRT drill is).  Not ported, and raising
NotImplementedError where a request needs it: the mesh path
(``GSKY_SPMD=1``).  There is no fallback: a failure on the device path
raises.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import math
import os
import threading
import time
import xml.etree.ElementTree as ET
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geo import geometry as geom
from ..geo.crs import EPSG4326, parse_crs
from ..geo.geoloc import load_geoloc_grid
from ..geo.transform import BBox, GeoTransform
from ..index.client import Dataset
from ..index.store import fmt_time
from ..io.netcdf import NetCDF
from ..io.registry import open_raster
from ..io.vrt import VRTRaster, render_vrt
from ..ops import drill as D
from ..ops.raster import nodata_mask
from ..ops.stats import masked_stats
from . import drill_cache as DC
from .executor import _bucket_pow2
from .waves import default_waves, waves_enabled
from .types import DrillResult, GeoDrillRequest

# host-clock stages of a drill: "gather" and "stats" are the host side
# of the device work (it runs asynchronously); "readback" waits for it;
# "host" is the cold path's host reads and numpy reductions
SPANS = ("index", "rasterize", "gather", "stats", "readback", "host",
         "merge")
# window buckets of the resident path (the reference executor's)
_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(math.ceil(n / 4096) * 4096)


class _Spans:
    """Accumulated host-clock seconds per stage (thread-safe)."""

    def __init__(self):
        self.totals = dict.fromkeys(SPANS, 0.0)
        self._lock = threading.Lock()

    def add(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        with self._lock:
            self.totals[name] += now - t0
        return now


def split_by_years(req: GeoDrillRequest, year_step: int):
    """Year-stepped request splitting (`processor/date_splitter.go`):
    copies of ``req`` covering consecutive ``year_step``-year windows of
    its time range, the last clamped to end_time.  ``year_step <= 0``
    yields the request as is."""
    if year_step <= 0 or req.start_time is None or req.end_time is None:
        yield req
        return

    def add_years(ts: float, n: int) -> float:
        d = dt.datetime.fromtimestamp(ts, dt.timezone.utc)
        try:
            d = d.replace(year=d.year + n)
        except ValueError:      # Feb 29 -> Mar 1, Go AddDate behaviour
            d = d.replace(year=d.year + n, month=3, day=1)
        return d.timestamp()

    if req.start_time >= req.end_time:
        yield req               # a point in time: nothing to window
        return
    t = req.start_time
    while t < req.end_time:
        nxt = add_years(t, year_step)
        yield dataclasses.replace(req, start_time=t,
                                  end_time=min(nxt, req.end_time))
        t = nxt


def merge_results(parts: List[DrillResult]) -> DrillResult:
    """Concatenate per-window DrillResults (the windows of
    `split_by_years` are disjoint, so rows merge by date)."""
    parts = [p for p in parts if p.dates]
    if not parts:
        return DrillResult([], {}, {}, [])
    if len(parts) == 1:
        return parts[0]
    names: List[str] = []
    for p in parts:
        for n in p.values:
            if n not in names:
                names.append(n)
    rows = {}
    counts_rows = {}
    for p in parts:
        for i, d in enumerate(p.dates):
            row = rows.setdefault(d, {})
            crow = counts_rows.setdefault(d, {})
            for n in p.values:
                row[n] = p.values[n][i]
                crow[n] = p.counts.get(n, [0] * len(p.dates))[i]
    dates = sorted(rows)
    values = {n: [rows[d].get(n, float("nan")) for d in dates]
              for n in names}
    counts = {n: [counts_rows[d].get(n, 0) for d in dates] for n in names}
    raw = sorted({n for p in parts for n in p.raw_namespaces})
    return DrillResult(dates, values, counts, raw)


class DrillPipeline:
    """Polygon drills over a MAS index.  ``device`` (default "cuda")
    holds the resident stacks and runs the device reductions; without
    CUDA it raises unless the caller passes ``device="cpu"``.  ``cache``
    defaults to the device's shared `DrillStackCache`."""

    def __init__(self, mas, device="cuda",
                 cache: Optional[DC.DrillStackCache] = None):
        self.mas = mas
        self.device = resolve_device(device)
        self.cache = cache if cache is not None \
            else DC.for_device(self.device)
        self._spans = _Spans()

    @property
    def spans(self) -> Dict[str, float]:
        return self._spans.totals

    def process_split(self, req: GeoDrillRequest,
                      year_step: int = 0) -> DrillResult:
        """Split the request into year-stepped windows, drill each, and
        merge (`processor/date_splitter.go`)."""
        return merge_results([self.process(w)
                              for w in split_by_years(req, year_step)])

    def index(self, req: GeoDrillRequest) -> List[Dataset]:
        namespaces = list(req.band_exprs.var_list) \
            + [n for n in req.mask_namespaces
               if n not in req.band_exprs.var_list]
        kw = dict(srs="EPSG:4326", wkt=req.geometry_wkt,
                  namespaces=",".join(namespaces))
        if req.start_time is not None:
            kw["time"] = fmt_time(req.start_time)
        if req.end_time is not None:
            kw["until"] = fmt_time(req.end_time)
        return self.mas.intersects(req.collection, **kw)

    def process(self, req: GeoDrillRequest) -> DrillResult:
        # large-polygon tiling (`drill_indexer.go:115-137`): each tile
        # runs the index and per-file reductions on its own, and the
        # (namespace, date) accumulator merges them count-weighted.
        # Adjacent tiles both burn their shared boundary row, as in the
        # reference, so edge pixels count twice
        tiles = tiled_geometries(req.geometry_wkt, req.index_tile_x_size,
                                 req.index_tile_y_size)
        acc: Dict[Tuple[str, float], List[Tuple[float, int]]] = \
            defaultdict(list)
        if len(tiles) > 1:
            approx_seen: set = set()
            for wkt in tiles:
                sub = dataclasses.replace(req, geometry_wkt=wkt,
                                          index_tile_x_size=0.0,
                                          index_tile_y_size=0.0)
                self._drill_into(sub, acc, approx_seen)
        else:
            self._drill_into(req, acc)
        t0 = time.perf_counter()
        res = _merge(acc, req)
        self._spans.add("merge", t0)
        return res

    def _drill_into(self, req: GeoDrillRequest, acc,
                    approx_seen: Optional[set] = None) -> None:
        t0 = time.perf_counter()
        datasets = self.index(req)
        self._spans.add("index", t0)
        g4326 = geom.from_wkt(req.geometry_wkt)
        mask_ns = set(req.mask_namespaces)
        mask_ds = [d for d in datasets if d.namespace in mask_ns]
        for ds in [d for d in datasets if d.namespace not in mask_ns]:
            sel = _selected_times(ds, req)
            if not sel:
                continue
            vrt_xml = None
            if req.vrt_xml:
                vrt_xml = render_vrt(req.vrt_xml, ds.file_path,
                                     _vrt_masks(ds, mask_ds, req))
            elif req.approx and ds.means and ds.sample_counts \
                    and len(ds.means) >= len(ds.timestamps):
                # crawler-stats fast path: whole-file aggregates, so
                # under polygon tiling a file counts exactly once
                if approx_seen is not None:
                    k = (ds.file_path, ds.ds_name, ds.namespace)
                    if k in approx_seen:
                        continue
                    approx_seen.add(k)
                for ti in sel:
                    date = ds.timestamps[ti] if ds.timestamps else 0.0
                    acc[(ds.namespace, date)].append(
                        (float(ds.means[min(ti, len(ds.means) - 1)]),
                         int(ds.sample_counts[
                             min(ti, len(ds.sample_counts) - 1)])))
                continue
            stats = self._drill_file(ds, sel, g4326, req, vrt_xml)
            if stats is None:
                continue
            values, counts, deciles = stats
            for k, ti in enumerate(sel):
                date = ds.timestamps[ti] if ds.timestamps else 0.0
                acc[(ds.namespace, date)].append(
                    (float(values[k]), int(counts[k])))
                for d in range(req.deciles):
                    acc[(f"{ds.namespace}_d{d + 1}", date)].append(
                        (float(deciles[k, d]), 1))

    def _drill_file(self, ds: Dataset, sel: List[int],
                    g4326: geom.Geometry, req: GeoDrillRequest,
                    vrt_xml: Optional[str] = None):
        """Masked reductions for the selected timesteps of one file (or
        of a rendered VRT wrapping it, `drill.go:363-423`); None when
        the file or the polygon window has no data."""
        is_vrt = bool(vrt_xml)
        is_nc = not is_vrt and not ds.ds_name.upper().startswith("GMT:") \
            and (ds.file_path.lower().endswith((".nc", ".nc4"))
                 or ds.ds_name.upper().startswith("NETCDF:"))
        try:
            if is_vrt:
                h = VRTRaster(vrt_xml)
                H, W = h.height, h.width
            elif is_nc:
                h = NetCDF(ds.file_path)
                var = ds.ds_name.split(":")[-1].strip('"')
                v = h.variables[var]
                H, W = v.shape[-2], v.shape[-1]
            else:
                h = open_raster(ds.file_path)
                H, W = h.height, h.width
        except (OSError, ValueError, KeyError, ET.ParseError):
            return None

        try:
            t0 = time.perf_counter()
            try:
                if is_vrt and h.crs is not None:
                    src_crs = h.crs
                else:
                    src_crs = parse_crs(ds.srs) if ds.srs else EPSG4326
                gt = h.gt if is_vrt else \
                    GeoTransform.from_gdal(ds.geo_transform)
                g = g4326 if src_crs == EPSG4326 else g4326.transform(
                    lambda x, y: EPSG4326.transform_to(src_crs, x, y))
            except ValueError:  # unparseable SRS
                return None
            if ds.geo_loc and not is_vrt:
                made = _geoloc_drill_mask(ds, g4326, H, W)
                if made is None:
                    return None
                mask, (c0, r0, c1, r1) = made
            else:
                # envelope intersect + ALL_TOUCHED mask burn
                b = g.bbox()
                c0, r0 = gt.geo_to_pixel(b.xmin, b.ymax)
                c1, r1 = gt.geo_to_pixel(b.xmax, b.ymin)
                c0, c1 = sorted((c0, c1))
                r0, r1 = sorted((r0, r1))
                c0 = max(int(math.floor(c0)), 0)
                r0 = max(int(math.floor(r0)), 0)
                c1 = min(int(math.ceil(c1)), W)
                r1 = min(int(math.ceil(r1)), H)
                if c0 >= c1 or r0 >= r1:
                    return None
                wgt = gt.window(c0, r0)
                mask = geom.rasterize(g, c1 - c0, r1 - r0,
                                      lambda x, y: wgt.geo_to_pixel(x, y),
                                      all_touched=True)
            self._spans.add("rasterize", t0)
            if not mask.any():
                return None

            # strided band reads with interpolation (`drill.go:119-214`)
            stride = max(req.band_strides, 1)
            read_idx: List[int] = []
            for s in range(0, len(sel), stride):
                e = min(s + stride, len(sel))
                read_idx.append(s)
                if e - 1 != s:
                    read_idx.append(e - 1)
            read_idx = sorted(set(read_idx))

            band0 = 1
            if not is_nc and ":" in ds.ds_name \
                    and ds.ds_name.rsplit(":", 1)[-1].isdigit():
                band0 = int(ds.ds_name.rsplit(":", 1)[-1])

            # resident-stack path: the stack lives on the device, this
            # request ships the polygon mask and the timestep indices
            if not is_vrt and DC.enabled():
                getter = self.cache.get if DC.sync_mode() \
                    else self.cache.get_async
                st = getter(ds.file_path, is_nc, var if is_nc else "",
                            band0, ds.nodata)
                if st is not None:
                    dev = _drill_device(st, sel, read_idx, mask,
                                        (c0, r0, c1, r1), req, self._spans)
                    if dev is not None:
                        vals, counts, dec = dev
                        return _maybe_interp(vals, counts, dec, read_idx,
                                             sel, stride, req)

            t0 = time.perf_counter()
            bands_data = []
            for k in read_idx:
                ti = sel[k]
                if is_vrt:
                    data = h.read(1, (c0, r0, c1 - c0, r1 - r0),
                                  time_index=ti)
                    nodata = h.nodata
                elif is_nc:
                    data = h.read_slice(var, ti if len(v.shape) > 2
                                        else None,
                                        (c0, r0, c1 - c0, r1 - r0))
                    nodata = ds.nodata if ds.nodata is not None \
                        else v.nodata
                else:
                    # one timestamp per file; the band index comes from
                    # the crawler's ds_name suffix
                    data = h.read(band0, (c0, r0, c1 - c0, r1 - r0))
                    nodata = ds.nodata if ds.nodata is not None \
                        else h.nodata
                bands_data.append((data.astype(np.float32),
                                   nodata_mask(data, nodata)))
            data = np.stack([d for d, _ in bands_data])
            valid = np.stack([m for _, m in bands_data]) & (mask[None] > 0)
            B = data.shape[0]
            vals, counts, dec = _stats_tail(data.reshape(B, -1),
                                            valid.reshape(B, -1), req)
            self._spans.add("host", t0)
            return _maybe_interp(vals, counts, dec, read_idx, sel, stride,
                                 req)
        finally:
            h.close()


def _vrt_masks(ds: Dataset, mask_ds: List[Dataset],
               req: GeoDrillRequest) -> List[str]:
    """The mask files of one data granule's VRT
    (`drill_indexer.go:318-380`): exactly one temporally co-registered
    mask granule per requested mask namespace, in the order of
    ``req.mask_namespaces`` (so the pixel function's band order is
    stable); a namespace with several candidates keeps the one on the
    data granule's own tile.  No candidate, or several, raises
    ValueError (an indexer error in the reference)."""
    masks = []
    for ns in req.mask_namespaces:
        cands = [m for m in mask_ds
                 if m.namespace == ns and _times_match(ds, m)]
        if len(cands) > 1:
            same_tile = [m for m in cands if m.polygon == ds.polygon]
            if len(same_tile) == 1:
                cands = same_tile
        if len(cands) > 1:
            raise ValueError(
                f"multiple mask granules for namespace {ns!r} "
                f"co-registered with {ds.file_path}")
        if not cands:
            raise ValueError(
                f"no mask granule for namespace {ns!r} "
                f"co-registered with {ds.file_path}")
        masks.append(cands[0].file_path)
    return masks


def _geoloc_drill_mask(ds: Dataset, g4326: geom.Geometry, H: int,
                       W: int):
    """Polygon membership over a CURVILINEAR swath: every sample carries
    its own coordinates, so membership is a vectorised containment test
    on the geolocation arrays — the swath analogue of the affine
    ALL_TOUCHED burn.  Returns (mask (uint8, window-shaped), window
    (c0, r0, c1, r1) in RASTER pixels) or None when nothing matches.

    Handles the details the naive test misses: the geometry is taken in
    the geo_loc record's OWN srs (not ds.srs, which rulesets may
    override); antimeridian-crossing swaths compare on the grid's
    unwrapped longitude branch; a bbox prefilter crops the grid before
    the O(edges x samples) ray cast; geoloc line/pixel offsets+steps map
    grid indices to raster pixels (subsampled geolocation grids); and
    point/line/sub-sample-size geometries fall back to marking the
    samples nearest their vertices, so a tiny drill doesn't silently
    report "no data"."""
    grid = load_geoloc_grid(ds.file_path, ds.geo_loc)
    if grid is None:
        return None
    gl_srs = ds.geo_loc.get("srs") or "EPSG:4326"
    try:
        gl_crs = parse_crs(gl_srs)
        g = g4326 if gl_crs == EPSG4326 else g4326.transform(
            lambda x, y: EPSG4326.transform_to(gl_crs, x, y))
    except ValueError:
        return None
    if grid._wraps:
        # the grid longitudes live on the unwrapped [180, 360) branch
        g = g.transform(lambda x, y: (np.where(np.asarray(x) < 0.0,
                                               np.asarray(x) + 360.0,
                                               np.asarray(x)), y))

    gh, gw = grid.gx.shape
    inpoly = np.zeros((gh, gw), bool)
    if g.polys:
        b = g.bbox()
        with np.errstate(invalid="ignore"):
            box = ((grid.gx >= b.xmin) & (grid.gx <= b.xmax)
                   & (grid.gy >= b.ymin) & (grid.gy <= b.ymax))
        if box.any():
            rr = np.nonzero(box.any(axis=1))[0]
            cc = np.nonzero(box.any(axis=0))[0]
            sr, er = int(rr[0]), int(rr[-1]) + 1
            sc, ec = int(cc[0]), int(cc[-1]) + 1
            inpoly[sr:er, sc:ec] = geom.contains_mask(
                g, grid.gx[sr:er, sc:ec], grid.gy[sr:er, sc:ec])
    if not inpoly.any():
        # point/line drills and polygons smaller than sample spacing:
        # nearest-sample marking (the ALL_TOUCHED-style floor)
        pts = []
        if g.points is not None:
            pts.append(np.asarray(g.points, np.float64))
        for poly in g.polys:
            for ring in poly:
                if len(ring):
                    pts.append(np.asarray(ring, np.float64))
        if not pts:
            return None
        pts_a = np.concatenate(pts, axis=0)
        col, row = grid.invert(pts_a[:, 0], pts_a[:, 1])
        # invert() returns RASTER pixel coords; back to grid indices
        gj = np.rint((col - 0.5 - grid.pixel_offset)
                     / grid.pixel_step).astype(np.int64)
        gi = np.rint((row - 0.5 - grid.line_offset)
                     / grid.line_step).astype(np.int64)
        ok = (gi >= 0) & (gi < gh) & (gj >= 0) & (gj < gw)
        if not ok.any():
            return None
        inpoly[gi[ok], gj[ok]] = True

    rr = np.nonzero(inpoly.any(axis=1))[0]
    cc = np.nonzero(inpoly.any(axis=0))[0]
    gr0, gr1 = int(rr[0]), int(rr[-1]) + 1
    gc0, gc1 = int(cc[0]), int(cc[-1]) + 1
    # grid indices -> raster pixels via the geoloc offsets/steps; a
    # subsampled geolocation grid (pixel_step > 1) expands each sample
    # to its step-sized block of raster pixels
    ls = max(int(grid.line_step), 1)
    ps = max(int(grid.pixel_step), 1)
    r0 = int(grid.line_offset + ls * gr0)
    c0 = int(grid.pixel_offset + ps * gc0)
    sub = inpoly[gr0:gr1, gc0:gc1]
    mask = np.repeat(np.repeat(sub, ls, axis=0), ps, axis=1)
    r1 = min(r0 + mask.shape[0], H)
    c1 = min(c0 + mask.shape[1], W)
    if r0 >= r1 or c0 >= c1:
        return None
    mask = mask[:r1 - r0, :c1 - c0].astype(np.uint8)
    if not mask.any():
        return None
    return mask, (c0, r0, c1, r1)


def tiled_geometries(wkt: str, step_x: float,
                     step_y: float) -> List[str]:
    """Split an area geometry into index-tile intersections
    (`drill_indexer.go:386-520`): a grid of (step_x, step_y)-degree
    tiles over the envelope, each clipped against the polygon.
    Non-area geometries, disabled steps and degenerate output give the
    whole geometry."""
    if step_x <= 0.0 and step_y <= 0.0:
        return [wkt]
    try:
        g = geom.from_wkt(wkt)
        if g.kind not in ("Polygon", "MultiPolygon") or g.is_empty:
            return [wkt]
        b = g.bbox()
        sx = step_x if step_x > 0 else (b.xmax - b.xmin) or 1.0
        sy = step_y if step_y > 0 else (b.ymax - b.ymin) or 1.0
        if b.xmax - b.xmin <= sx and b.ymax - b.ymin <= sy:
            return [wkt]
        # integer tile counts: float stepping emits sliver tiles when
        # the extent divides evenly
        nx = max(int(math.ceil((b.xmax - b.xmin) / sx - 1e-9)), 1)
        ny = max(int(math.ceil((b.ymax - b.ymin) / sy - 1e-9)), 1)
        out = []
        for iy in range(ny):
            y1 = b.ymax - iy * sy
            y0 = max(y1 - sy, b.ymin)
            for ix in range(nx):
                x0 = b.xmin + ix * sx
                x1 = min(x0 + sx, b.xmax)
                c = g.clip_bbox(BBox(x0, y0, x1, y1))
                if not c.is_empty:
                    out.append(c.to_wkt())
        return out or [wkt]
    except Exception:  # noqa: BLE001 - the reference's whole-geometry
        return [wkt]   # answer on a tiling error


def _times_match(data: Dataset, mask: Dataset) -> bool:
    """A mask granule rides with a data granule when their timestamp
    sets overlap (or either carries none)."""
    if not data.timestamps or not mask.timestamps:
        return True
    return bool(set(data.timestamps) & set(mask.timestamps))


def _selected_times(ds: Dataset, req: GeoDrillRequest) -> List[int]:
    if not ds.timestamps:
        return [0]
    out = []
    for i, t in enumerate(ds.timestamps):
        if req.start_time is not None and t < req.start_time - 1:
            continue
        if req.end_time is not None and t > req.end_time + 1:
            continue
        out.append(i)
    return out


def _stats_host(dataf: np.ndarray, validf: np.ndarray,
                req: GeoDrillRequest):
    """The reductions in numpy, for host-read window data (a cold
    request, or a window larger than its bucket)."""
    vals, counts = D.masked_mean_impl(
        dataf, validf, req.clip_lower, req.clip_upper, req.pixel_count)
    if req.deciles:
        dec = D.deciles_impl(dataf, validf, req.deciles).astype(np.float32)
    else:
        dec = np.zeros((dataf.shape[0], 0), np.float32)
    return vals.astype(np.float32), counts.astype(np.int32), dec


def _stats_tail(dataf, validf, req: GeoDrillRequest,
                spans: Optional[_Spans] = None):
    """Masked mean (+ deciles) over (B, N) data/valid: numpy arrays
    reduce in numpy (`_stats_host`); tensors reduce where they lie,
    the masked sums and counts through kernel B3 (its plain version for
    CPU tensors), pixel-count mode through the plain reduction."""
    if isinstance(dataf, np.ndarray):
        return _stats_host(dataf, validf, req)
    if os.environ.get("GSKY_SPMD", "0") == "1":
        raise NotImplementedError(
            "the mesh drill path (GSKY_SPMD=1) is not ported to "
            "gsky_tpu_torch yet")
    spans = spans or _Spans()
    t0 = time.perf_counter()
    if waves_enabled():
        # host (vals, counts), each as the per-call branch computes it
        vals, c = default_waves(dataf.device).drill_stats(
            dataf, validf, req.clip_lower, req.clip_upper,
            req.pixel_count)
        t0 = spans.add("stats", t0)
        dec = D.deciles(dataf, validf, req.deciles).cpu().numpy() \
            if req.deciles else np.zeros((dataf.shape[0], 0), np.float32)
        spans.add("readback", t0)
        return vals, c, dec
    if not req.pixel_count:
        s, c = masked_stats(dataf, validf, req.clip_lower, req.clip_upper)
    else:
        v, c = D.masked_mean(dataf, validf, req.clip_lower, req.clip_upper,
                             pixel_count=True)
    dec = D.deciles(dataf, validf, req.deciles) if req.deciles else None
    t0 = spans.add("stats", t0)
    c = c.cpu().numpy()
    if not req.pixel_count:
        s = s.cpu().numpy()
        vals = np.where(c > 0, s / np.maximum(c, 1), 0.0).astype(np.float32)
    else:
        vals = v.cpu().numpy()
    dec = dec.cpu().numpy() if dec is not None \
        else np.zeros((dataf.shape[0], 0), np.float32)
    spans.add("readback", t0)
    return vals, c, dec


def _maybe_interp(vals, counts, dec, read_idx, sel, stride,
                  req: GeoDrillRequest):
    """Strided-endpoint interpolation of statistics
    (`drill.go:119-214`)."""
    if stride > 1 and len(read_idx) < len(sel):
        cols = np.concatenate([vals[:, None], dec], axis=1)
        vi, ci = D.interp_strided(cols, np.tile(counts[:, None],
                                                (1, cols.shape[1])),
                                  np.asarray(read_idx), len(sel))
        vals = vi[:, 0]
        dec = vi[:, 1:]
        counts = ci[:, 0]
    return vals, counts, dec


def _drill_device(st: DC.DeviceStack, sel: List[int], read_idx: List[int],
                  mask: np.ndarray, win, req: GeoDrillRequest,
                  spans: Optional[_Spans] = None):
    """Drill one file from its resident stack: upload the polygon mask
    and the timestep indices, slice the window on the device, reduce
    there.  (values, counts, deciles) for the read_idx timesteps, or
    None when the window does not fit its bucket (the caller then reads
    from the host)."""
    spans = spans or _Spans()
    t0 = time.perf_counter()
    c0, r0, c1, r1 = win
    T, H, W = st.shape
    wh, ww = r1 - r0, c1 - c0
    bh = min(_bucket(wh), H)
    bw = min(_bucket(ww), W)
    if bh < wh or bw < ww:
        return None
    # clamp the origin so the padded window stays in bounds; the mask
    # shifts by the clamp offset so pixels keep their identity
    r0c = min(r0, H - bh)
    c0c = min(c0, W - bw)
    mask_p = np.zeros((bh, bw), bool)
    mask_p[r0 - r0c:r0 - r0c + wh, c0 - c0c:c0 - c0c + ww] = mask > 0
    tsel = np.asarray([sel[k] for k in read_idx], np.int64)
    B = len(tsel)
    tsel_p = np.pad(tsel, (0, _bucket_pow2(B) - B), mode="edge")
    # nodata compares in the file's dtype (parity with
    # ops.raster.nodata_mask); a nodata not representable there matches
    # nothing.  NaN nodata: NaN != NaN, the ~isnan term covers it
    nd = st.nodata
    if np.isnan(nd):
        nd_native, use_nd = 0, False
    else:
        cast = np.asarray(nd).astype(st.np_dtype)
        nd_native, use_nd = cast.item(), bool(float(cast) == float(nd))
    dev = st.dev.device
    dataf, validf = D.window_gather(
        st.dev, torch.from_numpy(tsel_p).to(dev), r0c, c0c,
        torch.from_numpy(mask_p).to(dev), nd_native, use_nd, (bh, bw))
    spans.add("gather", t0)
    vals, counts, dec = _stats_tail(dataf, validf, req, spans)
    return vals[:B], counts[:B], dec[:B]


def _merge(acc, req: GeoDrillRequest) -> DrillResult:
    """Weighted means per (namespace, date), then band expressions."""
    dates = sorted({d for (_, d) in acc})
    raw_ns = sorted({n for (n, _) in acc})
    series: Dict[str, List[float]] = {}
    counts: Dict[str, List[int]] = {}
    for ns in raw_ns:
        vs, cs = [], []
        for d in dates:
            items = acc.get((ns, d), [])
            tot = sum(c for _, c in items)
            if tot > 0:
                vs.append(sum(v * c for v, c in items) / tot)
            else:
                vs.append(float("nan"))
            cs.append(tot)
        series[ns] = vs
        counts[ns] = cs

    exprs = req.band_exprs
    out_values: Dict[str, List[float]] = {}
    out_counts: Dict[str, List[int]] = {}
    for ce, name in zip(exprs.expressions, exprs.expr_names):
        if ce._ast[0] == "var" and ce.variables[0] in series:
            out_values[name] = series[ce.variables[0]]
            out_counts[name] = counts[ce.variables[0]]
            continue
        vs, cs = [], []
        for di in range(len(dates)):
            env = {}
            ok = True
            cnt = 0
            for var in ce.variables:
                if var not in series or math.isnan(series[var][di]):
                    ok = False
                    break
                env[var] = np.float64(series[var][di])
                cnt = max(cnt, counts[var][di])
            if ok:
                try:
                    vs.append(float(ce(env, xp=np)))
                except ZeroDivisionError:
                    vs.append(float("nan"))
            else:
                vs.append(float("nan"))
            cs.append(cnt if ok else 0)
        out_values[name] = vs
        out_counts[name] = cs
    # decile columns pass through
    for ns in raw_ns:
        if "_d" in ns and ns not in out_values:
            out_values[ns] = series[ns]
            out_counts[ns] = counts[ns]
    return DrillResult(dates, out_values, out_counts, raw_ns)


def drill_csv(res: DrillResult,
              namespaces: Optional[List[str]] = None) -> str:
    """CSV rows 'date,v1,v2,...' — the WPS template payload format
    (`processor/drill_merger.go:161-171`)."""
    ns = namespaces or list(res.values)
    lines = []
    for i, d in enumerate(res.dates):
        stamp = dt.datetime.fromtimestamp(d, dt.timezone.utc) \
            .strftime("%Y-%m-%d")
        row = [stamp]
        for n in ns:
            v = res.values.get(n, [float("nan")] * len(res.dates))[i]
            row.append("" if math.isnan(v) else f"{v:.4f}")
        lines.append(",".join(row))
    return "\n".join(lines)
