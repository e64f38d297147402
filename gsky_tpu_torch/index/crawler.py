"""File crawler: one MAS record per raster file.

Counterpart of `gsky_tpu/index/crawler.py` for the formats the port
reads natively: `extract` opens a GeoTIFF, a NetCDF (3, or 4 where
h5py imports), a GMT grid or an HDF4 / HDF-EOS file, and emits the
{"filename", "file_type", "geo_metadata": [...]} record
`MASStore.ingest` takes: timestamps from the NetCDF time axis or the
file name, curvilinear NetCDF products' ``geo_loc`` record, and
optionally approximate per-timestep means and sample counts, which the
drill's fast path answers from.  Not ported: crawler rulesets and the
eo-datasets YAML extractors (ROADMAP A.8); a file no reader claims
gives an error record.
"""

from __future__ import annotations

import datetime as dt
import math
import os
import re
from typing import Dict, Optional

import numpy as np

from ..geo.transform import GeoTransform
from ..io.geotiff import GeoTIFF
from ..io.netcdf import NetCDF
from ..ops.raster import NP_TO_GDAL
from .store import ISO, fmt_time, sanitize_namespace

_TIFF_MAGIC = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
_HDF4_MAGIC = b"\x0e\x03\x13\x01"

# filename timestamp patterns
_TIME_PATTERNS = [
    (re.compile(r"(\d{4})-(\d{2})-(\d{2})[T_ ]?(\d{2})[:\-]?(\d{2})"),
     "ymdhm"),
    (re.compile(r"(\d{4})(\d{2})(\d{2})(\d{2})(\d{2})"), "ymdhm"),
    (re.compile(r"(\d{4})-(\d{2})-(\d{2})"), "ymd"),
    (re.compile(r"(\d{4})(\d{2})(\d{2})"), "ymd"),
    (re.compile(r"A(\d{4})(\d{3})"), "yj"),  # MODIS A2018123
]


def timestamp_from_filename(name: str) -> Optional[str]:
    base = os.path.basename(name)
    for pat, kind in _TIME_PATTERNS:
        m = pat.search(base)
        if not m:
            continue
        try:
            if kind == "yj":
                d = dt.datetime(int(m.group(1)), 1, 1,
                                tzinfo=dt.timezone.utc) \
                    + dt.timedelta(days=int(m.group(2)) - 1)
            elif kind == "ymdhm":
                d = dt.datetime(int(m.group(1)), int(m.group(2)),
                                int(m.group(3)), int(m.group(4)),
                                int(m.group(5)), tzinfo=dt.timezone.utc)
            else:
                d = dt.datetime(int(m.group(1)), int(m.group(2)),
                                int(m.group(3)), tzinfo=dt.timezone.utc)
            return d.strftime(ISO)
        except ValueError:
            continue
    return None


def _polygon_wkt(gt: GeoTransform, w: int, h: int) -> str:
    x0, y0 = gt.pixel_to_geo(0, 0)
    x1, y1 = gt.pixel_to_geo(w, 0)
    x2, y2 = gt.pixel_to_geo(w, h)
    x3, y3 = gt.pixel_to_geo(0, h)
    return f"POLYGON(({x0} {y0},{x1} {y1},{x2} {y2},{x3} {y3},{x0} {y0}))"


def _approx_stats(data: np.ndarray, nodata) -> Dict:
    valid = np.isfinite(data.astype(np.float64))
    if nodata is not None and not (isinstance(nodata, float)
                                   and math.isnan(nodata)):
        valid &= data != nodata
    n = int(valid.sum())
    mean = float(data[valid].mean()) if n else 0.0
    return {"means": [mean], "sample_counts": [n]}


def extract_geotiff(path: str, namespace: Optional[str] = None,
                    approx_stats: bool = False) -> Dict:
    with GeoTIFF(path) as g:
        stem = sanitize_namespace(
            os.path.splitext(os.path.basename(path))[0])
        ts = timestamp_from_filename(path)
        geo_md = []
        for b in range(1, g.count + 1):
            ns = namespace or (stem if g.count == 1 else f"{stem}_b{b}")
            ds = {
                "ds_name": f"{path}:{b}" if g.count > 1 else path,
                "namespace": ns,
                "array_type": NP_TO_GDAL.get(np.dtype(g.dtype), "Float32"),
                "proj_wkt": g.crs.to_wkt(),
                "proj4": g.crs.to_proj4(),
                "geotransform": list(g.gt.to_gdal()),
                "x_size": g.width,
                "y_size": g.height,
                "polygon": _polygon_wkt(g.gt, g.width, g.height),
                "timestamps": [ts] if ts else [],
                "timestamps_source": "filename" if ts else "",
                "nodata": g.nodata,
                "band": b,
                "overviews": [{"x_size": i.width, "y_size": i.height}
                              for _, i in g.overviews] or None,
            }
            if approx_stats:
                ds.update(_approx_stats(g.read(b), g.nodata))
            geo_md.append(ds)
    return {"filename": path, "file_type": "GeoTIFF", "geo_metadata": geo_md}


def extract_gmt(path: str, approx_stats: bool = False) -> Dict:
    """MAS record for a GMT grid (`gmtdataset.cpp:226-404` role): one
    band, geographic by GMT convention."""
    from ..geo.crs import EPSG4326
    from ..io.gmt import GMTGrid

    with GMTGrid(path) as g:
        stem = sanitize_namespace(
            os.path.splitext(os.path.basename(path))[0])
        ts = timestamp_from_filename(path)
        ds = {
            # the GMT: prefix keeps .nc/.grd-named GMT grids off the
            # NetCDF decode path (granule routing keys on ds_name)
            "ds_name": f'GMT:"{path}"',
            "namespace": stem,
            "array_type": NP_TO_GDAL.get(np.dtype(g.dtype), "Float32"),
            "proj_wkt": EPSG4326.to_wkt(),
            "proj4": EPSG4326.to_proj4(),
            "geotransform": list(g.gt.to_gdal()),
            "x_size": g.width,
            "y_size": g.height,
            "polygon": _polygon_wkt(g.gt, g.width, g.height),
            "timestamps": [ts] if ts else [],
            "timestamps_source": "filename" if ts else "",
            # GMT holes are NaN, which nodata_mask's finite check
            # already rejects; recording NaN here would round-trip the
            # store as NULL->0.0 and mask real zero-valued pixels
            "nodata": None,
            "band": 1,
            "overviews": None,
        }
        if approx_stats:
            ds.update(_approx_stats(g.read(1), g.nodata))
    return {"filename": path, "file_type": "GMT", "geo_metadata": [ds]}


def extract_hdf4(path: str, approx_stats: bool = False) -> Dict:
    """MAS record for an HDF4 / HDF-EOS grid file (the MODIS family the
    reference serves through GDAL's HDF4 reader): one namespace per
    scientific data set, georeferenced from StructMetadata.0 when
    present (sinusoidal or geographic), else pixel space.  Timestamps come from the filename (the MODIS
    ``AYYYYDDD`` pattern is in `_TIME_PATTERNS`)."""
    from ..geo.crs import EPSG4326
    from ..io.hdf4 import HDF4

    with HDF4(path) as h:
        stem = sanitize_namespace(
            os.path.splitext(os.path.basename(path))[0])
        ts = timestamp_from_filename(path)
        gt = h.gt or GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        crs = h.crs or EPSG4326
        geo_md = []
        for b, s in enumerate(h.sds, start=1):
            if len(s.dims) < 2:
                continue
            hh, ww = int(s.dims[-2]), int(s.dims[-1])
            ns = sanitize_namespace(s.name) or (
                stem if len(h.sds) == 1 else f"sds_{b}")
            ds = {
                # the trailing :band index is what granule expansion
                # (and the drill indexer) recover the band from — the
                # store has no band column (`granule.py:60-63`)
                "ds_name": f'HDF4:"{path}":{s.name}:{b}',
                "namespace": ns,
                "array_type": NP_TO_GDAL.get(
                    np.dtype(s.dtype.newbyteorder("=")), "Float32"),
                "proj_wkt": crs.to_wkt(),
                "proj4": crs.to_proj4(),
                "geotransform": list(gt.to_gdal()),
                "x_size": ww,
                "y_size": hh,
                "polygon": _polygon_wkt(gt, ww, hh),
                "timestamps": [ts] if ts else [],
                "timestamps_source": "filename" if ts else "",
                "nodata": s.fill,
                "band": b,
                "overviews": None,
            }
            if approx_stats:
                ds.update(_approx_stats(h.read(b), s.fill))
            geo_md.append(ds)
    return {"filename": path, "file_type": "HDF4",
            "geo_metadata": geo_md}


def extract_raster(path: str, approx_stats: bool = False) -> Dict:
    """MAS record for whatever else `io.registry` opens (the
    `GDALOpen`-for-everything-else role of `warp.go:89-101`).
    Georeferencing comes from the handle; srs defaults to EPSG:4326.
    A file no registered reader claims raises ValueError."""
    from ..geo.crs import EPSG4326
    from ..io.registry import open_raster

    h = open_raster(path)
    try:
        stem = sanitize_namespace(
            os.path.splitext(os.path.basename(path))[0])
        ts = timestamp_from_filename(path)
        gt = getattr(h, "gt", None) or GeoTransform(0, 1, 0, 0, 0, 1)
        crs = getattr(h, "crs", None) or EPSG4326
        count = getattr(h, "bands", 1)
        geo_md = []
        for b in range(1, count + 1):
            ns = stem if count == 1 else f"{stem}_b{b}"
            ds = {
                "ds_name": f"{path}:{b}" if count > 1 else path,
                "namespace": ns,
                "array_type": "Float32",
                "proj_wkt": crs.to_wkt(),
                "proj4": crs.to_proj4(),
                "geotransform": list(gt.to_gdal()),
                "x_size": h.width,
                "y_size": h.height,
                "polygon": _polygon_wkt(gt, h.width, h.height),
                "timestamps": [ts] if ts else [],
                "timestamps_source": "filename" if ts else "",
                "nodata": h.nodata,
                "band": b,
                "overviews": None,
            }
            if approx_stats:
                ds.update(_approx_stats(h.read(b), h.nodata))
            geo_md.append(ds)
    finally:
        h.close()
    return {"filename": path, "file_type": "Raster",
            "geo_metadata": geo_md}


def extract_netcdf(path: str, approx_stats: bool = False) -> Dict:
    with NetCDF(path) as nc:
        # curvilinear products carry 2-D lon/lat geolocation arrays
        # instead of an affine grid; detect them BEFORE geotransform(),
        # which raises for a swath without 1-D axis variables
        gl = nc.geoloc_vars()
        try:
            gt = nc.geotransform()
        except ValueError:
            if gl is None:
                raise
            gt = GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        ts = nc.timestamps()
        geo_loc = None
        gl_polygon = None
        if gl is not None:
            gx, gy = gl
            geo_loc = {"x_var": gx.name, "y_var": gy.name,
                       "line_offset": 0.0, "pixel_offset": 0.0,
                       "line_step": 1.0, "pixel_step": 1.0,
                       "srs": "EPSG:4326"}
            ax = np.asarray(gx[:], np.float64)
            ay = np.asarray(gy[:], np.float64)
            with np.errstate(invalid="ignore"):
                gl_polygon = (
                    f"POLYGON (({np.nanmin(ax)} {np.nanmin(ay)},"
                    f"{np.nanmax(ax)} {np.nanmin(ay)},"
                    f"{np.nanmax(ax)} {np.nanmax(ay)},"
                    f"{np.nanmin(ax)} {np.nanmax(ay)},"
                    f"{np.nanmin(ax)} {np.nanmin(ay)}))")
        geo_md = []
        for v in nc.raster_vars():
            crs = nc.crs(v)
            h, w = v.shape[-2], v.shape[-1]
            is_gl = gl is not None and gl[0].shape == (h, w)
            stamps = [fmt_time(t) for t in ts] if ts is not None else []
            ts_src = "axis" if stamps else ""
            if not stamps:
                fn_ts = timestamp_from_filename(path)
                stamps = [fn_ts] if fn_ts else []
                ts_src = "filename" if stamps else ""
            axes = []
            if len(v.shape) > 2 and ts is not None:
                axes.append({"name": "time", "params": list(map(float, ts)),
                             "strides": [1], "shape": [len(ts)],
                             "grid": "default"})
            ds = {
                "ds_name": f'NETCDF:"{path}":{v.name}',
                "namespace": v.name,
                "array_type": NP_TO_GDAL.get(
                    np.dtype(v.dtype.newbyteorder("=")), "Float32"),
                "proj_wkt": "EPSG:4326" if is_gl else crs.to_wkt(),
                "proj4": "+proj=longlat +datum=WGS84 +no_defs"
                if is_gl else crs.to_proj4(),
                "geotransform": list(gt.to_gdal()),
                "x_size": w,
                "y_size": h,
                "polygon": gl_polygon if is_gl else _polygon_wkt(gt, w, h),
                "timestamps": stamps,
                "timestamps_source": ts_src,
                "nodata": v.nodata,
                "axes": axes or None,
            }
            if is_gl:
                ds["geo_loc"] = geo_loc
            if approx_stats and len(v.shape) == 3:
                means, counts = [], []
                for t in range(v.shape[0]):
                    st = _approx_stats(nc.read_slice(v.name, t), v.nodata)
                    means.append(st["means"][0])
                    counts.append(st["sample_counts"][0])
                ds["means"] = means
                ds["sample_counts"] = counts
            geo_md.append(ds)
    return {"filename": path, "file_type": "NetCDF", "geo_metadata": geo_md}


def extract(path: str, approx_stats: bool = False) -> Dict:
    """Extract one file's MAS record, routed by its extension and magic
    bytes.  Never raises: a file that cannot be read, or that no reader
    claims, yields an error record with no datasets."""
    path = os.path.abspath(path)  # MAS scopes queries by path prefix
    low = path.lower()

    def _nc_or_gmt():
        # GMT grids share the CDF magic; the variable layout decides.
        # Non-NetCDF files wearing these extensions go to the registry
        with open(path, "rb") as fp:
            m = fp.read(8)
        if m[:3] != b"CDF" and m[:8] != _HDF5_MAGIC:
            return extract_raster(path, approx_stats=approx_stats)
        from ..io.gmt import is_gmt
        if is_gmt(path):
            return extract_gmt(path, approx_stats)
        return extract_netcdf(path, approx_stats)

    try:
        if low.endswith((".nc", ".nc4", ".cdf", ".grd")):
            return _nc_or_gmt()
        if low.endswith((".tif", ".tiff", ".gtiff")):
            return extract_geotiff(path, approx_stats=approx_stats)
        # sniff (.hdf may be HDF4 *or* HDF5-based, so magic decides)
        with open(path, "rb") as fp:
            magic = fp.read(8)
        if magic[:3] == b"CDF" or magic[:8] == _HDF5_MAGIC:
            return _nc_or_gmt()
        if magic[:4] == _HDF4_MAGIC:
            return extract_hdf4(path, approx_stats=approx_stats)
        if magic[:4] in _TIFF_MAGIC:
            return extract_geotiff(path, approx_stats=approx_stats)
        return extract_raster(path, approx_stats=approx_stats)
    except Exception as e:
        return {"filename": path, "file_type": "", "error": str(e),
                "geo_metadata": []}
