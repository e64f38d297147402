"""File crawler: one MAS record per raster file.

Counterpart of the GeoTIFF part of `gsky_tpu/index/crawler.py`:
`extract` opens a GeoTIFF and emits the {"filename", "file_type",
"geo_metadata": [...]} record `MASStore.ingest` takes, with the
timestamp parsed from the file name.
"""

from __future__ import annotations

import datetime as dt
import os
import re
from typing import Dict, Optional

import numpy as np

from ..geo.transform import GeoTransform
from ..io.geotiff import GeoTIFF
from ..ops.raster import NP_TO_GDAL
from .store import ISO, sanitize_namespace

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


def extract_geotiff(path: str, namespace: Optional[str] = None) -> Dict:
    with GeoTIFF(path) as g:
        stem = sanitize_namespace(
            os.path.splitext(os.path.basename(path))[0])
        ts = timestamp_from_filename(path)
        geo_md = []
        for b in range(1, g.count + 1):
            ns = namespace or (stem if g.count == 1 else f"{stem}_b{b}")
            geo_md.append({
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
            })
    return {"filename": path, "file_type": "GeoTIFF", "geo_metadata": geo_md}


def extract(path: str) -> Dict:
    """Extract one GeoTIFF's MAS record.  Never raises: a file that
    cannot be read yields an error record with no datasets."""
    path = os.path.abspath(path)  # MAS scopes queries by path prefix
    try:
        return extract_geotiff(path)
    except (OSError, ValueError) as e:
        return {"filename": path, "file_type": "", "error": str(e),
                "geo_metadata": []}
