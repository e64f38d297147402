"""WCS auto-size: the output size that keeps the source resolution.

Counterpart of `gsky_tpu/pipeline/extent.py`: for each dataset the
index matches, the destination pixel size that keeps its resolution
(`geo.transform.suggest_output_size`), scaled to the request's share
of that dataset's extent; the largest over the datasets.
"""

from __future__ import annotations

from typing import Tuple

from ..geo import geometry as geom
from ..geo.crs import parse_crs
from ..geo.transform import GeoTransform, suggest_output_size
from ..index.client import MASClient
from ..index.store import fmt_time
from .types import GeoTileRequest


def compute_reprojection_extent(mas: MASClient, req: GeoTileRequest,
                                max_size: int = 65536) -> Tuple[int, int]:
    """(width, height) for the request bbox; (0, 0) when no dataset
    matches."""
    kw = dict(srs=req.crs.name(), wkt=req.bbox.to_polygon_wkt(),
              namespaces=",".join(req.band_exprs.var_list),
              nseg=req.polygon_segments)
    if req.start_time is not None:
        kw["time"] = fmt_time(req.start_time)
    if req.end_time is not None:
        kw["until"] = fmt_time(req.end_time)
    best_w = best_h = 0
    for ds in mas.intersects(req.collection, **kw):
        if not ds.geo_transform or not ds.srs:
            continue
        try:
            src_crs = parse_crs(ds.srs)
        except ValueError:
            continue
        gt = GeoTransform.from_gdal(ds.geo_transform)
        # the source size, from the footprint polygon's bbox
        try:
            b = geom.from_wkt(ds.polygon).bbox()
        except ValueError:
            continue
        c0, r0 = gt.geo_to_pixel(b.xmin, b.ymax)
        c1, r1 = gt.geo_to_pixel(b.xmax, b.ymin)
        w = abs(int(round(c1 - c0)))
        h = abs(int(round(r1 - r0)))
        if w < 2 or h < 2:
            continue
        try:
            dst_bbox, sw, sh = suggest_output_size(gt, w, h, src_crs,
                                                   req.crs, max_size)
        except ValueError:
            continue
        if dst_bbox.width <= 0 or dst_bbox.height <= 0:
            continue
        fw = req.bbox.width / dst_bbox.width
        fh = req.bbox.height / dst_bbox.height
        best_w = max(best_w, min(int(round(sw * fw)), max_size))
        best_h = max(best_h, min(int(round(sh * fh)), max_size))
    return best_w, best_h
