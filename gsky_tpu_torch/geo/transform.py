"""Affine geotransforms, bounding boxes and extent reprojection.

Counterpart of `gsky_tpu/geo/transform.py` (host numpy path): `BBox`,
`GeoTransform`, `transform_bbox`, `pixel_resolution`, and the WCS
export's `suggest_output_size` and `split_bbox`, with the reference's
arithmetic order so both packages compute the same float64 coordinates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from .crs import CRS, EPSG3857


@dataclass(frozen=True)
class BBox:
    """Axis-aligned bounding box in some CRS: (xmin, ymin, xmax, ymax)."""

    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def width(self) -> float:
        return self.xmax - self.xmin

    @property
    def height(self) -> float:
        return self.ymax - self.ymin

    def intersects(self, other: "BBox") -> bool:
        return not (self.xmax <= other.xmin or other.xmax <= self.xmin
                    or self.ymax <= other.ymin or other.ymax <= self.ymin)

    def buffer(self, d: float) -> "BBox":
        return BBox(self.xmin - d, self.ymin - d, self.xmax + d, self.ymax + d)

    def to_polygon_wkt(self) -> str:
        return (f"POLYGON(({self.xmin} {self.ymin},{self.xmax} {self.ymin},"
                f"{self.xmax} {self.ymax},{self.xmin} {self.ymax},"
                f"{self.xmin} {self.ymin}))")


@dataclass(frozen=True)
class GeoTransform:
    """GDAL-style affine geotransform.

    ``x = x0 + col*dx + row*rx``, ``y = y0 + col*ry + row*dy`` where
    (x0, y0) is the outer corner of pixel (0, 0)."""

    x0: float
    dx: float
    rx: float
    y0: float
    ry: float
    dy: float

    @classmethod
    def from_gdal(cls, g: Sequence[float]) -> "GeoTransform":
        return cls(g[0], g[1], g[2], g[3], g[4], g[5])

    def to_gdal(self) -> Tuple[float, ...]:
        return (self.x0, self.dx, self.rx, self.y0, self.ry, self.dy)

    @classmethod
    def from_bbox(cls, bbox: BBox, width: int, height: int) -> "GeoTransform":
        """North-up transform covering bbox with width x height pixels."""
        return cls(bbox.xmin, bbox.width / width, 0.0,
                   bbox.ymax, 0.0, -bbox.height / height)

    def pixel_to_geo(self, col, row):
        """(col,row) pixel coords (fractional, origin at corner) -> (x,y)."""
        x = self.x0 + col * self.dx + row * self.rx
        y = self.y0 + col * self.ry + row * self.dy
        return x, y

    def geo_to_pixel(self, x, y):
        """(x,y) -> fractional (col,row)."""
        det = self.dx * self.dy - self.rx * self.ry
        inv_dx = self.dy / det
        inv_rx = -self.rx / det
        inv_ry = -self.ry / det
        inv_dy = self.dx / det
        dxv = x - self.x0
        dyv = y - self.y0
        col = inv_dx * dxv + inv_rx * dyv
        row = inv_ry * dxv + inv_dy * dyv
        return col, row

    def bbox(self, width: int, height: int) -> BBox:
        xs, ys = [], []
        for c, r in ((0, 0), (width, 0), (0, height), (width, height)):
            x, y = self.pixel_to_geo(c, r)
            xs.append(x)
            ys.append(y)
        return BBox(min(xs), min(ys), max(xs), max(ys))

    @property
    def is_north_up(self) -> bool:
        return self.rx == 0.0 and self.ry == 0.0

    def resolution(self) -> Tuple[float, float]:
        return (math.hypot(self.dx, self.ry), math.hypot(self.rx, self.dy))

    def window(self, col0: int, row0: int) -> "GeoTransform":
        """Transform for a sub-window starting at pixel (col0, row0)."""
        x0, y0 = self.pixel_to_geo(col0, row0)
        return GeoTransform(x0, self.dx, self.rx, y0, self.ry, self.dy)

    def scaled(self, fx: float, fy: float) -> "GeoTransform":
        """Transform for the same extent at resolution scaled by (fx, fy)
        (fx > 1 means coarser pixels) — the overview georeferencing."""
        return GeoTransform(self.x0, self.dx * fx, self.rx * fy,
                            self.y0, self.ry * fx, self.dy * fy)

    def decimated(self, st: int) -> "GeoTransform":
        """Transform for a [::st, ::st] strided sampling of this grid:
        decimated pixel k holds the value of full-resolution pixel
        k*st, so the origin shifts back by (st-1)/2 pixels to keep
        sample centres where they were."""
        return GeoTransform(
            self.x0 - (st - 1) / 2 * (self.dx + self.rx),
            self.dx * st, self.rx * st,
            self.y0 - (st - 1) / 2 * (self.ry + self.dy),
            self.ry * st, self.dy * st)


def transform_bbox(bbox: BBox, src: CRS, dst: CRS, densify: int = 21) -> BBox:
    """Reproject a bbox by densified edge sampling."""
    if src == dst:
        return bbox
    t = np.linspace(0.0, 1.0, densify)
    xs = bbox.xmin + t * bbox.width
    ys = bbox.ymin + t * bbox.height
    ex = np.concatenate([xs, xs, np.full_like(t, bbox.xmin),
                         np.full_like(t, bbox.xmax)])
    ey = np.concatenate([np.full_like(t, bbox.ymin),
                         np.full_like(t, bbox.ymax), ys, ys])
    ox, oy = src.transform_to(dst, ex, ey)
    ok = np.isfinite(ox) & np.isfinite(oy)
    if not ok.any():
        raise ValueError("bbox does not transform into destination CRS")
    return BBox(float(np.min(ox[ok])), float(np.min(oy[ok])),
                float(np.max(ox[ok])), float(np.max(oy[ok])))


def pixel_resolution(bbox: BBox, crs: CRS, width: int, height: int) -> float:
    """EPSG:3857 metres per pixel of a request (the zoom-limit test)."""
    c = transform_bbox(bbox, crs, EPSG3857)
    return max(c.width / width, c.height / height)


def suggest_output_size(src_gt: GeoTransform, src_w: int, src_h: int,
                        src_crs: CRS, dst_crs: CRS,
                        max_size: int = 65536) -> Tuple[BBox, int, int]:
    """A destination extent and pixel size that roughly keep the source
    resolution (the role of GDALSuggestedWarpOutput): the source extent
    reprojected, at the destination length of one source pixel step
    taken at the centre."""
    src_bbox = src_gt.bbox(src_w, src_h)
    dst_bbox = transform_bbox(src_bbox, src_crs, dst_crs)
    cx = (src_bbox.xmin + src_bbox.xmax) / 2
    cy = (src_bbox.ymin + src_bbox.ymax) / 2
    rx, ry = src_gt.resolution()
    x2, y2 = src_crs.transform_to(dst_crs, np.array([cx, cx + rx]),
                                  np.array([cy, cy + ry]))
    dres = max(min(abs(float(x2[1] - x2[0])), abs(float(y2[1] - y2[0]))),
               1e-9)
    w = max(1, min(max_size, int(round(dst_bbox.width / dres))))
    h = max(1, min(max_size, int(round(dst_bbox.height / dres))))
    return dst_bbox, w, h


def split_bbox(bbox: BBox, width: int, height: int,
               tile_w: int, tile_h: int):
    """Cut an output raster into tiles of at most tile_w x tile_h, row
    by row: [(tile_bbox, off_x, off_y, tw, th), ...], the edge tiles
    ragged."""
    gt = GeoTransform.from_bbox(bbox, width, height)
    out = []
    for row0 in range(0, height, tile_h):
        th = min(tile_h, height - row0)
        for col0 in range(0, width, tile_w):
            tw = min(tile_w, width - col0)
            x0, y0 = gt.pixel_to_geo(col0, row0)
            x1, y1 = gt.pixel_to_geo(col0 + tw, row0 + th)
            out.append((BBox(min(x0, x1), min(y0, y1), max(x0, x1),
                             max(y0, y1)), col0, row0, tw, th))
    return out
