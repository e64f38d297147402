"""Polygon geometry for the metadata index and the drill mask burn.

Counterpart of the parts of `gsky_tpu/geo/geometry.py` that
`index/store.py` and the drill need: WKT parsing and writing, vertex
transforms, bbox, segmentize, point-in-polygon, the antimeridian split,
clipping to a box (polygon tiling), planar area, GeoJSON parsing (the
WPS geometry input), and `rasterize`, the drill's ALL_TOUCHED polygon
burn (GDALRasterizeGeometries with ALL_TOUCHED=TRUE,
`worker/gdalprocess/drill.go:275-327`).
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .transform import BBox

Ring = np.ndarray  # (N, 2) float64


@dataclass
class Geometry:
    """Point / LineString / Polygon / MultiPolygon.  ``polys`` holds
    polygons as ring lists (exterior first); points and lines live in
    ``points``."""

    kind: str
    polys: List[List[Ring]] = field(default_factory=list)
    points: Optional[np.ndarray] = None

    def bbox(self) -> BBox:
        arrs = []
        if self.points is not None:
            arrs.append(self.points)
        for poly in self.polys:
            arrs.extend(poly)
        pts = np.concatenate(arrs, axis=0)
        return BBox(float(pts[:, 0].min()), float(pts[:, 1].min()),
                    float(pts[:, 0].max()), float(pts[:, 1].max()))

    def transform(self, fn) -> "Geometry":
        """Apply fn(x_array, y_array) -> (x, y) to every vertex."""
        def t(a):
            x, y = fn(a[:, 0], a[:, 1])
            return np.stack([np.asarray(x), np.asarray(y)], axis=1)
        return Geometry(
            self.kind,
            polys=[[t(r) for r in poly] for poly in self.polys],
            points=t(self.points) if self.points is not None else None,
        )

    def area(self) -> float:
        """Planar area (units of the coordinate system squared)."""
        total = 0.0
        for poly in self.polys:
            for i, ring in enumerate(poly):
                a = abs(_shoelace(ring))
                total += a if i == 0 else -a
        return total

    def contains_point(self, x: float, y: float) -> bool:
        for poly in self.polys:
            if _point_in_ring(poly[0], x, y):
                if not any(_point_in_ring(h, x, y) for h in poly[1:]):
                    return True
        return False

    def segmentize(self, max_len: float) -> "Geometry":
        """Insert vertices so no segment exceeds max_len."""
        def seg(r):
            out = [r[0]]
            for i in range(1, len(r)):
                p0, p1 = r[i - 1], r[i]
                d = math.hypot(p1[0] - p0[0], p1[1] - p0[1])
                n = max(1, int(math.ceil(d / max_len)))
                for k in range(1, n + 1):
                    out.append(p0 + (p1 - p0) * (k / n))
            return np.asarray(out)
        return Geometry(self.kind,
                        polys=[[seg(r) for r in poly] for poly in self.polys],
                        points=self.points)

    def clip_bbox(self, b: BBox) -> "Geometry":
        """Polygon intersection with an axis-aligned box (four
        Sutherland-Hodgman half-plane passes per ring).  Polygons whose
        exterior clips away drop; holes clip with their polygon."""
        def clip_ring(r):
            c = r
            for axis, bound, keep_le in ((0, b.xmin, False),
                                         (0, b.xmax, True),
                                         (1, b.ymin, False),
                                         (1, b.ymax, True)):
                if not len(c):
                    break
                c = _clip_ring_halfplane(c, axis, bound, keep_le)
            return c

        polys = []
        for rings in self.polys:
            ext = clip_ring(rings[0]) if rings else np.zeros((0, 2))
            # degenerate output (fewer than 4 points) drops: an
            # ALL_TOUCHED burn would count a sliver ring's pixels
            if len(ext) < 4:
                continue
            keep = [ext]
            for hole in rings[1:]:
                h = clip_ring(hole)
                if len(h) >= 4:
                    keep.append(h)
            polys.append(keep)
        kind = "MultiPolygon" if len(polys) > 1 else "Polygon"
        return Geometry(kind, polys=polys)

    @property
    def is_empty(self) -> bool:
        return not self.polys or all(
            not rings or not len(rings[0]) for rings in self.polys)

    def to_wkt(self, ndigits: int = 8) -> str:
        def fmt(v):
            s = f"{v:.{ndigits}f}".rstrip("0").rstrip(".")
            return s if s not in ("-0", "") else "0"

        def ring_wkt(r):
            pts = list(r)
            if len(pts) and (pts[0][0] != pts[-1][0]
                             or pts[0][1] != pts[-1][1]):
                pts.append(pts[0])
            return "(" + ",".join(f"{fmt(p[0])} {fmt(p[1])}"
                                  for p in pts) + ")"

        if self.kind == "Point":
            p = self.points[0]
            return f"POINT({fmt(p[0])} {fmt(p[1])})"
        if self.kind in ("LineString", "MultiPoint"):
            body = ",".join(f"{fmt(p[0])} {fmt(p[1])}" for p in self.points)
            return f"{self.kind.upper()}({body})"
        if self.kind == "Polygon":
            return "POLYGON(" + ",".join(ring_wkt(r)
                                         for r in self.polys[0]) + ")"
        if self.kind == "MultiPolygon":
            return "MULTIPOLYGON(" + ",".join(
                "(" + ",".join(ring_wkt(r) for r in poly) + ")"
                for poly in self.polys) + ")"
        raise ValueError(self.kind)

    def split_dateline(self) -> "Geometry":
        """Split polygons whose longitudes span the antimeridian into
        parts on both sides of +/-180."""
        if self.kind not in ("Polygon", "MultiPolygon"):
            return self
        out_polys: List[List[Ring]] = []
        changed = False
        for poly in self.polys:
            ext = poly[0]
            lons = ext[:, 0]
            if lons.max() - lons.min() <= 180.0:
                out_polys.append(poly)
                continue
            changed = True
            shifted = [r.copy() for r in poly]
            for r in shifted:
                r[:, 0] = np.where(r[:, 0] < 0, r[:, 0] + 360.0, r[:, 0])
            east = [_clip_ring_halfplane(r, 0, 180.0, keep_le=True)
                    for r in shifted]
            west = [_clip_ring_halfplane(r, 0, 180.0, keep_le=False)
                    for r in shifted]
            east = [r for r in east if len(r) >= 4]
            west = [r for r in west if len(r) >= 4]
            # an exactly degenerate shifted exterior was never crossing
            # (vertices on +/-180): keep the polygon whole
            if abs(_shoelace(shifted[0])) == 0.0:
                out_polys.append(poly)
                continue
            if east:
                out_polys.append(east)
            if west:
                for r in west:
                    r[:, 0] -= 360.0
                out_polys.append(west)
        if not changed:
            return self
        if len(out_polys) == 1:
            return Geometry("Polygon", polys=out_polys)
        return Geometry("MultiPolygon", polys=out_polys)


def _clip_ring_halfplane(ring: Ring, axis: int, bound: float,
                         keep_le: bool) -> Ring:
    """Sutherland-Hodgman clip of a ring against an axis-aligned
    half-plane, closing the result."""
    def inside(p):
        return p[axis] <= bound if keep_le else p[axis] >= bound

    def cross(p0, p1):
        t = (bound - p0[axis]) / (p1[axis] - p0[axis])
        q = p0 + t * (np.asarray(p1, np.float64) - p0)
        q[axis] = bound
        return q

    pts = [np.asarray(p, np.float64) for p in ring]
    if len(pts) and np.array_equal(pts[0], pts[-1]):
        pts = pts[:-1]
    out: List[np.ndarray] = []
    for i, p1 in enumerate(pts):
        p0 = pts[i - 1]
        if inside(p1):
            if not inside(p0):
                out.append(cross(p0, p1))
            out.append(np.asarray(p1, np.float64))
        elif inside(p0):
            out.append(cross(p0, p1))
    if len(out) < 3:
        return np.zeros((0, 2))
    out.append(out[0])
    return np.asarray(out, np.float64)


def _shoelace(ring: Ring) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _point_in_ring(ring: Ring, px: float, py: float) -> bool:
    x, y = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    cond = (y > py) != (y2 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x + (py - y) * (x2 - x) / (y2 - y)
    crossings = np.count_nonzero(cond & (px < xint))
    return bool(crossings % 2)


# ---------------------------------------------------------------------------
# Rasterization: the drill mask burn
# ---------------------------------------------------------------------------

def rasterize(geom: Geometry, width: int, height: int,
              geo_to_pixel, all_touched: bool = True) -> np.ndarray:
    """Burn a geometry into a (height, width) uint8 mask.
    ``geo_to_pixel(x_arr, y_arr) -> (col, row)`` maps geometry
    coordinates to fractional pixel coordinates.  ``all_touched=True``
    also sets every pixel the boundary passes through."""
    mask = np.zeros((height, width), dtype=np.uint8)
    if geom.kind in ("Point", "MultiPoint"):
        c, r = geo_to_pixel(geom.points[:, 0], geom.points[:, 1])
        c = np.floor(np.asarray(c)).astype(int)
        r = np.floor(np.asarray(r)).astype(int)
        ok = (c >= 0) & (c < width) & (r >= 0) & (r < height)
        mask[r[ok], c[ok]] = 1
        return mask
    if geom.kind == "LineString":
        c, r = geo_to_pixel(geom.points[:, 0], geom.points[:, 1])
        px = np.stack([np.asarray(c, dtype=np.float64),
                       np.asarray(r, dtype=np.float64)], axis=1)
        _burn_lines(mask, px)
        return mask
    for poly in geom.polys:
        rings_px = []
        for ring in poly:
            c, r = geo_to_pixel(ring[:, 0], ring[:, 1])
            rings_px.append(np.stack([np.asarray(c, dtype=np.float64),
                                      np.asarray(r, dtype=np.float64)],
                                     axis=1))
        _fill_polygon(mask, rings_px, all_touched)
    return mask


def _fill_polygon(mask: np.ndarray, rings: List[np.ndarray],
                  all_touched: bool):
    """Even-odd scanline fill at pixel centres (row + 0.5), vectorised
    over edges: each edge's crossings of its active rows at once, then
    the crossings sorted per row and paired."""
    height, width = mask.shape

    def close(r):
        if len(r) and (r[0][0] != r[-1][0] or r[0][1] != r[-1][1]):
            return np.vstack([r, r[:1]])
        return r

    rings = [close(r) for r in rings]
    ey0, ey1, ex0, eslope = [], [], [], []
    for pts in rings:
        if len(pts) < 3:
            continue
        x0, y0 = pts[:-1, 0], pts[:-1, 1]
        x1, y1 = pts[1:, 0], pts[1:, 1]
        nz = y0 != y1
        x0, y0, x1, y1 = x0[nz], y0[nz], x1[nz], y1[nz]
        swap = y0 > y1
        x0s = np.where(swap, x1, x0)
        y0s = np.where(swap, y1, y0)
        x1s = np.where(swap, x0, x1)
        y1s = np.where(swap, y0, y1)
        ey0.append(y0s)
        ey1.append(y1s)
        ex0.append(x0s)
        eslope.append((x1s - x0s) / (y1s - y0s))
    if not ey0:
        return
    y0 = np.concatenate(ey0)
    y1 = np.concatenate(ey1)
    x0 = np.concatenate(ex0)
    slope = np.concatenate(eslope)
    # active rows per edge: y0 <= row + 0.5 < y1
    r0 = np.maximum(np.ceil(y0 - 0.5).astype(np.int64), 0)
    r1 = np.minimum(np.ceil(y1 - 0.5).astype(np.int64), height)
    counts = np.maximum(r1 - r0, 0)
    total = int(counts.sum())
    if total:
        eidx = np.repeat(np.arange(len(y0)), counts)
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        rows = r0[eidx] + (np.arange(total) - starts)
        xs = x0[eidx] + (rows + 0.5 - y0[eidx]) * slope[eidx]
        order = np.lexsort((xs, rows))
        rows, xs = rows[order], xs[order]
        row_start = np.searchsorted(rows, np.arange(height), side="left")
        row_end = np.searchsorted(rows, np.arange(height), side="right")
        for row in range(height):
            s, e = row_start[row], row_end[row]
            if s >= e:
                continue
            rxs = xs[s:e]
            for i in range(0, len(rxs) - 1, 2):
                c0 = int(math.ceil(rxs[i] - 0.5))
                c1 = int(math.floor(rxs[i + 1] - 0.5))
                if c1 >= 0 and c0 < width:
                    mask[row, max(c0, 0):min(c1, width - 1) + 1] = 1
    if all_touched:
        for ring in rings:
            _burn_lines(mask, ring)


def _burn_lines(mask: np.ndarray, ring: np.ndarray):
    """Set every pixel a polyline passes through (half-pixel samples)."""
    height, width = mask.shape
    for i in range(len(ring) - 1):
        x0, y0 = ring[i]
        x1, y1 = ring[i + 1]
        n = int(max(abs(x1 - x0), abs(y1 - y0)) * 2) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        cx = np.floor(x0 + (x1 - x0) * t).astype(int)
        cy = np.floor(y0 + (y1 - y0) * t).astype(int)
        ok = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
        mask[cy[ok], cx[ok]] = 1


def _parse_ring_text(t: str) -> np.ndarray:
    pts = []
    for pair in t.split(","):
        xy = pair.split()
        pts.append((float(xy[0]), float(xy[1])))
    return np.asarray(pts, dtype=np.float64)


def _split_parens(t: str) -> List[str]:
    """Contents of each top-level parenthesised group."""
    out, depth, cur = [], 0, []
    for ch in t:
        if ch == "(":
            depth += 1
            if depth == 1:
                cur = []
                continue
        elif ch == ")":
            depth -= 1
            if depth == 0:
                out.append("".join(cur))
                continue
        if depth >= 1:
            cur.append(ch)
    return out


def from_wkt(wkt: str) -> Geometry:
    s = wkt.strip()
    m = re.match(r"^\s*(\w+)\s*\((.*)\)\s*$", s, re.S)
    if not m:
        raise ValueError(f"bad WKT: {wkt[:80]!r}")
    kind = m.group(1).upper()
    body = m.group(2)
    if kind == "POINT":
        xy = body.split()
        return Geometry("Point", points=np.array(
            [[float(xy[0]), float(xy[1])]], dtype=np.float64))
    if kind == "LINESTRING":
        return Geometry("LineString", points=_parse_ring_text(body))
    if kind == "POLYGON":
        rings = [_parse_ring_text(r) for r in _split_parens(body)]
        return Geometry("Polygon", polys=[rings])
    if kind == "MULTIPOLYGON":
        polys = []
        for poly_txt in _split_parens(body):
            rings = [_parse_ring_text(r) for r in _split_parens(poly_txt)]
            polys.append(rings)
        return Geometry("MultiPolygon", polys=polys)
    raise ValueError(f"unsupported WKT type {kind}")


def from_geojson(obj) -> Geometry:
    """A GeoJSON geometry, Feature or FeatureCollection (its first
    feature), as the WPS geometry input arrives."""
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    t = obj.get("type")
    if t == "FeatureCollection":
        feats = obj.get("features") or []
        if not feats:
            raise ValueError("empty FeatureCollection")
        return from_geojson(feats[0])
    if t == "Feature":
        return from_geojson(obj["geometry"])
    coords = obj.get("coordinates")
    if t == "Point":
        return Geometry("Point", points=np.array(
            [[float(coords[0]), float(coords[1])]], dtype=np.float64))
    if t == "LineString":
        return Geometry("LineString",
                        points=np.asarray(coords, dtype=np.float64))
    if t == "Polygon":
        return Geometry("Polygon", polys=[[np.asarray(r, dtype=np.float64)
                                           for r in coords]])
    if t == "MultiPolygon":
        return Geometry("MultiPolygon",
                        polys=[[np.asarray(r, dtype=np.float64) for r in poly]
                               for poly in coords])
    raise ValueError(f"unsupported GeoJSON type {t}")
