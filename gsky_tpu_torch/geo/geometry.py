"""Polygon geometry for the metadata index's intersects test.

Counterpart of the parts of `gsky_tpu/geo/geometry.py` that
`index/store.py` needs: WKT polygon parsing, vertex transforms, bbox,
segmentize, point-in-polygon and the antimeridian split.
"""

from __future__ import annotations

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
