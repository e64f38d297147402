"""Geolocation-array (curvilinear grid) support.

Counterpart of `gsky_tpu/geo/geoloc.py` (host numpy, float64; the same
formulas and op order, so both packages invert to the same bits).  A
curvilinear product carries 2-D per-sample longitude/latitude arrays
instead of an affine geotransform.  The port inverts them only at the
host-side control points of the approx transformer
(`pipeline.executor._geoloc_ctrl`); the control grid then carries
fractional source PIXEL coordinates with an identity affine, and the
warp kernels (B1, B2) reconstruct the dense map bilinearly exactly as
they do for projected grids.

Inversion: a coarse scatter-filled backmap gives the initial guess,
then damped Newton iterations on the bilinear surface refine it.
Out-of-domain queries extrapolate linearly from the nearest edge cell,
so coordinates fall outside [0, W) and the kernels' bounds checks
reject them per pixel.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np


class GeolocGrid:
    """gx/gy: (gh, gw) geolocation arrays — the geographic coordinates
    of raster samples; raster pixel (col, row) maps to array index
    (j, i) via col = pixel_offset + pixel_step * j (GDAL GEOLOCATION
    metadata convention, offsets/steps from the crawler's geo_loc
    record)."""

    def __init__(self, gx: np.ndarray, gy: np.ndarray,
                 line_offset: float = 0.0, pixel_offset: float = 0.0,
                 line_step: float = 1.0, pixel_step: float = 1.0,
                 backmap_size: int = 64):
        self.gx = np.asarray(gx, np.float64)
        self.gy = np.asarray(gy, np.float64)
        if self.gx.shape != self.gy.shape or self.gx.ndim != 2:
            raise ValueError("geolocation arrays must be matching 2-D")
        self.line_offset = float(line_offset)
        self.pixel_offset = float(pixel_offset)
        self.line_step = float(line_step)
        self.pixel_step = float(pixel_step)
        # antimeridian-crossing swaths: adjacent samples jumping ~360°
        # would make the bilinear surface non-invertible at the seam;
        # unwrap to a continuous +[180, 360) branch (queries shift onto
        # the same branch in invert())
        self._wraps = False
        with np.errstate(invalid="ignore"):
            jumps = max(
                float(np.nanmax(np.abs(np.diff(self.gx, axis=0)))
                      if self.gx.shape[0] > 1 else 0.0),
                float(np.nanmax(np.abs(np.diff(self.gx, axis=1)))
                      if self.gx.shape[1] > 1 else 0.0))
        if jumps > 180.0:
            self._wraps = True
            self.gx = np.where(self.gx < 0.0, self.gx + 360.0, self.gx)
        self._build_backmap(backmap_size)

    # -- backmap --------------------------------------------------------

    def _build_backmap(self, n: int):
        gh, gw = self.gx.shape
        finite = np.isfinite(self.gx) & np.isfinite(self.gy)
        if not finite.any():
            raise ValueError("geolocation arrays are all-invalid")
        self.x0 = float(np.nanmin(np.where(finite, self.gx, np.nan)))
        self.x1 = float(np.nanmax(np.where(finite, self.gx, np.nan)))
        self.y0 = float(np.nanmin(np.where(finite, self.gy, np.nan)))
        self.y1 = float(np.nanmax(np.where(finite, self.gy, np.nan)))
        self._bn = n
        sx = (self.x1 - self.x0) or 1.0
        sy = (self.y1 - self.y0) or 1.0
        bi = np.full((n, n), -1.0)
        bj = np.full((n, n), -1.0)
        ii, jj = np.nonzero(finite)
        bx = np.clip(((self.gx[ii, jj] - self.x0) / sx * (n - 1)), 0,
                     n - 1).astype(np.int64)
        by = np.clip(((self.gy[ii, jj] - self.y0) / sy * (n - 1)), 0,
                     n - 1).astype(np.int64)
        # last write wins per bin — any sample in the bin is a fine seed
        bi[by, bx] = ii
        bj[by, bx] = jj
        # hole-fill by nearest-neighbour dilation so every bin seeds
        for _ in range(2 * n):
            holes = bi < 0
            if not holes.any():
                break
            for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                src_i = np.roll(bi, (dy, dx), (0, 1))
                src_j = np.roll(bj, (dy, dx), (0, 1))
                take = holes & (src_i >= 0)
                bi[take] = src_i[take]
                bj[take] = src_j[take]
                holes = bi < 0
        self._bi = bi
        self._bj = bj

    # -- bilinear sample with linear extrapolation ----------------------

    def _sample(self, arr: np.ndarray, i: np.ndarray, j: np.ndarray):
        """Bilinear value + partials at fractional (i, j); cells clamp to
        the grid so out-of-bounds queries extend the edge cell
        linearly."""
        gh, gw = arr.shape
        i0 = np.clip(np.floor(i).astype(np.int64), 0, gh - 2)
        j0 = np.clip(np.floor(j).astype(np.int64), 0, gw - 2)
        ti = i - i0
        tj = j - j0
        a00 = arr[i0, j0]
        a01 = arr[i0, j0 + 1]
        a10 = arr[i0 + 1, j0]
        a11 = arr[i0 + 1, j0 + 1]
        v = (a00 * (1 - ti) * (1 - tj) + a01 * (1 - ti) * tj
             + a10 * ti * (1 - tj) + a11 * ti * tj)
        dvi = (a10 - a00) * (1 - tj) + (a11 - a01) * tj
        dvj = (a01 - a00) * (1 - ti) + (a11 - a10) * ti
        return v, dvi, dvj

    # -- inversion ------------------------------------------------------

    def invert(self, x, y, iters: int = 12) -> Tuple[np.ndarray,
                                                     np.ndarray]:
        """Geographic (x, y) -> fractional raster pixel coords
        (col, row), corner-based (sample j's centre is at col j + 0.5),
        ready for the warp kernels' identity-affine control grids.
        Out-of-domain points extrapolate past the grid edge and land
        outside [0, size) where the kernel bounds checks reject them."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if self._wraps:
            x = np.where(x < 0.0, x + 360.0, x)
        shape = x.shape
        xf = x.ravel()
        yf = y.ravel()
        gh, gw = self.gx.shape
        n = self._bn
        sx = (self.x1 - self.x0) or 1.0
        sy = (self.y1 - self.y0) or 1.0
        bxi = np.clip(((xf - self.x0) / sx * (n - 1)), 0,
                      n - 1)
        byi = np.clip(((yf - self.y0) / sy * (n - 1)), 0, n - 1)
        with np.errstate(invalid="ignore"):
            bxi = np.nan_to_num(bxi).astype(np.int64)
            byi = np.nan_to_num(byi).astype(np.int64)
        i = self._bi[byi, bxi].astype(np.float64)
        j = self._bj[byi, bxi].astype(np.float64)
        for _ in range(iters):
            vx, dxi, dxj = self._sample(self.gx, i, j)
            vy, dyi, dyj = self._sample(self.gy, i, j)
            rx = vx - xf
            ry = vy - yf
            det = dxj * dyi - dxi * dyj
            det = np.where(np.abs(det) < 1e-30, 1e-30, det)
            dj = (rx * dyi - ry * dxi) / det
            di = (ry * dxj - rx * dyj) / det
            # damped + bounded step: keeps the iteration stable across
            # backmap-seed jumps while still allowing edge extrapolation
            step = np.maximum(gh, gw) * 0.5
            i = i - np.clip(di, -step, step)
            j = j - np.clip(dj, -step, step)
            i = np.clip(i, -2.0, gh + 1.0)
            j = np.clip(j, -2.0, gw + 1.0)
        bad = ~(np.isfinite(xf) & np.isfinite(yf))
        i = np.where(bad, np.nan, i)
        j = np.where(bad, np.nan, j)
        col = self.pixel_offset + self.pixel_step * j + 0.5
        row = self.line_offset + self.line_step * i + 0.5
        return col.reshape(shape), row.reshape(shape)


# -- loading ------------------------------------------------------------

_grid_cache: Dict[tuple, GeolocGrid] = {}
_grid_cache_lock = threading.Lock()


def load_geoloc_grid(path: str, geo_loc: Dict) -> Optional[GeolocGrid]:
    """GeolocGrid for a granule's geo_loc record (crawler schema:
    x_var/y_var + offsets/steps), cached per file+vars.  None when the
    arrays can't be read."""
    key = (path, geo_loc.get("x_var"), geo_loc.get("y_var"))
    with _grid_cache_lock:
        hit = _grid_cache.get(key)
    if hit is not None:
        return hit
    try:
        from ..io.netcdf import NetCDF
        with NetCDF(path) as nc:
            gx = np.asarray(nc.variables[geo_loc["x_var"]][:], np.float64)
            gy = np.asarray(nc.variables[geo_loc["y_var"]][:], np.float64)
        grid = GeolocGrid(
            gx, gy,
            line_offset=float(geo_loc.get("line_offset", 0.0)),
            pixel_offset=float(geo_loc.get("pixel_offset", 0.0)),
            line_step=float(geo_loc.get("line_step", 1.0)),
            pixel_step=float(geo_loc.get("pixel_step", 1.0)))
    except Exception:
        return None
    # eviction + insert under one lock: two racing loaders must not both
    # pop the same key (the loser's KeyError used to fail the request)
    with _grid_cache_lock:
        while len(_grid_cache) > 16:
            _grid_cache.pop(next(iter(_grid_cache)))
        _grid_cache[key] = grid
    return grid
