"""Native GMT grid reader and writer.

Counterpart of `gsky_tpu/io/gmt.py`.  A GMT v4 grid is a NetCDF-classic
container carrying 1-D bookkeeping variables ``dimension`` (nx, ny),
``x_range``/``y_range``/``z_range`` (2-vectors) and ``spacing``, plus
the flat row-major grid in a 1-D variable ``z`` whose first row is the
NORTH edge.  ``z:node_offset`` selects pixel (1) vs gridline (0)
registration; gridline-registered grids offset the geotransform by half
a pixel (`gmtdataset.cpp:349-374` of the reference's GDAL format code).
``scale_factor``/``add_offset`` are carried as metadata, not applied to
pixels (consumers see raw stored values).

The reader rides the port's NetCDF-classic parser; `GMTGrid` exposes
the GeoTIFF-shaped handle interface (width/height/read/nodata/
overviews) so the decode, scene-cache and drill paths serve GMT
granules unchanged through `io.registry`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..geo.transform import GeoTransform
from .netcdf import NetCDF


def is_gmt(path: str) -> bool:
    """Cheap signature check: NetCDF container whose variable set has
    the GMT bookkeeping shape (`gmtdataset.cpp:256-268`)."""
    try:
        with open(path, "rb") as fp:
            if fp.read(3) != b"CDF":
                return False
        with NetCDF(path) as nc:
            v = nc.variables
            return "dimension" in v and "z" in v \
                and len(v["z"].shape) == 1
    except Exception:
        return False


class GMTGrid:
    """One-band GMT grid with the tiff-like handle interface."""

    def __init__(self, path: str):
        self.path = path
        self._nc = NetCDF(path)
        v = self._nc.variables
        if "dimension" not in v or "z" not in v:
            self._nc.close()
            raise ValueError(f"not a GMT grid: {path}")
        nm = np.asarray(v["dimension"][:2], np.int64)
        self.width = int(nm[0])
        self.height = int(nm[1])
        if self.width <= 0 or self.height <= 0 \
                or self.width * self.height > (1 << 31):
            self._nc.close()
            raise ValueError(f"bad GMT dimensions {nm}: {path}")
        z = v["z"]
        if int(np.prod(z.shape)) < self.width * self.height:
            self._nc.close()
            raise ValueError(f"GMT z variable too small: {path}")
        self.scale_factor = float(z.attrs.get("scale_factor", 1.0))
        self.add_offset = float(z.attrs.get("add_offset", 0.0))
        # absent attribute defaults to PIXEL registration, matching the
        # reference's reader (`gmtdataset.cpp:330` inits node_offset = 1
        # before reading the attr) — parity over GMT's own convention
        node_offset = int(np.asarray(
            z.attrs.get("node_offset", 1)).reshape(-1)[0])
        self.gt = self._geotransform(v, node_offset)
        # GMT marks holes with NaN (float grids); integer grids carry
        # no nodata marker in the v4 layout
        self.nodata: Optional[float] = (
            float("nan") if np.dtype(z.dtype).kind == "f" else None)
        self.dtype = z.dtype
        self.overviews: Tuple = ()

    def _geotransform(self, v, node_offset: int) -> GeoTransform:
        if "x_range" not in v or "y_range" not in v:
            return GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        xr = np.asarray(v["x_range"][:2], np.float64)
        yr = np.asarray(v["y_range"][:2], np.float64)
        if node_offset == 1:       # pixel registration
            dx = (xr[1] - xr[0]) / self.width
            dy = (yr[0] - yr[1]) / self.height
            return GeoTransform(float(xr[0]), float(dx), 0.0,
                                float(yr[1]), 0.0, float(dy))
        # gridline registration: samples sit ON the range ends
        dx = (xr[1] - xr[0]) / max(self.width - 1, 1)
        dy = (yr[0] - yr[1]) / max(self.height - 1, 1)
        return GeoTransform(float(xr[0] - dx * 0.5), float(dx), 0.0,
                            float(yr[1] - dy * 0.5), 0.0, float(dy))

    def read(self, band: int = 1,
             window: Optional[Tuple[int, int, int, int]] = None,
             ifd=None) -> np.ndarray:
        """(h, w) array for ``window`` = (col0, row0, w, h); row 0 is
        the north edge, as the flat z layout stores it."""
        if window is None:
            window = (0, 0, self.width, self.height)
        c0, r0, w, h = window
        z = self._nc.variables["z"]
        if c0 == 0 and w == self.width:
            # full-width read: ONE contiguous slice instead of h
            # variable round-trips (the scene/drill caches read whole
            # grids this way)
            flat = np.asarray(z[r0 * w:(r0 + h) * w])
            return flat.reshape(h, w)
        rows = []
        # row-contiguous slices out of the flat variable; the NC3/HDF5
        # readers slice without materialising the whole grid
        for r in range(r0, r0 + h):
            start = r * self.width + c0
            rows.append(np.asarray(z[start:start + w]))
        return np.stack(rows) if rows else \
            np.zeros((0, w), np.asarray(z[0:0]).dtype)

    def close(self):
        self._nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_gmt(path: str, data: np.ndarray, x_range: Tuple[float, float],
              y_range: Tuple[float, float],
              node_offset: int = 1) -> None:
    """Write a pixel/gridline-registered GMT v4 grid (fixtures + the
    WCS 'gmt' output style).  ``data`` (H, W) with row 0 = north."""
    from .netcdf import write_netcdf3_raw

    H, W = data.shape
    data = np.ascontiguousarray(data)
    zmin = float(np.nanmin(data)) if data.size else 0.0
    zmax = float(np.nanmax(data)) if data.size else 0.0
    sx = (x_range[1] - x_range[0]) / (W if node_offset else max(W - 1, 1))
    sy = (y_range[1] - y_range[0]) / (H if node_offset else max(H - 1, 1))
    write_netcdf3_raw(
        path, [("side", 2), ("xysize", H * W)], [
            ("x_range", ("side",), {},
             np.asarray(x_range, np.float64)),
            ("y_range", ("side",), {},
             np.asarray(y_range, np.float64)),
            ("z_range", ("side",), {},
             np.asarray([zmin, zmax], np.float64)),
            ("spacing", ("side",), {}, np.asarray([sx, sy], np.float64)),
            ("dimension", ("side",), {}, np.asarray([W, H], np.int32)),
            ("z", ("xysize",),
             {"node_offset": np.asarray([node_offset], np.int32)},
             data.reshape(-1)),
        ], {"title": "", "source": "gsky_tpu"})
