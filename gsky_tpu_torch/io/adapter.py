"""Adapter-tier raster readers for formats outside the native set.

Counterpart of `gsky_tpu/io/adapter.py`.  `ImageRaster` decodes
anything PIL can open (Sentinel-2 JPEG2000 through openjpeg, PNG, JPEG,
BMP) and georeferences it through an ESRI world file (`.j2w`, `.jgw`,
`.pgw`, `.tfw`, `.wld`, `.bpw`) beside the image, the sidecar GDAL also
honours.  PIL is imported when an image is opened: on a host without
it, opening one raises its ImportError, which the crawler records.  PIL
has no partial JP2 decode, so the first window read decodes the whole
image once per open handle and windows slice from it (the scene cache
keeps the device copy).

`RasterioRaster` and `GdalRaster` wrap those libraries where the host
has them (`io.registry` registers each only when it imports): true
windowed reads and GDAL's formats, with the same tiff-like interface.
Nothing here needs either.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..geo.transform import GeoTransform

_WORLD_EXTS = (".wld", ".j2w", ".jgw", ".pgw", ".tfw", ".bpw")
_IMAGE_MAGICS = (
    b"\x00\x00\x00\x0cjP  ",        # JP2 signature box
    b"\xff\x4f\xff\x51",            # raw JPEG2000 codestream
    b"\x89PNG\r\n\x1a\n",
    b"\xff\xd8\xff",
    b"BM",
)


def read_world_file(path: str) -> Optional[GeoTransform]:
    """Six-line ESRI world file -> GeoTransform (world files give the
    CENTRE of the top-left pixel; GDAL shifts by half a pixel)."""
    base = os.path.splitext(path)[0]
    for ext in _WORLD_EXTS:
        for cand in (base + ext, base + ext.upper()):
            if os.path.exists(cand):
                try:
                    with open(cand) as fp:
                        vals = [float(fp.readline()) for _ in range(6)]
                except (OSError, ValueError):
                    return None
                dx, ry, rx, dy, cx, cy = vals
                return GeoTransform(cx - dx * 0.5 - rx * 0.5, dx, rx,
                                    cy - ry * 0.5 - dy * 0.5, ry, dy)
    return None


def sniff_image(path: str, magic: bytes) -> bool:
    return any(magic.startswith(m) for m in _IMAGE_MAGICS)


class ImageRaster:
    """PIL-decoded raster with world-file georeferencing."""

    def __init__(self, path: str):
        import threading

        from PIL import Image
        self.path = path
        img = Image.open(path)
        self.width, self.height = img.size
        self._img = img
        self._arr: Optional[np.ndarray] = None
        # handles are shared across decode worker threads via the
        # handle cache; PIL's lazy load() is not thread-safe
        self._decode_lock = threading.Lock()
        self.bands = len(img.getbands())
        self.nodata: Optional[float] = None
        self.overviews: Tuple = ()
        self.gt = read_world_file(path) or \
            GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        self.crs = None        # sidecar .prj / ruleset srs supplies it

    def _array(self) -> np.ndarray:
        with self._decode_lock:
            if self._arr is None:
                a = np.asarray(self._img)
                if a.ndim == 2:
                    a = a[..., None]
                self._arr = a
            return self._arr

    def read(self, band: int = 1,
             window: Optional[Tuple[int, int, int, int]] = None,
             ifd=None) -> np.ndarray:
        a = self._array()
        b = min(max(band, 1), a.shape[-1]) - 1
        if window is None:
            return a[..., b]
        c0, r0, w, h = window
        return a[r0:r0 + h, c0:c0 + w, b]

    def close(self):
        try:
            self._img.close()
        except Exception:
            # a handle torn down twice (cache eviction racing a
            # context-manager exit) is already closed — nothing to free
            pass
        # under the decode lock: close() can race a decode thread
        # still inside _array() via the shared handle cache
        with self._decode_lock:
            self._arr = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def sniff_rasterio(path: str, magic: bytes) -> bool:
    return True                 # last-resort tier before PIL


class RasterioRaster:
    """rasterio-backed windowed reader (present only when the image
    ships rasterio)."""

    def __init__(self, path: str):
        import rasterio
        self._ds = rasterio.open(path)
        self.width = self._ds.width
        self.height = self._ds.height
        self.bands = self._ds.count
        self.nodata = self._ds.nodata
        self.overviews: Tuple = ()
        t = self._ds.transform
        self.gt = GeoTransform(t.c, t.a, t.b, t.f, t.d, t.e)
        self.crs = None

    def read(self, band: int = 1,
             window: Optional[Tuple[int, int, int, int]] = None,
             ifd=None) -> np.ndarray:
        import rasterio.windows as rw
        if window is None:
            return self._ds.read(band)
        c0, r0, w, h = window
        return self._ds.read(band, window=rw.Window(c0, r0, w, h))

    def close(self):
        self._ds.close()


def sniff_gdal(path: str, magic: bytes) -> bool:
    return True


class GdalRaster:
    """GDAL-backed reader (present only when the host has GDAL): all
    of GDAL's formats (HDF4, JP2, GMT, ...)."""

    def __init__(self, path: str):
        from osgeo import gdal
        self._ds = gdal.Open(path)
        if self._ds is None:
            raise ValueError(f"GDAL cannot open {path}")
        self.width = self._ds.RasterXSize
        self.height = self._ds.RasterYSize
        self.bands = self._ds.RasterCount
        b1 = self._ds.GetRasterBand(1)
        self.nodata = b1.GetNoDataValue()
        self.overviews: Tuple = ()
        g = self._ds.GetGeoTransform()
        self.gt = GeoTransform(g[0], g[1], g[2], g[3], g[4], g[5])
        self.crs = None

    def read(self, band: int = 1,
             window: Optional[Tuple[int, int, int, int]] = None,
             ifd=None) -> np.ndarray:
        b = self._ds.GetRasterBand(band)
        if window is None:
            return b.ReadAsArray()
        c0, r0, w, h = window
        return b.ReadAsArray(c0, r0, w, h)

    def close(self):
        self._ds = None
