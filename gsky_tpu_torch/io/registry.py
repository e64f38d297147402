"""Pluggable raster-format registry.

Counterpart of `gsky_tpu/io/registry.py`: the native tier (GeoTIFF, GMT
and HDF4, read by the port's own readers), then the adapter tier
(`io.adapter`), in the reference's order: rasterio and GDAL, each only
when it imports, then ``pil-image`` always (PIL itself is imported when
an image is opened).  Each entry sniffs magic bytes and returns a handle
with the uniform "tiff-like" interface the decode, scene-cache and drill
paths consume —

    .width .height .nodata .overviews
    .read(band, (col0, row0, w, h)) -> np.ndarray
    .close()

plus optionally .gt (GeoTransform) and .crs for the crawler.  NetCDF
proper stays on the `io.netcdf.NetCDF` facade (variables and
hyperslabs, not a flat band model): decode and drill route it by
granule metadata before consulting the registry.  Register other
formats with `register()`; a file no entry claims raises ValueError.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Tuple

_Entry = Tuple[str, Callable[[str, bytes], bool], Callable[[str], object]]

_lock = threading.Lock()
_formats: List[_Entry] = []


def register(name: str, sniff: Callable[[str, bytes], bool],
             opener: Callable[[str], object],
             prepend: bool = False) -> None:
    """Add a format: ``sniff(path, magic16)`` decides cheaply,
    ``opener(path)`` returns a tiff-like handle."""
    with _lock:
        if prepend:
            _formats.insert(0, (name, sniff, opener))
        else:
            _formats.append((name, sniff, opener))


def formats() -> List[str]:
    with _lock:
        return [name for name, _, _ in _formats]


def open_raster(path: str):
    """Open ``path`` with the first matching format.  Raises ValueError
    listing the sniffed magic when nothing claims the file."""
    try:
        with open(path, "rb") as fp:
            magic = fp.read(16)
    except OSError as e:
        raise ValueError(f"cannot read {path}: {e}") from e
    with _lock:
        entries = list(_formats)
    for name, sniff, opener in entries:
        try:
            claimed = sniff(path, magic)
        except Exception:
            claimed = False
        if claimed:
            return opener(path)
    raise ValueError(
        f"no registered reader for {path} (magic {magic[:8]!r}; "
        f"formats: {formats()})")


# -- built-in formats --------------------------------------------------------

def _sniff_tiff(path: str, magic: bytes) -> bool:
    return magic[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")


def _open_tiff(path: str):
    from .geotiff import GeoTIFF
    return GeoTIFF(path)


def _sniff_gmt(path: str, magic: bytes) -> bool:
    if magic[:3] != b"CDF":
        return False
    from .gmt import is_gmt
    return is_gmt(path)


def _open_gmt(path: str):
    from .gmt import GMTGrid
    return GMTGrid(path)


def _sniff_hdf4(path: str, magic: bytes) -> bool:
    return magic[:4] == b"\x0e\x03\x13\x01"


def _open_hdf4(path: str):
    from .hdf4 import HDF4
    return HDF4(path)


register("geotiff", _sniff_tiff, _open_tiff)
register("gmt", _sniff_gmt, _open_gmt)
register("hdf4", _sniff_hdf4, _open_hdf4)


def _register_adapters() -> None:
    """The adapter tier, best first: rasterio and GDAL where they
    import, the PIL image adapter always."""
    try:
        import rasterio  # noqa: F401
        from .adapter import RasterioRaster, sniff_rasterio
        register("rasterio", sniff_rasterio, lambda p: RasterioRaster(p))
    except ImportError:
        pass
    try:
        from osgeo import gdal  # noqa: F401
        from .adapter import GdalRaster, sniff_gdal
        register("gdal", sniff_gdal, lambda p: GdalRaster(p))
    except ImportError:
        pass
    from .adapter import ImageRaster, sniff_image
    register("pil-image", sniff_image, lambda p: ImageRaster(p))


_register_adapters()

