"""Granule window decoding and the open-file handle cache.

Counterpart of `gsky_tpu/pipeline/decode.py`: for each granule, work out
which source window the destination tile's gather footprint touches,
read only that window (a GeoTIFF window from the coarsest sufficient
overview, or a NetCDF hyperslab, strided when zoomed out), and hand back
float32 data + validity, uploaded to the pipeline's device.  Reads run
in a thread pool.

Non-NetCDF files open through the format registry (`io.registry`:
GeoTIFF, GMT, HDF4).  A curvilinear (``geo_loc``) granule has no affine
pixel grid: it renders through the scene path's geolocation control
grid (`executor._geoloc_ctrl`), and one that reaches this window decode
is skipped and counted (`geoloc_skips`), as the reference does.

With ingest on (``GSKY_INGEST``, the default), a GeoTIFF window's
blocks and a NetCDF-3 hyperslab's rows come through coalesced ranged
reads of the granule's `ingest.source.ByteSource` (`_read_tiff`,
`_read_nc`): the same blocks and decode as the handle's read, so the
same values.  A ranged read that fails falls back to the handle's read
and is counted (`ingest.stats` ``fallbacks``).  Not ported: fault
injection (ROADMAP A.16).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import math
import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geo.crs import CRS, parse_crs
from ..geo.transform import BBox, GeoTransform, transform_bbox
from ..ingest import ingest_enabled
from ..ingest import stats as ingest_stats
from ..ingest.source import source_for
from ..io.geotiff import GeoTIFF
from ..io.netcdf import NetCDF
from ..io.registry import open_raster
from ..ops.raster import nodata_mask
from ..resilience import faults
from .types import Granule


@dataclass
class DecodedWindow:
    granule: Granule
    data: torch.Tensor        # (h, w) float32, on the pipeline's device
    valid: torch.Tensor       # (h, w) bool, on the same device
    window_gt: GeoTransform   # georeferencing of the window
    src_crs: CRS


class _HandleCache:
    """LRU of open NetCDF and registry handles with a per-path open
    latch: concurrent callers for one path wait for the first opener."""

    def __init__(self, max_handles: int = 64):
        self._lock = threading.Lock()
        self._handles: Dict[str, object] = {}
        self._order: List[str] = []
        self._opening: Dict[str, threading.Event] = {}
        self._max = max_handles

    def get(self, path: str, is_netcdf: bool = False):
        while True:
            with self._lock:
                h = self._handles.get(path)
                if h is not None:
                    return h
                ev = self._opening.get(path)
                if ev is None:
                    ev = self._opening[path] = threading.Event()
                    break
            # opener in flight: wait, then re-check (a set() without a
            # cached handle means the open failed — retry it ourselves)
            ev.wait()
        try:
            h = NetCDF(path) if is_netcdf else open_raster(path)
        except BaseException:
            with self._lock:
                self._opening.pop(path, None)
            ev.set()
            raise
        with self._lock:
            self._opening.pop(path, None)
            self._handles[path] = h
            self._order.append(path)
            while len(self._order) > self._max:
                self._handles.pop(self._order.pop(0)).close()
        ev.set()
        return h


_handles = _HandleCache()
_skip_lock = threading.Lock()
geoloc_skips = 0


def _ingest_source(path: str):
    """The granule's ByteSource when ingest is on, else None (the
    handle's read).  A source that cannot be opened is None too."""
    if not ingest_enabled():
        return None
    try:
        return source_for(path)
    except (OSError, ValueError):
        return None


def _ranged_or_whole(src, ranged, whole, path: str) -> np.ndarray:
    """``ranged(src)`` when there is a source, counted as a ranged
    window; any failure of it falls back to ``whole()``, counted as a
    fallback; ``whole()`` alone without a source."""
    if src is not None:
        try:
            out = ranged(src)
            ingest_stats.record_ranged_window()
            return out
        except Exception:
            ingest_stats.record_fallback()
            logging.getLogger("gsky.decode").warning(
                "ranged read of %s failed; reading through the handle",
                path, exc_info=True)
    out = whole()
    ingest_stats.record_whole(out.nbytes)
    return out


def _read_tiff(h, band: int, win, ifd, path: str) -> np.ndarray:
    """A GeoTIFF window read, ranged when a ByteSource is available.
    Other registry handles read through ``read(band, window)``."""
    return _ranged_or_whole(
        _ingest_source(path) if isinstance(h, GeoTIFF) else None,
        lambda src: h.read(band, win, ifd=ifd, source=src),
        lambda: h.read(band, win, ifd=ifd) if ifd is not None
        else h.read(band, win), path)


def _read_nc(h, var_name: str, time_index, win, step: int,
             path: str) -> np.ndarray:
    """A NetCDF hyperslab read, ranged (NetCDF-3 row ranges) when a
    ByteSource is available; an HDF5-based file reads through h5py."""
    return _ranged_or_whole(
        _ingest_source(path) if h._nc3 is not None else None,
        lambda src: h.read_slice_source(var_name, src, time_index, win,
                                        step=step),
        lambda: h.read_slice(var_name, time_index, win, step=step), path)


def granule_footprint_frac(granule: Granule, dst_bbox: BBox,
                           dst_crs: CRS, handles: "_HandleCache"
                           ) -> Optional[float]:
    """The share (0..1) of the granule's raster the destination
    footprint touches, or None when it cannot be computed (callers
    assume all of it): what routes a scene-cache miss to the ranged
    window path."""
    if granule.geo_loc:
        return None
    try:
        src_crs = parse_crs(granule.srs) if granule.srs else dst_crs
        gt = GeoTransform.from_gdal(granule.geo_transform)
        src_bbox = transform_bbox(dst_bbox, dst_crs, src_crs)
        h = handles.get(granule.path, granule.is_netcdf)
    except (OSError, ValueError):
        return None
    if granule.is_netcdf:
        v = h.variables.get(granule.var_name)
        if v is None:
            return None
        H, W = v.shape[-2], v.shape[-1]
    else:
        W, H = h.width, h.height
    if not W or not H:
        return None
    win = _pixel_window(gt, src_bbox, W, H, margin=3)
    if win is None:
        return 0.0
    return (win[2] * win[3]) / float(W * H)


def margin_for(resample: str) -> int:
    return {"near": 1, "nearest": 1, "bilinear": 2, "cubic": 3}.get(resample, 2)


def dst_stride_px(gt: GeoTransform, src_bbox: BBox,
                  dst_hw: Optional[Tuple[int, int]]) -> float:
    """Source pixels stepped per destination pixel for this request (min
    of the two axes): what selects an overview level."""
    if dst_hw is None:
        return 1.0
    th, tw = dst_hw
    if not tw or not th or not gt.dx or not gt.dy:
        return 1.0
    sx = abs(src_bbox.width / gt.dx) / tw
    sy = abs(src_bbox.height / gt.dy) / th
    return max(1.0, min(sx, sy))


def decode_window(granule: Granule, dst_bbox: BBox, dst_crs: CRS,
                  resample: str = "near",
                  dst_hw: Optional[Tuple[int, int]] = None,
                  device="cuda") -> Optional[DecodedWindow]:
    """Read the source window covering dst_bbox (+ resample margin) and
    upload it to ``device`` (the card unless the caller asks for the
    CPU).  Returns None when the granule doesn't intersect the tile.
    With ``dst_hw`` = (height, width), zoomed-out requests read a
    GeoTIFF overview or a strided NetCDF hyperslab."""
    if granule.geo_loc:
        # curvilinear granules render only through the scene path's
        # geolocation control grid; reaching this decode means a caller
        # missed that routing: log it, the granule degrades to empty
        global geoloc_skips
        with _skip_lock:
            geoloc_skips += 1
            n = geoloc_skips
        if n <= 10 or n % 1000 == 0:
            logging.getLogger("gsky.decode").warning(
                "curvilinear granule %s skipped on the windowed decode "
                "path (renders only via the scene path; skip #%d)",
                granule.path, n)
        return None
    faults.inject("decode")
    dev = resolve_device(device)
    src_crs = parse_crs(granule.srs) if granule.srs else dst_crs
    gt = GeoTransform.from_gdal(granule.geo_transform)
    try:
        src_bbox = transform_bbox(dst_bbox, dst_crs, src_crs)
    except ValueError:
        return None

    margin = margin_for(resample)
    h = _handles.get(granule.path, granule.is_netcdf)
    stride = dst_stride_px(gt, src_bbox, dst_hw)
    if granule.is_netcdf:
        v = h.variables.get(granule.var_name)
        if v is None:
            return None
        H, W = v.shape[-2], v.shape[-1]
        st = int(stride) if stride >= 2.0 else 1
        if st > 1 and (H // st < 2 or W // st < 2):
            st = 1
        if st > 1:
            gt = gt.decimated(st)
            win = _pixel_window(gt, src_bbox, W // st, H // st, margin)
            if win is None:
                return None
            c0, r0, w, ww = win
            data = _read_nc(h, granule.var_name, granule.time_index,
                            (c0 * st, r0 * st, w * st, ww * st), st,
                            granule.path)
        else:
            win = _pixel_window(gt, src_bbox, W, H, margin)
            if win is None:
                return None
            data = _read_nc(h, granule.var_name, granule.time_index, win,
                            1, granule.path)
        nodata = granule.nodata if granule.nodata is not None else v.nodata
    else:
        ovr = None
        if stride >= 2.0 and h.overviews:
            fx, fy, ovr = h.pick_overview(stride)
        if ovr is not None:
            gt = gt.scaled(fx, fy)
            win = _pixel_window(gt, src_bbox, ovr.width, ovr.height, margin)
            if win is None:
                return None
            data = _read_tiff(h, granule.band, win, ovr, granule.path)
        else:
            win = _pixel_window(gt, src_bbox, h.width, h.height, margin)
            if win is None:
                return None
            data = _read_tiff(h, granule.band, win, None, granule.path)
        nodata = granule.nodata if granule.nodata is not None else h.nodata
    valid = nodata_mask(data, nodata)
    return DecodedWindow(
        granule, torch.from_numpy(data.astype(np.float32)).to(dev),
        torch.from_numpy(valid).to(dev), gt.window(win[0], win[1]), src_crs)


def _pixel_window(gt: GeoTransform, bbox: BBox, W: int, H: int,
                  margin: int) -> Optional[Tuple[int, int, int, int]]:
    c0, r0 = gt.geo_to_pixel(bbox.xmin, bbox.ymax)
    c1, r1 = gt.geo_to_pixel(bbox.xmax, bbox.ymin)
    c0, c1 = sorted((c0, c1))
    r0, r1 = sorted((r0, r1))
    c0 = max(int(math.floor(c0)) - margin, 0)
    r0 = max(int(math.floor(r0)) - margin, 0)
    c1 = min(int(math.ceil(c1)) + margin, W)
    r1 = min(int(math.ceil(r1)) + margin, H)
    if c0 >= c1 or r0 >= r1:
        return None
    return c0, r0, c1 - c0, r1 - r0


def decode_all(granules: List[Granule], dst_bbox: BBox, dst_crs: CRS,
               resample: str = "near", workers: int = 8,
               dst_hw: Optional[Tuple[int, int]] = None,
               errors: Optional[List[Exception]] = None,
               device="cuda") -> List[Optional[DecodedWindow]]:
    """Decode all granule windows concurrently, preserving order.

    A ``None`` slot means EITHER the granule doesn't intersect the tile
    OR its decode raised; pass ``errors`` to collect the raised
    exceptions for the partial-failure policy (`check_partial`).
    NotImplementedError is never absorbed, nor is a failure of the card
    (`_device_failure`: out of memory, a failed CUDA call), nor a device
    that cannot be had: ``device`` is resolved before any read."""
    device = resolve_device(device)
    if not granules:
        return []
    with cf.ThreadPoolExecutor(min(workers, len(granules))) as ex:
        return list(ex.map(
            lambda g: _safe_decode(g, dst_bbox, dst_crs, resample, dst_hw,
                                   errors, device),
            granules))


def _device_failure(e: BaseException) -> bool:
    """Whether ``e`` is a failure of the card rather than of a granule:
    device memory exhausted, or a failed CUDA call (torch's error for
    one, or a message naming a CUDA error)."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(e, acc):
        return True
    return isinstance(e, RuntimeError) and \
        re.search(r"\bCUDA (\w+ )?error", str(e)) is not None


def _safe_decode(g, dst_bbox, dst_crs, resample, dst_hw=None, errors=None,
                 device="cuda"):
    try:
        return decode_window(g, dst_bbox, dst_crs, resample, dst_hw, device)
    except NotImplementedError:
        raise
    except Exception as e:
        # a granule's own read or format failure degrades to a missing
        # granule; a failure of the card fails the request
        if _device_failure(e):
            raise
        if errors is not None:
            errors.append(e)
        return None
