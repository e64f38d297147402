"""Granule window decoding and the open-file handle cache.

Counterpart of `gsky_tpu/pipeline/decode.py`: for each granule, work out
which source window the destination tile's gather footprint touches,
read only that window (a GeoTIFF window from the coarsest sufficient
overview, or a NetCDF hyperslab, strided when zoomed out), and hand back
float32 data + validity, uploaded to the pipeline's device.  Reads run
in a thread pool.

Not ported: the ranged-ingest byte sources, fault injection and the
ingest counters (the port reads through the handle, as the JAX package
does with ingest off).  A curvilinear (``geo_loc``) granule raises
NotImplementedError: the port has no geolocation route to send it to.
"""

from __future__ import annotations

import concurrent.futures as cf
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
from ..io.geotiff import GeoTIFF
from ..io.netcdf import NetCDF
from ..ops.raster import nodata_mask
from .types import Granule


@dataclass
class DecodedWindow:
    granule: Granule
    data: torch.Tensor        # (h, w) float32, on the pipeline's device
    valid: torch.Tensor       # (h, w) bool, on the same device
    window_gt: GeoTransform   # georeferencing of the window
    src_crs: CRS


class _HandleCache:
    """LRU of open GeoTIFF / NetCDF handles with a per-path open latch:
    concurrent callers for one path wait for the first opener."""

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
            h = NetCDF(path) if is_netcdf else GeoTIFF(path)
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
        raise NotImplementedError(
            f"curvilinear granule {granule.path}: the geolocation route "
            "is not ported yet (ROADMAP A.8)")
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
            data = h.read_slice(granule.var_name, granule.time_index,
                                (c0 * st, r0 * st, w * st, ww * st), st)
        else:
            win = _pixel_window(gt, src_bbox, W, H, margin)
            if win is None:
                return None
            data = h.read_slice(granule.var_name, granule.time_index, win)
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
            data = h.read(granule.band, win, ifd=ovr)
        else:
            win = _pixel_window(gt, src_bbox, h.width, h.height, margin)
            if win is None:
                return None
            data = h.read(granule.band, win)
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
