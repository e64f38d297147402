"""Device-resident source-scene cache.

Counterpart of `gsky_tpu/pipeline/scene_cache.py` (classic read path):
each (path, band or variable and timestep, level) source raster — a
GeoTIFF band at an overview level, a GMT or HDF4 band (through
`io.registry`), or a NetCDF variable's timestep read at a power-of-two
stride — is decoded once, NaN-encoded as
f32 (invalid pixels — nodata or non-finite — become NaN, so a tap's
validity is one isfinite test), padded with NaN to 256-multiples and
kept on the device; every later tile warps from the cached tensor.
Eviction is LRU by device bytes; scenes above ``max_scene_px`` at the
chosen level are not cached.
"""

from __future__ import annotations

import itertools
import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geo.crs import CRS, parse_crs
from ..geo.transform import GeoTransform
from ..ops.raster import nodata_mask
from .decode import _HandleCache
from .types import Granule

_scene_serial = itertools.count(1)

log = logging.getLogger("gsky.scene_cache")


@dataclass
class DeviceScene:
    dev: torch.Tensor         # (bh, bw) f32, invalid=NaN, bucket-padded
    height: int               # true rows
    width: int                # true cols
    nodata: float             # NaN when absent
    gt: GeoTransform
    crs: CRS
    # monotonic identity: downstream caches key on this, never on id()
    serial: int = field(default_factory=lambda: next(_scene_serial))

    @property
    def bucket(self) -> Tuple[int, int]:
        return tuple(self.dev.shape)

    @property
    def dtype(self):
        return self.dev.dtype


def _bucket(n: int, step: int = 256) -> int:
    return max(step, (n + step - 1) // step * step)


def encode_scene(data: np.ndarray, nodata) -> np.ndarray:
    """NaN-encode a decoded band into a bucket-padded f32 array."""
    nd = float(nodata) if nodata is not None else float("nan")
    if data.dtype != np.float32 or not np.isnan(nd):
        valid = nodata_mask(data, nd if not np.isnan(nd) else None)
        data = data.astype(np.float32)
        valid &= np.isfinite(data)
        data[~valid] = np.nan
    true_h, true_w = data.shape
    bh, bw = _bucket(true_h), _bucket(true_w)
    if (bh, bw) != data.shape:
        pad = np.full((bh, bw), np.nan, np.float32)
        pad[:true_h, :true_w] = data
        data = pad
    return data


class SceneCache:
    def __init__(self, max_bytes: int = 2 << 30,
                 max_scene_px: int = 64 << 20, device="cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._handles = _HandleCache()
        self._scenes: Dict[tuple, DeviceScene] = {}
        self._order: List[tuple] = []
        self._bytes = 0
        self._max_bytes = max_bytes
        self._max_scene_px = max_scene_px
        self._inflight: Dict[tuple, threading.Event] = {}
        self.hits = 0
        self.misses = 0

    def _key(self, g: Granule) -> tuple:
        return (g.path, g.band, g.var_name, g.time_index)

    def _pick_level(self, g: Granule, stride: float) -> int:
        """Decimation level for a request stepping ``stride`` source
        pixels per dst pixel: the coarsest GeoTIFF overview that fits,
        or a power-of-two read stride for NetCDF (quantised, so that a
        zoom sweep shares cache entries)."""
        if stride < 2.0:
            return 1
        try:
            h = self._handles.get(g.path, g.is_netcdf)
        except (OSError, ValueError):
            return 1
        if g.is_netcdf:
            v = h.variables.get(g.var_name)
            H, W = (v.shape[-2], v.shape[-1]) if v is not None else (2, 2)
            lv = 1
            while lv * 2 <= stride and H // (lv * 2) >= 2 \
                    and W // (lv * 2) >= 2:
                lv *= 2
            return lv
        best = 1
        for f, _ in h.overviews:
            if f <= stride:
                best = f
        return best

    def get(self, g: Granule, stride: float = 1.0) -> Optional[DeviceScene]:
        """Cached scene for a granule, decoding + uploading on first use;
        None when the scene is uncacheable (too big / unreadable).
        Concurrent requests for one scene decode once."""
        level = self._pick_level(g, stride)
        key = self._key(g) + (level,)
        while True:
            with self._lock:
                hit = self._scenes.get(key)
                if hit is not None:
                    self.hits += 1
                    self._order.remove(key)
                    self._order.append(key)
                    return hit
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    self.misses += 1
                    break
            ev.wait()

        scene = None
        try:
            scene = self._load(g, level)
            if scene is not None:
                nbytes = scene.dev.numel() * scene.dev.element_size()
                with self._lock:
                    self._scenes[key] = scene
                    self._order.append(key)
                    self._bytes += nbytes
                    while self._bytes > self._max_bytes and \
                            len(self._order) > 1:
                        old = self._scenes.pop(self._order.pop(0))
                        self._bytes -= old.dev.numel() \
                            * old.dev.element_size()
        finally:
            with self._lock:
                self._inflight.pop(key).set()
        return scene

    def _load(self, g: Granule, level: int = 1) -> Optional[DeviceScene]:
        gt = GeoTransform.from_gdal(g.geo_transform)
        try:
            h = self._handles.get(g.path, g.is_netcdf)
            if g.is_netcdf:
                v = h.variables.get(g.var_name)
                if v is None:
                    return None
                H, W = v.shape[-2], v.shape[-1]
                st = level if level > 1 and H // level >= 2 \
                    and W // level >= 2 else 1
                Ho, Wo = H // st, W // st
                if Ho * Wo > self._max_scene_px:
                    return None
                data = h.read_slice(g.var_name, g.time_index,
                                    (0, 0, Wo * st, Ho * st), step=st)
                if st > 1:
                    gt = gt.decimated(st)
                nodata = g.nodata if g.nodata is not None else v.nodata
            else:
                W, H = h.width, h.height
                ovr = None
                if level > 1 and h.overviews:
                    fx, fy, ovr = h.pick_overview(float(level))
                if ovr is not None:
                    gt = gt.scaled(fx, fy)
                    W, H = ovr.width, ovr.height
                if H * W > self._max_scene_px:
                    return None
                nodata = g.nodata if g.nodata is not None else h.nodata
                # the registry's read contract is read(band, window):
                # only a GeoTIFF overview read passes its IFD
                data = h.read(g.band, (0, 0, W, H), ifd=ovr) \
                    if ovr is not None else h.read(g.band, (0, 0, W, H))
        except (OSError, ValueError) as e:
            # uncacheable stays a visible degradation, never a crash
            log.warning("scene uncacheable: %s (%s: %s)", g.path,
                        type(e).__name__, e)
            return None
        crs = parse_crs(g.srs) if g.srs else None
        if crs is None:
            return None
        true_h, true_w = data.shape
        dev = torch.from_numpy(encode_scene(data, nodata)).to(self.device)
        return DeviceScene(dev=dev, height=true_h, width=true_w,
                           nodata=float("nan"), gt=gt, crs=crs,
                           serial=next(_scene_serial))
