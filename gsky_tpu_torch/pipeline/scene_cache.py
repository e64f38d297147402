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

With ingest on (``GSKY_INGEST``, the default):

* a GeoTIFF band whose f32 cast is exact (f32, or integers of at most
  16 bits with an f32-exact nodata) loads staged: it decodes straight
  into a bucket-sized buffer of the `ingest.staging` pool, is
  NaN-encoded there (the same bits as `encode_scene`) and uploaded from
  it (`staged_loads` counts these);
* with ``GSKY_INGEST_WINDOW_FRAC`` > 0, a request whose footprint
  covers less than that share of a scene that is not resident is
  declined (`window_routed` counts these), so the caller serves it
  through the ranged window decode; the ``GSKY_INGEST_WINDOW_PROMOTE``
  (default 4)-th decline of one scene loads it instead.

A scene's ``serial`` names its content, on every node: a scene loaded
from a file takes it from the file's identity (`content_serial`: path,
band, variable, time index, decimation level, shape, and the file's
size and modification time), a stable hash in [2**52, 2**53), so that
page pools, their journals and the cache fabric's peers key one
scene's pages alike however many scenes each process loaded before it.
The reference numbers scenes with a per-process counter, under which a
peer's or a restarted process's serial 3 is another scene (ROADMAP
C.18).  A scene with no file behind it keeps a counter, below 2**52.
Serials stay on the host: no device tensor holds one.

Under mesh per-member placement (``GSKY_MESH_PLACE=1``, `mesh.pools`)
a scene is uploaded to the member that owns its serial, the one whose
page pool stages its pages.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geo.crs import CRS, parse_crs
from ..geo.transform import GeoTransform
from ..ingest import ingest_enabled, window_route_frac
from ..ingest import stats as ingest_stats
from ..ingest.staging import default_staging_pool
from ..io.geotiff import GeoTIFF
from ..ops.raster import nodata_mask
from ..resilience import faults
from .decode import _HandleCache, granule_footprint_frac
from .types import Granule

# serials of scenes with no file behind them; a content serial has bit
# 52 set, which the counter never reaches
_scene_serial = itertools.count(1)
_CONTENT_BIT = 1 << 52


def content_serial(g: Granule, level: int, shape) -> int:
    """The serial of granule ``g``'s scene at decimation ``level`` and
    true ``shape``: a hash of its identity and its file's size and
    modification time, the same in every process that loads the same
    bytes.  A path that is not a local file takes the next counter
    value (a serial that no other scene has)."""
    try:
        st = os.stat(g.path)
    except (OSError, TypeError, ValueError):
        return next(_scene_serial)
    ident = json.dumps([g.path, g.band, g.var_name, g.time_index,
                        int(level), [int(v) for v in shape],
                        st.st_size, st.st_mtime_ns])
    digest = hashlib.blake2b(ident.encode(), digest_size=8).digest()
    return _CONTENT_BIT | (int.from_bytes(digest, "big")
                           & (_CONTENT_BIT - 1))

log = logging.getLogger("gsky.scene_cache")
# every live cache, for the pressure monitor's relief
_live: "weakref.WeakSet[SceneCache]" = weakref.WeakSet()


@dataclass
class DeviceScene:
    dev: torch.Tensor         # (bh, bw) f32, invalid=NaN, bucket-padded
    height: int               # true rows
    width: int                # true cols
    nodata: float             # NaN when absent
    gt: GeoTransform
    crs: CRS
    # content identity (`content_serial`): downstream caches and the
    # page pool key on this, never on id()
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
        self.evictions = 0
        # declines per scene key (promotion to residency) and the
        # requests served through the window path
        self._route_counts: Dict[tuple, int] = {}
        self.window_routed = 0
        self.staged_loads = 0
        _live.add(self)

    @property
    def max_bytes(self) -> int:
        """The resident scenes' byte budget (LRU beyond it)."""
        return self._max_bytes

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

    @staticmethod
    def _route_promote() -> int:
        try:
            return int(os.environ.get("GSKY_INGEST_WINDOW_PROMOTE", 4))
        except (TypeError, ValueError):
            return 4

    def _route_window(self, key: tuple, g: Granule, dst_bbox,
                      dst_crs) -> bool:
        """True when this request should stream through the ranged
        window path instead of loading the whole scene: ingest is on,
        the scene is neither resident nor loading, and the footprint
        covers less than ``GSKY_INGEST_WINDOW_FRAC`` of the raster.  The
        ``GSKY_INGEST_WINDOW_PROMOTE``-th decline of one key loads it."""
        if not ingest_enabled():
            return False
        lim = window_route_frac()
        if lim <= 0.0:
            return False
        with self._lock:
            if key in self._scenes or key in self._inflight:
                return False
        frac = granule_footprint_frac(g, dst_bbox, dst_crs, self._handles)
        if frac is None or frac >= lim:
            return False
        promote = self._route_promote()
        with self._lock:
            n = self._route_counts.get(key, 0) + 1
            self._route_counts[key] = n
            if len(self._route_counts) > 4096:
                self._route_counts.pop(next(iter(self._route_counts)))
            if 0 < promote <= n:
                del self._route_counts[key]
                return False      # hot after all: load it
            self.window_routed += 1
        return True

    def get(self, g: Granule, stride: float = 1.0, dst_bbox=None,
            dst_crs=None) -> Optional[DeviceScene]:
        """Cached scene for a granule, decoding + uploading on first use;
        None when the scene is uncacheable (too big / unreadable).
        Concurrent requests for one scene decode once.  ``dst_bbox`` /
        ``dst_crs``, the request's footprint, let `_route_window`
        decline (None) a scene the request barely touches."""
        level = self._pick_level(g, stride)
        key = self._key(g) + (level,)
        if dst_bbox is not None and dst_crs is not None and \
                self._route_window(key, g, dst_bbox, dst_crs):
            return None
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
                        self.evictions += 1
        finally:
            with self._lock:
                self._inflight.pop(key).set()
        return scene

    def resident(self, g: Granule, stride: float = 1.0) -> bool:
        """Whether `get` would find the scene at this stride resident."""
        key = self._key(g) + (self._pick_level(g, stride),)
        with self._lock:
            return key in self._scenes

    def clear(self) -> None:
        """Drop every resident scene; loads in flight insert theirs when
        they finish.  The pressure monitor's critical relief calls it."""
        with self._lock:
            self._scenes.clear()
            self._order.clear()
            self._bytes = 0

    def _staging_read(self, h, band: int, W: int, H: int, ovr, nodata):
        """Decode a whole GeoTIFF band into a staging buffer of the
        scene's bucket: (buffer, pool), or (None, None) for the classic
        load.  Only a band whose f32 cast is exact stages, so the
        nodata compare and the encoded bits are those of
        `encode_scene`."""
        if not ingest_enabled() or not isinstance(h, GeoTIFF):
            return None, None
        dt = h.dtype
        if not ((dt.kind == "f" and dt.itemsize == 4)
                or (dt.kind in "iu" and dt.itemsize <= 2)):
            return None, None
        if nodata is not None:
            ndf = float(nodata)
            if not (np.isnan(ndf) or float(np.float32(ndf)) == ndf):
                return None, None
        pool = default_staging_pool()
        buf = pool.acquire(_bucket(H), _bucket(W), self.device)
        try:
            h.read(band, (0, 0, W, H), ifd=ovr, out=buf.numpy()[:H, :W])
        except BaseException:
            pool.release(buf)
            raise
        return buf, pool

    def _load(self, g: Granule, level: int = 1) -> Optional[DeviceScene]:
        gt = GeoTransform.from_gdal(g.geo_transform)
        sbuf = spool = None
        try:
            faults.inject("decode")
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
                sbuf, spool = self._staging_read(h, g.band, W, H, ovr,
                                                 nodata)
                if sbuf is not None:
                    data = None
                elif ovr is not None:
                    data = h.read(g.band, (0, 0, W, H), ifd=ovr)
                else:
                    # the registry's read contract is read(band, window)
                    data = h.read(g.band, (0, 0, W, H))
        except (OSError, ValueError) as e:
            # uncacheable stays a visible degradation, never a crash
            log.warning("scene uncacheable: %s (%s: %s)", g.path,
                        type(e).__name__, e)
            return None
        crs = parse_crs(g.srs) if g.srs else None
        if crs is None:
            if sbuf is not None:
                spool.release(sbuf)
            return None
        if sbuf is not None:
            return self._staged_scene(sbuf, spool, H, W, nodata, gt, crs,
                                      H * W * h.dtype.itemsize,
                                      content_serial(g, level, (H, W)))
        ingest_stats.record_whole(data.nbytes)
        true_h, true_w = data.shape
        serial = content_serial(g, level, (true_h, true_w))
        dev = torch.from_numpy(encode_scene(data, nodata)).to(
            self._upload_device(serial))
        return DeviceScene(dev=dev, height=true_h, width=true_w,
                           nodata=float("nan"), gt=gt, crs=crs,
                           serial=serial)

    def _upload_device(self, serial: int) -> torch.device:
        """Where a scene is uploaded: under mesh per-member placement
        (``GSKY_MESH_PLACE=1``) the member that owns it, whose page pool
        will stage its pages (`mesh.pools.staging_device`); else this
        cache's device."""
        from ..mesh.pools import staging_device
        return staging_device(serial, self.device) or self.device

    def _staged_scene(self, buf: torch.Tensor, pool, H: int, W: int,
                      nodata, gt: GeoTransform, crs: CRS,
                      nbytes: int, serial: int) -> DeviceScene:
        """The scene of a staged load: NaN-encode the buffer in place
        (as `encode_scene` does), upload it, and hand it back to the
        pool, cooling until the copy is done (on the CPU the scene is
        the buffer itself, which the pool then forgets)."""
        view = buf.numpy()[:H, :W]
        nd = float(nodata) if nodata is not None else float("nan")
        if not np.isnan(nd):
            valid = nodata_mask(view, nd)
            valid &= np.isfinite(view)
            view[~valid] = np.nan
        target = self._upload_device(serial)
        dev = buf.to(target, non_blocking=True)
        done = None
        if target.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(target))
        pool.release(buf, dev, done)
        ingest_stats.record_whole(nbytes)
        with self._lock:
            self.staged_loads += 1
        return DeviceScene(dev=dev, height=H, width=W,
                           nodata=float("nan"), gt=gt, crs=crs,
                           serial=serial)


def live_caches():
    """The scene caches alive now (each `WarpExecutor` has its own)."""
    return list(_live)
