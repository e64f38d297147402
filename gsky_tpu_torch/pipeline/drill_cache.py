"""Device-resident drill stack cache.

Counterpart of `gsky_tpu/pipeline/drill_cache.py`.  The whole variable
stack (T, H, W) of a drilled file is uploaded once, in its native dtype,
and stays on the device; each drill request then ships only a
rasterized polygon mask and a timestep index vector, and the window
slice and the masked reductions run on the device
(`ops.drill.window_gather`, kernel B3).

A stack counts as resident only once its copy to the device has
finished.  Eviction is LRU by device bytes.  Stacks above
``max_item_bytes`` (1 GiB) are not cached, nor are 64-bit stacks (the
reference keeps its uploads at 32 bits).  NetCDF-3 has no unsigned
types; a uint16 / uint32 stack (the ``_Unsigned`` convention) is held
widened to int32 / int64, because PyTorch's unsigned types beyond uint8
lack the comparison ops, while nodata semantics follow the file's dtype
(`DeviceStack.np_dtype`).

Each device has its own cache (`for_device`); the load path raises on
an upload that fails instead of falling back.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .decode import _HandleCache

_stack_serial = itertools.count(1)

# file dtypes the device holds widened (value-preserving)
_WIDEN = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64}


@dataclass
class DeviceStack:
    dev: torch.Tensor         # (T, H, W) native dtype (see _WIDEN)
    nodata: float             # NaN when absent
    np_dtype: np.dtype        # the file's dtype: nodata compares in it
    serial: int = field(default_factory=lambda: next(_stack_serial))

    @property
    def shape(self):
        return tuple(self.dev.shape)

    @property
    def nbytes(self) -> int:
        return self.dev.numel() * self.dev.element_size()


def stack_from_numpy(data: np.ndarray, nodata,
                     device) -> DeviceStack:
    """Upload a (T, H, W) stack of at most 32 bits (uint16 / uint32
    widened); returns once the copy has landed."""
    if data.ndim != 3 or data.dtype.itemsize > 4:
        raise ValueError(f"drill stacks are (T, H, W) of at most 32 bits, "
                         f"got {data.shape} {data.dtype}")
    host = np.ascontiguousarray(data, _WIDEN.get(data.dtype, data.dtype))
    dev = torch.from_numpy(host).to(resolve_device(device))
    if dev.is_cuda:
        torch.cuda.current_stream(dev.device).synchronize()
    return DeviceStack(dev=dev, np_dtype=data.dtype,
                       nodata=float("nan") if nodata is None
                       else float(nodata))


class DrillStackCache:
    def __init__(self, device="cuda", max_bytes: int = 4 << 30,
                 max_item_bytes: int = 1 << 30, max_negative: int = 4096,
                 max_background_loads: int = 2):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # bound on concurrent get_async loader threads: a cold drill
        # over many files must not start one full-raster load per file
        self._bg_slots = threading.BoundedSemaphore(max_background_loads)
        self._handles = _HandleCache()
        self._stacks: Dict[tuple, DeviceStack] = {}
        self._order: List[tuple] = []
        self._bytes = 0
        self._max_bytes = max_bytes
        self._max_item = max_item_bytes
        # permanently uncacheable keys (too big / 64-bit), bounded
        self._neg: Dict[tuple, None] = {}
        self._max_neg = max_negative
        self._inflight: Dict[tuple, threading.Event] = {}
        # background load failures, re-raised by the next request
        self._errors: List[BaseException] = []
        self.hits = 0
        self.misses = 0

    @property
    def max_bytes(self) -> int:
        """The resident stacks' byte budget (LRU beyond it)."""
        return self._max_bytes

    @staticmethod
    def _key(path: str, var_name: str, band0: int,
             nodata: Optional[float]):
        """(key, mtime), or None when the file cannot be stat'd.  NaN
        cannot be part of a dict key (NaN != NaN), so an absent or NaN
        nodata keys as "nan"."""
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return None
        nd_key = "nan" if nodata is None or \
            (isinstance(nodata, float) and np.isnan(nodata)) \
            else float(nodata)
        return (path, mtime, var_name, band0, nd_key), mtime

    def _hit(self, key) -> Optional[DeviceStack]:  # gskylint: holds-lock
        """Resident stack under _lock, counted and moved to MRU."""
        hit = self._stacks.get(key)
        if hit is not None:
            self.hits += 1
            self._order.remove(key)
            self._order.append(key)
        return hit

    def _raise_background_error(self) -> None:
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            raise RuntimeError("drill stack upload failed") from errs[0]

    def get(self, path: str, is_nc: bool, var_name: str, band0: int,
            nodata: Optional[float]) -> Optional[DeviceStack]:
        """The (T, H, W) stack of one file variable / band, uploading on
        first use and blocking until the copy has landed.  None when
        uncacheable (too big or 64-bit) or the file is gone.  Concurrent
        first requests load once."""
        self._raise_background_error()
        made = self._key(path, var_name, band0, nodata)
        if made is None:
            return None
        key, mtime = made
        while True:
            with self._lock:
                hit = self._hit(key)
                if hit is not None:
                    return hit
                if key in self._neg:
                    self.hits += 1
                    return None
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    self.misses += 1
                    break
            ev.wait()
        return self._load_into(key, mtime, path, is_nc, var_name, band0,
                               nodata)

    def get_async(self, path: str, is_nc: bool, var_name: str,
                  band0: int,
                  nodata: Optional[float]) -> Optional[DeviceStack]:
        """The resident stack, or None at once, scheduling a background
        load on a first miss so that a later request hits: a cold
        request runs at host-read speed instead of waiting for the
        upload."""
        self._raise_background_error()
        made = self._key(path, var_name, band0, nodata)
        if made is None:
            return None
        key, mtime = made
        with self._lock:
            hit = self._hit(key)
            if hit is not None:
                return hit
            if key in self._neg:
                self.hits += 1
                return None
            if key in self._inflight:
                return None          # load already on its way
            if not self._bg_slots.acquire(blocking=False):
                return None          # loaders busy: a later request loads
            self._inflight[key] = threading.Event()
            self.misses += 1

        def load_and_release():
            try:
                self._load_into(key, mtime, path, is_nc, var_name,
                                band0, nodata)
            except BaseException as e:  # noqa: BLE001 - re-raised later
                with self._lock:
                    self._errors.append(e)
            finally:
                self._bg_slots.release()

        threading.Thread(target=load_and_release,
                         name="gsky-drill-upload", daemon=True).start()
        return None

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Block until no load is in flight.  True when idle within the
        timeout; a background load that failed raises here."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                evs = list(self._inflight.values())
            if not evs:
                self._raise_background_error()
                return True
            for ev in evs:
                if not ev.wait(max(deadline - time.monotonic(), 0.0)):
                    return False

    def clear(self) -> None:
        """Drop every resident stack."""
        with self._lock:
            self._stacks.clear()
            self._order.clear()
            self._neg.clear()
            self._bytes = 0

    def _load_into(self, key, mtime, path, is_nc, var_name, band0,
                   nodata) -> Optional[DeviceStack]:
        """Load and insert under the in-flight latch the caller took."""
        try:
            stack = self._load(path, is_nc, var_name, band0, nodata)
            with self._lock:
                if stack is not None:
                    # a new mtime supersedes older entries for the file
                    for old in [k for k in self._order
                                if k[0] == path and k[1] != mtime]:
                        self._order.remove(old)
                        self._bytes -= self._stacks.pop(old).nbytes
                    self._stacks[key] = stack
                    self._order.append(key)
                    self._bytes += stack.nbytes
                    while self._bytes > self._max_bytes and \
                            len(self._order) > 1:
                        old = self._order.pop(0)
                        self._bytes -= self._stacks.pop(old).nbytes
                else:
                    if len(self._neg) >= self._max_neg:
                        self._neg.pop(next(iter(self._neg)))
                    self._neg[key] = None
        finally:
            with self._lock:
                self._inflight.pop(key).set()
        return stack

    def _load(self, path: str, is_nc: bool, var_name: str, band0: int,
              nodata: Optional[float]) -> Optional[DeviceStack]:
        """The uploaded stack, or None when it is permanently
        uncacheable (unknown variable, 64-bit, above max_item_bytes)."""
        h = self._handles.get(path, is_nc)
        if is_nc:
            v = h.variables.get(var_name)
            if v is None:
                return None
            dtype = np.dtype(v.dtype)
            if len(v.shape) == 2:
                T, (H, W) = 1, v.shape
            else:
                T, H, W = v.shape[0], v.shape[-2], v.shape[-1]
            nd = nodata if nodata is not None else v.nodata
            if dtype.itemsize > 4 or T * H * W * dtype.itemsize \
                    > self._max_item:
                return None
            if len(v.shape) <= 3:
                data = np.asarray(v[:])
                if data.ndim == 2:
                    data = data[None]
            else:   # rank 4: (t, level0, y, x) per-timestep reads
                data = np.stack([h.read_slice(var_name, t, (0, 0, W, H))
                                 for t in range(T)])
        else:
            W, H = h.width, h.height
            dtype = np.dtype(h.dtype)
            nd = nodata if nodata is not None else h.nodata
            if dtype.itemsize > 4 or H * W * dtype.itemsize > self._max_item:
                return None
            data = h.read(band0, (0, 0, W, H))[None]
        if data.dtype.itemsize > 4:
            return None
        return stack_from_numpy(data, nd, self.device)


# one cache per device, shared by the pipelines on it
_caches: Dict[torch.device, DrillStackCache] = {}
_caches_lock = threading.Lock()


def for_device(device) -> DrillStackCache:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _caches_lock:
        cache = _caches.get(dev)
        if cache is None:
            cache = _caches[dev] = DrillStackCache(device=dev)
        return cache


def live_caches():
    """Every device's drill-stack cache."""
    with _caches_lock:
        return list(_caches.values())


def clear_all() -> None:
    """Empty every device's drill-stack cache (the pressure monitor's
    critical relief)."""
    with _caches_lock:
        caches = list(_caches.values())
    for cache in caches:
        cache.clear()


def enabled() -> bool:
    """GSKY_DRILL_CACHE=0 turns the resident-stack path off."""
    return os.environ.get("GSKY_DRILL_CACHE", "1") != "0"


def sync_mode() -> bool:
    """GSKY_DRILL_CACHE=sync makes the first request wait for the upload
    instead of answering from host reads."""
    return os.environ.get("GSKY_DRILL_CACHE", "1") == "sync"
