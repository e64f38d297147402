"""Open-file handle cache for granule and drill reads.

Counterpart of `gsky_tpu/pipeline/decode.py::_HandleCache`, for the
GeoTIFF and NetCDF-3 files the port serves.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from ..io.geotiff import GeoTIFF
from ..io.netcdf import NetCDF


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
