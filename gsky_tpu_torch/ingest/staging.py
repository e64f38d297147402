"""Host staging buffers sized to the page grid.

Counterpart of `gsky_tpu/ingest/staging.py` over torch host tensors.
A scene load used to make three full-scene host arrays: the decoded
band, its f32 cast and the bucket-padded copy it uploaded.  With ingest
on, the band decodes straight into a NaN-filled, bucket-sized f32
buffer from this pool, is NaN-encoded in place and uploaded from the
same memory.

* Pinning: a pooled buffer for a CUDA device is page-locked, so its
  upload is an asynchronous DMA; a buffer over the pool's budget
  (``GSKY_STAGING_MB``, default 128) is unpooled and stays pageable, so
  no load pays a ``cudaHostAlloc`` for it.  (A 7936 x 7936 f32 bucket,
  a Landsat-size scene's, is 252 MB: over the default budget, so such
  a scene never pools at default settings.)
* Cooling: a released buffer that fed an upload waits in a cooling list
  until the CUDA event recorded after its ``non_blocking`` copy has
  completed (``event.query()``): recycling host memory under an
  in-flight copy would corrupt the resident scene.
* Aliasing: on the CPU the "device" scene is the buffer itself
  (``Tensor.to("cpu")`` returns it), so the buffer is uncharged and
  forgotten, never recycled.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import torch


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class StagingPool:
    """Shape-keyed free list of NaN-filled f32 host tensors."""

    def __init__(self, max_mb: Optional[int] = None):
        self._lock = threading.Lock()
        self._free: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        self._cooling: List[Tuple[object, torch.Tensor]] = []
        self._pooled: Dict[int, int] = {}      # data_ptr -> bytes charged
        self._bytes = 0
        self._max_bytes = (max_mb if max_mb is not None
                           else _env_int("GSKY_STAGING_MB", 128)) << 20
        self.allocated = 0
        self.reused = 0
        self.unpooled = 0
        self.pinned = 0

    def _drain_cooling_locked(self) -> None:
        still = []
        for event, buf in self._cooling:
            if event.query():
                self._free.setdefault(tuple(buf.shape), []).append(buf)
            else:
                still.append((event, buf))
        self._cooling = still

    def acquire(self, rows: int, cols: int, device) -> torch.Tensor:
        """A NaN-filled f32 (rows, cols) host tensor for a load onto
        ``device``: a free pooled one of that shape, a new pooled one
        (pinned when ``device`` is CUDA) while the budget allows, else an
        unpooled pageable one."""
        shape = (int(rows), int(cols))
        dev = torch.device(device)
        with self._lock:
            self._drain_cooling_locked()
            bucket = self._free.get(shape)
            if bucket:
                buf = bucket.pop()
                self.reused += 1
                buf.fill_(float("nan"))
                return buf
            nbytes = shape[0] * shape[1] * 4
            pooled = self._bytes + nbytes <= self._max_bytes
            if pooled:
                self._bytes += nbytes
                self.allocated += 1
            else:
                self.unpooled += 1
        pin = pooled and dev.type == "cuda"
        try:
            buf = torch.full(shape, float("nan"), dtype=torch.float32,
                             pin_memory=pin)
        except BaseException:
            if pooled:
                with self._lock:
                    self._bytes -= nbytes
                    self.allocated -= 1
            raise
        if pooled:
            with self._lock:
                self._pooled[buf.data_ptr()] = nbytes
                self.pinned += int(pin)
        return buf

    def release(self, buf: torch.Tensor, dev: Optional[torch.Tensor] = None,
                done=None) -> None:
        """Return a buffer from `acquire`.  ``dev``: the device tensor
        uploaded from it; ``done``: the CUDA event recorded after that
        upload, until which the buffer cools.  Without either the buffer
        is free at once (no consumer is in flight).  An unpooled buffer
        is dropped."""
        with self._lock:
            charged = self._pooled.get(buf.data_ptr())
            if charged is None:
                return
            if dev is not None and dev.device.type == "cpu" \
                    and dev.data_ptr() == buf.data_ptr():
                # the scene IS this memory: uncharge and forget it
                del self._pooled[buf.data_ptr()]
                self._bytes = max(0, self._bytes - charged)
                return
            if done is not None:
                self._cooling.append((done, buf))
            else:
                self._free.setdefault(tuple(buf.shape), []).append(buf)

    def stats(self) -> Dict:
        with self._lock:
            free = sum(len(v) for v in self._free.values())
            return {"allocated": self.allocated, "reused": self.reused,
                    "unpooled": self.unpooled, "pinned": self.pinned,
                    "free": free, "cooling": len(self._cooling),
                    "pool_bytes": self._bytes,
                    "max_bytes": self._max_bytes}

    def clear(self) -> None:
        with self._lock:
            self._free.clear()
            self._cooling.clear()
            self._pooled.clear()
            self._bytes = 0
            self.allocated = self.reused = self.unpooled = self.pinned = 0


_default: Optional[StagingPool] = None
_default_lock = threading.Lock()


def default_staging_pool() -> StagingPool:
    global _default
    with _default_lock:
        if _default is None:
            _default = StagingPool()
        return _default


def reset_staging_pool() -> None:
    """Drop the process's pool, so ``GSKY_STAGING_MB`` is read again."""
    global _default
    with _default_lock:
        _default = None
