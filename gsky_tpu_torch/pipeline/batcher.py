"""Cross-request render batching: concurrent tiles share one launch.

Counterpart of `gsky_tpu/pipeline/batcher.py` (ROADMAP A.18), off by
default (``GSKY_RENDER_BATCH=1`` turns it on).  A tile waits at most
``max_wait_s`` (3 ms) for companions; a group that reaches
``min(max_batch, knee)`` tiles flushes at once and cancels its wait
timer.  A flush pads its tile count to the next power of two (at most
``max_batch``, 16).  Its exception reaches every waiter.  A waiter
whose request's cancel token fires stops waiting within one poll tick;
the flush still serves its companions.

Two legs, as in the reference:

- the paged leg (`render_paged`): tiles whose pages are staged in the
  page pool coalesce by their statics alone, whatever their scenes and
  window sizes.  A flush is ONE launch of kernel B1
  (`ops.paged.render_byte_paged`) over ragged (Np, T, S) page tables:
  the granule and slot axes padded to the batch's largest, padding rows
  with ns_id -1 and padding lanes with the null table, so they gather
  nothing.  The pins `table_for` took are released in ``finally``.
  The reference races this launch against per-tile XLA legs; the port
  runs no races.  With waves live a tile here joins the device's wave
  instead (`pipeline.waves`): wave ticks subsume batcher flushes.
- the dense leg (`render`): tiles over one set of cached scenes (the key
  holds the scenes' serials and the statics) flush together through
  kernel B2 (`ops.warp_render.render_scenes`), one launch per tile,
  since B2 has no tile axis.  The reference unions the tiles' gather
  windows; the port has no gather window (ROADMAP A.4), so
  `_union_window` is always the whole-stack case and every dense flush
  counts in ``full_batches``.

The knee: per padded size, an EMA of the measured per-tile time (the
first sample of each size discarded); a size slower per tile than
``_KNEE_RATIO`` x the best smaller size caps the flush threshold at
half of it, and the cap only moves down.  ``GSKY_RENDER_BATCH_MAX``
pins it.  `note_oom` halves the knee: each executor registers it as
the device guard's OOM hook.  A flush's launch and readback run under
``device_guard.run`` ("dispatch.paged" or "dispatch.bucketed").  Each
flush ticks
``gsky_batch_flushes_total{kind}`` ("paged" or "full") and is a
``batch.flush`` span (trigger "size" or "timer") of the trace of the
request whose thread ran it.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import device_guard
from ..obs import span as obs_span
from ..obs import tsan
from ..obs.metrics import BATCH_FLUSHES
from ..resilience.cancel import current_token

_MAX_BATCH = 16
# EMA weight of the newest per-tile latency sample
_EMA_ALPHA = 0.3
# a padded size is past the knee when its per-tile latency exceeds the
# best smaller size's by this factor
_KNEE_RATIO = 1.25


def batching_enabled() -> bool:
    """GSKY_RENDER_BATCH=1 turns the batcher on (default off)."""
    return os.environ.get("GSKY_RENDER_BATCH", "0") == "1"


def _knee_cap() -> int:
    """GSKY_RENDER_BATCH_MAX: a static cap on the flush threshold."""
    try:
        v = int(os.environ.get("GSKY_RENDER_BATCH_MAX", _MAX_BATCH))
    except ValueError:
        return _MAX_BATCH
    return max(1, min(_MAX_BATCH, v))


def _pow2_pad(n: int, most: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, most)


class RenderBatcher:
    def __init__(self, max_batch: int = _MAX_BATCH,
                 max_wait_s: float = 0.003):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._lock = threading.Lock()
        # key -> (scenes, [item, ...], Timer)
        self._groups: Dict[tuple, Tuple[object, List, object]] = {}
        self.win_batches = 0        # dense flushes with a union window
        self.full_batches = 0       # dense flushes over whole scenes
        self.paged_batches = 0      # paged flushes (one B1 launch each)
        # bytes moved for padding instead of payload: padding lanes'
        # inputs and outputs, and page slots no lane gathers
        self.pad_waste_bytes = 0
        self.flush_sizes: List[int] = []   # real tiles per paged flush
        self.knee = min(max_batch, _knee_cap())
        self._tile_ms: Dict[int, float] = {}   # padded size -> EMA ms
        self._tile_n: Dict[int, int] = {}      # samples per size
        if tsan.enabled():
            # lockset tracking across flush timers and request threads
            tsan.track(self, "RenderBatcher")

    def _observe(self, np_size: int, n_tiles: int, ms: float) -> None:
        """Fold one flush's per-tile time into its padded size's EMA and
        lower the knee when this size is slower per tile than a smaller
        one.  The first sample of each size (its warm-up) is dropped."""
        with self._lock:
            seen = self._tile_n.get(np_size, 0)
            self._tile_n[np_size] = seen + 1
            if seen == 0:
                return
            per_tile = ms / max(1, n_tiles)
            ema = self._tile_ms.get(np_size)
            self._tile_ms[np_size] = per_tile if ema is None else \
                (1 - _EMA_ALPHA) * ema + _EMA_ALPHA * per_tile
            if np_size <= 1:
                return
            smaller = [v for k, v in self._tile_ms.items()
                       if k < np_size]
            if smaller and self._tile_ms[np_size] > \
                    _KNEE_RATIO * min(smaller):
                self.knee = min(self.knee, max(1, np_size // 2))

    def note_oom(self) -> None:
        """Halve the coalesce knee (a device guard's OOM relief hook);
        it only moves down."""
        with self._lock:
            self.knee = max(1, self.knee // 2)

    def stats(self) -> Dict:
        with self._lock:
            return {"batch_knee": self.knee,
                    "tile_ms": {k: round(v, 3)
                                for k, v in sorted(self._tile_ms.items())},
                    "win_batches": self.win_batches,
                    "full_batches": self.full_batches,
                    "paged_batches": self.paged_batches,
                    "pad_waste_bytes": self.pad_waste_bytes}

    @staticmethod
    def _wait(fut: Future):
        """Block on a flush's future, cancellation-aware: a request whose
        token fired stops waiting within one poll tick while the flush
        still runs for its companions."""
        tok = current_token()
        if tok is None:
            return fut.result()
        while True:
            try:
                return fut.result(timeout=0.05)
            except _FutTimeout:
                tok.check("batch")

    def _join(self, key: tuple, scenes, item, flush_fn, statics):
        """Add ``item`` (its last element the future) to ``key``'s group,
        opening the group and its timer, or flushing it when full."""
        flush_now = None
        with self._lock:
            entry = self._groups.get(key)
            if entry is None:
                timer = threading.Timer(self.max_wait_s, self._flush_key,
                                        (key, statics, flush_fn))
                timer.daemon = True
                self._groups[key] = (scenes, [item], timer)
                timer.start()
            else:
                entry[1].append(item)
                if len(entry[1]) >= min(self.max_batch, self.knee):
                    flush_now = self._groups.pop(key)
        if flush_now is not None:
            # the timer would fire into an empty group: cancel it now
            flush_now[2].cancel()
            flush_fn(flush_now, statics, "size")
        return self._wait(item[-1])

    def _flush_key(self, key: tuple, statics: tuple, flush_fn):
        with self._lock:
            entry = self._groups.pop(key, None)
        if entry is not None:
            flush_fn(entry, statics, "timer")

    # -- the dense leg (kernel B2) ---------------------------------------

    def render(self, key: tuple, scenes, ctrl, params, sp,
               statics: tuple, win_raw=None):
        """Submit one tile over cached ``scenes`` (device tensors),
        ``ctrl`` (2, gh, gw) on the device, ``params`` (B, 16) and ``sp``
        (3,); blocks until its flush ran.  ``key`` holds the scenes'
        identity and the statics (method, n_ns, (h, w), step, auto,
        colour_scale).  Returns the uint8 (h, w) tile on the host."""
        fut: Future = Future()
        return self._join(key, scenes, (ctrl, params, sp, win_raw, fut),
                          self._execute, statics)

    def _union_window(self, items, scenes):
        """The batch's gather window: the port has none (ROADMAP A.4),
        so every dense flush reads whole scenes."""
        return None, None

    def _execute(self, entry, statics: tuple, trigger: str):
        from ..ops.warp_render import render_scenes
        scenes, items = entry[0], entry[1]
        try:
            N = len(items)
            Np = _pow2_pad(N, self.max_batch)
            self._union_window(items, scenes)
            with self._lock:
                self.full_batches += 1
            BATCH_FLUSHES.labels(kind="full").inc()
            t0 = time.perf_counter()
            # traced only when flushed from a request's thread (a timer
            # thread carries no request context)
            with obs_span("batch.flush", trigger=trigger) as bsp:
                out = device_guard.run(
                    "dispatch.bucketed",
                    lambda: torch.stack([
                        render_scenes(scenes, it[0], it[1],
                                      torch.as_tensor(it[2]), *statics)
                        for it in items]).cpu().numpy())
                bsp.set(tiles=N, padded=Np, windowed=False)
            self._observe(Np, N, (time.perf_counter() - t0) * 1e3)
            for i, it in enumerate(items):
                it[-1].set_result(out[i])
        except Exception as e:  # propagate to every waiter
            for it in items:
                if not it[-1].done():
                    it[-1].set_exception(e)

    # -- the paged leg (kernel B1) ---------------------------------------

    def render_paged(self, key: tuple, pool, tables, params16, ctrl, sp,
                     statics: tuple, real_pages: int, lane=None,
                     serials=None) -> np.ndarray:
        """Submit one tile whose pages are staged in ``pool``: ``tables``
        (T, S) int32 PINNED (the flush unpins), ``params16`` (T, 16),
        ``ctrl`` (2, gh, gw) and ``sp`` (3,) on the host.  ``key`` holds
        the statics only, so tiles over different scenes and window
        sizes share a flush.  With waves live the tile joins the
        device's wave (``lane`` and ``serials`` are its bucketed leg and
        scene identity there).  Blocks; returns the uint8 (h, w) tile on
        the host."""
        from .waves import active_waves, waves_enabled
        w = active_waves(pool.device) if waves_enabled() else None
        if w is not None:
            return w.render_byte(pool, tables, params16, ctrl, sp, statics,
                                 lane, serials)
        fut: Future = Future()
        item = (pool, np.asarray(tables), np.asarray(params16),
                np.asarray(ctrl, np.float32), np.asarray(sp, np.float32),
                int(real_pages), fut)
        return self._join(key, None, item, self._execute_paged, statics)

    def _execute_paged(self, entry, statics: tuple, trigger: str):
        from ..ops.paged import PARAMS_W, render_byte_paged
        items = entry[1]
        method, n_ns, out_hw, step, auto, colour_scale = statics
        h, w = out_hw
        pool = items[0][0]
        try:
            N = len(items)
            Np = _pow2_pad(N, self.max_batch)
            T = max(it[1].shape[0] for it in items)
            S = max(it[1].shape[1] for it in items)
            tables = np.zeros((Np, T, S), np.int32)
            params = np.zeros((Np, T, PARAMS_W), np.float32)
            params[:, :, 10] = -1.0     # ns_id: padding rows
            for i, it in enumerate(items):
                ti, si = it[1].shape
                tables[i, :ti, :si] = it[1]
                params[i, :ti] = it[2]
            ctrls = np.stack([it[3] for it in items]
                             + [items[0][3]] * (Np - N))
            sps = np.stack([it[4] for it in items]
                           + [items[0][4]] * (Np - N))
            real_pages = sum(it[5] for it in items)
            page_bytes = pool.page_rows * pool.page_cols * 4
            waste = (Np - N) * (h * w + ctrls[0].nbytes
                                + T * PARAMS_W * 4 + sps[0].nbytes) \
                + (Np * T * S - real_pages) * page_bytes
            with self._lock:
                self.paged_batches += 1
                self.pad_waste_bytes += int(waste)
                self.flush_sizes.append(N)
            BATCH_FLUSHES.labels(kind="paged").inc()
            dev = pool.device
            t0 = time.perf_counter()
            def flush():
                with pool.locked_pool() as parr:
                    out = render_byte_paged(
                        parr, torch.from_numpy(tables).to(dev),
                        torch.from_numpy(
                            params.reshape(Np * T, PARAMS_W)).to(dev),
                        torch.from_numpy(ctrls).to(dev),
                        torch.from_numpy(sps), method, n_ns, out_hw, step,
                        auto, colour_scale)
                # the padding lanes never leave the device
                return out[:N].cpu().numpy()

            with obs_span("batch.flush", trigger=trigger) as bsp:
                host = device_guard.run("dispatch.paged", flush)
                bsp.set(tiles=N, padded=Np, paged=True)
            self._observe(Np, N, (time.perf_counter() - t0) * 1e3)
            for i, it in enumerate(items):
                it[-1].set_result(host[i])
        except Exception as e:  # propagate to every waiter
            for it in items:
                if not it[-1].done():
                    it[-1].set_exception(e)
        finally:
            for it in items:
                pool.unpin(it[1])
