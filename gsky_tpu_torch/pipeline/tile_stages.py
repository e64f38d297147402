"""The staged GetMap path: a request's fused render as bounded stages.

Counterpart of `gsky_tpu/pipeline/tile_stages.py`.  `render_staged`
runs the fused single-band route of one request as

    plan -> index -> decode -> dispatch -> readback

calling the same halves the serial path runs, in the same order, with
the same inputs, so its bytes are the serial path's: for a one-band
style `composite_prep` then `composite_dispatch` (a single band or
band algebra), for a 3-band style `_bands_prep` then the RGBA rung and,
where it declines, the planes rung, for 2 or 4 bands `_bands_prep` then
the planes rung.  Each stage but readback passes a
process-wide `StageGate` (a semaphore with occupancy telemetry), so
concurrent requests overlap: one decodes scenes into the device cache
while another's launch runs.  With waves on, dispatch passes no gate:
the wave scheduler needs concurrent arrivals to coalesce.
``GSKY_TILE_PIPELINE=0`` (read per request) sends GetMap down the
serial ladder instead.  The gates' sizes: ``GSKY_TILE_DECODE_WORKERS``
(default 4) and ``GSKY_TILE_DISPATCH_SLOTS`` (default 2).

Per-request spans (``spans``): seconds of plan, index, decode, dispatch
and readback, and the gates' queue high-water marks.  Not ported:
cancellation checks and the trace spans (A.16), the device guard's
readback probe (A.10).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from .decode import _device_failure
from .waves import waves_enabled


def tile_pipeline_enabled() -> bool:
    """GSKY_TILE_PIPELINE=0 turns the staged path off (default on)."""
    return os.environ.get("GSKY_TILE_PIPELINE", "1") != "0"


def _env_int(name: str, default: int, lo: int = 1, hi: int = 64) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(lo, min(hi, v))


class StageGate:
    """Bounded admission to one stage, shared by every request of the
    process: a semaphore, the occupancy high-water mark (requests at the
    gate, itself included, when one arrived), busy seconds, entries."""

    def __init__(self, name: str, limit: int):
        self.name = name
        self.limit = limit
        self._sem = threading.Semaphore(limit)
        self._lock = threading.Lock()
        self.waiting = 0
        self.queue_max = 0
        self.busy_s = 0.0
        self.entries = 0

    @contextlib.contextmanager
    def enter(self, spans: Optional[Dict] = None,
              qkey: Optional[str] = None):
        with self._lock:
            self.waiting += 1
            occupancy = self.waiting
            self.queue_max = max(self.queue_max, occupancy)
        if spans is not None and qkey:
            spans[qkey] = max(spans.get(qkey, 0), occupancy)
        self._sem.acquire()
        with self._lock:
            self.waiting -= 1
            self.entries += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._sem.release()
            with self._lock:
                self.busy_s += dt

    def stats(self) -> Dict:
        with self._lock:
            return {"limit": self.limit, "waiting": self.waiting,
                    "queue_max": self.queue_max, "entries": self.entries,
                    "busy_s": self.busy_s}


_gates: Dict[str, StageGate] = {}
_gates_lock = threading.Lock()
# stage -> (knob, default limit): decode admits several requests (scene
# loads are file reads and uploads); dispatch two, one launching while
# the previous one's output drains
_STAGES = {"decode": ("GSKY_TILE_DECODE_WORKERS", 4),
           "dispatch": ("GSKY_TILE_DISPATCH_SLOTS", 2)}


def _gate(name: str) -> StageGate:
    with _gates_lock:
        g = _gates.get(name)
        if g is None:
            env, default = _STAGES[name]
            g = _gates[name] = StageGate(name, _env_int(env, default))
        return g


def reset_gates() -> None:
    """Forget the gates, so that the next request reads the knobs."""
    with _gates_lock:
        _gates.clear()


def gate_stats() -> Dict:
    with _gates_lock:
        return {n: g.stats() for n, g in _gates.items()}


def _decode_stage(pipe, req, granules, spans: Dict) -> None:
    """Load every distinct scene into the device cache under the decode
    gate.  A prefetch: a scene that fails here is loaded again by the
    dispatch stage, which raises as the serial path does; a device
    failure (out of memory, a failed CUDA call) raises here."""
    t0 = time.perf_counter()
    with _gate("decode").enter(spans, "decode_queue_max"):
        seen = set()
        dst_gt = req.dst_gt()
        for g in granules:
            k = (g.path, g.band, g.var_name, g.time_index)
            if k in seen:
                continue
            seen.add(k)
            try:
                pipe.executor.warm_scene(g, dst_gt, req.crs, req.height,
                                         req.width)
            except Exception as e:
                if _device_failure(e) or isinstance(e, NotImplementedError):
                    raise
    spans["decode_s"] = spans.get("decode_s", 0.0) \
        + time.perf_counter() - t0


def _dispatch_stage(dispatch, spans: Dict):
    """Run the request's fused dispatch; under the dispatch gate unless
    waves are on."""
    t0 = time.perf_counter()
    try:
        if waves_enabled():
            return dispatch()
        with _gate("dispatch").enter(spans, "dispatch_queue_max"):
            return dispatch()
    finally:
        spans["dispatch_s"] = spans.get("dispatch_s", 0.0) \
            + time.perf_counter() - t0


def _readback(out, spans: Dict) -> np.ndarray:
    """The tile on the host: a wave's result already is; a tensor is
    copied (waiting for its launch)."""
    t0 = time.perf_counter()
    arr = out if isinstance(out, np.ndarray) else out.cpu().numpy()
    spans["readback_s"] = spans.get("readback_s", 0.0) \
        + time.perf_counter() - t0
    return arr


def render_staged(pipe, req, n_exprs: int, offset: float = 0.0,
                  scale: float = 0.0, clip: float = 0.0,
                  colour_scale: int = 0, auto: bool = True,
                  stats: Optional[Dict[str, int]] = None,
                  spans: Optional[Dict] = None):
    """The staged GetMap path, in the request's thread: (kind, host
    array) with kind "composite" (uint8 (H, W)), "rgba" ((H, W, 4)) or
    "planes" ((n, H, W)), or None when the fused route does not serve
    the request (the caller then takes the modular route, as the serial
    path does)."""
    spans = spans if spans is not None else {}
    t0 = time.perf_counter()
    if n_exprs == 1:
        made = pipe.composite_prep(req, stats, spans)
        pipe.executor.add_span("index", t0)
    elif n_exprs == 3:
        made = pipe._bands_prep(req, n_bands=3, stats=stats, spans=spans)
    else:
        made = pipe._bands_prep(req, stats=stats, spans=spans)
    spans["plan_s"] = spans.get("plan_s", 0.0) + max(
        0.0, time.perf_counter() - t0 - spans.get("index_s", 0.0))
    if made is None:
        return None
    _decode_stage(pipe, req, made[0], spans)
    args = (offset, scale, clip, colour_scale, auto)
    if n_exprs == 1:
        kind = "composite"
        out = _dispatch_stage(
            lambda: pipe.composite_dispatch(req, made, *args), spans)
    else:
        kind, out = "planes", None
        if n_exprs == 3:
            kind = "rgba"
            out = _dispatch_stage(lambda: pipe._rgba_try(req, *made, *args),
                                  spans)
        if out is None:
            kind = "planes"
            out = _dispatch_stage(
                lambda: pipe._bands_dispatch(req, *made, *args), spans)
    if out is None:
        return None
    return kind, _readback(out, spans)
