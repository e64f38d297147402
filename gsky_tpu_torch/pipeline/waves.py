"""Wave serving: concurrent GetMap tiles, animation frames and drills
share one kernel launch per wave.

Counterpart of `gsky_tpu/pipeline/waves.py` (`WaveScheduler`) for the
``byte``, ``scored``, ``expr`` and ``drill`` kinds.  A request enqueues
an entry (its payload and a future) and blocks on the future.  Three
daemon threads serve the queue:

- the ticker waits ``GSKY_WAVE_TICK_MS`` for companions after the first
  entry arrives, then assembles: it drains up to ``GSKY_WAVE_MAX``
  entries, groups them by (kind, statics, pool), plans each group
  (`autoplan.plan_wave_group`: superblocks, or the bucketed route),
  stacks its page tables and params (padding rows carry ns_id -1, so
  every lane's result is independent of its companions), its ctrl grids
  and scale params, and uploads the stacks into a `_StagingRing` slot;
- the dispatcher pops staged waves and launches each: kernel B1 over
  all its lanes for ``byte``/``scored``/``expr`` (``ops.paged``, with
  ``sb_of`` under a superblock plan; an ``expr`` wave's lanes share one
  fingerprint, their literals stacked (N, C) like the scale params), B2
  per lane on the bucketed route, B3's K-block form for ``drill``
  (`ops.paged.wave_drill_stats`); it then
  unpins the lanes' pages and records a completion event;
- the drainer waits for that event, copies the wave's outputs to host
  memory (pinned on the card) once, and sets each entry's future in
  entry order.

``GSKY_WAVE_PIPELINE=0`` assembles and dispatches on the ticker thread
(`run_wave`): the same stacks, the same launches.  ``GSKY_WAVES=0``
turns waves off: every request is served per call.

Streams.  Page staging, the staging ring's uploads and every wave's
launches run on the device's current stream (the default stream of
every thread here), so stream order alone keeps them apart: a page is
staged before a wave that reads it, and the next upload into a ring
slot, issued after the slot is released (after the launch that reads
it is enqueued), runs after that launch.  No tensor crosses streams.

The reference lands results in an on-device output ring (a workaround
for XLA buffer donation) and re-renders each entry per call after a
device incident.  The port has neither: PyTorch's caching allocator
reuses output blocks across waves, the drainer hands out host copies
only, and a failed wave fails every entry's request (`stats()`
"failed").  Not ported: mesh waves (A.11), brownout and pressure
clamps and cancellation (A.16),
`device_guard` supervision (A.10).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import paged
from ..ops.expr import fingerprint_hash
from ..ops.paged import PARAMS_W, expr_epilogue, scale_lanes, \
    wave_drill_stats
from ..ops.warp_render import render_scenes, warp_scenes_scored
from . import autoplan


def waves_enabled() -> bool:
    """GSKY_WAVES=0 serves every request per call (default on)."""
    return os.environ.get("GSKY_WAVES", "1") != "0"


def _env_int(name: str, default: int, lo: int, hi: int) -> int:
    try:
        v = int(os.environ.get(name, str(default)))
    except ValueError:
        v = default
    return max(lo, min(hi, v))


def wave_max() -> int:
    """Most entries a wave takes (GSKY_WAVE_MAX, default 16, 1..64)."""
    return _env_int("GSKY_WAVE_MAX", 16, 1, 64)


def wave_tick_ms() -> float:
    """How long the ticker waits for companions after the first entry
    (GSKY_WAVE_TICK_MS, default 2 ms, 0..100)."""
    try:
        v = float(os.environ.get("GSKY_WAVE_TICK_MS", "2"))
    except ValueError:
        v = 2.0
    return max(0.0, min(100.0, v))


def wave_pipeline_enabled() -> bool:
    """GSKY_WAVE_PIPELINE=0 assembles and dispatches on one thread
    (default on: assembly runs one wave ahead of dispatch).  Read per
    tick."""
    return os.environ.get("GSKY_WAVE_PIPELINE", "1") != "0"


def wave_queue_depth() -> int:
    """Staged waves assembly may run ahead of dispatch (GSKY_WAVE_QUEUE,
    default 1, 1..4)."""
    return _env_int("GSKY_WAVE_QUEUE", 1, 1, 4)


def wave_stage_slots() -> int:
    """Staging slots per (kind, statics) family (GSKY_WAVE_STAGE_SLOTS,
    default 2, 2..4)."""
    return _env_int("GSKY_WAVE_STAGE_SLOTS", 2, 2, 4)


@dataclass
class BucketedLane:
    """What a lane's bucketed leg (kernel B2 over its cached scenes)
    needs: the scenes, the group's params rows without its padding rows
    ((n, 11) f32), the ctrl grid on the device, and ``shape``, the
    (pow2 granules, bucket rows, bucket cols) of the dense stack the
    reference's bucketed leg reads (the planner's byte estimate)."""

    scenes: List[torch.Tensor]
    params: np.ndarray
    ctrl: torch.Tensor
    shape: Tuple[int, int, int]


class _Entry:
    __slots__ = ("kind", "key", "payload", "future", "cleanup",
                 "_cleaned", "t_enq")

    def __init__(self, kind, key, payload, cleanup=None):
        self.kind = kind
        self.key = key
        self.payload = payload
        self.future: Future = Future()
        self.cleanup = cleanup
        self._cleaned = cleanup is None
        self.t_enq = time.perf_counter()

    def cleanup_once(self):
        if not self._cleaned:
            self._cleaned = True
            self.cleanup()


class _StageSlot:
    __slots__ = ("bufs", "busy")

    def __init__(self):
        self.bufs: Dict[str, torch.Tensor] = {}
        self.busy = False


class _StagingRing:
    """Device input slots, ``wave_stage_slots()`` per (kind, statics)
    family: assembly `acquire`s a free slot and `upload`s the wave's
    host stacks into it (into the slot's previous buffers when shape and
    dtype match); dispatch `release`s it once the launch that reads it
    is enqueued.  On the card an upload goes through pinned memory,
    asynchronously, on the current stream."""

    def __init__(self, device):
        self.device = device
        self._fams: Dict[tuple, List[_StageSlot]] = {}
        self._cursor: Dict[tuple, int] = {}
        self._cv = threading.Condition()
        self.staged = 0
        self.reused = 0

    def _n(self) -> int:
        return wave_stage_slots()

    def acquire(self, family: tuple, should_stop=None) -> tuple:
        with self._cv:
            slots = self._fams.get(family)
            if slots is None or len(slots) != self._n():
                slots = [_StageSlot() for _ in range(self._n())]
                self._fams[family] = slots
                self._cursor[family] = 0
            while True:
                n = len(slots)
                start = self._cursor[family]
                for k in range(n):
                    i = (start + k) % n
                    if not slots[i].busy:
                        slots[i].busy = True
                        self._cursor[family] = (i + 1) % n
                        return (family, i)
                if should_stop is not None and should_stop():
                    raise RuntimeError("staging ring shut down")
                self._cv.wait(timeout=0.1)

    def upload(self, token: tuple, host: Dict[str, np.ndarray]) -> Dict:
        family, i = token
        with self._cv:
            slot = self._fams[family][i]
        dev: Dict[str, torch.Tensor] = {}
        reused = 0
        cuda = self.device.type == "cuda"
        for name, arr in host.items():
            src = torch.from_numpy(np.ascontiguousarray(arr))
            if cuda:
                src = src.pin_memory()
            prev = slot.bufs.get(name)
            if prev is not None and tuple(prev.shape) == tuple(src.shape) \
                    and prev.dtype == src.dtype:
                buf = prev
                reused += 1
            else:
                buf = torch.empty(src.shape, dtype=src.dtype,
                                  device=self.device)
            buf.copy_(src, non_blocking=cuda)
            dev[name] = buf
        slot.bufs = dev
        with self._cv:
            self.staged += 1
            self.reused += reused
        return dev

    def release(self, token: Optional[tuple]):
        if token is None:
            return
        family, i = token
        with self._cv:
            fam = self._fams.get(family)
            if fam is not None and i < len(fam):
                fam[i].busy = False
            self._cv.notify_all()

    def stats(self) -> Dict:
        with self._cv:
            return {"families": len(self._fams),
                    "slots_per_family": self._n(),
                    "staged": self.staged, "slot_reuse": self.reused}


class _StagedWave:
    __slots__ = ("kind", "key", "entries", "plan", "dev", "slot",
                 "pool_gen")

    def __init__(self, kind, key, entries, plan=None, dev=None, slot=None,
                 pool_gen=None):
        self.kind = kind
        self.key = key
        self.entries = entries
        self.plan = plan
        self.dev = dev
        self.slot = slot
        self.pool_gen = pool_gen


def _stack(es, name):
    return np.stack([np.asarray(e.payload[name]) for e in es])


def _stack_tables(es: List[_Entry]):
    """The group's tables (N, T, S) int32 and params (N*T, 16) f32: the
    granule axis to the largest lane's, the slots likewise; padding rows
    carry ns_id -1 and a null table, so they gather nothing."""
    N = len(es)
    T = max(e.payload["tables"].shape[0] for e in es)
    S = max(e.payload["tables"].shape[1] for e in es)
    tables = np.zeros((N, T, S), np.int32)
    params = np.zeros((N, T, PARAMS_W), np.float32)
    params[:, :, 10] = -1.0
    for i, e in enumerate(es):
        ti, si = e.payload["tables"].shape
        tables[i, :ti, :si] = e.payload["tables"]
        params[i, :ti] = e.payload["params16"]
    return tables, params.reshape(N * T, PARAMS_W)


def _host_inputs(kind: str, es: List[_Entry], plan) -> Dict:
    """A byte or scored group's launch inputs as host arrays, over its N
    real lanes (the reference pads N to a power of two for XLA's
    program cache; a launch here takes any N)."""
    N = len(es)
    host = {"ctrls": _stack(es, "ctrl")}
    if kind in ("byte", "expr"):
        host["sps"] = _stack(es, "sp")
    if kind == "expr":
        host["consts"] = _stack(es, "consts")
    if plan is not None and plan.route == "superblock":
        T = plan.params.shape[0] // plan.sb_of.shape[0]
        host["tables"] = plan.tables
        host["params"] = plan.params[:N * T]
        host["sb_of"] = plan.sb_of[:N]
    else:
        host["tables"], host["params"] = _stack_tables(es)
    return host


class WaveScheduler:
    """The wave pipeline of one device.  Threads start on the first
    submit and are daemons."""

    def __init__(self, device="cuda", tick_ms: Optional[float] = None):
        """``tick_ms`` overrides GSKY_WAVE_TICK_MS for this scheduler."""
        self.device = resolve_device(device)
        self._tick_ms = tick_ms
        self.staging = _StagingRing(self.device)
        self._lock = threading.Lock()
        self._pending: List[_Entry] = []
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._readback_q: Queue = Queue()
        self._staged_q: deque = deque()
        self._q_cv = threading.Condition()
        self._ticker: Optional[threading.Thread] = None
        self._drainer: Optional[threading.Thread] = None
        self._dispatcher: Optional[threading.Thread] = None
        # counters (under _lock)
        self.dispatches = 0          # launches of a group
        self.waves = 0
        self.requests = 0
        self.failed = 0              # entries whose wave failed
        self.superblock_lanes = 0    # lanes launched under a superblock plan
        self.bucketed_lanes = 0      # lanes the planner routed to B2
        self.occupancy: Dict[int, int] = {}
        self.readback_depth_max = 0
        self.assembly_ms_last = 0.0
        self.stage_ms_last = 0.0
        self.staged_waves = 0
        self._t_dispatch_end: Optional[float] = None
        self._gap_ms: List[float] = []
        self.gap_total_ms = 0.0
        self.busy_total_ms = 0.0

    # -- knobs ---------------------------------------------------------

    def _tick_s(self) -> float:
        ms = self._tick_ms if self._tick_ms is not None else wave_tick_ms()
        return ms / 1e3

    # -- submission ----------------------------------------------------

    def _submit(self, entry: _Entry) -> _Entry:
        self._ensure_threads()
        with self._lock:
            self._pending.append(entry)
            self.requests += 1
        self._kick.set()
        return entry

    # -- threads -------------------------------------------------------

    def _ensure_threads(self):
        if self._ticker is not None and self._ticker.is_alive():
            return
        with self._lock:
            if self._ticker is None or not self._ticker.is_alive():
                self._stop.clear()
                self._ticker = threading.Thread(
                    target=self._ticker_loop, name="gsky-wave-ticker",
                    daemon=True)
                self._ticker.start()
            if self._drainer is None or not self._drainer.is_alive():
                self._drainer = threading.Thread(
                    target=self._drain_loop, name="gsky-wave-readback",
                    daemon=True)
                self._drainer.start()
            if self._dispatcher is None or not self._dispatcher.is_alive():
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="gsky-wave-dispatch",
                    daemon=True)
                self._dispatcher.start()

    def _ticker_loop(self):
        while not self._stop.is_set():
            self._kick.wait(timeout=0.25)
            if self._stop.is_set():
                return
            with self._lock:
                if not self._pending:
                    self._kick.clear()
                    continue
            tick = self._tick_s()
            if tick > 0:
                time.sleep(tick)
            # a failure fails its entries inside; nothing escapes
            if wave_pipeline_enabled():
                self.assemble_once()
            else:
                self.run_wave()

    def _dispatch_loop(self):
        while not self._stop.is_set():
            self.dispatch_once(timeout=0.25)

    def _drain_loop(self):
        while True:
            try:
                item = self._readback_q.get(timeout=0.25)
            except Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            groups, done = item
            try:
                if done is not None:
                    done.synchronize()
                host = [[self._to_host(d) for d in devs]
                        for _k, _es, devs in groups]
            except Exception as exc:
                for _k, es, _d in groups:
                    self._fail(es, exc)
                continue
            for (_kind, es, _d), lanes in zip(groups, host):
                for i, e in enumerate(es):
                    if not e.future.done():
                        e.future.set_result(lanes[0][i] if len(lanes) == 1
                                            else tuple(h[i] for h in lanes))

    def _to_host(self, d: torch.Tensor) -> np.ndarray:
        """One copy of a wave output to host memory (pinned on the
        card); lanes are rows of the returned array."""
        if d.device.type == "cpu":
            return d.numpy()
        h = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
        h.copy_(d)
        return h.numpy()

    # -- staged-wave queue ---------------------------------------------

    def _q_put(self, sg: _StagedWave):
        with self._q_cv:
            self._staged_q.append(sg)
            self._q_cv.notify_all()

    def _q_get(self, timeout: float = 0.0) -> Optional[_StagedWave]:
        deadline = time.monotonic() + timeout
        with self._q_cv:
            while not self._staged_q:
                left = deadline - time.monotonic()
                if left <= 0 or self._stop.is_set():
                    return None
                self._q_cv.wait(timeout=left)
            sg = self._staged_q.popleft()
            self._q_cv.notify_all()
            return sg

    def _q_wait_space(self):
        with self._q_cv:
            while (len(self._staged_q) >= wave_queue_depth()
                   and not self._stop.is_set()):
                self._q_cv.wait(timeout=0.1)

    # -- assembly ------------------------------------------------------

    def _drain_groups(self) -> Dict[tuple, List[_Entry]]:
        with self._lock:
            cap = wave_max()
            take = self._pending[:cap]
            del self._pending[:cap]
            leftover = bool(self._pending)
        if leftover:
            self._kick.set()
        groups: Dict[tuple, List[_Entry]] = {}
        for e in take:
            groups.setdefault((e.kind, e.key), []).append(e)
        return groups

    def run_wave(self) -> int:
        """Assemble and dispatch one wave on this thread (the
        GSKY_WAVE_PIPELINE=0 leg; tests step it directly).  Returns the
        entries dispatched."""
        t0 = time.perf_counter()
        groups = self._drain_groups()
        readback = []
        dispatched = 0
        for (kind, _key), es in groups.items():
            try:
                plan = autoplan.plan_wave_group(kind, es)
                devs = self._timed_dispatch(kind, es, plan, None)
            except Exception as exc:
                self._fail(es, exc)
                continue
            dispatched += len(es)
            readback.append((kind, es, devs))
        if readback:
            self._put_readback(readback)
        if dispatched:
            with self._lock:
                self.waves += 1
                self.assembly_ms_last = (time.perf_counter() - t0) * 1e3
        return dispatched

    def assemble_once(self) -> int:
        """The pipelined assembly stage: drain, plan, stack, upload, and
        queue each group for dispatch.  Returns the entries staged."""
        t0 = time.perf_counter()
        groups = self._drain_groups()
        staged_n = 0
        for (kind, key), es in groups.items():
            self._q_wait_space()
            if self._stop.is_set():
                self._fail(es, RuntimeError("wave scheduler shut down"))
                continue
            try:
                sg = self._stage_group(kind, key, es)
            except Exception as exc:
                self._fail(es, exc)
                continue
            staged_n += len(es)
            with self._lock:
                self.staged_waves += 1
                self.stage_ms_last = (time.perf_counter() - t0) * 1e3
            self._q_put(sg)
        if staged_n:
            with self._lock:
                self.assembly_ms_last = (time.perf_counter() - t0) * 1e3
        return staged_n

    def _stage_group(self, kind: str, key: tuple,
                     es: List[_Entry]) -> _StagedWave:
        if kind == "drill":
            # drill blocks already lie on the device: nothing to upload
            return _StagedWave(kind, key, es)
        if kind not in ("byte", "scored", "expr"):
            raise ValueError(f"unknown wave kind {kind!r}")
        plan = autoplan.plan_wave_group(kind, es, stage="assembly")
        pool_gen = es[0].payload["pool"].handoff()
        if plan is not None and plan.route == "bucketed":
            return _StagedWave(kind, key, es, plan=plan, pool_gen=pool_gen)
        slot = self.staging.acquire((kind, key), should_stop=self._stop.is_set)
        try:
            dev = self.staging.upload(slot, _host_inputs(kind, es, plan))
        except Exception:
            self.staging.release(slot)
            raise
        return _StagedWave(kind, key, es, plan=plan, dev=dev, slot=slot,
                           pool_gen=pool_gen)

    def dispatch_once(self, timeout: float = 0.0) -> int:
        """The dispatch stage: pop one staged wave and dispatch it.
        Returns the entries dispatched, 0 when the queue stayed empty."""
        sg = self._q_get(timeout=timeout)
        if sg is None:
            return 0
        return self._dispatch_staged(sg)

    def _dispatch_staged(self, sg: _StagedWave) -> int:
        es = sg.entries
        try:
            if sg.pool_gen is not None and \
                    not es[0].payload["pool"].handoff_ok(sg.pool_gen):
                raise RuntimeError("page pool torn down between wave "
                                   "assembly and dispatch")
            devs = self._timed_dispatch(sg.kind, es, sg.plan, sg.dev)
        except Exception as exc:
            self._fail(es, exc)
            return 0
        finally:
            # the launch that reads the slot is enqueued (or failed):
            # stream order puts the slot's next upload after it
            self.staging.release(sg.slot)
        with self._lock:
            self.waves += 1
        self._put_readback([(sg.kind, es, devs)])
        return len(es)

    def _put_readback(self, groups):
        done = None
        if self.device.type == "cuda":
            try:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            except Exception as exc:
                for _k, es, _d in groups:
                    self._fail(es, exc)
                return
        self._readback_q.put((groups, done))
        with self._lock:
            self.readback_depth_max = max(self.readback_depth_max,
                                          self._readback_q.qsize())

    # -- dispatch ------------------------------------------------------

    def _timed_dispatch(self, kind, es, plan, staged):
        t0 = time.perf_counter()
        with self._lock:
            gap = None if self._t_dispatch_end is None \
                else (t0 - self._t_dispatch_end) * 1e3
        try:
            devs = self._dispatch_group(kind, es, plan, staged)
        finally:
            for e in es:
                e.cleanup_once()
            t1 = time.perf_counter()
            with self._lock:
                if gap is not None:
                    self._gap_ms.append(gap)
                    if len(self._gap_ms) > 2048:
                        del self._gap_ms[:1024]
                    self.gap_total_ms += gap
                self.busy_total_ms += (t1 - t0) * 1e3
                self._t_dispatch_end = t1
        with self._lock:
            self.dispatches += 1
            n = len(es)
            self.occupancy[n] = self.occupancy.get(n, 0) + 1
            if plan is not None and plan.route == "superblock":
                self.superblock_lanes += n
            if plan is not None and plan.route == "bucketed":
                self.bucketed_lanes += n
        return devs

    def _fail(self, entries: List[_Entry], exc: Exception):
        """A failed wave fails its requests: no per-call re-render."""
        for e in entries:
            e.cleanup_once()
            if not e.future.done():
                e.future.set_exception(exc)
        with self._lock:
            self.failed += len(entries)

    def _dispatch_group(self, kind, es, plan, staged):
        if kind == "drill":
            clip_lo, clip_hi, pix = es[0].key[1:]
            vals, counts = wave_drill_stats(
                [e.payload["data"] for e in es],
                [e.payload["valid"] for e in es], clip_lo, clip_hi, pix)
            return (vals, counts)
        if kind not in ("byte", "scored", "expr"):
            raise ValueError(f"unknown wave kind {kind!r}")
        statics = es[0].key[0]
        method, n_ns, out_hw, step = statics[:4]
        if plan is not None and plan.route == "bucketed":
            # B2 per lane over its cached scenes
            return self._bucketed(kind, es, statics)
        dev = self.device
        if staged is None:
            staged = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                      for k, v in _host_inputs(kind, es, plan).items()}
        pool = es[0].payload["pool"]
        with pool.locked_pool() as parr:
            if kind == "byte":
                out = paged.render_byte_paged(
                    parr, staged["tables"], staged["params"],
                    staged["ctrls"], staged["sps"], method, n_ns, out_hw,
                    step, statics[4], statics[5], sb_of=staged.get("sb_of"))
                return (out,)
            if kind == "expr":
                fp = statics[6]
                out = paged.render_expr_paged(
                    parr, staged["tables"], staged["params"],
                    staged["ctrls"], staged["sps"], staged["consts"],
                    method, n_ns, out_hw, step, statics[4], statics[5], fp,
                    fingerprint_hash(fp), sb_of=staged.get("sb_of"))
                return (out,)
            canv, best = paged.warp_scored_paged(
                parr, staged["tables"], staged["params"], staged["ctrls"],
                method, n_ns, out_hw, step, sb_of=staged.get("sb_of"))
        return (canv, best > float("-inf"))

    def _bucketed(self, kind, es, statics):
        dev = self.device
        outs = []
        for e in es:
            lane: BucketedLane = e.payload["xla"]
            params = torch.from_numpy(lane.params).to(dev)
            if kind == "byte":
                sp = torch.from_numpy(np.asarray(e.payload["sp"]))
                outs.append(render_scenes(lane.scenes, lane.ctrl, params, sp,
                                          *statics))
            elif kind == "expr":
                # B2 over the lane's scenes, then the same epilogue
                c, b = warp_scenes_scored(lane.scenes, lane.ctrl, params,
                                          *statics[:4])
                consts = torch.from_numpy(e.payload["consts"][None]).to(dev)
                plane, ok = expr_epilogue(c[None], b[None], statics[6],
                                          consts)
                outs.append(scale_lanes(plane, ok, e.payload["sp"][None],
                                        statics[4], statics[5])[0])
            else:
                outs.append(warp_scenes_scored(lane.scenes, lane.ctrl,
                                               params, *statics[:4]))
        if kind in ("byte", "expr"):
            return (torch.stack(outs),)
        canv = torch.stack([c for c, _ in outs])
        best = torch.stack([b for _, b in outs])
        return (canv, best > float("-inf"))

    # -- enqueue API ---------------------------------------------------

    @staticmethod
    def _wait(entry: _Entry):
        return entry.future.result()

    def render_byte(self, pool, tables, params16, ctrl, sp, statics: tuple,
                    lane: BucketedLane, serials=None) -> np.ndarray:
        """One byte tile: its pages staged in ``pool`` and ``tables``
        (T, S) PINNED (the wave unpins them once its launch is
        enqueued), params16 (T, 16), ctrl (2, gh, gw), sp (3,).
        ``serials`` is the lane's scene identity: the planner merges
        only lanes of the same scenes.  Blocks; returns host uint8
        (H, W)."""
        e = _Entry("byte", (tuple(statics), id(pool)),
                   {"pool": pool, "tables": np.asarray(tables),
                    "params16": np.asarray(params16),
                    "ctrl": np.asarray(ctrl, np.float32),
                    "sp": np.asarray(sp, np.float32), "xla": lane,
                    "serials": tuple(serials) if serials else None},
                   cleanup=lambda: pool.unpin(tables))
        return self._wait(self._submit(e))

    def render_expr(self, pool, tables, params16, ctrl, sp, consts,
                    statics: tuple, lane: BucketedLane,
                    serials=None) -> np.ndarray:
        """One fused expression tile: `render_byte`'s contract plus
        ``consts``, the lane's literals (C,) f32; ``statics`` ends with
        the fingerprint key, so a wave's lanes share one structure.
        Blocks; returns host uint8 (H, W)."""
        e = _Entry("expr", (tuple(statics), id(pool)),
                   {"pool": pool, "tables": np.asarray(tables),
                    "params16": np.asarray(params16),
                    "ctrl": np.asarray(ctrl, np.float32),
                    "sp": np.asarray(sp, np.float32),
                    "consts": np.asarray(consts, np.float32), "xla": lane,
                    "serials": tuple(serials) if serials else None},
                   cleanup=lambda: pool.unpin(tables))
        return self._wait(self._submit(e))

    def warp_scored(self, pool, tables, params16, ctrl, statics: tuple,
                    lane: BucketedLane, serials=None):
        """One scored mosaic (statics (method, n_ns, (h, w), step)).
        Blocks; returns host (canv (n_ns, h, w) f32, valid (n_ns, h, w)
        bool)."""
        e = _Entry("scored", (tuple(statics), id(pool)),
                   {"pool": pool, "tables": np.asarray(tables),
                    "params16": np.asarray(params16),
                    "ctrl": np.asarray(ctrl, np.float32), "xla": lane,
                    "serials": tuple(serials) if serials else None},
                   cleanup=lambda: pool.unpin(tables))
        return self._wait(self._submit(e))

    def drill_stats(self, data, valid, clip_lower: float,
                    clip_upper: float, pixel_count: bool):
        """One drill reduction over (B, N) data/valid on the device:
        drills of one (shape, clips, mode) share a launch.  Blocks;
        returns host (vals (B,) f32, counts (B,) int32)."""
        e = _Entry("drill", (tuple(int(d) for d in data.shape),
                             float(clip_lower), float(clip_upper),
                             bool(pixel_count)),
                   {"data": data, "valid": valid})
        return self._wait(self._submit(e))

    # -- lifecycle -----------------------------------------------------

    def shutdown(self):
        """Stop the threads; pending and staged entries fail."""
        with self._lock:
            leftover = self._pending[:]
            self._pending.clear()
        if leftover:
            self._fail(leftover, RuntimeError("wave scheduler shut down"))
        self._stop.set()
        with self._q_cv:
            staged = list(self._staged_q)
            self._staged_q.clear()
            self._q_cv.notify_all()
        for sg in staged:
            self.staging.release(sg.slot)
            self._fail(sg.entries, RuntimeError("wave scheduler shut down"))
        self._kick.set()
        self._readback_q.put(None)
        for t in (self._ticker, self._dispatcher, self._drainer):
            if t is not None and t.is_alive() \
                    and t is not threading.current_thread():
                t.join(timeout=2.0)
        # a wave the dispatcher queued after the drainer stopped
        while True:
            try:
                item = self._readback_q.get_nowait()
            except Empty:
                break
            for _k, es, _d in (item[0] if item is not None else ()):
                self._fail(es, RuntimeError("wave scheduler shut down"))

    def stats(self) -> Dict:
        with self._lock:
            gaps = np.asarray(self._gap_ms) if self._gap_ms else None
            busy, gap = self.busy_total_ms, self.gap_total_ms
            out = {"enabled": True,
                   "device": str(self.device),
                   "pipeline": wave_pipeline_enabled(),
                   "wave_max": wave_max(),
                   "tick_ms": self._tick_s() * 1e3,
                   "queue_depth": wave_queue_depth(),
                   "dispatches": self.dispatches,
                   "waves": self.waves,
                   "requests": self.requests,
                   "failed": self.failed,
                   "superblock_lanes": self.superblock_lanes,
                   "bucketed_lanes": self.bucketed_lanes,
                   "occupancy": dict(sorted(self.occupancy.items())),
                   "assembly_ms_last": self.assembly_ms_last,
                   "stage_ms_last": self.stage_ms_last,
                   "staged_waves": self.staged_waves,
                   "staged_queue_depth": len(self._staged_q),
                   "gap_ms_p50": float(np.percentile(gaps, 50))
                   if gaps is not None else 0.0,
                   "gap_ms_p99": float(np.percentile(gaps, 99))
                   if gaps is not None else 0.0,
                   "gap_samples": 0 if gaps is None else int(gaps.size),
                   "dispatch_idle_fraction": gap / (gap + busy)
                   if gap + busy > 0 else 0.0,
                   "readback_queue_depth": self._readback_q.qsize(),
                   "readback_depth_max": self.readback_depth_max}
        out["staging"] = self.staging.stats()
        return out


# -- one scheduler per device ------------------------------------------

_schedulers: Dict[torch.device, WaveScheduler] = {}
_schedulers_lock = threading.Lock()


def _key(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_waves(device="cuda") -> WaveScheduler:
    """The scheduler of ``device``, made on first use."""
    key = _key(device)
    with _schedulers_lock:
        w = _schedulers.get(key)
        if w is None:
            w = _schedulers[key] = WaveScheduler(key)
        return w


def active_waves(device="cuda") -> Optional[WaveScheduler]:
    """The scheduler of ``device`` or None; never makes one."""
    with _schedulers_lock:
        return _schedulers.get(_key(device))


def wave_stats() -> Dict[str, Dict]:
    """Every live scheduler's `stats()`, by device; {} before the first
    wave request."""
    with _schedulers_lock:
        live = list(_schedulers.items())
    return {str(k): w.stats() for k, w in live}


def reset_waves():
    """Shut every scheduler down and forget it (tests, reconfiguration)."""
    with _schedulers_lock:
        live = list(_schedulers.values())
        _schedulers.clear()
    for w in live:
        w.shutdown()
