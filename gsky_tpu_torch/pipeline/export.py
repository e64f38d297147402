"""The staged WCS export engine: plan once, then decode, warp and encode
in overlapping stages.

Counterpart of `gsky_tpu/pipeline/export.py`.  One GetCoverage export
of several output tiles:

* **Plan.**  ONE `TilePipeline.index` query over the whole export bbox;
  granules are assigned to tiles by footprint (their WKT bounds,
  reprojected and buffered by 0.5%, so a granule the per-tile query
  would return is never dropped: an extra one adds no valid tap).
  With waves and the planner on (``GSKY_WAVES``, ``GSKY_PLAN``),
  consecutive tiles that share a source form a co-submission batch of
  at most ``GSKY_EXPORT_COSUBMIT`` tiles (default 4), rendered together
  so that their lanes meet in one wave.
* **Decode.**  A thread pool (``GSKY_EXPORT_DECODE_WORKERS``, default
  4) warms each distinct source (path, band, variable, time) once per
  export: into the scene cache where it is cacheable, else as one
  window over the whole export (`_memo_window`), which every tile that
  needs it reads.
* **Warp.**  One thread: `WarpExecutor.warp_mosaic_scenes` (kernel B1,
  or B2 where the paged leg declines), else `warp_mosaic` over the memo
  windows (B2); a layer with a mask band goes through
  `TilePipeline.render` (kernel B4).  A tile's outputs on the card are
  copied to pinned host memory without blocking, with an event the
  encode stage waits on before it reads them; a wave lane's result is
  already on the host and is taken as it comes.
* **Encode.**  ``GSKY_EXPORT_ENCODE_WORKERS`` threads (default 4) write
  each tile into the caller's sink: ``writer.write_region`` (the
  streamed GeoTIFF or the DAP4 spool) or the in-RAM ``out``/``valid``
  canvases.

Stages meet through queues of ``GSKY_EXPORT_QUEUE_DEPTH`` (default 4),
so a slow writer holds decode back.  The first error of any stage stops
the others and `run` raises it; the caller closes and unlinks a partial
sink.  `run` returns the stats: busy seconds per stage, queue
high-water marks, dedup counts and the executor's leg counts over the
export (``paged_engaged``, ``paged_declined``, ``paged_gated``).  The
plan and each stage thread's lifetime are spans of the request's trace
(``export.plan``, ``export.decode_stage``, ``export.warp_stage``,
``export.encode_stage``).  ``GSKY_EXPORT_PIPELINE=0`` gives the
per-tile serial path.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextvars
import dataclasses
import os
import queue
import re
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..geo.crs import parse_crs
from ..geo.transform import BBox, GeoTransform, transform_bbox
from ..obs import span as obs_span
from ..resilience import check_partial, current_token
from . import autoplan
from .decode import _device_failure, decode_window
from .tile import _empty_result, evaluate_expressions, ns_prio
from .types import Granule, TileResult
from .waves import waves_enabled

_DONE = object()      # end of stream on the stage queues
_LEGS = ("paged_engaged", "paged_declined", "paged_gated")


def pipeline_enabled() -> bool:
    """GSKY_EXPORT_PIPELINE (default on), read per request."""
    return os.environ.get("GSKY_EXPORT_PIPELINE", "1") != "0"


def _env_int(name: str, default: int, lo: int = 1, hi: int = 64) -> int:
    try:
        return max(lo, min(hi, int(os.environ.get(name, default))))
    except ValueError:
        return default


_NUM = re.compile(r"[-+]?[0-9]+(?:\.[0-9]*)?(?:[eE][-+]?[0-9]+)?")


def _wkt_bounds(wkt: str) -> Optional[BBox]:
    """The coordinate bounds of a WKT geometry; None when unparseable."""
    if not wkt:
        return None
    nums = [float(m.group()) for m in _NUM.finditer(wkt)]
    if len(nums) < 4 or len(nums) % 2:
        return None
    xs, ys = nums[0::2], nums[1::2]
    return BBox(min(xs), min(ys), max(xs), max(ys))


def _scene_key(g: Granule) -> tuple:
    # the scene cache's identity without the level: one decode a source
    return (g.path, g.band, g.var_name, g.time_index)


class _Pulled:
    """A tensor on its way to the host: a pinned buffer that a
    non-blocking copy fills, and the event recorded after the copy."""

    def __init__(self, t: torch.Tensor):
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        self.done.synchronize()
        return self.host.numpy()


def _start_pull(v):
    """Start the copy of a card tensor to the host; a host array or a
    CPU tensor is taken as it is."""
    if isinstance(v, torch.Tensor) and v.device.type == "cuda":
        return _Pulled(v)
    return v


def _host(v) -> np.ndarray:
    if isinstance(v, _Pulled):
        return v.numpy()
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


class ExportPipeline:
    """One WCS GetCoverage export: plan, then the staged render into
    ``writer`` (anything with ``write_region(ox, oy, block)``) or into
    the caller's ``out`` / ``valid`` canvases, block for block what the
    serial per-tile path writes."""

    def __init__(self, pipe, base_req, tiles, ns_names: Sequence[str],
                 bbox: BBox, width: int, height: int,
                 nodata: float = -9999.0, writer=None,
                 out: Optional[Dict[str, np.ndarray]] = None,
                 valid: Optional[Dict[str, np.ndarray]] = None):
        self.pipe = pipe
        self.base_req = base_req
        self.tiles = list(tiles)      # [(bbox, ox, oy, tw, th), ...]
        self.ns_names = list(ns_names)
        self.bbox = bbox
        self.width = width
        self.height = height
        self.nodata = nodata
        self.writer = writer
        self.out = out
        self.valid = valid
        self.decode_workers = _env_int("GSKY_EXPORT_DECODE_WORKERS", 4)
        self.encode_workers = _env_int("GSKY_EXPORT_ENCODE_WORKERS", 4)
        self.queue_depth = _env_int("GSKY_EXPORT_QUEUE_DEPTH", 4)
        self._stop = threading.Event()
        self._errors: List[BaseException] = []
        self._err_lock = threading.Lock()
        # scene key -> DeviceScene or None (uncacheable), by the decode
        # stage
        self._warm: Dict[tuple, object] = {}
        # scene key -> the one export-wide DecodedWindow (or None) of a
        # source the scene cache cannot hold
        self._memo: Dict[tuple, object] = {}
        self._memo_lock = threading.Lock()
        # scene keys whose window decode raised (not merely missed the
        # extent): the partial-failure budget counts them
        self._memo_failed: set = set()
        self._batch_of: List[int] = list(range(len(self.tiles)))
        self.stats: Dict[str, object] = {}

    # -- control ---------------------------------------------------------

    def cancel(self) -> None:
        """Stop between tiles: work in flight finishes, queued work is
        dropped.  The caller closes and unlinks a partial sink."""
        self._stop.set()

    def _fail(self, e: BaseException) -> None:
        with self._err_lock:
            self._errors.append(e)
        self._stop.set()

    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _take(self, q: queue.Queue):
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                continue
        return _DONE

    # -- plan --------------------------------------------------------------

    def _plan(self) -> List[List[Granule]]:
        """ONE index query over the export bbox, then each tile's
        granules by footprint in the destination CRS."""
        full_req = dataclasses.replace(
            self.base_req, bbox=self.bbox, width=self.width,
            height=self.height)
        granules = self.pipe.index(full_req)
        dst_crs = self.base_req.crs
        bounds: List[Optional[BBox]] = []
        for g in granules:
            bb = _wkt_bounds(g.polygon)
            if bb is not None and g.srs:
                try:
                    bb = transform_bbox(bb, parse_crs(g.srs), dst_crs)
                    bb = bb.buffer(0.005 * max(bb.width, bb.height))
                except ValueError:
                    bb = None
            else:
                bb = None      # no footprint: on every tile
            bounds.append(bb)
        plan = [[g for g, bb in zip(granules, bounds)
                 if bb is None or bb.intersects(tb)]
                for (tb, _, _, _, _) in self.tiles]
        self.stats["granules"] = len(granules)
        self.stats["granule_tile_refs"] = sum(len(gs) for gs in plan)
        self._batch_of = self._plan_batches(plan)
        return plan

    def _plan_batches(self, plan: List[List[Granule]]) -> List[int]:
        """A batch id per tile: consecutive tiles that share a source
        are co-submitted (at most ``GSKY_EXPORT_COSUBMIT``) when the
        planner and waves are on; else every tile is its own batch."""
        n = len(self.tiles)
        if not (autoplan.plan_enabled() and waves_enabled()):
            return list(range(n))
        cap = _env_int("GSKY_EXPORT_COSUBMIT", 4, lo=1, hi=16)
        keys = [set(map(_scene_key, gs)) for gs in plan]
        batch = [0] * n
        bid, size = 0, 1
        for i in range(1, n):
            if size < cap and keys[i] & keys[i - 1]:
                size += 1
            else:
                bid += 1
                size = 1
            batch[i] = bid
        return batch

    # -- stage 1: decode / warm ------------------------------------------

    def _full_gt(self) -> GeoTransform:
        return GeoTransform.from_bbox(self.bbox, self.width, self.height)

    def _warm_one(self, g: Granule) -> None:
        s = self.pipe.executor.warm_scene(g, self._full_gt(),
                                          self.base_req.crs, self.height,
                                          self.width)
        self._warm[_scene_key(g)] = s
        if s is None and not g.geo_loc:
            # uncacheable: its one window over the whole export, now
            self._memo_window(g)

    def _memo_window(self, g: Granule):
        key = _scene_key(g)
        with self._memo_lock:
            if key in self._memo:
                return self._memo[key]
        failed = False
        try:
            w = decode_window(g, self.bbox, self.base_req.crs,
                              self.base_req.resample,
                              dst_hw=(self.height, self.width),
                              device=self.pipe.device)
        except NotImplementedError:
            raise
        except Exception as e:
            # a granule's own read failure degrades it to missing; a
            # failure of the card fails the export
            if _device_failure(e):
                raise
            w = None
            failed = True
        with self._memo_lock:
            self._memo.setdefault(key, w)
            if failed:
                self._memo_failed.add(key)
            return self._memo[key]

    def _decode_stage(self, plan: List[List[Granule]],
                      q_warp: queue.Queue) -> None:
        """Tiles in output order: warm each tile's sources not seen yet,
        then hand the tile to the warp stage.  The bounded queue is the
        lookahead."""
        busy = 0.0
        seen: set = set()
        try:
            with cf.ThreadPoolExecutor(
                    self.decode_workers,
                    thread_name_prefix="gsky-export-decode") as pool:
                for tile, gs in zip(self.tiles, plan):
                    if self._stop.is_set():
                        return
                    t0 = time.perf_counter()
                    fresh = []
                    for g in gs:
                        k = _scene_key(g)
                        if k not in seen:
                            seen.add(k)
                            fresh.append(g)
                    # with a remote the workers read the sources: nothing
                    # is warmed or decoded here
                    local = self.pipe.remote is None
                    if fresh and local:
                        list(pool.map(self._warm_one, fresh))
                    # a tile with an uncacheable source takes the window
                    # leg, which needs windows for all its granules
                    if local and any(self._warm.get(_scene_key(g)) is None
                                     and not g.geo_loc for g in gs):
                        list(pool.map(self._memo_window,
                                      [g for g in gs if not g.geo_loc]))
                    busy += time.perf_counter() - t0
                    self.stats["warp_queue_max"] = max(
                        self.stats.get("warp_queue_max", 0),
                        q_warp.qsize() + 1)
                    if not self._put(q_warp, (tile, gs)):
                        return
            self._put(q_warp, _DONE)
        except BaseException as e:     # noqa: BLE001 - run() raises it
            self._fail(e)
        finally:
            self.stats["decode_s"] = busy
            self.stats["scenes_warmed"] = len(seen)
            self.stats["scenes_uncacheable"] = sum(
                1 for v in self._warm.values() if v is None)
            self.stats["windows_decoded"] = len(self._memo)

    # -- stage 2: warp -----------------------------------------------------

    def _render_tile(self, req, gs: List[Granule]) -> TileResult:
        """One tile from the warmed sources: `TilePipeline._render_fused`
        with the export's memo windows in place of its decode."""
        exprs = req.band_exprs
        H, W = req.height, req.width
        dev = self.pipe.device
        if not gs:
            return _empty_result(exprs, H, W, dev)
        if not self.pipe.fused_ok(req):
            # the modular route (a mask band, or the workers warping):
            # plan-once indexing and stage overlap still hold; the
            # mosaic is kernel B4
            return self.pipe.render(req, gs)
        ex = self.pipe.executor
        names, ns_ids, prio = ns_prio(gs)
        sc = ex.warp_mosaic_scenes(gs, ns_ids, prio, req.dst_gt(),
                                   req.crs, H, W, len(names),
                                   req.resample, host=True)
        if sc is None:
            ws = [self._memo_window(g) if not g.geo_loc else None
                  for g in gs]
            with self._memo_lock:
                failed = sum(1 for g in gs
                             if _scene_key(g) in self._memo_failed)
            check_partial(failed, len(gs), "decode")
            live = [(g, w) for g, w in zip(gs, ws) if w is not None]
            if not live:
                return _empty_result(exprs, H, W, dev)
            names, ns_ids, prio = ns_prio([g for g, _ in live])
            sc = ex.warp_mosaic([w for _, w in live], ns_ids, prio,
                                req.dst_gt(), req.crs, H, W, len(names),
                                req.resample)
        canv, vals = sc
        if isinstance(canv, np.ndarray):
            # a wave lane, already on the host: bare variables pass
            # through there; an expression is evaluated on the card
            canv, vals = torch.from_numpy(canv), torch.from_numpy(vals)
            if any(ce._ast[0] != "var" for ce in exprs.expressions):
                canv, vals = canv.to(dev), vals.to(dev)
        data_env = {n: canv[i] for i, n in enumerate(names)}
        valid_env = {n: vals[i] for i, n in enumerate(names)}
        return evaluate_expressions(
            exprs, data_env, valid_env, H, W, canv.device,
            granule_count=len(gs), file_count=len({g.path for g in gs}))

    def _flush_batch(self, batch, q_encode, pool) -> bool:
        """Render one batch and hand its tiles to the encoders in output
        order.  The tiles of a batch of several render concurrently, so
        that their lanes land in one wave."""
        if not batch:
            return True
        reqs = [dataclasses.replace(self.base_req, bbox=tb, width=tw,
                                    height=th)
                for (tb, _ox, _oy, tw, th), _gs in batch]
        if pool is not None and len(batch) > 1:
            # in the request's context: a tile's partial decode marks
            # the request degraded
            futs = [pool.submit(contextvars.copy_context().run,
                                self._render_tile, rq, gs)
                    for rq, (_t, gs) in zip(reqs, batch)]
            results = [f.result() for f in futs]
            self.stats["plan_batches"] = \
                self.stats.get("plan_batches", 0) + 1
            self.stats["plan_batched_tiles"] = \
                self.stats.get("plan_batched_tiles", 0) + len(batch)
        else:
            results = [self._render_tile(rq, gs)
                       for rq, (_t, gs) in zip(reqs, batch)]
        for ((_tb, ox, oy, tw, th), _gs), res in zip(batch, results):
            # start every card-to-host copy now: the encode stage waits
            # on it while this thread warps the next tile
            pulled = {n: (_start_pull(res.data[n]), _start_pull(res.valid[n]))
                      for n in self.ns_names if n in res.data}
            self.stats["encode_queue_max"] = max(
                self.stats.get("encode_queue_max", 0),
                q_encode.qsize() + 1)
            if not self._put(q_encode, ((ox, oy, tw, th), pulled)):
                return False
        return True

    def _warp_stage(self, q_warp: queue.Queue,
                    q_encode: queue.Queue) -> None:
        busy = 0.0
        co = max(Counter(self._batch_of).values(), default=1)
        pool = cf.ThreadPoolExecutor(
            co, thread_name_prefix="gsky-export-warp") if co > 1 else None
        try:
            batch: List = []
            bid = None
            i = 0
            while True:
                item = self._take(q_warp)
                if item is _DONE:
                    break
                b = self._batch_of[i] if i < len(self._batch_of) else i
                i += 1
                t0 = time.perf_counter()
                if bid is not None and b != bid:
                    ok = self._flush_batch(batch, q_encode, pool)
                    batch = []
                    if not ok:
                        return
                bid = b
                batch.append(item)
                busy += time.perf_counter() - t0
            t0 = time.perf_counter()
            self._flush_batch(batch, q_encode, pool)
            busy += time.perf_counter() - t0
        except BaseException as e:     # noqa: BLE001 - run() raises it
            self._fail(e)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
            self.stats["warp_s"] = busy

    # -- stage 3: encode / write -------------------------------------------

    def _encode_one(self, ox: int, oy: int, tw: int, th: int,
                    pulled) -> None:
        if self.writer is not None:
            block = np.full((len(self.ns_names), th, tw), self.nodata,
                            np.float32)
            for i, n in enumerate(self.ns_names):
                if n in pulled:
                    d, v = (_host(x) for x in pulled[n])
                    block[i] = np.where(v, d, self.nodata)
            self.writer.write_region(ox, oy, block)
            return
        for n in self.ns_names:
            if n in pulled:
                d, v = (_host(x) for x in pulled[n])
                self.out[n][oy:oy + th, ox:ox + tw] = d
                self.valid[n][oy:oy + th, ox:ox + tw] = v

    def _encode_stage(self, q_encode: queue.Queue,
                      busy: List[float]) -> None:
        try:
            while True:
                item = self._take(q_encode)
                if item is _DONE:
                    return
                (ox, oy, tw, th), pulled = item
                t0 = time.perf_counter()
                self._encode_one(ox, oy, tw, th, pulled)
                busy[0] += time.perf_counter() - t0
        except BaseException as e:     # noqa: BLE001 - run() raises it
            self._fail(e)

    # -- run ---------------------------------------------------------------

    def run(self) -> Dict:
        """Run the export; returns the stats.  Raises the first stage
        error (the caller then closes and unlinks a partial sink)."""
        t0 = time.perf_counter()
        ex = self.pipe.executor
        legs0 = {k: getattr(ex, k) for k in _LEGS}
        self.stats = {"tiles": len(self.tiles), "index_queries": 1,
                      "decode_workers": self.decode_workers,
                      "encode_workers": self.encode_workers,
                      "queue_depth": self.queue_depth}
        # a fired cancel token (client gone, deadline passed) trips the
        # stop flag every stage loop checks
        tok = current_token()
        unhook = tok.on_cancel(self.cancel) if tok is not None else None
        try:
            return self._run(t0, ex, legs0, tok)
        finally:
            if unhook is not None:
                unhook()

    def _run(self, t0: float, ex, legs0: Dict, tok) -> Dict:
        with obs_span("export.plan") as psp:
            plan = self._plan()
            psp.set(tiles=len(self.tiles),
                    granules=self.stats.get("granules", 0))
        q_warp: queue.Queue = queue.Queue(self.queue_depth)
        q_encode: queue.Queue = queue.Queue(self.queue_depth)

        def traced(span_name, fn, *args):
            # a stage thread runs in a copy of the request's context (a
            # Context cannot be entered by two threads at once), its
            # lifetime one span of the request's trace
            ctx = contextvars.copy_context()

            def body():
                with obs_span(span_name):
                    fn(*args)
            return lambda: ctx.run(body)

        decode_t = threading.Thread(
            target=traced("export.decode_stage", self._decode_stage, plan,
                          q_warp),
            name="gsky-export-plan", daemon=True)
        enc_busy = [[0.0] for _ in range(self.encode_workers)]
        encoders = [threading.Thread(
            target=traced("export.encode_stage", self._encode_stage,
                          q_encode, enc_busy[i]),
            name=f"gsky-export-encode-{i}", daemon=True)
            for i in range(self.encode_workers)]
        decode_t.start()
        for t in encoders:
            t.start()
        try:
            with obs_span("export.warp_stage"):
                self._warp_stage(q_warp, q_encode)
        finally:
            # every stage must see a sentinel or the stop flag
            for _ in encoders:
                self._put(q_encode, _DONE)
            decode_t.join()
            for t in encoders:
                t.join()
        with self._err_lock:
            if self._errors:
                raise self._errors[0]
        if self._stop.is_set():
            if tok is not None:
                tok.check("export")     # RequestCancelled when it fired
            raise RuntimeError("export cancelled")
        self.stats["encode_s"] = sum(b[0] for b in enc_busy)
        self.stats["wall_s"] = time.perf_counter() - t0
        self.stats["dedup_saved"] = max(
            0, self.stats.get("granule_tile_refs", 0)
            - self.stats.get("scenes_warmed", 0))
        for k in _LEGS:
            self.stats[k] = getattr(ex, k) - legs0[k]
        return self.stats
