"""The worker node: the RPC front door + the device executor + the
decode pool.

Counterpart of `gsky_tpu/worker/server.py`, in the role of GSKY's
`grpc-server/main.go` (binary ``gsky-rpc``): one unary gRPC method,
``/gskyrpc.GDAL/Process(Task) returns (Result)`` (`make_server`, the
reference's ``make_grpc_server``: a generic handler over the port's own
codec, `gskyrpc`, whose bytes are protobuf's), with the operations

- ``worker_info`` — answered inline (`grpc-server/main.go:31-33`), even
  while draining: it is the drain handshake the fleet's health monitor
  reads.  ``WorkerInfo.platform`` is the executor's device type
  ("cuda" or "cpu"); ``info_json`` carries the drain, the device
  supervisor, the decode pool, the page pools and the launch counts of
  this process's kernels (``kernels``);
- ``warp`` — decode in the subprocess pool, then warp on the executor
  this process owns (`WarpExecutor.warp_all`, the plain gather); a
  curvilinear granule instead warps from this process's scene cache
  through the geolocation control grid (`WarpExecutor.
  warp_mosaic_scenes`: kernel B1, or B2 where the pool declines);
- ``drill`` — the masked reductions of one file (`pipeline.drill.
  drill_file`: kernel B3 on the card);
- ``extent`` / ``info`` — pure IO, delegated to the pool;
- ``preempt`` — a preemption notice (the autoscaler's scale-down, the
  cloud's reclaim): the drain under the grace deadline, the scored page
  journal shipped to the ring successor (``journal_handoff``), then the
  exit (`fleet.elastic`); ``{"grace_s", "successor", "peers",
  "graceful"}`` in ``Task.path``;
- ``journal_handoff`` — the successor's half: the preempted node's hot
  set merged into this node's journal, its pages pulled from the
  preempted node's pool in the background;
- ``journal_export`` — this node's hot set, for a node that starts with
  an empty journal (`WorkerService.warm_boot`; the port's own op,
  ROADMAP C.18);
- ``page_fetch`` — the cache fabric's page RPC (`fabric.pagerpc`),
  served from the executor's page pool, the pool the kernels read.

``worker_info``, ``preempt``, ``journal_handoff``, ``journal_export``
and ``page_fetch`` answer outside the drain gate: a draining (preempted) node serving its
pages to its successor is the warm hand-off.  ``worker_info``'s
``elastic`` block is the autoscaler's readiness probe: the share of the
journal's hot set resident in the pool (``warm_fraction``), whether it
is ``ready``, the hand-off's counts and this process's elastic
counters.

The pool gives crash isolation for codec IO; the OOM monitor SIGKILLs
the fattest child under memory pressure.  A `DeviceGuardError` answers
``device: ...``, a full pool ``backpressure: ...`` and a draining node
``draining: ...``: the client fails over on each without charging the
node's breaker.

    python -m gsky_tpu_torch.worker.server -p PORT [-host H] [-n POOL] \\
        [-device cpu] [-max_tasks N] [-timeout S] [-oom_threshold MB]

renders on the CUDA card unless ``-device cpu`` is given, and raises
without one.  Before it listens it builds and loads the kernels
(`server.prewarm`, ``GSKY_PREWARM=0`` skips).  SIGTERM or SIGINT starts
the drain: new RPCs answer ``draining:``, those in flight finish (at
most ``GSKY_DRAIN_TIMEOUT_S``, 30), then the process exits 0; a
graceful preemption exits 0 at its grace deadline, one with no grace
at once with 1.  Without ``GSKY_POOL_JOURNAL`` the page journal lives
in a directory of its own a node (``gsky-worker-<port>`` under the
temporary directory): nodes on one host must not share one.  With the
fabric on and ``GSKY_FABRIC_PAGE_PEERS`` set, a node warms its pool
from those peers in the background (`WorkerService.warm_boot`), and
reports not ready until it has.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import logging
import math
import os
import signal
import tempfile
import threading
import time
import weakref
from typing import Optional

import grpc
import numpy as np
import torch

from .. import device_guard
from ..device import resolve_device
from ..device_guard import DeviceGuardError, journal
from ..fleet import DrainController, Draining
from ..obs import (TRACE_METADATA_KEY, current_trace_id, remote_trace,
                   span as obs_span)
from ..ops import kernel_launches
from ..resilience import faults
from . import gskyrpc as pb
from .oom import OOMMonitor
from .pool import PoolFullError, ProcessPool
from .serialize import granule_from_pb, pack_raster, unpack_raster

log = logging.getLogger("gsky.worker.server")

SERVICE = "gskyrpc.GDAL"
METHOD = f"/{SERVICE}/Process"
# RPCs the server runs at once (the reference's gRPC executor size)
HANDLER_SLOTS = 32
# how long a booting node waits for its decode children (a child's own
# start-up window, `pool.Process._spawn`) before it listens anyway
POOL_READY_S = 60.0


def _compile_probe():
    """Pre-dispatch compile-counter sample, paired with `_device_attrs`."""
    try:
        from ..server.prewarm import compile_count
        return compile_count()
    except Exception:
        return None


def _device_attrs(sp, c0) -> None:
    """Did THIS dispatch build or load a kernel (a fresh compile)?"""
    if c0 is not None:
        try:
            from ..server.prewarm import compile_count
            sp.set(fresh_compile=compile_count() > c0)
        except Exception:  # compile probe is best-effort telemetry
            pass


def _scored_entries(doc: dict) -> list:
    """A hot-set document's well-formed ``[serial, pi, pj, score]``
    entries, at most `HANDOFF_MAX` of them."""
    from ..fleet import elastic
    entries = []
    for e in doc.get("entries") or []:
        try:
            s, pi, pj = int(e[0]), int(e[1]), int(e[2])
            score = float(e[3]) if len(e) > 3 else 1.0
        except (TypeError, ValueError, IndexError):
            continue
        if pi < 0 or pj < 0:      # merge_scored's guard
            continue
        entries.append((s, pi, pj, score))
    return entries[:elastic.HANDOFF_MAX]


class WorkerService:
    """Op dispatch shared by the RPC server and in-process callers.
    ``device`` ("cuda" by default) is where the executor renders;
    without CUDA it must be "cpu".  ``executor``: the `WarpExecutor`
    whose page pool ``page_fetch`` serves and whose device warps, by
    default one of its own on ``device``; an OWS server's, for a page
    peer fronting the pool that server's renders fill."""

    def __init__(self, pool: ProcessPool, device="cuda", executor=None):
        self.device = resolve_device(device)
        self.pool = pool
        self.drain = DrainController("worker-node")
        if executor is None:
            from ..pipeline.executor import WarpExecutor
            executor = WarpExecutor(device=self.device)
        self.executor = executor
        # the elastic lifecycle (`fleet.elastic`): how this node names
        # itself to its peers (set by `main`, or GSKY_ELASTIC_SELF), the
        # preemption's state and the hand-off's counts
        self.advertise_addr = os.environ.get("GSKY_ELASTIC_SELF") or None
        self._preempt_lock = threading.Lock()
        self.preempted = False
        self.preempt_exit = None        # graceful: unpark `main`
        self.preempt_exit_hard = None   # no grace: end the process
        self._handoff = {"entries": 0, "filled": 0, "cold": 0,
                         "active": 0}
        self._warm_cache = (0.0, None)  # (monotonic time, journal want)
        self.warming = False            # the fabric's warm boot runs
        # a node:preempt fault takes the real protocol; held weakly, so
        # that a dropped service does not live on in the faults module
        ref = weakref.ref(self)

        def _on_preempt(grace_s: float, graceful: bool) -> None:
            svc = ref()
            if svc is not None:
                svc.begin_preemption(grace_s, graceful=graceful)

        faults.set_preempt_handler(_on_preempt)

    # -- ops -----------------------------------------------------------------

    def process(self, task: pb.Task, ctx=None) -> pb.Result:
        """``ctx`` is the gRPC ServicerContext (None from in-process
        callers): its ``x-gsky-trace`` metadata continues the gateway's
        trace here, and the child spans ride back on ``info_json`` for
        ops that leave that channel free."""
        op = task.operation
        header = None
        if ctx is not None:
            try:
                for k, v in ctx.invocation_metadata():
                    if k == TRACE_METADATA_KEY:
                        header = v
                        break
            except Exception:
                header = None
        with remote_trace(header, f"worker.{op}") as wtrace:
            res = self._process(task, op, ctx)
            if wtrace is not None and not res.info_json \
                    and op in ("warp", "drill", "extent"):
                try:
                    res.info_json = json.dumps(
                        {"spans": wtrace.span_dicts()})
                except Exception:  # span attachment is advisory telemetry
                    pass
            return res

    def _process(self, task: pb.Task, op: str, ctx=None) -> pb.Result:
        try:
            # node-level chaos (GSKY_FAULTS="node:kill:..." etc.) hits
            # every RPC including health probes — a killed node just dies
            faults.inject("node")
            # answered outside the drain gate: worker_info is the drain
            # handshake the fleet reads; a notice must land on a busy
            # node; inheriting or sharing a hot set is not work; and a preempted
            # node serving its pages to its successor in the grace
            # window is the warm hand-off
            if op == "worker_info":
                return self._worker_info()
            if op == "preempt":
                return self._preempt(task)
            if op == "journal_handoff":
                return self._journal_handoff(task)
            if op == "journal_export":
                return self._journal_export()
            if op == "page_fetch":
                return self._page_fetch(task)
            with self.drain.track():
                if op == "warp":
                    return self._warp(task, ctx)
                if op == "drill":
                    return self._drill(task)
                if op in ("extent", "info", "decode"):
                    return self.pool.submit(task)
                return pb.Result(error=f"unknown operation {op!r}")
        except Draining as e:
            return pb.Result(error=f"draining: {e}")
        except PoolFullError as e:
            return pb.Result(error=f"backpressure: {e}")
        except DeviceGuardError as e:
            # a device incident (hang, crash, OOM, corruption, a
            # rebuild): the client fails over without a breaker penalty
            return pb.Result(error=f"device: {e}")
        except Exception as e:
            log.exception("op %s failed trace=%s", op,
                          current_trace_id() or "-")
            return pb.Result(error=f"{type(e).__name__}: {e}")

    def _worker_info(self) -> pb.Result:
        r = pb.Result()
        r.worker.pool_size = self.pool.size
        r.worker.queue_cap = self.pool.queue.maxsize
        r.worker.platform = self.device.type
        # WorkerInfo has no spare field: the drain handshake, the device
        # supervisor's state and the pool's crash-loop breaker ride the
        # free-form info_json, so that the fleet's health monitor marks
        # a node degraded or fatal from the same probe
        info = dict(self.drain.stats())
        try:
            info["device"] = device_guard.default_supervisor().stats()
        except Exception:  # health still reports the drain
            pass
        try:
            info["pool"] = self.pool.stats()
        except Exception:  # pool stats optional in the health probe
            pass
        try:
            info["pages"] = self.executor.pool.stats()
        except Exception:  # a pool being torn down
            pass
        try:
            info["kernels"] = kernel_launches()
        except Exception:  # the launch counts are advisory
            pass
        try:
            info["elastic"] = self._elastic_info()
        except Exception:  # readiness is advisory; the probe answers
            pass
        r.info_json = json.dumps(info)
        return r

    # -- the elastic lifecycle (`fleet.elastic`) ----------------------------

    def _elastic_info(self) -> dict:
        """``worker_info``'s ``elastic`` block: the autoscaler's join
        gate reads ``ready``; ``warm_fraction`` is the share of the
        journal's hot set resident in the executor's pool (1.0 with
        nothing to warm); ``counters`` are this process's elastic
        counters (`fleet.elastic.counters`)."""
        from .. import fabric
        from ..fleet import elastic
        want = self._journal_want()
        st = self.executor.pool.stats()
        resident, capacity = int(st["resident"]), int(st["capacity"])
        if want <= 0:
            warm = 1.0
        else:
            goal = min(want, capacity) if capacity else want
            warm = min(1.0, resident / max(goal, 1))
        ready = not fabric.fabric_enabled() or \
            (not self.warming and warm >= elastic.WARM_FRAC)
        with self._preempt_lock:
            handoff = dict(self._handoff)
            preempted = self.preempted
        return {"ready": bool(ready),
                "warm_fraction": round(warm, 4),
                "prewarm_done": True,
                "preempted": preempted,
                "handoff": handoff,
                "counters": elastic.counters()}

    def _journal_want(self) -> int:
        """The journal's hot-set size, kept 5 s: the probe comes every
        heartbeat and `journal.replay` reads the whole file."""
        now = time.monotonic()
        ts, cached = self._warm_cache
        if cached is not None and now - ts < 5.0:
            return cached
        want = len(journal.replay()) if journal.journal_enabled() else 0
        self._warm_cache = (now, want)
        return want

    def _preempt(self, task: pb.Task) -> pb.Result:
        """The preemption notice: start the drain and the warm journal
        hand-off under the grace deadline.  Idempotent."""
        from ..fleet import elastic
        try:
            doc = json.loads(task.path or "{}")
        except ValueError:
            doc = {}
        grace = doc.get("grace_s")
        grace_s = float(grace) if grace is not None \
            else elastic.PREEMPT_GRACE_S
        self.begin_preemption(
            grace_s, graceful=bool(doc.get("graceful", True)),
            successor=doc.get("successor") or None,
            peers=[p for p in (doc.get("peers") or [])
                   if isinstance(p, str)])
        r = pb.Result()
        r.info_json = json.dumps({"ok": True, "grace_s": grace_s})
        return r

    def begin_preemption(self, grace_s: float, graceful: bool = True,
                         successor: Optional[str] = None,
                         peers=()) -> bool:
        """The first notice wins; later ones (a retried RPC, a second
        fault roll) do nothing.  True when this call started it."""
        with self._preempt_lock:
            if self.preempted:
                return False
            self.preempted = True
        threading.Thread(
            target=self._run_preemption,
            args=(max(float(grace_s), 0.0), graceful, successor,
                  list(peers)),
            daemon=True, name="gsky-preempt").start()
        return True

    def _run_preemption(self, grace_s, graceful, successor, peers):
        from ..fleet import elastic
        deadline = time.monotonic() + grace_s
        elastic.note_preemption(graceful and grace_s > 0)
        if not graceful or grace_s <= 0:
            # no grace: keep what a restart can use, then go
            log.warning("preemption (no grace): flushing journal")
            self._flush_pool_journal()
            hard = self.preempt_exit_hard or self.preempt_exit
            if hard is not None:
                hard()
            return
        log.info("preemption notice: grace=%.1fs successor=%s",
                 grace_s, successor or "-")
        self.drain.start_drain()
        self._ship_journal(successor, peers,
                           timeout=max(min(grace_s * 0.5, 5.0), 0.5))
        left = deadline - time.monotonic() - 0.25
        if not self.drain.wait_drained(max(left, 0.0)):
            # the grace deadline: the stragglers fail over, counted
            n = self.drain.abandon_inflight()
            log.warning("preemption grace expired with %d in flight; "
                        "failing them over", n)
        self._flush_pool_journal()
        st = self.drain.stats()
        log.info("preemption drain done: completed=%d refused=%d "
                 "abandoned=%d", st["completed"], st["refused"],
                 st["abandoned"])
        # held to the grace deadline even when the drain ended early:
        # the successor is pulling this node's pages over page_fetch,
        # and the fleet's probes need a beat of the draining state to
        # tell a preemption from a crash.  Four tenths of the grace (at
        # most 3 s) are left for the process's own teardown (its
        # listener, decode pool and CUDA context: ~1.2 s on the card),
        # which must end inside the window, before the reclaim
        left = deadline - time.monotonic() - min(3.0, 0.4 * grace_s)
        if left > 0:
            time.sleep(left)
        if self.preempt_exit is not None:
            self.preempt_exit()

    def _ship_journal(self, successor, peers, timeout: float) -> None:
        """Ship this node's hot set (heat scores with it) to its ring
        successor, which pulls the pages from this node's pool while the
        grace window keeps it alive."""
        from ..fleet import elastic
        doc = self._hot_set()
        if successor is None and self.advertise_addr:
            successor = elastic.successor_for(self.advertise_addr, peers)
        entries = doc["entries"]
        if not entries or not successor:
            return
        doc["peers"] = [p for p in peers if p != successor]
        try:
            elastic.control_rpc(successor, "journal_handoff", doc,
                                timeout=timeout)
            elastic.note_handoff_shipped(len(entries), True)
            log.info("journal handoff: %d entries -> %s",
                     len(entries), successor)
        except Exception:
            elastic.note_handoff_shipped(len(entries), False)
            log.warning("journal handoff to %s failed", successor)

    def _hot_set(self) -> dict:
        """This node's hot set, hottest first, with the heat scores:
        the document a hand-off ships and ``journal_export`` answers."""
        from ..fleet import elastic
        hot = journal.export_hot(elastic.HANDOFF_MAX)
        return {"v": 1, "source": self.advertise_addr,
                "entries": [[s, pi, pj, round(score, 3)]
                            for s, pi, pj, score in hot]}

    def _journal_export(self) -> pb.Result:
        """A peer's hot set for a node that starts with an empty journal
        (`warm_boot`).  Read only: nothing of this node changes."""
        r = pb.Result()
        r.info_json = json.dumps(self._hot_set())
        return r

    def warm_boot(self, peers) -> int:
        """The fabric's warm boot (`main`, with page peers set).  A node
        whose journal is empty, as one the autoscaler just launched,
        first takes the hot set of the first peer that answers
        (``journal_export``); then its pool pulls the journal's pages
        from the peers (`PagePool.rehydrate`).  ``ready`` stays false
        until this returns.  Returns the pages restored."""
        from .. import fabric
        from ..fleet import elastic
        self.warming = True
        try:
            if journal.journal_enabled() and not journal.replay():
                for peer in peers:
                    try:
                        doc = elastic.control_rpc(
                            peer, "journal_export", timeout=fabric.TIMEOUT_S)
                    except Exception:   # the next peer, or a cold start
                        log.warning("journal_export from %s failed", peer)
                        continue
                    entries = _scored_entries(doc)
                    if entries:
                        journal.merge_scored(entries)
                        log.info("warm boot: %d journal entries from %s",
                                 len(entries), peer)
                        break
            self._warm_cache = (0.0, None)
            return self.executor.pool.rehydrate()
        finally:
            self.warming = False

    def _flush_pool_journal(self) -> None:
        """Write the pool's hit counts to the journal (`PagePool.
        flush_heat`), so that even an abandoned exit leaves a hot set a
        restart replays.  The pool stays resident: the successor may
        still be pulling its pages (the reference tears it down here)."""
        try:
            self.executor.pool.flush_heat()
        except Exception:
            log.exception("journal flush on preemption failed")

    def _journal_handoff(self, task: pb.Task) -> pb.Result:
        """The successor's half of the hand-off: merge the preempted
        node's scored hot set into this node's journal, then pull its
        pages, hottest first, from that node's pool (and the other
        peers) over page_fetch, in the background: the notice returns
        inside the sender's grace window."""
        try:
            doc = json.loads(task.path or "{}")
        except ValueError:
            return pb.Result(error="elastic: malformed handoff")
        entries = _scored_entries(doc)
        journal.merge_scored(entries)
        self._warm_cache = (0.0, None)   # the hot set just grew
        source = doc.get("source") or None
        peers = [p for p in (doc.get("peers") or [])
                 if isinstance(p, str) and p != self.advertise_addr]
        with self._preempt_lock:
            self._handoff["entries"] += len(entries)
            self._handoff["active"] += 1
        threading.Thread(
            target=self._handoff_fill, args=(entries, source, peers),
            daemon=True, name="gsky-handoff-fill").start()
        r = pb.Result()
        r.info_json = json.dumps({"accepted": len(entries)})
        return r

    def _handoff_fill(self, entries, source, peers):
        from .. import fabric
        from ..fleet import elastic
        filled = 0
        keys = [(s, pi, pj) for s, pi, pj, _ in entries]
        try:
            if fabric.fabric_enabled() and keys:
                from ..fabric import pagerpc
                pool = self.executor.pool
                missing = [k for k in keys if not pool.has_page(*k)]
                fill_peers = [p for p in ([source] + peers) if p]
                filled = len(keys) - len(missing) + \
                    pagerpc.fill_from_peers(pool, missing,
                                            peers=fill_peers,
                                            prefer=source)
        except Exception:
            log.exception("handoff fill failed")
        cold = len(keys) - filled
        elastic.note_handoff_pages("peer", filled)
        elastic.note_handoff_pages("cold", cold)
        with self._preempt_lock:
            self._handoff["filled"] += filled
            self._handoff["cold"] += cold
            self._handoff["active"] -= 1
        log.info("handoff fill: %d/%d pages from peers", filled,
                 len(keys))

    def _page_fetch(self, task: pb.Task) -> pb.Result:
        """The cache fabric's page RPC: the requested resident pages of
        the executor's pool on the host, content-keyed with a CRC each
        (`fabric.pagerpc.serve_page_fetch`).  Refused while the page
        tier is off."""
        from .. import fabric
        if not fabric.fabric_enabled():
            return pb.Result(error="fabric: page peering disabled")
        from ..fabric import pagerpc
        try:
            doc = json.loads(task.path or "{}")
        except ValueError:
            return pb.Result(error="fabric: malformed page_fetch request")
        manifest, blob = pagerpc.serve_page_fetch(self.executor.pool, doc)
        res = pb.Result()
        res.raster = blob
        res.info_json = json.dumps(manifest)
        return res

    def _warp(self, task: pb.Task, ctx=None) -> pb.Result:
        from ..geo.crs import parse_crs
        from ..geo.transform import GeoTransform
        from ..pipeline.decode import DecodedWindow

        # the gateway's cancel token reaches here as the call's
        # cancellation (gRPC's ``is_active``); poll it at the expensive
        # boundaries and stop decoding and warping for an answer nobody
        # will read
        def _gone() -> bool:
            try:
                return ctx is not None and not ctx.is_active()
            except Exception:
                return False

        d = task.dst
        res = pb.Result()
        if _gone():
            return pb.Result(error="cancelled: client departed")
        g = granule_from_pb(task.granule)
        dst_gt = GeoTransform.from_gdal(list(d.geo_transform))
        if g.geo_loc:
            # a curvilinear granule has no affine window to decode: it
            # warps from this process's scene cache through the
            # geolocation control grid, read here rather than in the
            # pool, since the scene must land on this process's card
            c0 = _compile_probe()
            with obs_span("worker.dispatch", curvilinear=True,
                          shape=[d.height, d.width]) as wsp:
                sc = self.executor.warp_mosaic_scenes(
                    [g], [0], [1.0], dst_gt, parse_crs(d.srs), d.height,
                    d.width, 1, d.resample or "near")
            _device_attrs(wsp, c0)
            if sc is None:
                # a blank remote tile must not look like absent data
                log.warning("curvilinear granule %s uncacheable; "
                            "warp RPC returns empty trace=%s", g.path,
                            current_trace_id() or "-")
                return res
            canv, vals = sc
            a, v = self._readback(canv[0], vals[0])
            pack_raster(res, a, v)
            b = dst_gt.bbox(d.width, d.height)
            res.bbox.extend([b.xmin, b.ymin, b.xmax, b.ymax])
            res.dtype = "Float32"
            res.metrics.bytes_read = int(a.nbytes)
            return res
        decode = pb.Task()
        decode.CopyFrom(task)
        decode.operation = "decode"
        with obs_span("worker.decode") as dsp:
            dres = self.pool.submit(decode)
            dsp.set(bytes_read=int(dres.metrics.bytes_read))
        if dres.error:
            return dres
        if _gone():
            # decoded bytes for a departed client: stop before the
            # device dispatch, the costliest remaining step
            return pb.Result(error="cancelled: client departed")
        win = unpack_raster(dres)
        if win is None:  # the granule does not touch the tile
            return res
        data, valid = win
        dev = self.device
        wdw = DecodedWindow(
            granule=g, data=torch.from_numpy(data).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            window_gt=GeoTransform.from_gdal(list(dres.window_gt)),
            src_crs=parse_crs(dres.src_srs))
        c0 = _compile_probe()
        with obs_span("worker.dispatch",
                      shape=[d.height, d.width]) as wsp:
            out = self.executor.warp_all([wdw], dst_gt, parse_crs(d.srs),
                                         d.height, d.width,
                                         d.resample or "near")[0]
        _device_attrs(wsp, c0)
        if out is None:
            return res
        a, v = self._readback(out[0], out[1])
        pack_raster(res, a, v)
        b = dst_gt.bbox(d.width, d.height)
        res.bbox.extend([b.xmin, b.ymin, b.xmax, b.ymax])
        res.dtype = "Float32"
        res.metrics.CopyFrom(dres.metrics)
        return res

    @staticmethod
    def _readback(data, valid):
        """The warped plane and its validity on the host, the float pull
        under the device guard."""
        with obs_span("worker.readback") as rb:
            a = device_guard.guarded_readback(
                "worker.readback", lambda: data.cpu().numpy())
            v = valid.cpu().numpy()
            rb.set(bytes=int(a.nbytes + v.nbytes))
        return a, v

    def _drill(self, task: pb.Task) -> pb.Result:
        from ..geo import geometry as geom
        from ..index.client import Dataset
        from ..pipeline.drill import drill_file
        from ..pipeline.types import GeoDrillRequest

        g = task.granule
        sp = task.drill
        ds = Dataset(
            file_path=g.path, ds_name=g.ds_name, namespace=g.namespace,
            array_type=g.array_type or "Float32", srs=g.srs,
            geo_transform=list(g.geo_transform),
            timestamps=[], timestamps_iso=[], polygon="",
            nodata=g.nodata if g.has_nodata else 0.0)
        req = GeoDrillRequest(
            collection="", bands=[g.namespace or "b1"],
            geometry_wkt=sp.geometry_wkt,
            band_strides=max(int(sp.stride), 1),
            deciles=9 if sp.deciles else 0,
            pixel_count=sp.pixel_count,
            clip_lower=sp.clip_lower if sp.has_clip else -3.0e38,
            clip_upper=sp.clip_upper if sp.has_clip else 3.0e38)
        sel = list(sp.time_indices) or [0]
        # sp.vrt_xml arrives rendered (the client renders per granule,
        # `drill_indexer.go:340`); drill through the VRT when present
        out = drill_file(ds, sel, geom.from_wkt(sp.geometry_wkt), req,
                         vrt_xml=sp.vrt_xml or None, device=self.device)
        res = pb.Result()
        if out is None:
            return res
        vals, counts, dec = out
        res.series.means.extend(float(v) if math.isfinite(v) else 0.0
                                for v in np.asarray(vals).ravel())
        res.series.counts.extend(int(c) for c in np.asarray(counts).ravel())
        res.series.deciles.extend(float(v) for v in np.asarray(dec).ravel())
        return res

    def close(self):
        self.pool.close()


class RpcServer:
    """A bound gRPC server over a service's ``process``: `start`, the
    bound `port`, and `stop`."""

    def __init__(self, server: grpc.Server, port: int):
        self._server = server
        self.port = port

    def start(self) -> "RpcServer":
        self._server.start()
        return self

    def stop(self, grace: Optional[float] = 5.0) -> bool:
        """Refuse new RPCs, give those in flight ``grace`` seconds (None:
        cancel them now), then close, waiting for the close.  False when
        it took over the grace and 5 s more."""
        return self._server.stop(grace).wait((grace or 0.0) + 5.0)


def make_server(service, address: str = "0.0.0.0:11429",
                max_msg: int = 64 << 20) -> RpcServer:
    """The reference's ``make_grpc_server``: ``service.process`` behind
    a generic handler of ``gskyrpc.GDAL/Process``, `HANDLER_SLOTS` RPCs
    at once, messages capped at ``max_msg`` both ways, ``so_reuseport``
    on.  Bound, not started; port 0 binds a free port (`RpcServer.
    port`).  Raises when the address cannot be bound."""
    handler = grpc.method_handlers_generic_handler(SERVICE, {
        "Process": grpc.unary_unary_rpc_method_handler(
            lambda req, ctx: service.process(req, ctx),
            request_deserializer=pb.Task.FromString,
            response_serializer=pb.Result.SerializeToString),
    })
    server = grpc.server(
        cf.ThreadPoolExecutor(max_workers=HANDLER_SLOTS,
                              thread_name_prefix="gsky-worker-rpc"),
        options=[("grpc.max_receive_message_length", max_msg),
                 ("grpc.max_send_message_length", max_msg),
                 ("grpc.so_reuseport", 1)])
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port(address)
    if not port:
        raise RuntimeError(f"gRPC server: cannot bind {address}")
    return RpcServer(server, port)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gsky-rpc-torch")
    ap.add_argument("-p", "--port", type=int, default=11429)
    ap.add_argument("-host", default="0.0.0.0",
                    help="listen address (a v6 one in brackets: [::])")
    ap.add_argument("-n", "--pool", type=int, default=0,
                    help="decode pool size (default: cpu count)")
    ap.add_argument("-device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("-max_tasks", type=int, default=20000)
    ap.add_argument("-timeout", type=float, default=120.0)
    ap.add_argument("-oom_threshold", type=int, default=1536,
                    help="MemAvailable floor in MiB (0 disables)")
    a = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = resolve_device(a.device)       # raises without CUDA
    pool = ProcessPool(size=a.pool or None, max_tasks=a.max_tasks,
                       task_timeout=a.timeout)
    svc = WorkerService(pool=pool, device=device)
    # the kernels built and loaded, the page pool allocated, before the
    # listen socket opens (GSKY_PREWARM=0 skips)
    from ..server.prewarm import prewarm, prewarm_enabled
    if prewarm_enabled():
        warm = prewarm({}, svc.executor)
        log.info("prewarm: %d fresh compile(s) in %ss", warm["compiles"],
                 warm["seconds"])
    # the decode children up before the listen socket opens: a node
    # that answered while they still imported torch was re-admitted by
    # its router and queued its first tiles for seconds, which were
    # hedged away (a revived node's keys; the reference listens at
    # once).  A child that cannot start is the crash-loop breaker's
    if not pool.wait_ready(POOL_READY_S):
        log.warning("decode pool: %d of %d children ready",
                    pool.ready_count(), pool.size)
    monitor = None
    if a.oom_threshold:
        def _oom_killed(pid: int) -> None:
            # a defensive kill is a host-memory OOM incident: count it
            # on the supervisor and escalate the node's pressure
            from ..resilience.pressure import default_monitor
            device_guard.default_supervisor().record_oom(
                "worker.oom", RuntimeError(f"killed decode pid {pid}"))
            default_monitor().escalate()

        monitor = OOMMonitor(svc.pool.child_pids,
                             threshold_bytes=a.oom_threshold << 20,
                             on_kill=_oom_killed)
        monitor.start()
    server = make_server(svc, f"{a.host}:{a.port}")
    if not os.environ.get("GSKY_POOL_JOURNAL"):
        # a journal of this node's own: nodes on one host sharing the
        # default file would ship each other's pages on a hand-off
        journal.set_default_dir(os.path.join(
            tempfile.gettempdir(), f"gsky-worker-{server.port}"))
    if not svc.advertise_addr:
        # how peers reach this node for page_fetch and the hand-off; a
        # wildcard listen address advertises loopback (one host)
        host = "127.0.0.1" if a.host in ("[::]", "0.0.0.0") else a.host
        svc.advertise_addr = f"{host}:{server.port}"
    from .. import fabric
    if fabric.fabric_enabled() and fabric.page_peer_addrs():
        # the fabric's warm boot, in the background (the node serves and
        # stages cold meanwhile); not ready before it has ended
        svc.warming = True

        def _warm_boot():
            try:
                n = svc.warm_boot(fabric.page_peer_addrs())
                log.info("fabric: warm boot restored %d pages", n)
            except Exception:
                log.exception("fabric: warm boot failed")

        threading.Thread(target=_warm_boot, daemon=True,
                         name="gsky-fabric-warm").start()
    server.start()
    log.info("gsky-rpc-torch listening on %s:%d (pool=%d, %s)",
             a.host, server.port, svc.pool.size, device)
    print(f"gsky-rpc-torch listening on {a.host}:{server.port}",
          flush=True)

    # graceful drain: SIGTERM/SIGINT closes the accept gate (new ops
    # answer "draining:", worker_info keeps answering with the draining
    # flag so the fleet deregisters this node), in-flight ops run to
    # completion, then the server exits.  GSKY_DRAIN_TIMEOUT_S bounds
    # the wait; the stragglers are then counted as abandoned.
    stop = threading.Event()
    # a preemption (the preempt RPC, a node:preempt fault) exits through
    # the same park loop as a signal's drain; one with no grace takes
    # the process as the reclaim would
    svc.preempt_exit = stop.set
    svc.preempt_exit_hard = lambda: os._exit(1)

    def _drain():
        svc.drain.start_drain()
        timeout = float(os.environ.get("GSKY_DRAIN_TIMEOUT_S", "30") or 30)
        ok = svc.drain.wait_drained(timeout)
        if not ok:
            n = svc.drain.abandon_inflight()
            log.warning("drain timed out with %d in flight; "
                        "failing them over", n)
            svc._flush_pool_journal()
        st = svc.drain.stats()
        log.info("drain %s: completed=%d refused=%d inflight=%d "
                 "abandoned=%d",
                 "complete" if ok else "TIMED OUT",
                 st["completed"], st["refused"], st["inflight"],
                 st["abandoned"])
        stop.set()

    def _on_term(signum, frame):
        log.info("signal %d: draining worker node", signum)
        threading.Thread(target=_drain, daemon=True,
                         name="gsky-drain").start()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    try:
        # park until a signal's drain completes; the server keeps
        # serving from its own threads meanwhile
        while not stop.wait(0.5):
            pass
    finally:
        # the last answers are written before the listener goes
        server.stop(grace=5.0)
        if monitor:
            monitor.stop()
        svc.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
