"""The worker node: the RPC front door + the device executor + the
decode pool.

Counterpart of `gsky_tpu/worker/server.py`, in the role of GSKY's
`grpc-server/main.go` (binary ``gsky-rpc``): one unary method,
``Process(Task) returns (Result)``, over the port's HTTP/1.1 carrier
(`transport`), with the operations

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
- ``extent`` / ``info`` — pure IO, delegated to the pool.

``preempt``, ``journal_handoff`` and ``page_fetch`` (the elastic fleet
and the cache fabric) answer ``Result(error=...)`` naming ROADMAP A.20,
which brings them.

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
most ``GSKY_DRAIN_TIMEOUT_S``, 30), then the process exits 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import signal
import threading

import numpy as np
import torch

from .. import device_guard
from ..device import resolve_device
from ..device_guard import DeviceGuardError
from ..fleet import DrainController, Draining
from ..obs import current_trace_id, remote_trace, span as obs_span
from ..resilience import faults
from . import gskyrpc as pb
from .oom import OOMMonitor
from .pool import PoolFullError, ProcessPool
from .serialize import granule_from_pb, pack_raster, unpack_raster
from .transport import make_server

log = logging.getLogger("gsky.worker.server")

# the elastic fleet's and the cache fabric's ops, not ported yet
_NOT_PORTED = ("preempt", "journal_handoff", "page_fetch")


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


def kernel_launches() -> dict:
    """This process's launch count of each kernel wrapper."""
    from ..ops import first_valid, stats, warp_render
    out = {}
    for k in (warp_render.paged_render_kernel,
              warp_render.warp_render_kernel,
              stats.masked_stats_kernel, stats.masked_stats_many_kernel,
              first_valid.first_valid_kernel):
        out[k.symbol] = k.launches
    return out


class WorkerService:
    """Op dispatch shared by the RPC server and in-process callers.
    ``device`` ("cuda" by default) is where the executor renders;
    without CUDA it must be "cpu"."""

    def __init__(self, pool: ProcessPool, device="cuda"):
        self.device = resolve_device(device)
        self.pool = pool
        self.drain = DrainController("worker-node")
        from ..pipeline.executor import WarpExecutor
        self.executor = WarpExecutor(device=self.device)

    # -- ops -----------------------------------------------------------------

    def process(self, task: pb.Task, ctx=None) -> pb.Result:
        """``ctx`` is the transport's `CallContext` (None from
        in-process callers): its ``traceparent`` continues the
        gateway's trace here, and the child spans ride back on
        ``info_json`` for ops that leave that channel free."""
        op = task.operation
        header = getattr(ctx, "traceparent", None) if ctx is not None \
            else None
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
            if op == "worker_info":
                return self._worker_info()
            if op in _NOT_PORTED:
                return pb.Result(error=f"{op} is not ported yet "
                                       f"(ROADMAP A.20)")
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
        r.info_json = json.dumps(info)
        return r

    def _warp(self, task: pb.Task, ctx=None) -> pb.Result:
        from ..geo.crs import parse_crs
        from ..geo.transform import GeoTransform
        from ..pipeline.decode import DecodedWindow

        # the gateway's cancel token reaches here as a closed
        # connection; poll it at the expensive boundaries and stop
        # decoding and warping for an answer nobody will read
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
    server = make_server(svc, f"{a.host}:{a.port}").start()
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

    def _drain():
        svc.drain.start_drain()
        timeout = float(os.environ.get("GSKY_DRAIN_TIMEOUT_S", "30") or 30)
        ok = svc.drain.wait_drained(timeout)
        if not ok:
            n = svc.drain.abandon_inflight()
            log.warning("drain timed out with %d in flight; "
                        "failing them over", n)
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
