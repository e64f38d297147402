"""Client-side fleet dispatch to worker nodes.

Counterpart of `gsky_tpu/worker/client.py` (one gRPC channel per node,
`dial`), in the role of GSKY's `processor/tile_grpc.go` — a connection
pool over ``worker_nodes`` with per-granule warp RPCs, a concurrency
limiter of ``GrpcConcLimit x nodes`` (`tile_grpc.go:222`) and
worker-metrics accumulation — upgraded from static round-robin to fleet
routing:

- tasks carrying a route key ride the consistent-hash ring, so repeat
  requests for one tile land on the shard whose scene cache, page pool
  and built kernels are already warm for it;
- node health (phi-accrual over heartbeats fed from real RPC traffic
  plus active ``worker_info`` probes) gates the candidate order, and a
  breaker trip reports the node dead immediately;
- stragglers are hedged onto the next ring node past an adaptive p99
  delay, inside a token-bucket hedge budget;
- nodes answering ``backpressure:`` / ``draining:`` / ``device:`` are
  failed over without breaker penalty (they are alive), and an all-busy
  fleet surfaces as the *retryable* :class:`NodeBusy` so the retry
  policy's jittered backoff applies instead of an instant hard failure.

A fleet whose every node failed is `BackendUnavailable` (a 503 at the
OWS layer): the client never renders locally.  ``page_fetch`` asks a
node for content-keyed pages (the cache fabric, `fabric.pagerpc`).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextvars
import itertools
import json
import logging
import random
import threading
import time
from typing import List, Optional, Sequence, Tuple

import grpc
import numpy as np

from ..fleet import DRAINING, FleetRouter, hedged_call, tile_route_key
from ..geo.crs import CRS
from ..geo.transform import GeoTransform
from ..obs import (adopt_spans, current_trace_id, event as obs_event,
                   span as obs_span, trace_metadata)
from ..obs.metrics import RPC_SECONDS, TRACE_EVENTS
from ..pipeline.types import GeoTileRequest, Granule
from ..resilience import (BackendUnavailable, BreakerOpen, RetryPolicy,
                          call_with_retry, clamp_timeout, faults,
                          get_breaker, registry)
from . import gskyrpc as pb
from .serialize import granule_to_pb, unpack_raster
from .server import METHOD

log = logging.getLogger("gsky.worker.client")

# RPCs in flight per node, the reference's default ``conc_per_node``
CONC_PER_NODE = 16
# an RPC's timeout in seconds, cut to what is left of the request's
# deadline (`clamp_timeout`)
RPC_TIMEOUT_S = 130.0

# a node that dies and revives is re-dialled within a couple of the
# health monitor's beats, not after gRPC's default reconnect backoff
# (which grows to 2 minutes)
RECONNECT_BACKOFF_MS = 3000

# ops whose Result.info_json is free for the span-backhaul envelope
# ("info" / "worker_info" already carry their payloads there)
_SPAN_OPS = ("warp", "drill", "extent")


def _note(kind: str, **attrs) -> None:
    """Cross-cutting trace event + prom counter; never raises."""
    try:
        TRACE_EVENTS.labels(kind=kind).inc()
        obs_event(kind, **attrs)
    except Exception:  # telemetry must never fail the RPC path
        pass


def _rpc_observe(op: str, outcome: str, dur_s: float) -> None:
    try:
        RPC_SECONDS.labels(op=op, outcome=outcome).observe(dur_s)
    except Exception:  # telemetry must never fail the RPC path
        pass


def dial(address: str, max_msg: int = 64 << 20):
    """A gRPC channel to one worker node with the reference's options
    (receive and send capped at ``max_msg``) and its ``Process`` method:
    ``(channel, call)``; ``call(task, timeout=, metadata=)`` and
    ``call.future(...)`` answer a `gskyrpc.Result`."""
    ch = grpc.insecure_channel(address, options=[
        ("grpc.max_receive_message_length", max_msg),
        ("grpc.max_send_message_length", max_msg),
        ("grpc.max_reconnect_backoff_ms", RECONNECT_BACKOFF_MS)])
    return ch, ch.unary_unary(
        METHOD, request_serializer=pb.Task.SerializeToString,
        response_deserializer=pb.Result.FromString)


class NodeBusy(BackendUnavailable):
    """Every candidate node answered "queue full": the fleet is alive
    but saturated.  Retryable — the queues drain at pool speed, so a
    jittered backoff usually lands — unlike its parent, which means the
    fleet could not answer at all."""

    retryable = True

    def __init__(self, message: str, site: str = "worker"):
        super().__init__(message, site=site, retry_after=1.0)


class ConcLimiter:
    """Semaphore-style fan-out limiter (`processor/conc_limiter.go`)."""

    def __init__(self, n: int):
        self._sem = threading.Semaphore(max(n, 1))

    def __enter__(self):
        self._sem.acquire()
        return self

    def __exit__(self, *exc):
        self._sem.release()
        return False

    def try_acquire(self) -> bool:
        """Non-blocking acquire — hedges take a *spare* permit or none:
        a hedge must never queue behind primaries for a slot."""
        return self._sem.acquire(blocking=False)

    def release(self) -> None:
        self._sem.release()


class WorkerClient:
    """Fleet-routed RPC client over a worker node set."""

    def __init__(self, nodes: Sequence[str], max_msg: int = 64 << 20):
        if not nodes:
            raise ValueError("no worker nodes")
        nodes = list(nodes)
        random.shuffle(nodes)          # `tile_grpc.go:99-104`
        dialled = [dial(n, max_msg) for n in nodes]
        self._channels = [ch for ch, _ in dialled]
        self._stubs = [call for _, call in dialled]
        self._rr = itertools.count()
        # one breaker per node, shared process-wide by address so a
        # rebuilt client (SIGHUP reload) keeps the node's health history
        self._breakers = [get_breaker(f"worker:{n}") for n in nodes]
        self.limiter = ConcLimiter(CONC_PER_NODE * len(nodes))
        self.nodes = nodes
        self._index = {n: i for i, n in enumerate(nodes)}
        self._max_msg = max_msg
        self._closed = False
        self._close_lock = threading.Lock()
        # guards membership swaps (elastic scale/replace); dispatch
        # reads one consistent snapshot instead of holding it
        self._membership_lock = threading.Lock()
        self._listened: set = set()
        # jittered backoff for an all-nodes-busy fleet (NodeBusy): the
        # work queues drain in tens of ms, so short delays suffice
        self._busy_policy = RetryPolicy(max_attempts=3, base_delay=0.05,
                                        max_delay=0.5)
        # fleet routing state: ring + health + hedge over this node set
        self.fleet = FleetRouter(nodes, name="worker", probe=self._probe)
        for i, br in enumerate(self._breakers):
            br.add_listener(self._make_breaker_listener(nodes[i]))
            self._listened.add(nodes[i])
        if len(nodes) > 1 and self.fleet.monitor.interval_s > 0:
            self.fleet.monitor.start()
        # persistent fan-out pool: sized to the RPC concurrency cap so
        # per-request thread churn stays off the GetMap hot path
        self._fanout = cf.ThreadPoolExecutor(
            max_workers=CONC_PER_NODE * len(nodes),
            thread_name_prefix="gsky-warp-rpc")

    # -- fleet plumbing ------------------------------------------------------

    def _snapshot(self):
        """One consistent (nodes, stubs, breakers, index) view: the
        lists are rebuilt wholesale on membership change, never mutated
        in place, so a snapshot taken here stays internally aligned for
        the whole dispatch even while the elastic fleet rewires."""
        with self._membership_lock:
            return self.nodes, self._stubs, self._breakers, self._index

    def set_nodes(self, addrs: Sequence[str]) -> None:
        """Rewire membership live (fleet scale-up/down/replace): open
        channels for new nodes, retire departed ones, and reconcile the
        ring + health monitor — purging the departed nodes' router
        state so churn cannot grow unbounded maps.  In-flight RPCs on a
        retired channel surface as transport failures and fail over
        like any node death."""
        addrs = list(dict.fromkeys(addrs))
        if not addrs:
            raise ValueError("no worker nodes")
        added: List[str] = []
        removed: List = []
        with self._membership_lock:
            if self._closed or set(addrs) == set(self.nodes):
                return
            keep = set(addrs)
            old_index = self._index
            nodes: List[str] = []
            channels, stubs, breakers = [], [], []
            for n in addrs:
                i = old_index.get(n)
                if i is not None:
                    channels.append(self._channels[i])
                    stubs.append(self._stubs[i])
                    breakers.append(self._breakers[i])
                else:
                    ch, stub = dial(n, self._max_msg)
                    channels.append(ch)
                    stubs.append(stub)
                    breakers.append(get_breaker(f"worker:{n}"))
                    added.append(n)
                nodes.append(n)
            removed = [(n, self._channels[i])
                       for n, i in old_index.items() if n not in keep]
            self.nodes = nodes
            self._channels = channels
            self._stubs = stubs
            self._breakers = breakers
            self._index = {n: i for i, n in enumerate(nodes)}
            for n in added:
                # breakers are shared process-wide by address: only the
                # first membership of a node hooks this client's listener
                if n not in self._listened:
                    self._listened.add(n)
                    breakers[self._index[n]].add_listener(
                        self._make_breaker_listener(n))
        self.fleet.set_nodes(addrs)
        for _, ch in removed:
            try:
                ch.close()
            except Exception:  # channel already closed
                pass
        if len(addrs) > 1 and self.fleet.monitor.interval_s > 0:
            self.fleet.monitor.start()   # idempotent
        log.info("fleet membership: %d node(s) (+%d/-%d), generation %d",
                 len(addrs), len(added), len(removed),
                 self.fleet.ring.generation)

    def _make_breaker_listener(self, node: str):
        def on_change(br, old, new):
            # an OPEN breaker is an immediate dead-node report for the
            # router; a close (successful probe) is a heartbeat
            if new == br.OPEN:
                self.fleet.monitor.record_failure(node, fatal=True)
            elif new == br.CLOSED and old != br.CLOSED:
                self.fleet.monitor.record_heartbeat(node)
        return on_change

    def _probe(self, node: str):
        """Active health probe: one worker_info RPC.  Returns the
        DRAINING sentinel when the node answered only to say goodbye —
        or when its device supervisor reports suspect/reinitializing
        (alive, rebuilding: keep the beat history warm, route nothing
        new at it until a later probe sees it healthy).  A dead device
        or a tripped crash-loop breaker is an explicit fatal report."""
        if self._closed:
            return False
        _, stubs, _, index = self._snapshot()
        i = index.get(node)
        if i is None:
            return False     # departed between probe list and now
        try:
            res = stubs[i](pb.Task(operation="worker_info"),
                           timeout=5.0)
        except Exception:
            return False
        info = self._info(res)
        dev = info.get("device") or {}
        crash = (info.get("pool") or {}).get("crash_loop") or {}
        if dev.get("state") == "dead" or crash.get("tripped"):
            self.fleet.monitor.record_failure(node, fatal=True)
            return False
        if info.get("draining"):
            return DRAINING
        if dev.get("state") in ("suspect", "reinitializing"):
            return DRAINING
        return True

    @staticmethod
    def _info(res: pb.Result) -> dict:
        """The worker's free-form info_json envelope (drain handshake +
        device supervisor + pool crash-loop state), or {}."""
        if not res.info_json:
            return {}
        try:
            doc = json.loads(res.info_json)
        except (ValueError, AttributeError):
            return {}
        return doc if isinstance(doc, dict) else {}

    @classmethod
    def _draining(cls, res: pb.Result) -> bool:
        return bool(cls._info(res).get("draining"))

    @staticmethod
    def _is_fatal(e: Exception) -> bool:
        """Does this transport error mean the *node* is gone (connection
        refused / unreachable), not just this call?"""
        if isinstance(e, faults.InjectedFault):
            return False
        if isinstance(e, grpc.RpcError):
            return e.code() == grpc.StatusCode.UNAVAILABLE
        return isinstance(e, (ConnectionError, OSError))

    def autosize(self) -> int:
        """Size the RPC concurrency cap from the workers' actual pool
        sizes (`getGrpcPoolSize`, `utils/config.go:1124-1187`): the
        fan-out limit becomes sum(pool_size) across nodes.  Returns the
        new cap; keeps the configured default when the query fails."""
        try:
            total = sum(i.pool_size for i in self.worker_info()
                        if i.pool_size > 0)
        except Exception:
            return self.limiter._sem._value if hasattr(
                self.limiter, "_sem") else 0
        if total > 0:
            self.limiter = ConcLimiter(total)
            self._fanout.shutdown(wait=False)
            self._fanout = cf.ThreadPoolExecutor(
                max_workers=total, thread_name_prefix="gsky-warp-rpc")
        return total

    # -- dispatch ------------------------------------------------------------

    def process(self, task: pb.Task,
                route_key: Optional[str] = None) -> pb.Result:
        """Dispatch with fleet routing, health tracking and failover.

        With a ``route_key``, candidates come from the hash ring
        (healthy-first, bounded-load, deterministic spill order) and the
        first attempt may hedge onto the second candidate; without one,
        the legacy round-robin order applies.  On transport failure the
        node's breaker and health record it and the task fails over to
        the next candidate — ejecting a sick node costs one failed RPC,
        not a request.  Nodes answering ``backpressure:`` / ``draining:``
        are alive: they fail over without breaker penalty.  Exhaustion
        surfaces as :class:`NodeBusy` (every node busy — retryable),
        :class:`BreakerOpen` (every node circuit-open) or
        :class:`BackendUnavailable`.
        """
        if self._closed:
            raise BackendUnavailable("worker client is closed",
                                     site="worker")
        with self.limiter:
            return self._dispatch(task, route_key)

    def _dispatch(self, task: pb.Task, route_key: Optional[str]) -> pb.Result:
        nodes_l, stubs, breakers, index = self._snapshot()
        n = len(stubs)
        keyed = (route_key is not None and self.fleet.enabled and n > 1)
        if keyed:
            order = [index[m]
                     for m in self.fleet.candidates(route_key)
                     if m in index]
        else:
            start = next(self._rr)
            order = [(start + k) % n for k in range(n)]
        timeout = clamp_timeout(RPC_TIMEOUT_S)
        # one metadata tuple per dispatch: the trace context crosses the
        # process boundary as gRPC metadata (x-gsky-trace: "tid-sid")
        md = trace_metadata()
        op = task.operation
        busy = 0
        last: Optional[Exception] = None
        last_busy = ""
        from ..resilience import current_token
        tok = current_token()
        for pos, i in enumerate(order):
            if tok is not None:
                # a cancelled request must not start (or fail over to)
                # another RPC attempt
                tok.check("rpc")
            br = breakers[i]
            if not br.allow():
                continue
            node = nodes_l[i]
            started = node        # in-flight load is per dispatch target
            self.fleet.task_started(started)
            # the clock starts before the fault site, so that an injected
            # failure of the first attempt is timed like any other
            t0 = time.monotonic()
            try:
                faults.inject("worker")
                with obs_span("rpc.worker", node=node, op=op,
                              attempt=pos) as rsp:
                    if (pos == 0 and keyed and self.fleet.hedge_enabled
                            and len(order) > 1):
                        res, hedge_won = self._call_hedged(
                            task, i, order[1], timeout, md,
                            nodes_l, stubs, breakers)
                        if hedge_won:
                            i = order[1]
                            br = breakers[i]
                            node = nodes_l[i]
                            rsp.set(node=node, hedge_won=True)
                            _note("hedge_won", node=node)
                    else:
                        res = self._call_cancellable(stubs[i], task,
                                                     timeout, md, tok)
                dt = time.monotonic() - t0
            except Exception as e:
                br.record_failure()
                self.fleet.node_result(node, ok=False,
                                       fatal=self._is_fatal(e))
                _rpc_observe(op, "transport", time.monotonic() - t0)
                last = e
                if pos + 1 < len(order):
                    registry.count_retry("worker")
                    if keyed:
                        self.fleet.record_reroute()
                        _note("reroute", node=node, reason="failure")
                continue
            finally:
                self.fleet.task_finished(started)
            err = res.error or ""
            if err.startswith("backpressure:"):
                # alive, just saturated: no breaker penalty, fail over
                br.record_success()
                self.fleet.node_result(node, ok=True)
                _rpc_observe(op, "busy", dt)
                rsp.set(outcome="busy")
                busy += 1
                last_busy = err
                if keyed:
                    self.fleet.record_reroute()
                    _note("reroute", node=node, reason="busy")
                continue
            if err.startswith("draining:"):
                # alive, leaving: deregister from routing, fail over
                br.record_success()
                self.fleet.node_result(node, ok=True, draining=True)
                _rpc_observe(op, "draining", dt)
                rsp.set(outcome="draining")
                if keyed:
                    self.fleet.record_reroute()
                    _note("reroute", node=node, reason="draining")
                continue
            if err.startswith("device:"):
                # alive, but its device is mid-incident (hang/crash/OOM/
                # corruption — the supervisor is rebuilding it): no
                # breaker penalty, route around it like a draining node;
                # the next healthy worker_info probe restores it
                br.record_success()
                self.fleet.node_result(node, ok=True, draining=True)
                _rpc_observe(op, "device", dt)
                rsp.set(outcome="device")
                if pos + 1 < len(order):
                    registry.count_retry("worker")
                if keyed:
                    self.fleet.record_reroute()
                    _note("reroute", node=node, reason="device")
                last = RuntimeError(err)
                continue
            # a real answer (success or semantic error): the node lives
            br.record_success()
            self.fleet.node_result(node, ok=True, latency_s=dt)
            outcome = "error" if err else "ok"
            _rpc_observe(op, outcome, dt)
            rsp.set(outcome=outcome)
            if keyed:
                self.fleet.record_locality(route_key, node)
            else:
                self.fleet.record_rr()
            if md is not None and op in _SPAN_OPS and res.info_json:
                # the worker's child spans ride back on the free-form
                # info_json channel; stitch them into the live trace
                try:
                    env = json.loads(res.info_json)
                    if isinstance(env, dict):
                        adopt_spans(env.get("spans"))
                except ValueError:
                    pass
            return res
        if busy:
            raise NodeBusy(
                f"all worker nodes at capacity ({last_busy or 'busy'})")
        if last is None:
            raise BreakerOpen("all worker nodes circuit-open",
                              site="worker")
        registry.count_exhausted("worker")
        raise BackendUnavailable(
            f"all {n} worker node(s) failed (last: {last})",
            site="worker") from last

    def _call_cancellable(self, stub, task: pb.Task, timeout: float,
                          md, tok) -> pb.Result:
        """One RPC that honours the request's cancel token end-to-end:
        the token fires ``fut.cancel()``, gRPC propagates the abort to
        the server (whose handler polls ``ctx.is_active()`` and stops
        decoding/warping for the dead client), and the caller unwinds
        as :class:`RequestCancelled` — a BaseException, so the
        breaker records neither success nor failure for work WE
        abandoned."""
        if tok is None:
            return stub(task, timeout=timeout, metadata=md)
        fut = stub.future(task, timeout=timeout, metadata=md)
        unhook = tok.on_cancel(lambda: fut.cancel())
        try:
            return fut.result()
        except grpc.FutureCancelledError:
            tok.check("rpc")    # raises RequestCancelled when fired
            raise               # cancelled by someone else: propagate
        finally:
            unhook()

    def _call_hedged(self, task: pb.Task, i: int, j: int,
                     timeout: float, md=None,
                     nodes_l=None, stubs=None, breakers=None
                     ) -> Tuple[pb.Result, bool]:
        """First-candidate dispatch with a straggler hedge onto node
        ``j``.  The hedge consumes a *spare* limiter permit (or does not
        fire), spends one hedge-budget token, and whichever copy loses
        is cancelled — its permit freed immediately."""
        if stubs is None:
            nodes_l, stubs, breakers, _ = self._snapshot()
        fl = self.fleet
        permit = [False]

        def primary():
            fl.hedge.on_primary()
            return stubs[i].future(task, timeout=timeout, metadata=md)

        def hedge():
            # raising here just means "no hedge" to hedged_call
            if self._closed:
                raise RuntimeError("client closed")
            if not breakers[j].allow():
                raise RuntimeError("hedge target circuit-open")
            if not fl.hedge.try_hedge():
                raise RuntimeError("hedge budget exhausted")
            if not self.limiter.try_acquire():
                raise RuntimeError("no spare permit for hedge")
            permit[0] = True
            _note("hedge", node=nodes_l[j])
            try:
                return stubs[j].future(task, timeout=timeout,
                                       metadata=md)
            except Exception:
                permit[0] = False
                self.limiter.release()
                raise

        def on_hedge_cancelled():
            if permit[0]:
                permit[0] = False
                self.limiter.release()

        try:
            res, hedge_won = hedged_call(
                primary, hedge, fl.hedge.delay_s(), timeout,
                on_hedge_cancelled=on_hedge_cancelled)
            if hedge_won:
                fl.hedge.record_win()
            return res, hedge_won
        finally:
            # hedge won (or both settled without a fut2 cancel): the
            # extra permit still held covers a future that has finished
            if permit[0]:
                permit[0] = False
                self.limiter.release()

    # -- high-level ops ------------------------------------------------------

    def worker_info(self, timeout: float = 10.0) -> List[pb.WorkerInfo]:
        """Pool info from every reachable node (`getGrpcPoolSize`,
        `utils/config.go:1124-1187`).  Nodes are queried concurrently
        and unreachable ones are logged + flagged on their breaker and
        skipped — a dead node costs one timeout in parallel with the
        live queries, not a serial 10s stall each at startup.  Every
        answer doubles as a fleet heartbeat (and drain handshake)."""
        def one(arg):
            node, stub, br = arg
            try:
                r = stub(pb.Task(operation="worker_info"), timeout=timeout)
            except Exception as e:
                br.record_failure()
                self.fleet.node_result(node, ok=False,
                                       fatal=self._is_fatal(e))
                log.warning("worker_info: node %s unreachable: %s", node, e)
                return None
            br.record_success()
            self.fleet.node_result(node, ok=True,
                                   draining=self._draining(r))
            return r.worker
        nodes_l, stubs, breakers, _ = self._snapshot()
        infos = list(self._fanout.map(
            one, zip(nodes_l, stubs, breakers)))
        return [i for i in infos if i is not None]

    def warp(self, granule: Granule, dst_gt: GeoTransform, dst_crs: CRS,
             width: int, height: int, resample: str = "near",
             route_key: Optional[str] = None,
             ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        task = pb.Task(operation="warp")
        task.granule.CopyFrom(granule_to_pb(granule))
        task.dst.srs = dst_crs.name()
        task.dst.geo_transform.extend(dst_gt.to_gdal())
        task.dst.width = width
        task.dst.height = height
        task.dst.resample = resample
        # NodeBusy (all queues full) gets jittered backoff — the fleet
        # is alive, its queues drain in tens of ms; everything else
        # (semantic errors, dead fleet) re-raises unchanged
        res = call_with_retry(
            lambda: self.process(task, route_key=route_key),
            self._busy_policy, site="worker-busy",
            retryable=lambda e: isinstance(e, NodeBusy))
        if res.error:
            raise RuntimeError(res.error)
        return unpack_raster(res)

    def _sub_tile_grid(self, req: GeoTileRequest) -> Tuple[int, int]:
        """Dst sub-tile bounds for the RPC fan-out
        (`tile_grpc.go:143-198`).  Config values <= 1.0 are fractions of
        the dst size, > 1 absolute pixels, 0 off — but a response whose
        raster would break the channel's ``max_msg`` cap is ALWAYS
        sharded (GSKY relies on operators setting GrpcTileXSize; here a
        4096^2 WCS tile must not 64 MB-bomb the channel by default)."""
        def bound(cfg: float, full: int) -> int:
            if cfg <= 0.0:
                m = full
            elif cfg <= 1.0:
                m = int(full * cfg)
            else:
                m = int(cfg)
            return max(min(m, full), 1)

        mx = bound(req.grpc_tile_x_size, req.width)
        my = bound(req.grpc_tile_y_size, req.height)
        # auto-shard: warped response = w*h*(4B data + 1B mask) + slack.
        # The budget must stay clear of the recv cap itself (a floor
        # above 3/4*max_msg would shard to a size the channel still
        # rejects — a deterministic self-inflicted outage)
        budget = min(max(self._max_msg // 4, 1 << 20),
                     max(self._max_msg * 3 // 4, 5 * 64 * 64))
        while mx * my * 5 > budget and (mx > 64 or my > 64):
            if mx >= my:
                mx = max(mx // 2, 64)
            else:
                my = max(my // 2, 64)
        return mx, my

    def warp_many(self, granules: Sequence[Granule], req: GeoTileRequest,
                  resample: str) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
        """Concurrent per-granule warps, order-preserving; failures become
        empty granules (EmptyTile sentinel semantics).  Large dst tiles
        shard into sub-tile RPCs per granule (`tile_grpc.go:143-198`)
        and reassemble here.  Each sub-tile is
        routed by its canonical tile key, so a repeat of the same
        request re-lands every sub-tile on the shard that warped it
        before (warm scene + kernel caches), while the sub-tiles of one
        large request still spread across the ring."""
        if not granules:
            return []
        dst_gt = req.dst_gt()
        failures: List[Exception] = []
        mx, my = self._sub_tile_grid(req)

        def route_key(ox: int, oy: int, tw: int, th: int) -> str:
            b = dst_gt.window(ox, oy).bbox(tw, th)
            return tile_route_key(req.collection, req.crs.name(),
                                  (b.xmin, b.ymin, b.xmax, b.ymax),
                                  tw, th)

        # granule footprint in dst pixel space, for sub-tile pruning:
        # a granule touching one sub-tile must not cost an RPC per
        # sub-tile (`tile_grpc.go` computes granule windows per tile)
        def dst_px_bbox(g: Granule):
            if not g.polygon or (mx >= req.width and my >= req.height):
                return None
            try:
                from ..geo import geometry as geom
                from ..geo.crs import parse_crs
                from ..geo.transform import transform_bbox
                src_bbox = geom.from_wkt(g.polygon).bbox()
                dbox = transform_bbox(src_bbox, parse_crs(g.srs), req.crs)
                gt = dst_gt
                c0, r0 = gt.geo_to_pixel(dbox.xmin, dbox.ymax)
                c1, r1 = gt.geo_to_pixel(dbox.xmax, dbox.ymin)
                c0, c1 = sorted((c0, c1))
                r0, r1 = sorted((r0, r1))
                return (c0 - 2, r0 - 2, c1 + 2, r1 + 2)
            except Exception:
                return None

        jobs = []                 # (granule idx, ox, oy, tw, th)
        for i, g in enumerate(granules):
            pb_ = dst_px_bbox(g)
            touched = False
            for oy in range(0, req.height, my):
                for ox in range(0, req.width, mx):
                    tw = min(mx, req.width - ox)
                    th = min(my, req.height - oy)
                    if pb_ is not None and (
                            ox + tw < pb_[0] or ox > pb_[2]
                            or oy + th < pb_[1] or oy > pb_[3]):
                        continue
                    jobs.append((i, ox, oy, tw, th))
                    touched = True
            if not touched:
                # disjoint granule: keep one tiny probe RPC so the
                # result slot stays a real (empty) raster, not None-by-
                # accident if the footprint estimate was wrong
                jobs.append((i, 0, 0, min(mx, req.width),
                             min(my, req.height)))

        def one(job):
            i, ox, oy, tw, th = job
            try:
                return self.warp(granules[i], dst_gt.window(ox, oy),
                                 req.crs, tw, th, resample,
                                 route_key=route_key(ox, oy, tw, th))
            except Exception as e:
                failures.append(e)
                return None

        def one_bound(arg):
            # the fan-out pool's threads start from an empty Context;
            # each job gets its own copy of the caller's (a single
            # Context cannot be entered from two threads at once)
            ctx, job = arg
            return ctx.run(one, job)

        parts = list(self._fanout.map(
            one_bound,
            [(contextvars.copy_context(), j) for j in jobs]))
        # an explicit flag, NOT a job-count comparison: footprint
        # pruning can leave exactly one sub-tile per granule, and those
        # sub-rasters must still assemble into full-tile canvases
        sharded = mx < req.width or my < req.height
        if not sharded:                       # one whole-tile RPC each
            out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = parts
        else:
            out = [None] * len(granules)
            for (i, ox, oy, tw, th), part in zip(jobs, parts):
                if part is None:
                    continue
                if out[i] is None:
                    out[i] = (np.zeros((req.height, req.width),
                                       np.float32),
                              np.zeros((req.height, req.width), bool))
                d, v = part
                out[i][0][oy:oy + th, ox:ox + tw] = np.asarray(d)
                out[i][1][oy:oy + th, ox:ox + tw] = np.asarray(v)
        if failures:
            log.warning("%d/%d warp RPCs failed (first: %s) trace=%s",
                        len(failures), len(jobs), failures[0],
                        current_trace_id() or "-")
            if len(failures) < len(jobs):
                from ..resilience import mark_degraded
                mark_degraded("worker")
            # outage visibility: a dead fleet must not look like "no
            # data" — per-granule failures degrade to empty granules,
            # total failure becomes an error response upstream
            if len(failures) == len(jobs):
                if isinstance(failures[0], BackendUnavailable):
                    raise failures[0]
                raise RuntimeError(
                    f"all {len(jobs)} warp RPCs failed "
                    f"(first: {failures[0]})")
        return out

    def extent(self, granule: Granule, dst_crs: CRS) -> Tuple[int, int]:
        task = pb.Task(operation="extent")
        task.granule.CopyFrom(granule_to_pb(granule))
        task.dst.srs = dst_crs.name()
        res = self.process(task)
        if res.error:
            raise RuntimeError(res.error)
        return res.extent_width, res.extent_height

    def info(self, path: str) -> str:
        res = self.process(pb.Task(operation="info", path=path))
        if res.error:
            raise RuntimeError(res.error)
        return res.info_json

    def page_fetch(self, keys, max_bytes: Optional[int] = None,
                   route_key: Optional[str] = None) -> dict:
        """The cache fabric's batched page fetch: ``{key: (PR, PC) f32
        page}`` for the ``(serial, pi, pj)`` keys a node holds, pages
        whose CRC fails already dropped.  Routed like any op: a
        ``route_key`` lands the ask on the ring's node for it."""
        from ..fabric import pagerpc
        task = pb.Task(operation="page_fetch",
                       path=pagerpc.encode_request(keys, max_bytes))
        res = self.process(task, route_key=route_key)
        if res.error:
            raise RuntimeError(res.error)
        return pagerpc.decode_result(res.info_json, res.raster)

    def close(self):
        """Idempotent shutdown.  The closed flag flips *first*, so any
        dispatch racing the teardown is rejected up front with
        :class:`BackendUnavailable` instead of hitting a half-closed
        channel mid-RPC."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self.fleet.close()
        self._fanout.shutdown(wait=False)
        for ch in self._channels:
            try:
                ch.close()
            except Exception:  # channel already closed
                pass
