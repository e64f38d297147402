"""Elastic fleet: autoscaling preemptible workers with a warm hand-off.

Counterpart of `gsky_tpu/fleet/elastic.py`, copied (the port imports
nothing of the JAX package), its control RPCs over gRPC
(`worker.client.dial`).  Spot capacity is cheap and preemptible:
a fixed worker set either over-provisions for the Zipf peak or browns
out under it.  This module closes the loop:

- **demand**: `DemandSignal` folds the admission controller's queue
  depth and effective limits (`serving.admission`), the nodes' load in
  flight (`fleet.router`), the wave scheduler's occupancy when it runs,
  and the memory pressure state into one smoothed utilisation;
- **decision**: `Autoscaler` maps it onto scale-up and scale-down
  between its ``min_nodes`` and ``max_nodes``, with
  hysteresis (N ticks past a threshold) and a cooldown, and counts
  each decision (``gsky_elastic_decisions_total{dir}``);
- **actuation**: a `NodeProvider`; `LocalSubprocessProvider` starts
  ``python -m gsky_tpu_torch.worker.server`` processes, each with a
  page journal of its own;
- **preemption**: a ``preempt`` control RPC (or the fault
  ``node:preempt:<grace>``) starts the node's drain under a hard grace
  deadline, ships its scored page journal to its ring successor
  (``journal_handoff``), and exits.  The successor pulls the pages from
  the dying node's pool over ``page_fetch`` (`fabric.pagerpc`) instead
  of staging them cold;
- **readiness**: a launched node joins the ring only once its
  ``worker_info`` reports warm (the share of the journal's hot set
  resident in its pool), or its readiness deadline passes.  A node
  starts with a journal of its own, so with the fabric's page peers
  set its warm boot first takes a peer's hot set (``journal_export``)
  and reports not ready until its pool holds it (ROADMAP C.18).

Dormant unless ``GSKY_ELASTIC=1``: with the gate off no autoscaler
runs, no metric family renders, no ``/debug`` block appears.

Knobs, read at each call: ``GSKY_ELASTIC`` (0, the gate) and
``GSKY_ELASTIC_SELF`` (the address a launched node advertises).  The
autoscaler's tunables are its arguments, their defaults the
reference's env defaults; a notice's default grace (`PREEMPT_GRACE_S`),
the hand-off's size (`HANDOFF_MAX`) and the readiness warm fraction
(`WARM_FRAC`) are constants (ROADMAP C.18).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

from .ring import HashRing

log = logging.getLogger("gsky.fleet.elastic")


# a notice's default grace window (seconds), the journal entries a
# preempted node ships, the share of its hot set a node holds to be ready
PREEMPT_GRACE_S = 10.0
HANDOFF_MAX = 2048
WARM_FRAC = 0.5


def elastic_enabled() -> bool:
    return os.environ.get("GSKY_ELASTIC", "0") == "1"


# -- counters (module-level: the worker side has no autoscaler object) --------

_stats_lock = threading.Lock()


def _zero_stats() -> Dict:
    return {
        "decisions": {"up": 0, "down": 0},
        "preemptions": {"graceful": 0, "nograce": 0},
        "handoff_pages": {"peer": 0, "cold": 0},
        "handoffs_shipped": 0,
        "handoff_entries_shipped": 0,
        "handoff_ship_failures": 0,
        "ready_waits": 0,
        "ready_timeouts": 0,
    }


_stats: Dict = _zero_stats()


def reset_stats() -> None:
    """Test hook: zero the process-wide elastic counters."""
    global _stats
    with _stats_lock:
        _stats = _zero_stats()


def note_decision(direction: str) -> None:
    with _stats_lock:
        d = _stats["decisions"]
        d[direction] = d.get(direction, 0) + 1


def note_preemption(graceful: bool) -> None:
    with _stats_lock:
        key = "graceful" if graceful else "nograce"
        _stats["preemptions"][key] += 1


def note_handoff_pages(source: str, n: int) -> None:
    if n <= 0:
        return
    with _stats_lock:
        hp = _stats["handoff_pages"]
        hp[source] = hp.get(source, 0) + n


def note_handoff_shipped(entries: int, ok: bool) -> None:
    with _stats_lock:
        if ok:
            _stats["handoffs_shipped"] += 1
            _stats["handoff_entries_shipped"] += entries
        else:
            _stats["handoff_ship_failures"] += 1


def note_ready_wait(timed_out: bool) -> None:
    with _stats_lock:
        _stats["ready_waits"] += 1
        if timed_out:
            _stats["ready_timeouts"] += 1


def counters() -> Dict:
    with _stats_lock:
        return json.loads(json.dumps(_stats))   # deep copy


# -- autoscaler registry (the /debug block and metrics read through it) -------

_SCALERS: "weakref.WeakSet[Autoscaler]" = weakref.WeakSet()
_scalers_lock = threading.Lock()


def register_autoscaler(a: "Autoscaler") -> None:
    with _scalers_lock:
        _SCALERS.add(a)


def autoscalers() -> List["Autoscaler"]:
    with _scalers_lock:
        return list(_SCALERS)


def elastic_stats() -> Dict:
    """The /debug ``elastic`` block: process counters + one entry per
    live autoscaler."""
    out: Dict = {"enabled": elastic_enabled(), "counters": counters()}
    scalers = {}
    for a in autoscalers():
        scalers[a.name] = a.stats()
    if scalers:
        out["autoscalers"] = scalers
    return out


def dormant() -> bool:
    """True when elastic has left no trace in this process — used by
    the metrics collector to keep the exposition byte-identical under
    ``GSKY_ELASTIC=0``."""
    if elastic_enabled() or autoscalers():
        return False
    with _stats_lock:
        return _stats == _zero_stats()


# -- control RPCs -------------------------------------------------------------

def control_rpc(addr: str, operation: str, doc: Optional[Dict] = None,
                timeout: float = 5.0) -> Dict:
    """One control RPC (``preempt``, ``journal_handoff``,
    ``journal_export``, ``worker_info``) to one node over gRPC: its
    ``info_json`` parsed.  Raises on a transport or node error; a
    control caller decides how to degrade."""
    from ..worker import gskyrpc as pb
    from ..worker.client import dial
    task = pb.Task(operation=operation)
    if doc is not None:
        task.path = json.dumps(doc)
    ch, call = dial(addr)
    try:
        res = call(task, timeout=timeout)
    finally:
        ch.close()
    if res.error:
        raise RuntimeError(res.error)
    try:
        return json.loads(res.info_json or "{}")
    except ValueError:
        return {}


def probe_info(addr: str, timeout: float = 5.0) -> Optional[Dict]:
    """``worker_info`` probe returning the info dict, None on failure."""
    try:
        return control_rpc(addr, "worker_info", timeout=timeout)
    except Exception:
        return None


def successor_for(self_addr: str, peers: Sequence[str]) -> Optional[str]:
    """The ring successor a preempted node ships its journal to, when
    the notice did not name one: deterministic over the known peer set
    so the dying node and the autoscaler agree without coordination."""
    members = sorted(set(list(peers) + [self_addr]))
    if len(members) < 2:
        return None
    return HashRing(members, vnodes=32).successor(self_addr)


# -- node providers -----------------------------------------------------------

class NodeProvider:
    """Where real provisioning plugs in.  Addresses returned by
    :meth:`launch` are the carrier's ``host:port``; a launched node may
    still be booting — the autoscaler gates ring membership on the
    readiness probe, not on ``launch`` returning."""

    def launch(self) -> str:
        raise NotImplementedError

    def terminate(self, addr: str) -> None:
        raise NotImplementedError

    def preempt(self, addr: str, grace_s: float,
                successor: Optional[str] = None,
                peers: Sequence[str] = ()) -> bool:
        """Deliver a preemption notice (the cloud's ~30s warning).  The
        default delivery is the ``preempt`` control RPC; a provider
        whose substrate signals differently (SIGTERM, metadata server)
        overrides this."""
        try:
            control_rpc(addr, "preempt",
                        {"v": 1, "grace_s": float(grace_s),
                         "successor": successor, "peers": list(peers)},
                        timeout=5.0)
            return True
        except Exception:
            return False

    def alive(self, addr: str) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalSubprocessProvider(NodeProvider):
    """Worker nodes as local processes (``python -m
    gsky_tpu_torch.worker.server``, on ``device``), the provider tests
    and the chip smoke scale: every elastic path (readiness, hand-off,
    preemption) runs against real worker processes with the real
    carrier between them.  Each node gets a page journal of its own
    (``GSKY_POOL_JOURNAL`` under ``journal_dir``, by default the
    temporary directory, named by its port) unless ``extra_env`` names
    one: nodes sharing a journal would ship each other's pages."""

    def __init__(self, extra_env: Optional[Dict[str, str]] = None,
                 pool_size: int = 1, host: str = "127.0.0.1",
                 log_dir: Optional[str] = None, device: str = "cuda",
                 journal_dir: Optional[str] = None):
        self.extra_env = dict(extra_env or {})
        self.pool_size = int(pool_size)
        self.host = host
        self.log_dir = log_dir
        self.device = device
        self.journal_dir = journal_dir
        self._lock = threading.Lock()
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: List = []

    @staticmethod
    def free_port() -> int:
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def journal_path(self, port: int) -> str:
        """The page journal of the node on ``port``."""
        return os.path.join(self.journal_dir or tempfile.gettempdir(),
                            f"gsky_pool_journal-{port}.jsonl")

    def launch(self) -> str:
        port = self.free_port()
        addr = f"{self.host}:{port}"
        env = {**os.environ, "GSKY_POOL_JOURNAL": self.journal_path(port),
               **self.extra_env, "GSKY_ELASTIC_SELF": addr}
        out = subprocess.DEVNULL
        if self.log_dir:
            out = open(os.path.join(
                self.log_dir, f"worker-{port}.log"), "w")
            self._logs.append(out)
        # close_fds=False (cwd None) takes posix_spawn: a launch from a
        # busy serving process must not fork, since a child forked mid
        # render can deadlock on another thread's lock before its exec
        proc = subprocess.Popen(
            [sys.executable, "-m", "gsky_tpu_torch.worker.server",
             "-p", str(port), "-host", self.host,
             "-n", str(self.pool_size), "-oom_threshold", "0",
             "-device", self.device],
            env=env, stdout=out, stderr=subprocess.STDOUT,
            close_fds=False)
        with self._lock:
            self._procs[addr] = proc
        return addr

    def terminate(self, addr: str) -> None:
        with self._lock:
            proc = self._procs.pop(addr, None)
        if proc is None:
            return
        try:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
        except Exception:  # already exited / reaped
            pass

    def alive(self, addr: str) -> bool:
        with self._lock:
            proc = self._procs.get(addr)
        return proc is not None and proc.poll() is None

    def addrs(self) -> List[str]:
        with self._lock:
            return sorted(self._procs)

    def close(self) -> None:
        for addr in self.addrs():
            self.terminate(addr)
        for fp in self._logs:
            try:
                fp.close()
            except Exception:  # log file already closed
                pass


# -- demand signal ------------------------------------------------------------

class DemandSignal:
    """Folds the serving stack's existing telemetry into one smoothed
    utilisation number (1.0 = running at the configured limit; >1.0 =
    queueing).  Sources are all optional — a gateway without admission
    control still scales on in-flight load alone.

    - admission: max over service classes of
      ``(in_use + queued) / effective_limit`` — queue depth pushes the
      signal past 1 exactly when AIMD is refusing to grow.
    - fleet: total in-flight across nodes / (nodes x per-node target).
    - waves: device occupancy fraction, when the wave scheduler is live.
    - pressure: state 1 scales the sample x1.25, state 2 x1.5 —
      memory pressure is demand for *more nodes*, not more per-node
      concurrency.
    """

    def __init__(self, admission=None, router=None,
                 occupancy: Optional[Callable[[], Optional[float]]] = None,
                 pressure: Optional[Callable[[], int]] = None,
                 node_conc: int = 8, alpha: float = 0.3):
        self.admission = admission
        self.router = router
        self.occupancy = occupancy
        self.pressure = pressure
        self.node_conc = max(int(node_conc), 1)
        self.alpha = alpha
        self.smoothed: Optional[float] = None
        self.last_raw: Optional[float] = None
        self.last_parts: Dict[str, float] = {}

    def _admission_util(self) -> Optional[float]:
        if self.admission is None:
            return None
        try:
            st = self.admission.stats()
        except Exception:
            return None
        util = None
        for cls in (st.get("classes") or {}).values():
            eff = cls.get("effective_limit") or cls.get("limit") or 0
            if eff <= 0:
                continue
            u = (cls.get("in_use", 0) + cls.get("queued", 0)) / eff
            util = u if util is None else max(util, u)
        return util

    def _fleet_util(self) -> Optional[float]:
        if self.router is None:
            return None
        try:
            nodes = self.router.ring.nodes
            if not nodes:
                return None
            total = sum(self.router.load_of(n) for n in nodes)
            return total / (len(nodes) * self.node_conc)
        except Exception:
            return None

    def sample(self) -> float:
        parts: Dict[str, float] = {}
        vals: List[float] = []
        a = self._admission_util()
        if a is not None:
            parts["admission"] = round(a, 4)
            vals.append(a)
        f = self._fleet_util()
        if f is not None:
            parts["fleet"] = round(f, 4)
            vals.append(f)
        if self.occupancy is not None:
            try:
                occ = self.occupancy()
            except Exception:
                occ = None
            if occ is not None:
                parts["waves"] = round(float(occ), 4)
                vals.append(float(occ))
        raw = max(vals) if vals else 0.0
        if self.pressure is not None:
            try:
                p = int(self.pressure())
            except Exception:
                p = 0
            if p:
                parts["pressure"] = p
                raw *= 1.25 if p == 1 else 1.5
        self.last_raw = raw
        self.last_parts = parts
        if self.smoothed is None:
            self.smoothed = raw
        else:
            self.smoothed += self.alpha * (raw - self.smoothed)
        return self.smoothed


# -- the control loop ---------------------------------------------------------

class Autoscaler:
    """Samples demand, scales membership through the provider, and
    treats preemption as routine: a node that reports draining or goes
    dead is purged from the ring and (when below the floor or demand
    holds) replaced by a launch that warms from peers before joining.

    ``client`` is the routing surface being scaled: anything with
    ``nodes`` (list), ``set_nodes(addrs)`` and ``fleet`` (a
    :class:`~gsky_tpu_torch.fleet.router.FleetRouter`) — in production the
    worker :class:`~gsky_tpu_torch.worker.client.WorkerClient`."""

    def __init__(self, provider: NodeProvider, client, *,
                 name: str = "worker",
                 min_nodes: int = 1,
                 max_nodes: int = 4,
                 interval_s: float = 2.0,
                 up: float = 0.8,
                 down: float = 0.25,
                 up_ticks: int = 2,
                 down_ticks: int = 5,
                 cooldown_s: float = 30.0,
                 ready_timeout_s: float = 120.0,
                 drain_grace_s: float = PREEMPT_GRACE_S,
                 demand: Optional[DemandSignal] = None,
                 probe: Optional[Callable[[str], Optional[Dict]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.provider = provider
        self.client = client
        self.name = name
        self.min_nodes = max(min_nodes, 0)
        self.max_nodes = max(max_nodes, self.min_nodes or 1)
        self.interval_s = interval_s
        self.up = up
        self.down = down
        self.up_ticks = max(up_ticks, 1)
        self.down_ticks = max(down_ticks, 1)
        self.cooldown_s = cooldown_s
        self.ready_timeout_s = ready_timeout_s
        self.drain_grace_s = drain_grace_s
        self.demand = demand or DemandSignal(router=client.fleet)
        self.probe = probe or probe_info
        self._clock = clock
        self._lock = threading.Lock()
        # addr -> {"t0": launch time, "deadline": join-anyway time}
        self._pending: Dict[str, Dict] = {}
        self._leaving: Dict[str, float] = {}   # addr -> removal time
        self._above = 0
        self._below = 0
        self._last_decision: Optional[float] = None
        self.decisions: List[Dict] = []
        self.preempted_seen: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        register_autoscaler(self)

    # -- membership helpers ---------------------------------------------------

    def _active(self) -> List[str]:
        return list(self.client.nodes)

    def _record(self, direction: str, reason: str, **kw) -> None:
        ev = {"dir": direction, "reason": reason,
              "t": round(self._clock(), 3), **kw}
        with self._lock:
            self.decisions.append(ev)
            if len(self.decisions) > 256:
                del self.decisions[:128]
        if direction in ("up", "down"):
            note_decision(direction)
        log.info("elastic %s: %s %s", self.name, direction, ev)

    # -- scale actions --------------------------------------------------------

    def _launch(self, reason: str) -> Optional[str]:
        try:
            addr = self.provider.launch()
        except Exception:
            log.exception("elastic %s: launch failed", self.name)
            self._record("launch_failed", reason)
            return None
        now = self._clock()
        with self._lock:
            self._pending[addr] = {
                "t0": now, "deadline": now + self.ready_timeout_s}
        self._record("up", reason, node=addr)
        self._last_decision = now
        return addr

    def _join_if_ready(self) -> None:
        with self._lock:
            pending = dict(self._pending)
        if not pending:
            return
        now = self._clock()
        for addr, ent in pending.items():
            if not self.provider.alive(addr):
                with self._lock:
                    self._pending.pop(addr, None)
                self._record("join_abandoned", "died_booting", node=addr)
                continue
            info = self.probe(addr)
            el = (info or {}).get("elastic") or {}
            ready = bool(el.get("ready")) if info is not None else False
            timed_out = now >= ent["deadline"]
            if not ready and not timed_out:
                continue
            if timed_out and info is None:
                # never answered a single probe: joining would route
                # live traffic at a black hole — give up on the node
                with self._lock:
                    self._pending.pop(addr, None)
                self._record("join_abandoned", "never_answered",
                             node=addr)
                try:
                    self.provider.terminate(addr)
                except Exception:  # provider may already have reaped it
                    pass
                continue
            with self._lock:
                self._pending.pop(addr, None)
            note_ready_wait(timed_out and not ready)
            nodes = self._active()
            if addr not in nodes:
                self.client.set_nodes(nodes + [addr])
            self._record(
                "join", "ready" if ready else "ready_timeout", node=addr,
                wait_s=round(now - ent["t0"], 3),
                warm_fraction=el.get("warm_fraction"))

    def _scale_down(self, reason: str) -> None:
        nodes = self._active()
        if len(nodes) <= self.min_nodes:
            return
        fleet = self.client.fleet
        victim = min(nodes, key=lambda n: (fleet.load_of(n), n))
        successor = fleet.ring.successor(victim)
        peers = [n for n in nodes if n != victim]
        # remove from the ring FIRST: no new work routes at the victim
        # while it drains, and the bounded-load spill absorbs its arc
        self.client.set_nodes(peers)
        now = self._clock()
        with self._lock:
            self._leaving[victim] = now
        self._record("down", reason, node=victim, successor=successor)
        self._last_decision = now

        def _retire():
            ok = self.provider.preempt(
                victim, self.drain_grace_s, successor=successor,
                peers=peers)
            if not ok:
                log.warning("elastic %s: preempt notice to %s failed; "
                            "terminating", self.name, victim)
            self._stop.wait(self.drain_grace_s + 2.0)
            self.provider.terminate(victim)
            with self._lock:
                self._leaving.pop(victim, None)

        threading.Thread(target=_retire, daemon=True,
                         name=f"gsky-elastic-retire-{victim}").start()

    def _reconcile_departures(self) -> int:
        """Purge nodes that died or announced draining (external
        preemption); returns how many were removed."""
        from .health import DEAD, DRAINING
        fleet = self.client.fleet
        nodes = self._active()
        gone: List[str] = []
        for n in nodes:
            st = fleet.monitor.state(n)
            if st not in (DEAD, DRAINING):
                continue
            with self._lock:
                leaving = n in self._leaving
            if not leaving and n not in self.preempted_seen:
                self.preempted_seen.add(n)
                note_preemption(st == DRAINING)
                self._record("preempted", st, node=n)
            gone.append(n)
        if gone:
            self.client.set_nodes([n for n in nodes if n not in gone])
        return len(gone)

    # -- the loop -------------------------------------------------------------

    def tick(self) -> float:
        """One control-loop iteration (public for tests); returns the
        smoothed demand sample."""
        self._join_if_ready()
        self._reconcile_departures()
        demand = self.demand.sample()
        nodes = self._active()
        with self._lock:
            n_total = len(nodes) + len(self._pending)
        now = self._clock()
        cooled = (self._last_decision is None
                  or now - self._last_decision >= self.cooldown_s)
        if demand > self.up:
            self._above += 1
            self._below = 0
        elif demand < self.down:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if n_total < self.min_nodes:
            # below the floor (preemption took us under): replace
            # immediately, cooldown does not apply to the floor
            for _ in range(self.min_nodes - n_total):
                self._launch("floor")
        elif (self._above >= self.up_ticks and cooled
                and n_total < self.max_nodes):
            self._above = 0
            self._launch("demand")
        elif (self._below >= self.down_ticks and cooled
                and len(nodes) > self.min_nodes):
            self._below = 0
            self._scale_down("idle")
        return demand

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"gsky-elastic-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("elastic %s: tick failed", self.name)

    # -- reporting ------------------------------------------------------------

    def node_counts(self) -> Dict[str, int]:
        with self._lock:
            pending, leaving = len(self._pending), len(self._leaving)
        return {"active": len(self._active()),
                "pending": pending, "leaving": leaving}

    def stats(self) -> Dict:
        with self._lock:
            decisions = list(self.decisions[-32:])
            pending = sorted(self._pending)
            leaving = sorted(self._leaving)
        return {
            "nodes": self._active(),
            "pending": pending,
            "leaving": leaving,
            "min": self.min_nodes, "max": self.max_nodes,
            "demand": {
                "smoothed": round(self.demand.smoothed, 4)
                if self.demand.smoothed is not None else None,
                "raw": round(self.demand.last_raw, 4)
                if self.demand.last_raw is not None else None,
                "parts": dict(self.demand.last_parts),
                "up": self.up, "down": self.down},
            "decisions": decisions,
        }
