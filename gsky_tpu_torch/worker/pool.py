"""Supervised decode-subprocess pool.

Counterpart of `gsky_tpu/worker/pool.py`, with the fault-tolerance
semantics of GSKY's worker layer (`worker/gdalprocess/pool.go` +
`process.go`):

- N subprocesses share one bounded task queue; enqueue on a full queue is
  rejected immediately (queue cap 200/process, `pool.go:19-25`).
- A crashed or wedged subprocess is SIGKILLed and replaced; its task is
  retried up to 5 times (`process.go:189-198`, `pool.go:40-63`).
- Each subprocess is recycled after ``max_tasks`` tasks, jittered per
  process so the pool doesn't recycle in lockstep (`pool.go:29-33`,
  `process.go:154-159`).
- Children die with the parent (Pdeathsig, `process.go:63`): each child
  sets ``PR_SET_PDEATHSIG`` itself (`subproc`), so the spawn needs no
  ``preexec_fn`` and stays a plain ``Popen`` that execs at once: a
  ``preexec_fn`` would run Python in a forked copy of a process that
  may hold a CUDA context.
- A task's wait in the queue, until a subprocess takes it, is the
  ``pool_wait_s`` attribute of the caller's span (the worker node's
  ``worker.decode``).
"""

from __future__ import annotations

import logging
import os
import queue
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from ..obs import set_attr
from ..resilience import faults
from . import gskyrpc as pb
from .ipc import call_subprocess

log = logging.getLogger("gsky.worker.pool")

MAX_RETRIES = 5
QUEUE_CAP_PER_PROCESS = 200

# consecutive-spawn-failure backoff: exponential with full jitter so a
# pool of slots all failing against the same broken dependency doesn't
# hammer it in lockstep
RESPAWN_BACKOFF_BASE_S = 0.5
RESPAWN_BACKOFF_CAP_S = 15.0

# crash-loop breaker: this many unexpected respawns (crashes or spawn
# failures — NOT planned max_tasks recycles) inside the sliding window
# and the node stops pretending restarts will fix it
CRASH_LOOP_MAX = 5
CRASH_LOOP_WINDOW_S = 60.0


def _respawn_backoff(failures: int, rand=random.random) -> float:
    """Delay before the next spawn attempt after `failures` consecutive
    failures: min(cap, base * 2^failures) with full jitter."""
    raw = min(RESPAWN_BACKOFF_CAP_S,
              RESPAWN_BACKOFF_BASE_S * (2 ** min(failures, 16)))
    return raw * (0.5 + rand())


class CrashLoopBreaker:
    """Sliding-window respawn counter that latches `tripped`.

    A subprocess crash is survivable — the supervisor replaces it and
    retries the task.  A CRASH LOOP is not: N unexpected respawns inside
    the window means something environmental (bad install, exhausted
    node, poisoned input wedging every child) that one more restart
    won't fix.  Tripping doesn't stop the pool — it keeps limping, which
    still beats refusing everything — but the state is folded into the
    worker's info block so the fleet health monitor marks the node fatal
    and routers stop sending it fresh work."""

    def __init__(self, max_crashes: int = CRASH_LOOP_MAX,
                 window_s: float = CRASH_LOOP_WINDOW_S,
                 clock=time.monotonic):
        self.max_crashes = max(1, int(max_crashes))
        self.window_s = float(window_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._times: List[float] = []
        self.total = 0
        self.tripped = False

    def record(self) -> bool:
        """Count one unexpected respawn; returns the (possibly newly)
        tripped state."""
        with self._lock:
            now = self.clock()
            self.total += 1
            self._times.append(now)
            cutoff = now - self.window_s
            self._times = [t for t in self._times if t >= cutoff]
            if len(self._times) >= self.max_crashes and not self.tripped:
                self.tripped = True
                log.error(
                    "crash-loop breaker tripped: %d respawns in %.0fs; "
                    "reporting node fatal to fleet health",
                    len(self._times), self.window_s)
            return self.tripped

    def stats(self) -> dict:
        with self._lock:
            return {"tripped": self.tripped, "respawns": self.total,
                    "recent": len(self._times),
                    "max_crashes": self.max_crashes,
                    "window_s": self.window_s}


def _recycle_threshold(max_tasks: int, size: int,
                       rand=random.randrange) -> int:
    """Jittered per-process recycle threshold, proportional to the
    recycle period so a pool draining one shared queue doesn't restart
    in lockstep (the reference jitters by pool size, `pool.go:29-33`;
    our children block ~tens of seconds on startup imports, so the
    spread must be much wider than a few tasks)."""
    if size <= 1:
        return max_tasks
    return max_tasks + rand(max(size, max_tasks // 10))

class _Task:
    __slots__ = ("task", "event", "result", "attempts", "trace_id",
                 "t_submit", "wait_s")

    def __init__(self, task: pb.Task):
        self.task = task
        self.event = threading.Event()
        self.result: Optional[pb.Result] = None
        self.attempts = 0
        # seconds in the queue before a subprocess took it (first take)
        self.t_submit = time.monotonic()
        self.wait_s: Optional[float] = None
        # captured at submit: the feeder thread that logs a crash has no
        # request context of its own
        try:
            from ..obs import current_trace_id
            self.trace_id = current_trace_id() or "-"
        except Exception:
            self.trace_id = "-"


class PoolFullError(RuntimeError):
    """Task queue full: pure backpressure, not a broken pool.

    ``retryable`` so :func:`resilience.retry.call_with_retry` backs off
    and re-enqueues instead of failing the request outright — the queue
    drains at pool speed, so a jittered retry usually lands."""

    retryable = True


class Process:
    """One supervised subprocess + the worker thread that feeds it."""

    def __init__(self, pool: "ProcessPool", idx: int):
        self.pool = pool
        self.idx = idx
        self.sock_path = os.path.join(
            pool.tmp_dir, f"gsky_decode_{os.getpid()}_{idx}.sock")
        self.max_tasks = _recycle_threshold(pool.max_tasks, pool.size)
        self.proc: Optional[subprocess.Popen] = None
        self.tasks_done = 0
        self.spawn_failures = 0   # consecutive; drives the backoff
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"gsky-pool-{idx}")
        self.thread.start()

    # -- child lifecycle -----------------------------------------------------

    def _spawn(self):
        self.tasks_done = 0
        try:
            os.unlink(self.sock_path)
        except FileNotFoundError:
            pass
        proc = subprocess.Popen(
            [sys.executable, "-m", "gsky_tpu_torch.worker.subproc",
             "-sock", self.sock_path,
             "-max_tasks", str(self.max_tasks),
             "-timeout", str(self.pool.task_timeout),
             "-parent", str(os.getpid())],
            stderr=subprocess.DEVNULL if self.pool.quiet else None)
        self.proc = proc
        # give the child time for its first imports (torch is heavy)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and not self.pool.closed:
            if os.path.exists(self.sock_path):
                return
            if proc.poll() is not None:
                break
            time.sleep(0.01)
        if self.pool.closed:
            return
        raise RuntimeError(f"decode subprocess {self.idx} failed to start")

    def _kill(self):
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        self.proc = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def ready(self) -> bool:
        """Alive with its socket bound."""
        proc = self.proc
        return proc is not None and proc.poll() is None \
            and os.path.exists(self.sock_path)

    # -- task loop -----------------------------------------------------------

    def _respawn(self, crashed: bool = False) -> bool:
        """Spawn with the feeder thread kept alive on failure — a slot
        that can't start a child keeps retrying instead of dying.
        `crashed` marks an UNEXPECTED replacement (child died or wedged,
        vs a planned max_tasks recycle) and feeds the pool's crash-loop
        breaker; spawn failures always do.  Consecutive failures back
        off exponentially with jitter so a broken dependency isn't
        hammered in lockstep by every slot."""
        if crashed:
            self.pool.breaker.record()
        try:
            self._spawn()
            self.spawn_failures = 0
            return True
        except (RuntimeError, OSError) as e:
            log.error("subprocess %d spawn failed: %s", self.idx, e)
            self._kill()
            self.pool.breaker.record()
            delay = _respawn_backoff(self.spawn_failures)
            self.spawn_failures += 1
            deadline = time.monotonic() + delay
            while time.monotonic() < deadline and not self.pool.closed:
                time.sleep(0.05)
            return False

    def _run(self):
        self._respawn()
        while not self.pool.closed:
            if self.proc is None or self.proc.poll() is not None:
                # crashed, recycled, or never started: replace it.  A
                # child that EXITED on its own (proc present, poll set)
                # counts as a crash; a slot still failing to spawn
                # (proc None) already counted when the spawn failed.
                if not self._respawn(crashed=self.proc is not None):
                    continue
            try:
                item = self.pool.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                break
            if item.wait_s is None:
                item.wait_s = time.monotonic() - item.t_submit
            try:
                # injected "pool" faults raise a ConnectionError subclass
                # here, driving the REAL kill/respawn/retry path below —
                # no test-only branches in the recovery logic
                faults.inject("pool")
                res = call_subprocess(
                    self.sock_path, item.task,
                    timeout=self.pool.task_timeout + 10.0)
                item.result = res
                item.event.set()
                self.tasks_done += 1
                if self.tasks_done >= self.max_tasks:
                    self._kill()
                    self._respawn()
            except (ConnectionError, OSError) as e:
                # crash/wedge: kill + replace + retry (`process.go:189-198`)
                log.warning("subprocess %d task failed (%s); restarting "
                            "trace=%s", self.idx, e, item.trace_id)
                self._kill()
                self._respawn(crashed=True)
                item.attempts += 1
                if item.attempts >= MAX_RETRIES:
                    item.result = pb.Result(
                        error=f"task failed after {item.attempts} attempts")
                    item.event.set()
                else:
                    try:
                        self.pool.queue.put_nowait(item)
                    except queue.Full:
                        item.result = pb.Result(error="queue full on retry")
                        item.event.set()
        self._kill()


class ProcessPool:
    """N supervised subprocesses sharing one bounded queue."""

    def __init__(self, size: Optional[int] = None, max_tasks: int = 20000,
                 task_timeout: float = 120.0, tmp_dir: Optional[str] = None,
                 quiet: bool = False):
        self.size = size or max(os.cpu_count() or 2, 2)
        self.max_tasks = max_tasks
        self.task_timeout = task_timeout
        self.tmp_dir = tmp_dir or tempfile.mkdtemp(prefix="gsky_pool_")
        self.quiet = quiet
        self.closed = False
        self.breaker = CrashLoopBreaker()
        self.queue: "queue.Queue[Optional[_Task]]" = queue.Queue(
            maxsize=QUEUE_CAP_PER_PROCESS * self.size)
        self.processes: List[Process] = [
            Process(self, i) for i in range(self.size)]

    def submit(self, task: pb.Task) -> pb.Result:
        """Run one task; raises PoolFullError on backpressure
        (`pool.go:19-25`)."""
        if self.closed:
            raise RuntimeError("pool closed")
        item = _Task(task)
        try:
            self.queue.put_nowait(item)
        except queue.Full:
            raise PoolFullError("worker task queue full")
        # IO timeout is enforced by the subprocess itself + call timeout;
        # the extra margin covers queueing delay under load.
        if not item.event.wait(self.task_timeout * MAX_RETRIES + 60.0):
            return pb.Result(error="task timed out in queue")
        if item.wait_s is not None:
            # the queue's share of the caller's span (`worker.decode`)
            set_attr(pool_wait_s=round(item.wait_s, 6))
        return item.result

    def child_pids(self) -> List[int]:
        return [p.pid for p in self.processes if p.pid is not None]

    def ready_count(self) -> int:
        """Children alive with their socket bound: ready for a task."""
        return sum(1 for p in self.processes if p.ready())

    def wait_ready(self, timeout: float) -> bool:
        """Wait until every child is ready, or has failed to start (the
        crash-loop breaker's from there), or ``timeout`` passes; whether
        every child is ready."""
        deadline = time.monotonic() + timeout
        while not all(p.ready() or p.spawn_failures
                      for p in self.processes):
            if time.monotonic() >= deadline or self.closed:
                break
            time.sleep(0.02)
        return self.ready_count() == self.size

    def stats(self) -> dict:
        """Folded into the worker's info block (_worker_info) so the
        client-side fleet health monitor sees crash-loop state."""
        return {"size": self.size, "ready": self.ready_count(),
                "queue_depth": self.queue.qsize(),
                "crash_loop": self.breaker.stats()}

    def close(self):
        self.closed = True
        # fail queued tasks immediately so blocked submitters wake up
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.result = pb.Result(error="pool closed")
                item.event.set()
        for _ in self.processes:
            try:
                self.queue.put_nowait(None)
            except queue.Full:
                pass  # feeders also exit via the closed-flag poll
        for p in self.processes:
            p.thread.join(timeout=10)
            p._kill()
