"""Device supervisor: every guarded dispatch supervised, every failure
answered retryably.

Counterpart of `gsky_tpu/device_guard/supervisor.py`, with its state
machine, knobs and defaults.  Four failure shapes are classified and
routed:

- **hang**: a device sync (a readback, a ``.cpu()``) runs under a
  monitored deadline (``GSKY_DEVICE_HANG_S``, default 30 s,
  :func:`supervised_sync`); past it the caller gets :class:`DeviceHang`
  and the device turns suspect;
- **crash**: a CUDA error out of a dispatch or a sync turns the device
  suspect; the request fails retryably (:class:`DeviceGuardError`
  subclasses ``BackendUnavailable``, so the server answers 503 with
  ``Retry-After``);
- **oom**: an out-of-memory error triggers the one-shot relief (the
  pressure monitor escalates, its relief trimming the colder half of
  every live page pool; the registered OOM hooks run: the render
  batchers halve their knee) and one retry (:func:`run`);
- **corruption**: the readback integrity probe (:func:`integrity_check`:
  +-inf is never a legal output value; the pipeline encodes validity as
  NaN) quarantines poisoned pages through the pools' audit under
  ``GSKY_POOL_AUDIT=1``, else takes the device through a rebuild.

State machine::

    healthy --incident--> suspect --backoff elapsed--> reinitializing
       ^                                                  |       |
       +------------------- rebuild ok -------------------+       |
                                          repeated rebuild failure v
                                                                 dead

A suspect device admits no dispatch until its jittered exponential
backoff (``GSKY_DEVICE_REINIT_BACKOFF`` = "base,cap" seconds, default
"0.5,8") elapses; the first dispatch past it rebuilds inline: every
live page pool is torn down (its hot set journaled), PyTorch's caching
allocator returns its free blocks (``torch.cuda.empty_cache``), a probe
round-trips ``torch.zeros(8) + 1`` through ``.cpu()`` on each pool's
device under the hang watchdog, and the pools re-stage their hottest
pages from the scene caches (`journal`).  A request that arrives
mid-backoff gets :class:`DeviceReinitializing` with ``retry_after`` set
to the wait left.  After ``MAX_REINIT_FAILURES`` failed rebuilds the
device is dead.

CUDA errors reach the port in three forms, each classified here: a
``torch.cuda.OutOfMemoryError`` (an allocation); a kernel wrapper's
``"<symbol> failed: CUDA error <rc>"`` (`ops.cuda_lib`: rc 2,
``cudaErrorMemoryAllocation``, is an OOM, every other code a crash);
and torch's ``RuntimeError: CUDA error: <text>`` at a sync (``out of
memory`` is an OOM, the rest crashes).  The injected faults
(`resilience.faults`, site ``device``) raise the reference's
``INTERNAL:`` and ``RESOURCE_EXHAUSTED:`` messages, which ride the same
path.  A sticky CUDA error (an illegal address, 700; a launch failure,
719) leaves the process's context unusable: the rebuild's probe fails
every time and the device ends dead, with the server answering 503
throughout (ROADMAP C).

A guarded call runs on a sync worker thread that enters its caller's
current CUDA stream, because PyTorch's current stream is per thread: a
launch from the worker then lands on the stream the caller's uploads
recorded their events on.  Workers are reused (the reference starts a
thread a call); a hung one is abandoned.

``GSKY_DEVICE_GUARD=0`` is the escape hatch: read per call, every entry
point is then exactly ``thunk()``.
"""

from __future__ import annotations

import os
import queue
import random
import re
import threading
import time
import weakref
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from ..resilience.breaker import BackendUnavailable

HEALTHY, SUSPECT, REINITIALIZING, DEAD = 0, 1, 2, 3
STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect",
               REINITIALIZING: "reinitializing", DEAD: "dead"}

# consecutive failed rebuilds before the device is declared dead
MAX_REINIT_FAILURES = 6

# cudaErrorMemoryAllocation: the one return code of a kernel wrapper
# that is an out-of-memory
_CUDA_OOM_RC = 2
_WRAPPER_RC = re.compile(r"failed: CUDA error (\d+)$")


class DeviceGuardError(BackendUnavailable):
    """A supervised device failure.  Subclasses ``BackendUnavailable``
    so that the server answers 503 with Retry-After; ``retryable``
    makes retry policies treat it as a transport fault."""

    retryable = True


class DeviceHang(DeviceGuardError):
    """A device sync exceeded its watchdog deadline."""


class DeviceCorruption(DeviceGuardError):
    """The output-integrity probe rejected a readback."""


class DeviceReinitializing(DeviceGuardError):
    """The device is mid-backoff or mid-rebuild; retry elsewhere."""


class DeviceDead(DeviceGuardError):
    """Rebuilds keep failing; only an operator recovers it."""

    retryable = False


def guard_enabled() -> bool:
    """The escape hatch, read per call."""
    return os.environ.get("GSKY_DEVICE_GUARD", "1") != "0"


def hang_deadline_s() -> float:
    try:
        return float(os.environ.get("GSKY_DEVICE_HANG_S", "30"))
    except ValueError:
        return 30.0


def pool_audit_enabled() -> bool:
    return os.environ.get("GSKY_POOL_AUDIT", "") == "1"


def _backoff_spec() -> tuple:
    """GSKY_DEVICE_REINIT_BACKOFF = "base,cap" seconds (default
    "0.5,8"): attempt N waits min(cap, base * 2**N), jittered."""
    raw = os.environ.get("GSKY_DEVICE_REINIT_BACKOFF", "0.5,8")
    try:
        parts = [float(x) for x in raw.split(",")]
        base = max(0.01, parts[0])
        cap = max(base, parts[1]) if len(parts) > 1 else max(base, 8.0)
        return base, cap
    except (ValueError, IndexError):
        return 0.5, 8.0


def classify(exc: BaseException) -> Optional[str]:
    """The incident kind of an exception out of a device dispatch or
    sync ("hang", "oom", "crash", "corrupt"), or None for an error that
    is not the device's (it is re-raised as it is)."""
    if isinstance(exc, DeviceHang):
        return "hang"
    if isinstance(exc, DeviceCorruption):
        return "corrupt"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    msg = f"{type(exc).__name__}: {exc}"
    if "RESOURCE_EXHAUSTED" in msg or "Resource exhausted" in msg:
        return "oom"
    if type(exc).__name__ == "XlaRuntimeError" or "INTERNAL:" in msg:
        return "crash"
    m = _WRAPPER_RC.search(str(exc))
    if m is not None:
        return "oom" if int(m.group(1)) == _CUDA_OOM_RC else "crash"
    if isinstance(exc, RuntimeError) and "CUDA error: " in msg:
        return "oom" if "out of memory" in msg.split("CUDA error: ", 1)[1] \
            else "crash"
    return None


def _live_pools():
    from ..pipeline import pages
    return pages.live_pools()


class DeviceSupervisor:
    """The per-process device state machine.  Thread-safe; the clock is
    injectable for tests."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.RLock()
        self._rng = random.Random(0xD06)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._state = HEALTHY
            self._since = self._clock()
            self._incident = ""     # kind that took the device out
            self._next_attempt = 0.0
            self._failures = 0      # consecutive failed rebuilds
            self.reinits = 0
            self.hangs = 0
            self.crashes = 0
            self.ooms = 0
            self.oom_retries = 0
            self.corruptions = 0
            self.quarantined_pages = 0
            self.rehydrated_pages = 0
            self.last_error = ""
            self.incidents: deque = deque(maxlen=32)

    # -- state ---------------------------------------------------------

    def state(self) -> int:
        with self._lock:
            return self._state

    def state_name(self) -> str:
        return STATE_NAMES[self.state()]

    def staging_ok(self) -> bool:
        """Page staging grows device residency: decline it the moment
        the device is anything but healthy (`PagePool.table_for`)."""
        return not guard_enabled() or self.state() == HEALTHY

    def _note(self, kind: str, site: str, exc=None) -> None:  # gskylint: holds-lock
        self.incidents.append({
            "kind": kind, "site": site, "t": round(self._clock(), 3),
            "error": str(exc)[:200] if exc is not None else ""})
        if exc is not None:
            self.last_error = f"{type(exc).__name__}: {exc}"[:200]

    def _mark_suspect(self, kind: str) -> None:  # gskylint: holds-lock
        if self._state in (DEAD, REINITIALIZING):
            return
        self._incident = kind
        if self._state != SUSPECT:
            self._state = SUSPECT
            self._since = self._clock()
        base, cap = _backoff_spec()
        delay = min(cap, base * (2.0 ** self._failures))
        delay *= 0.5 + self._rng.random()       # jitter 0.5x .. 1.5x
        self._next_attempt = self._clock() + delay

    # -- incident recording --------------------------------------------

    def record_hang(self, site: str, exc=None) -> None:
        with self._lock:
            self.hangs += 1
            self._note("hang", site, exc)
            self._mark_suspect("hang")

    def record_crash(self, site: str, exc=None) -> None:
        with self._lock:
            self.crashes += 1
            self._note("crash", site, exc)
            self._mark_suspect("crash")

    def record_oom(self, site: str, exc=None, fatal: bool = False) -> None:
        """An out-of-memory.  One that relief and its retry can absorb
        does not make the device suspect; a fatal one (the retry ran
        out of memory too) does."""
        with self._lock:
            self.ooms += 1
            self._note("oom", site, exc)
            if fatal:
                self._mark_suspect("oom")

    def record_corruption(self, site: str, exc=None) -> None:
        """A poisoned readback.  Under GSKY_POOL_AUDIT=1 the pools'
        audit runs first: when it finds and quarantines poisoned pages
        the device stays in service (re-staging heals them); otherwise
        the device goes through a rebuild."""
        with self._lock:
            self.corruptions += 1
            self._note("corrupt", site, exc)
        quarantined = 0
        if pool_audit_enabled():
            try:
                quarantined = sum(p.audit() for p in _live_pools())
            except Exception:  # noqa: BLE001 - a device the audit cannot
                quarantined = 0  # read takes the rebuild below
        with self._lock:
            self.quarantined_pages += quarantined
            if quarantined <= 0:
                self._mark_suspect("corrupt")

    # -- admission + rebuild -------------------------------------------

    def admit(self, site: str = "dispatch") -> None:
        """Gate a dispatch on device health.  Healthy passes; suspect
        raises retryably until the backoff elapses, then the admitting
        thread rebuilds inline (its request pays the rehydration, every
        later one finds a warm pool)."""
        if not guard_enabled():
            return
        with self._lock:
            st = self._state
            if st == HEALTHY:
                return
            if st == DEAD:
                raise DeviceDead(
                    f"device dead after {self._failures} failed rebuilds"
                    f" (last: {self.last_error or self._incident})",
                    site=site, retry_after=60.0)
            now = self._clock()
            if st == REINITIALIZING or now < self._next_attempt:
                raise DeviceReinitializing(
                    f"device {STATE_NAMES[st]} after {self._incident}",
                    site=site,
                    retry_after=max(0.1, self._next_attempt - now))
            self._state = REINITIALIZING
        ok = False
        try:
            ok = self._reinitialize()
        finally:
            with self._lock:
                if ok:
                    self._state = HEALTHY
                    self._failures = 0
                    self._incident = ""
                    self._since = self._clock()
                else:
                    self._failures += 1
                    if self._failures >= MAX_REINIT_FAILURES:
                        self._state = DEAD
                    else:
                        self._state = SUSPECT
                        self._mark_suspect(self._incident or "crash")
        if not ok:
            raise DeviceReinitializing(
                f"device rebuild failed ({self.last_error})", site=site,
                retry_after=max(0.1, self._next_attempt - self._clock()))

    def _reinitialize(self) -> bool:
        """Tear down and rebuild: journal and drop every live page pool,
        release the allocator's cached blocks, prove each pool's device
        answers (under the hang watchdog: a device still wedged fails
        the rebuild instead of blocking it), then rehydrate the pools."""
        with self._lock:
            self.reinits += 1
        try:
            pools = _live_pools()
            for pool in pools:
                pool.teardown()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
            devices = {p.device for p in pools} or {torch.device(
                "cuda" if torch.cuda.is_available() else "cpu")}
            for dev in devices:
                got = supervised_sync(
                    "device.probe",
                    lambda dev=dev: (torch.zeros(8, device=dev) + 1).cpu())
                if not bool((got == 1).all()):
                    raise RuntimeError(f"device probe on {dev} read back "
                                       f"{got.tolist()}")
            restored = sum(p.rehydrate() for p in pools)
            with self._lock:
                self.rehydrated_pages += restored
            return True
        except Exception as e:   # noqa: BLE001 - any failure = not ok
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"[:200]
            return False

    # -- reporting ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                "enabled": guard_enabled(),
                "state": STATE_NAMES[self._state],
                "state_code": self._state,
                "since_s": round(now - self._since, 3),
                "incident": self._incident,
                "retry_in_s": round(max(0.0, self._next_attempt - now), 3)
                if self._state in (SUSPECT, REINITIALIZING) else 0.0,
                "reinit_failures": self._failures,
                "reinits": self.reinits,
                "hangs": self.hangs,
                "crashes": self.crashes,
                "ooms": self.ooms,
                "oom_retries": self.oom_retries,
                "corruptions": self.corruptions,
                "quarantined_pages": self.quarantined_pages,
                "rehydrated_pages": self.rehydrated_pages,
                "hang_deadline_s": hang_deadline_s(),
                "audit": pool_audit_enabled(),
                "last_error": self.last_error,
                "incidents": list(self.incidents),
            }


_default = DeviceSupervisor()


def default_supervisor() -> DeviceSupervisor:
    return _default


def staging_ok() -> bool:
    return _default.staging_ok()


# hooks the OOM relief runs (each executor registers its batcher's
# `note_oom`, so that the retry and every later flush are smaller); a
# bound method is held weakly, so that a server's executor can go
_oom_hooks: List[Callable] = []
_hooks_lock = threading.Lock()


def register_oom_hook(fn: Callable[[], None]) -> None:
    ref = weakref.WeakMethod(fn) if hasattr(fn, "__self__") \
        else (lambda: fn)
    with _hooks_lock:
        if all(r() != fn for r in _oom_hooks):
            _oom_hooks.append(ref)


def _live_oom_hooks() -> List[Callable[[], None]]:
    with _hooks_lock:
        _oom_hooks[:] = [r for r in _oom_hooks if r() is not None]
        return [r() for r in _oom_hooks]


_UNSET = object()

# -- two waves in flight --------------------------------------------------
#
# The pipelined wave scheduler (pipeline/waves.py) stages wave N+1's
# uploads while wave N runs.  An upload queued on the stream behind a
# hung kernel presents as a hung upload on the assembly thread, so a
# staging-side timeout is blamed on the wave that is executing.

_exec_lock = threading.Lock()
_exec_windows: dict = {}     # key -> (site, t_start)
_exec_seq = [0]


def _staging_site(site: str) -> bool:
    """Staging-class sites: uploads issued ahead of the launch that
    will read them (``wave.stage``)."""
    return site.endswith(".stage")


class execution_window:
    """Marks ``site`` as the device work executing now, for hang
    attribution while a staging wave is in flight."""

    def __init__(self, site: str):
        self.site = site

    def __enter__(self):
        with _exec_lock:
            _exec_seq[0] += 1
            self._key = _exec_seq[0]
            _exec_windows[self._key] = (self.site, time.monotonic())
        return self

    def __exit__(self, *exc):
        with _exec_lock:
            _exec_windows.pop(self._key, None)
        return False


def attribute_hang(site: str) -> str:
    """The site a watchdog timeout belongs to: an executing site's own;
    a staging site's, the oldest execution window still open (the
    upload queued behind it), else its own."""
    if not _staging_site(site):
        return site
    with _exec_lock:
        live = sorted(_exec_windows.values(), key=lambda p: p[1])
    return live[0][0] if live else site


def _caller_stream():
    """The calling thread's current CUDA stream, or None before CUDA is
    initialised in this process (a thunk then starts it on the default
    stream, which every thread shares)."""
    if torch.cuda.is_initialized():
        return torch.cuda.current_stream()
    return None


class _SyncWorker:
    """A daemon thread that runs supervised syncs, one at a time.  An
    idle worker waits in ``_idle_workers``; a sync takes one (or starts
    one) and hands it the job.  A worker whose job outlives its deadline
    is abandoned to the device; should the job ever return, the worker
    goes back to the idle list.  Reusing threads keeps a guarded call's
    host cost to a hand-off: a new thread a call (the reference's) also
    pays CUDA's per-thread set-up on its first launch."""

    def __init__(self):
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._loop, daemon=True,
                         name="gsky-devsync").start()

    def _loop(self):
        while True:
            job, done = self._jobs.get()
            job()
            done.set()
            # an idle worker keeps no job: a job closes over what its
            # sync read (a wave's entries, their page pool), which would
            # stay on the card after their server closed
            del job, done
            with _idle_lock:
                _idle_workers.append(self)

    def run(self, job) -> threading.Event:
        done = threading.Event()
        self._jobs.put((job, done))
        return done


_idle_workers: List[_SyncWorker] = []
_idle_lock = threading.Lock()


def _worker() -> _SyncWorker:
    with _idle_lock:
        if _idle_workers:
            return _idle_workers.pop()
    return _SyncWorker()


def supervised_sync(site: str, thunk: Callable,
                    deadline_s: Optional[float] = None):
    """Run a device sync under the hang watchdog.

    The thunk runs on a sync worker thread (`_SyncWorker`), inside the
    caller's current CUDA stream, and the caller waits for it up to the
    deadline: a sync blocked in the CUDA runtime cannot be interrupted
    from its own thread, so on timeout the worker is abandoned and the
    caller gets :class:`DeviceHang` (the supervisor turns suspect
    first).  Fault site ``device`` fires inside the watchdog, so
    ``device:hang:..`` specs take the real deadline path.  A thunk must
    contain its sync: a launch alone returns at once and cannot hang.
    """
    if not guard_enabled():
        return thunk()
    deadline = hang_deadline_s() if deadline_s is None else deadline_s
    out = [_UNSET, None]
    stream = _caller_stream()

    def _call():
        from ..resilience import faults
        faults.inject("device")
        if _staging_site(site):
            return thunk()
        # the window is held by the sync thread: a hung launch keeps it
        # open after the watchdog abandons it, so that a staging hang
        # queued behind it is attributed to it
        with execution_window(site):
            return thunk()

    def _run():
        try:
            if stream is None:
                out[0] = _call()
            else:
                with torch.cuda.stream(stream):
                    out[0] = _call()
        except BaseException as e:   # noqa: BLE001 - re-raised below
            out[1] = e

    done = _worker().run(_run)
    if not done.wait(deadline if deadline > 0 else None):
        blame = attribute_hang(site)
        _default.record_hang(blame)
        detail = "" if blame == site else \
            f" (attributed to executing {blame!r})"
        raise DeviceHang(
            f"device sync {site!r} exceeded {deadline:.3g}s"
            f" watchdog{detail}", site=blame)
    if out[1] is not None:
        raise out[1]
    return out[0]


def _oom_relief() -> None:
    """The one-shot out-of-memory relief: the pressure monitor escalates
    (its cache relief, which in the port also trims the colder half of
    every live page pool, as the reference's guard trims its pool
    before escalating; the admission clamp; brownout), then the
    registered OOM hooks run."""
    from ..resilience.pressure import default_monitor
    default_monitor().escalate()
    for fn in _live_oom_hooks():
        fn()


def run(site: str, thunk: Callable, reduced: Optional[Callable] = None):
    """A device dispatch under full supervision: the admission gate,
    fault injection, the hang watchdog, incident classification and
    the OOM relief and retry.  ``reduced``, when given, is the smaller
    variant the retry runs.

    With ``GSKY_DEVICE_GUARD=0`` this is exactly ``thunk()``.
    """
    if not guard_enabled():
        return thunk()
    sup = _default
    sup.admit(site)
    try:
        return supervised_sync(site, thunk)
    except DeviceGuardError:
        raise                   # a hang: recorded and typed already
    except Exception as e:
        kind = classify(e)
        if kind == "oom":
            sup.record_oom(site, e)
            _oom_relief()
            retry = reduced if reduced is not None else thunk
            try:
                result = supervised_sync(site, retry)
            except DeviceGuardError:
                raise
            except Exception as e2:
                sup.record_oom(site, e2, fatal=True)
                raise DeviceGuardError(
                    f"device OOM at {site!r} persisted after relief:"
                    f" {e2}", site=site) from e2
            with sup._lock:
                sup.oom_retries += 1
            return result
        if kind == "crash":
            sup.record_crash(site, e)
            raise DeviceGuardError(
                f"device crash at {site!r}: {e}", site=site) from e
        raise


def integrity_check(site: str, arr) -> None:
    """The output-integrity probe: sample the readback on a stride and
    reject it if any value is +-inf.  NaN is the pipeline's validity
    encoding; nothing on the render path writes inf, so an inf means
    the device (or the copy back from it) corrupted the buffer."""
    if not guard_enabled():
        return
    try:
        a = np.asarray(arr)
    except Exception:
        return
    if a.dtype.kind != "f" or a.size == 0:
        return
    flat = a.reshape(-1)
    step = max(1, flat.size // 4096)
    if np.isinf(flat[::step]).any():
        _default.record_corruption(site)
        raise DeviceCorruption(
            f"readback at {site!r} failed the integrity probe"
            " (non-finite beyond NaN validity)", site=site)


def _poison(arr):
    """device:corrupt injection: alternate floats set to inf on a copy
    of the readback, the shape a flipped bit in memory or on the bus
    presents."""
    a = np.array(arr, copy=True)
    if a.dtype.kind == "f" and a.size:
        a.reshape(-1)[::2] = np.inf
    return a


def guarded_readback(site: str, thunk: Callable):
    """A supervised readback: :func:`run` (watchdog, classification)
    plus corruption injection and the integrity probe on the result."""
    if not guard_enabled():
        return thunk()
    arr = run(site, thunk)
    from ..resilience import faults
    if faults.flag("device", "corrupt"):
        arr = _poison(arr)
    integrity_check(site, arr)
    return arr


def reset() -> None:
    """Test hook: fresh supervisor state.  Registered OOM hooks stay:
    they are wired once, at executor construction."""
    with _exec_lock:
        _exec_windows.clear()
    _default.reset()
