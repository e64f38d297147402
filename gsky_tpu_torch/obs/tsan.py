"""Lockset race sanitizer (Eraser-style), opt-in via ``GSKY_TSAN=1``.

Counterpart of `gsky_tpu/obs/tsan.py`.

It catches what no reading of the source does: aliased structures,
callbacks that outlive their ``with`` block, and the cross-thread
interleavings of the wave scheduler's threads, the page pool's staging
and teardown paths, and the render batcher's timers.

Algorithm (Savage et al., "Eraser", SOSP '97, write-set variant):

* every instrumented lock tracks, per thread, the set of locks held;
* every *write* to a tracked shared variable ``v`` refines its
  candidate set ``C(v) ∩= locks_held(current thread)`` once a second
  thread has touched it (first-writer accesses are exempt: objects
  are routinely built single-threaded before publication);
* ``C(v) = ∅`` with two distinct writer threads ⇒ no single lock
  consistently protected ``v`` — a race report carrying both stacks
  (the previous conflicting write's and the current one's).

Instrumentation has two hooks:

* :func:`install` monkeypatches ``threading.Lock``/``RLock`` so every
  lock created afterwards participates in lockset tracking (existing
  locks simply never appear in locksets — races guarded only by a
  pre-install lock can false-positive, so install() runs before the
  server boots: server/main.py calls :func:`maybe_install` first
  thing);
* :func:`track` swizzles one object's class so attribute writes are
  checked; the wave scheduler, page pool, and render batcher
  self-register at construction when tsan is enabled (a disabled
  process pays a single ``if`` per constructor).

Everything is a no-op unless ``GSKY_TSAN=1`` (read at call time, not
import — the knob survives SIGHUP reconfigure like every other one).
Reports are collected, deduplicated per (class, attribute), and
surfaced via :func:`races` / :func:`report` and counted in
``gsky_tsan_races_total``.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

_REAL_LOCK = threading.Lock          # bound pre-install, used internally
_REAL_RLOCK = threading.RLock

_STACK_DEPTH = 12                    # frames kept per access record


def enabled() -> bool:
    """GSKY_TSAN=1 turns the sanitizer on (call-time read)."""
    return os.environ.get("GSKY_TSAN", "0") == "1"


# -- lockset bookkeeping ------------------------------------------------

_tls = threading.local()


def _held() -> frozenset:
    return frozenset(getattr(_tls, "held", ()) or ())


def _push(lock_id: int) -> None:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    held.append(lock_id)


def _pop(lock_id: int) -> None:
    held = getattr(_tls, "held", None)
    if held and lock_id in held:
        held.reverse()
        held.remove(lock_id)
        held.reverse()


class TsanLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper that records
    holdership in the per-thread lockset.  Delegates everything to a
    real lock, so semantics (blocking, timeouts, context manager,
    Condition compatibility) are untouched."""

    __slots__ = ("_lock", "_id")

    def __init__(self, rlock: bool = False):
        self._lock = _REAL_RLOCK() if rlock else _REAL_LOCK()
        self._id = id(self)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            _push(self._id)
        return got

    def release(self):
        self._lock.release()
        _pop(self._id)

    def locked(self):
        return self._lock.locked() if hasattr(self._lock, "locked") \
            else False

    def __getattr__(self, attr):
        # delegate the long tail of private lock protocol —
        # _at_fork_reinit (os.register_at_fork), _is_owned /
        # _release_save / _acquire_restore (Condition over RLock)
        return getattr(self._lock, attr)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<TsanLock {self._id:#x} over {self._lock!r}>"


# -- race records -------------------------------------------------------

class _VarState:
    """Per (object id, attribute) Eraser write-state."""

    __slots__ = ("first_thread", "lockset", "last_write", "shared")

    def __init__(self, thread_id: int, held: frozenset, stack):
        self.first_thread = thread_id
        self.lockset: Optional[frozenset] = None   # None = universe
        self.last_write: Tuple[int, str, object] = \
            (thread_id, threading.current_thread().name, stack)
        self.shared = False


class RaceReport:
    def __init__(self, name: str, attr: str, prev, cur):
        self.name = name
        self.attr = attr
        self.prev_thread, self.prev_stack = prev
        self.cur_thread, self.cur_stack = cur

    def render(self) -> str:
        prev = "".join(traceback.format_list(self.prev_stack)) \
            if self.prev_stack else "  <no stack>\n"
        cur = "".join(traceback.format_list(self.cur_stack)) \
            if self.cur_stack else "  <no stack>\n"
        return (f"RACE on {self.name}.{self.attr}: no common lock "
                f"across writer threads\n"
                f"  previous write [{self.prev_thread}]:\n{prev}"
                f"  current write  [{self.cur_thread}]:\n{cur}")


class _Collector:
    def __init__(self):
        self._lock = _REAL_LOCK()
        self._vars: Dict[Tuple[int, str], _VarState] = {}
        self._races: List[RaceReport] = []
        self._seen: set = set()

    def note_write(self, obj, name: str, attr: str) -> None:
        if not enabled():
            return      # a tracked singleton outliving GSKY_TSAN=1
        tid = threading.get_ident()
        held = _held()
        stack = traceback.extract_stack(limit=_STACK_DEPTH)[:-3]
        key = (id(obj), attr)
        with self._lock:
            st = self._vars.get(key)
            if st is None:
                self._vars[key] = _VarState(tid, held, stack)
                return
            prev = st.last_write
            st.last_write = (tid, threading.current_thread().name,
                             stack)
            if tid == st.first_thread and not st.shared:
                return            # still thread-confined
            st.shared = True
            st.lockset = held if st.lockset is None \
                else (st.lockset & held)
            if st.lockset:
                return
            dedup = (name, attr)
            if dedup in self._seen:
                return
            self._seen.add(dedup)
            self._races.append(RaceReport(
                name, attr, (prev[1], prev[2]),
                (threading.current_thread().name, stack)))

    def races(self) -> List[RaceReport]:
        with self._lock:
            return list(self._races)

    def reset(self) -> None:
        with self._lock:
            self._vars.clear()
            self._races.clear()
            self._seen.clear()


_collector = _Collector()


def races() -> List[RaceReport]:
    return _collector.races()


def race_count() -> int:
    return len(_collector.races())


def report() -> str:
    rs = _collector.races()
    if not rs:
        return "tsan: no races detected"
    return "\n".join(r.render() for r in rs)


def reset() -> None:
    _collector.reset()


# -- attribute-write instrumentation ------------------------------------

_swizzled: Dict[type, type] = {}


def track(obj, name: Optional[str] = None) -> bool:
    """Start checking attribute writes on ``obj``.  Returns True when
    tracking is live.  Implemented by swizzling the instance onto a
    per-class subclass whose ``__setattr__`` notes the write — zero
    cost for untracked instances of the same class.  Classes with
    ``__slots__`` and no ``__dict__`` cannot be swizzled safely and
    are declined."""
    if not enabled():
        return False
    cls = type(obj)
    if cls in _swizzled.values():
        return True              # already a tracking subclass
    sub = _swizzled.get(cls)
    if sub is None:
        if not hasattr(obj, "__dict__"):
            return False
        label = name or cls.__name__

        def _setattr(self, attr, value,
                     _base=cls, _label=label):
            _collector.note_write(self, _label, attr)
            _base.__setattr__(self, attr, value)

        try:
            sub = type(cls.__name__, (cls,),
                       {"__setattr__": _setattr,
                        "__tsan_tracked__": True})
        except TypeError:
            return False
        _swizzled[cls] = sub
    try:
        object.__setattr__(obj, "__class__", sub)
    except TypeError:
        return False
    return True


# -- threading.Lock patch ----------------------------------------------

_installed = False


def install() -> bool:
    """Patch ``threading.Lock``/``RLock`` so locks created from here
    on participate in lockset tracking.  Idempotent."""
    global _installed
    if _installed:
        return True
    threading.Lock = lambda: TsanLock(rlock=False)    # type: ignore
    threading.RLock = lambda: TsanLock(rlock=True)    # type: ignore
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    threading.Lock = _REAL_LOCK                       # type: ignore
    threading.RLock = _REAL_RLOCK                     # type: ignore
    _installed = False


def maybe_install() -> bool:
    """install() iff GSKY_TSAN=1 — the one-liner boot hook."""
    if enabled():
        return install()
    return False


def installed() -> bool:
    return _installed


def tsan_stats() -> Dict:
    """The /debug ``tsan`` block and the gsky_tsan_races_total family
    (obs/metrics.py) read this; cheap when disabled."""
    with _collector._lock:
        tracked = len(_collector._vars)
        nraces = len(_collector._races)
    return {"enabled": enabled(), "installed": _installed,
            "tracked_vars": tracked, "races": nraces}
