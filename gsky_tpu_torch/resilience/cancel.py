"""Request-scoped cooperative cancellation.

Counterpart of `gsky_tpu/resilience/cancel.py`.  A client that went
away, or a request past its deadline, would otherwise hold decode
threads, admission permits, wave lanes, page pins and encode time until
its render finished: a worker thread cannot be interrupted.  The
`CancelToken` closes that gap as the deadline does.  It rides a
`contextvars.ContextVar` into worker threads (submitted under a copy of
the context; the token object is shared), and every costly stage checks
it:

    gateway admission queue   (serving/admission.py)
    tile stage boundaries     (pipeline/tile_stages.py)
    wave assembly and launch  (pipeline/waves.py)
    batcher flush waits       (pipeline/batcher.py)
    export planner loops      (pipeline/export.py, via on_cancel)
    encode                    (io/png.py)

The OWS handler fires the token when its client disconnects or its
deadline passes; the abandoned work unwinds at its next check.

`RequestCancelled` subclasses ``asyncio.CancelledError``, as in the
reference: it is a ``BaseException``, so it unwinds through ``except
Exception`` ladders (no accidental 500, no degraded fallback swallowing
it); the handler maps it explicitly.

A token may carry a ``probe``: a cheap callable, run by `check` at most
once per ``probe_every`` seconds, that returns a reason when the token
should fire (the threaded server's client-disconnect test; the
reference learns of a disconnect from its event loop instead).
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import threading
import time
from typing import Callable, Dict, Optional


class RequestCancelled(asyncio.CancelledError):
    """The request's cancel token fired; abandon its work."""

    def __init__(self, reason: str = "cancelled", stage: str = ""):
        super().__init__(f"request cancelled ({reason})"
                         + (f" at stage {stage}" if stage else ""))
        self.reason = reason
        self.stage = stage


# process-wide cancellation counts per stage
_counts_lock = threading.Lock()
_counts: Dict[str, int] = {}
_fired = 0


def _count(stage: str) -> None:
    with _counts_lock:
        _counts[stage] = _counts.get(stage, 0) + 1


def cancel_stats() -> Dict:
    with _counts_lock:
        return {"fired": _fired, "stages": dict(_counts)}


def reset_cancel_stats() -> None:
    global _fired
    with _counts_lock:
        _counts.clear()
        _fired = 0


class CancelToken:
    """One token per request; fires once, its callbacks run when it
    fires.  ``cancel`` may come from another thread while workers are in
    ``check``: state is under a plain lock and callbacks never run
    under it."""

    __slots__ = ("_lock", "_cancelled", "reason", "_callbacks", "probe",
                 "probe_every", "_probed_at")

    def __init__(self, probe: Optional[Callable[[], Optional[str]]] = None,
                 probe_every: float = 0.05) -> None:
        self._lock = threading.Lock()
        self._cancelled = False
        self.reason = ""
        self._callbacks: list = []
        self.probe = probe
        self.probe_every = float(probe_every)
        self._probed_at = -1e9

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self, reason: str = "cancelled") -> bool:
        """Fire the token (idempotent); True on the first call.  Each
        registered callback runs once, outside the lock; one that raises
        does not keep the others from running."""
        global _fired
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            self.reason = reason
            cbs, self._callbacks = self._callbacks, []
        with _counts_lock:
            _fired += 1
        for cb in cbs:
            try:
                cb()
            except Exception:  # one failing cancel callback must not block the rest
                pass
        return True

    def on_cancel(self, cb: Callable[[], None]) -> Callable[[], None]:
        """Run ``cb`` when the token fires, or now when it has.  Returns
        a remover (idempotent) for a stage whose cancellable window
        closes."""
        run_now = False
        with self._lock:
            if self._cancelled:
                run_now = True
            else:
                self._callbacks.append(cb)
        if run_now:
            try:
                cb()
            except Exception:  # callback failure must not mask the cancellation
                pass
            return lambda: None

        def _remove() -> None:
            with self._lock:
                try:
                    self._callbacks.remove(cb)
                except ValueError:
                    pass
        return _remove

    def _run_probe(self) -> None:
        now = time.monotonic()
        if now - self._probed_at < self.probe_every:
            return
        self._probed_at = now
        try:
            reason = self.probe()
        except Exception:  # a probe that fails says nothing
            reason = None
        if reason:
            self.cancel(reason)

    def check(self, stage: str) -> None:
        """Raise `RequestCancelled` (and count the stage) when the token
        has fired; a no-op otherwise."""
        if not self._cancelled and self.probe is not None:
            self._run_probe()
        if self._cancelled:
            _count(stage)
            raise RequestCancelled(self.reason or "cancelled", stage)


_current: contextvars.ContextVar[Optional[CancelToken]] = \
    contextvars.ContextVar("gsky_torch_cancel", default=None)


def current_token() -> Optional[CancelToken]:
    return _current.get()


@contextlib.contextmanager
def cancel_scope(token: Optional[CancelToken] = None):
    """Make ``token`` (or a fresh one) the request's current token."""
    tok = token or CancelToken()
    ctx_token = _current.set(tok)
    try:
        yield tok
    finally:
        _current.reset(ctx_token)


def check_cancel(stage: str) -> None:
    """Check the current token, if any: the one line every stage calls
    at its boundary.  Outside a request scope it is a no-op."""
    tok = _current.get()
    if tok is not None:
        tok.check(stage)
