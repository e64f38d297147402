"""Request-scoped tracing over a ContextVar.

Counterpart of `gsky_tpu/obs/trace.py`.  A trace is born at the OWS
request boundary (``start_trace``) and carried implicitly wherever the
request's context goes: the server's render thread runs under a copy of
it (`server.ows._bounded`), as do an animation's frame workers.  Raw
threads and long-lived pools start from an empty context, so the
request re-binds it there (``bind``, ``contextvars.Context.run``).
``traceparent`` / ``trace_metadata`` / ``remote_trace`` /
``adopt_spans`` are the wire form and the stitching of a trace that
crosses into another process (the remote workers' hop, ROADMAP A.10).

Overhead discipline: ``span()`` costs one ContextVar read when no trace
is active, and ``GSKY_TRACE=0`` (read once per request) means no trace
is ever activated.  Span bodies never raise out of the
instrumentation: a broken sink must not fail a render.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# (trace, current span id); None when the code path is untraced.
_CURRENT: contextvars.ContextVar[Optional[Tuple["Trace", str]]] = \
    contextvars.ContextVar("gsky_trace", default=None)

_ID_LOCK = threading.Lock()
_ID_STATE = [int.from_bytes(os.urandom(8), "big")]


def _new_id() -> str:
    # os.urandom per span is measurable on the hot path; a counter
    # seeded once from the OS is unique enough for correlation ids.
    with _ID_LOCK:
        _ID_STATE[0] = (_ID_STATE[0] + 0x9E3779B97F4A7C15) & (2 ** 64 - 1)
        x = _ID_STATE[0]
    # xorshift-style mix so consecutive ids don't share prefixes
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x ^= x >> 27
    return format(x, "016x")


def trace_enabled() -> bool:
    """Master switch, read per request: ``GSKY_TRACE=0`` disables."""
    return os.environ.get("GSKY_TRACE", "1").lower() not in (
        "0", "false", "no", "off")


class Span:
    """One timed operation inside a trace.  Mutable while open; the
    instrumented code may attach attributes (``set``) and point events
    (``event``) through the handle yielded by ``span()``."""

    __slots__ = ("span_id", "parent_id", "name", "process", "t0",
                 "dur_s", "attrs", "events", "_pc0")

    def __init__(self, span_id: str, parent_id: Optional[str], name: str,
                 process: str, attrs: Optional[Dict[str, Any]] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.process = process
        self.t0 = time.time()
        self._pc0 = time.perf_counter()
        self.dur_s: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Dict[str, Any]] = []

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **attrs) -> None:
        ev: Dict[str, Any] = {"name": name, "t": time.time()}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def close(self) -> None:
        if self.dur_s is None:
            self.dur_s = time.perf_counter() - self._pc0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "span_id": self.span_id, "parent_id": self.parent_id,
            "name": self.name, "process": self.process,
            "t0": self.t0, "dur_s": self.dur_s}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = self.events
        return d


class _NullSpan:
    """Shared no-op handle yielded when no trace is active."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def event(self, name: str, **attrs) -> None:
        pass


_NULL = _NullSpan()


class Trace:
    """A collection of spans sharing one ``trace_id``.  Thread-safe:
    stage threads and RPC fanout workers append concurrently."""

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None, process: str = "gateway",
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id or _new_id()
        self.process = process
        self.root = Span(_new_id(), parent_id, name, process, attrs)
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._open: Dict[str, Span] = {}           # open child spans by id
        self._foreign: List[Dict[str, Any]] = []   # adopted remote spans
        self.status: Optional[int] = None
        self.degraded: List[str] = []

    # -- recording ----------------------------------------------------
    def add(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)

    def adopt(self, span_dicts: Sequence[Dict[str, Any]]) -> None:
        """Merge spans exported by another process (same trace_id)."""
        with self._lock:
            self._foreign.extend(dict(d) for d in span_dicts)

    # -- export -------------------------------------------------------
    def span_dicts(self) -> List[Dict[str, Any]]:
        """All spans including the root, start-ordered."""
        self.root.close()
        with self._lock:
            out = [self.root.to_dict()]
            out.extend(s.to_dict() for s in self._spans)
            out.extend(self._foreign)
        out.sort(key=lambda d: d.get("t0") or 0.0)
        return out

    def to_dict(self) -> Dict[str, Any]:
        self.root.close()
        return {
            "trace_id": self.trace_id,
            "name": self.root.name,
            "t0": self.root.t0,
            "dur_s": self.root.dur_s,
            "status": self.status,
            "degraded": list(self.degraded),
            "attrs": dict(self.root.attrs),
            "spans": self.span_dicts(),
        }


# ---------------------------------------------------------------------------
# context accessors

def current_context() -> Optional[Tuple[Trace, str]]:
    return _CURRENT.get()


def current_trace() -> Optional[Trace]:
    cur = _CURRENT.get()
    return cur[0] if cur is not None else None


def current_trace_id() -> Optional[str]:
    cur = _CURRENT.get()
    return cur[0].trace_id if cur is not None else None


def current_span_id() -> Optional[str]:
    cur = _CURRENT.get()
    return cur[1] if cur is not None else None


def traceparent() -> Optional[str]:
    """``trace_id-span_id`` wire form for the gRPC metadata hop."""
    cur = _CURRENT.get()
    if cur is None:
        return None
    return f"{cur[0].trace_id}-{cur[1]}"


# the gRPC metadata key that carries `traceparent` to a worker node
TRACE_METADATA_KEY = "x-gsky-trace"


def trace_metadata() -> Optional[Tuple[Tuple[str, str], ...]]:
    """The worker RPC's metadata for the current trace, None untraced."""
    tp = traceparent()
    return ((TRACE_METADATA_KEY, tp),) if tp else None


def set_attr(**attrs) -> None:
    """Attach attributes to the innermost open span (root if no child
    is open).  No-op when untraced."""
    cur = _CURRENT.get()
    if cur is None:
        return
    trace, span_id = cur
    if span_id == trace.root.span_id:
        trace.root.attrs.update(attrs)
        return
    with trace._lock:
        sp = trace._open.get(span_id)
        if sp is None:
            for cand in reversed(trace._spans):
                if cand.span_id == span_id:
                    sp = cand
                    break
    if sp is not None:
        sp.attrs.update(attrs)
        return
    trace.root.attrs.update(attrs)


def event(name: str, **attrs) -> None:
    """Record a point event on the trace root (retry, breaker-open,
    hedge fired, reroute...).  Events on the root rather than the
    innermost span so cross-cutting layers (resilience, fleet) need no
    span handle.  No-op when untraced."""
    cur = _CURRENT.get()
    if cur is None:
        return
    try:
        cur[0].root.event(name, **attrs)
    except Exception:  # tracing must never fail the traced request
        pass


# ---------------------------------------------------------------------------
# span lifecycle

@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Any]:
    """Open a child span of the current context.  Yields the ``Span``
    (or a shared no-op handle when untraced) so callers can ``.set()``
    attributes discovered mid-flight."""
    cur = _CURRENT.get()
    if cur is None:
        yield _NULL
        return
    trace, parent = cur
    sp = Span(_new_id(), parent, name, trace.process, attrs or None)
    with trace._lock:
        trace._open[sp.span_id] = sp
    tok = _CURRENT.set((trace, sp.span_id))
    try:
        yield sp
    except BaseException as exc:
        sp.attrs.setdefault("error", type(exc).__name__)
        raise
    finally:
        _CURRENT.reset(tok)
        sp.close()
        with trace._lock:
            trace._open.pop(sp.span_id, None)
            trace._spans.append(sp)


def record_span(name: str, dur_s: float, t0: Optional[float] = None,
                **attrs) -> None:
    """Add an already-measured interval as a closed child span of the
    current context — for seams that time themselves (stage gates,
    admission waits) where wrapping the code in ``span()`` would
    double-clock it.  No-op when untraced."""
    cur = _CURRENT.get()
    if cur is None:
        return
    trace, parent = cur
    try:
        sp = Span(_new_id(), parent, name, trace.process, attrs or None)
        sp.t0 = float(t0) if t0 is not None else time.time() - float(dur_s)
        sp.dur_s = float(dur_s)
        trace.add(sp)
    except Exception:  # tracing must never fail the traced request
        pass


@contextlib.contextmanager
def start_trace(name: str, process: str = "gateway",
                **attrs) -> Iterator[Optional[Trace]]:
    """Create a new trace rooted at ``name`` and activate it for the
    enclosed block.  Yields the ``Trace`` (None when ``GSKY_TRACE=0``).
    On exit the completed trace is handed to the flight recorder."""
    if not trace_enabled():
        yield None
        return
    trace = Trace(name, process=process, attrs=attrs or None)
    tok = _CURRENT.set((trace, trace.root.span_id))
    try:
        yield trace
    except BaseException as exc:
        trace.root.attrs.setdefault("error", type(exc).__name__)
        raise
    finally:
        _CURRENT.reset(tok)
        trace.root.close()
        try:
            from .recorder import default_recorder
            default_recorder().record(trace.to_dict())
        except Exception:  # recorder handoff is best-effort telemetry
            pass


@contextlib.contextmanager
def bind(ctx: Optional[Tuple[Trace, str]]) -> Iterator[None]:
    """Re-establish a captured context inside a raw thread (stage
    threads and executor pools start from an empty Context).  Pass the
    result of ``current_context()`` captured on the submitting side."""
    if ctx is None:
        yield
        return
    tok = _CURRENT.set(ctx)
    try:
        yield
    finally:
        _CURRENT.reset(tok)


@contextlib.contextmanager
def remote_trace(header: Optional[str], name: str,
                 process: str = "worker", **attrs) -> Iterator[Optional[Trace]]:
    """Worker-side continuation of a propagated context.  ``header`` is
    the ``traceparent()`` wire form from gRPC metadata; the new local
    root becomes a child of the caller's RPC span.  The collected spans
    (``trace.span_dicts()``) are shipped back on the RPC result rather
    than recorded locally."""
    if not header:
        yield None
        return
    try:
        tid, _, sid = header.partition("-")
        if not tid or not sid:
            yield None
            return
    except Exception:
        yield None
        return
    trace = Trace(name, trace_id=tid, parent_id=sid, process=process,
                  attrs=attrs or None)
    tok = _CURRENT.set((trace, trace.root.span_id))
    try:
        yield trace
    except BaseException as exc:
        trace.root.attrs.setdefault("error", type(exc).__name__)
        raise
    finally:
        _CURRENT.reset(tok)
        trace.root.close()


def adopt_spans(span_dicts: Optional[Sequence[Dict[str, Any]]]) -> None:
    """Stitch spans returned by a worker into the live trace."""
    if not span_dicts:
        return
    cur = _CURRENT.get()
    if cur is None:
        return
    try:
        cur[0].adopt(span_dicts)
    except Exception:  # adopted remote spans are advisory
        pass
