"""Predictive prefetch: warm scenes ahead of the next request.

Counterpart of `gsky_tpu/ingest/prefetch.py`: the same predictions,
keys, budget, TTL and outcomes, so one key stream scores the same hits,
misses and wasted entries in both packages.

The serving gateway sees strong short-horizon structure in its key
stream — a panning client walks adjacent bboxes at one zoom, a zooming
client halves the bbox in place, a WCS export scans tiles in row-major
order.  The `PrefetchPlanner` watches the resolved GetMap keys
(`server/ows.py` feeds it after admission), recognises those patterns,
and warms the scene cache / page pool for the *predicted* next keys on
a background worker, so the real request finds its scenes resident and
pays only the dispatch.

Discipline over enthusiasm:

* **pressure-aware** — any work is declined while
  `resilience.pressure.pressure_state()` ≥ 1 (prefetch must never push
  a browning-out process harder);
* **budgeted** — warmed bytes are capped per rolling minute by
  ``GSKY_PREFETCH_BUDGET_MB`` (default 256);
* **cancellable** — every warm runs under a `resilience.cancel` scope
  owned by the planner; `close()` cancels in-flight work;
* **honest accounting** — each real request scores against the ready
  set: prefetched-and-used is a *hit*, everything else a *miss*;
  ready entries that expire unused (``GSKY_PREFETCH_TTL_S``, default
  30 s) are *wasted*.  The three outcomes are counted in the ingest
  ledger (`ingest.stats`, ``prefetch``).

The planner knows nothing about layers or granules: the server
registers a ``warm_fn(layer, bbox, width, height, crs, time_s)``
callback that resolves granules and warms them (returning approximate
bytes warmed, for the budget).  A bound method is held weakly: the
planner never keeps the server that fed it (and that server's scene
cache and page pool) alive, and a server dropped unbinds itself; a
closed one lets go with `unbind`.  Tests register their own.  Knobs:
``GSKY_PREFETCH=0`` (off), ``GSKY_PREFETCH_BUDGET_MB``,
``GSKY_PREFETCH_TTL_S``; ``GSKY_INGEST=0`` turns it off too.
"""

from __future__ import annotations

import inspect
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from . import stats

WarmFn = Callable[..., Optional[int]]

# key: (layer, quantised bbox, width, height, crs, time_s)
Key = Tuple


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _quant(v: float) -> float:
    # match serving.quantise_bbox's spirit: float-noise-proof equality
    # for keys derived from independently-parsed query strings.  Nine
    # SIGNIFICANT digits, not decimal places: predicted bboxes are
    # built by float arithmetic (b1 + dx) and must collide with the
    # client's own coordinates at web-mercator magnitudes (~1e7, where
    # fixed decimal rounding absorbs no ulp noise at all) as well as in
    # degrees.
    return float(f"{float(v):.9g}")


def _qbbox(bbox) -> Tuple[float, float, float, float]:
    return (_quant(bbox[0]), _quant(bbox[1]),
            _quant(bbox[2]), _quant(bbox[3]))


class PrefetchPlanner:
    """Pan/zoom/scan-aware scene prefetcher (one worker thread)."""

    _HISTORY = 8          # per-session bbox history for pan detection
    _LOOKAHEAD = 2        # pan steps predicted per observation
    _QUEUE_MAX = 64

    def __init__(self, warm_fn: Optional[WarmFn] = None):
        from ..resilience.cancel import CancelToken
        self._warm_ref = None
        self.warm_fn = warm_fn
        self._lock = threading.Lock()
        self._pending: "OrderedDict[Key, Tuple]" = OrderedDict()
        self._ready: "OrderedDict[Key, float]" = OrderedDict()
        self._history: Dict[Tuple, Deque[Tuple[Key, Tuple]]] = {}
        self._popularity: Dict[str, int] = {}
        self._budget_window: Deque[Tuple[float, int]] = deque()
        self._token = CancelToken()
        self._wake = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        # counters (under _lock)
        self.predicted = 0
        self.warmed = 0
        self.warm_errors = 0
        self.declined_pressure = 0
        self.declined_budget = 0
        self.declined_disabled = 0

    # -- configuration (re-read per call: live-tunable) -----------------

    @staticmethod
    def _enabled() -> bool:
        from . import ingest_enabled
        return ingest_enabled() and \
            os.environ.get("GSKY_PREFETCH", "1") != "0"

    @staticmethod
    def _ttl() -> float:
        return _env_float("GSKY_PREFETCH_TTL_S", 30.0)

    @staticmethod
    def _budget_bytes() -> int:
        return int(_env_float("GSKY_PREFETCH_BUDGET_MB", 256.0) * (1 << 20))

    # -- observation + scoring -----------------------------------------

    def observe(self, layer: str, bbox, width: int, height: int,
                crs: str, time_s: Optional[float] = None) -> None:
        """Feed one real, admitted GetMap key: scores it against the
        ready set (hit/miss), learns the session pattern, and enqueues
        predictions.  Never raises; never blocks on warm work."""
        try:
            self._observe(layer, bbox, int(width), int(height),
                          str(crs), time_s)
        except Exception:  # prediction is advisory: never fail the request
            pass

    def _observe(self, layer, bbox, width, height, crs, time_s) -> None:
        qb = _qbbox(bbox)
        key: Key = (layer, qb, width, height, crs, time_s)
        now = time.monotonic()
        with self._lock:
            self._expire_locked(now)
            hit = self._find_near_locked(self._ready, key)
            if hit is not None:
                del self._ready[hit]
                stats.record_prefetch("hit")
            else:
                # in-flight predictions count as misses too: the
                # prefetch lost the race it exists to win
                stats.record_prefetch("miss")
            self._popularity[layer] = self._popularity.get(layer, 0) + 1
            sess = (layer, width, height, crs, time_s)
            hist = self._history.setdefault(
                sess, deque(maxlen=self._HISTORY))
            hist.append((key, qb))
            preds = self._predict_locked(sess, hist)
        if preds:
            self._enqueue(preds)

    def note_scan(self, layer: str, bboxes: List, width: int, height: int,
                  crs: str, time_s: Optional[float] = None) -> None:
        """WCS export scan-order hint: the export planner knows its
        upcoming tile grid exactly — no inference needed, just warm the
        next tiles in order."""
        preds: List[Key] = [
            (layer, _qbbox(b), int(width), int(height), str(crs), time_s)
            for b in bboxes[:self._QUEUE_MAX]]
        with self._lock:
            self.predicted += len(preds)
        self._enqueue(preds)

    def _predict_locked(self, sess, hist) -> List[Key]:
        """Pan continuation: when the last two bboxes of a session are
        one tile-step apart, the next steps along that vector are the
        best guess for a panning client.  Zoom-in: a bbox that shrank
        in place predicts the next halving around the same centre."""
        if len(hist) < 2:
            return []
        (_, b1), (_, b0) = hist[-1], hist[-2]
        layer, width, height, crs, time_s = sess
        w1, h1 = b1[2] - b1[0], b1[3] - b1[1]
        w0, h0 = b0[2] - b0[0], b0[3] - b0[1]
        preds: List[Key] = []
        if abs(w1 - w0) <= 1e-6 * max(abs(w1), abs(w0), 1e-12) and \
                abs(h1 - h0) <= 1e-6 * max(abs(h1), abs(h0), 1e-12):
            dx, dy = b1[0] - b0[0], b1[1] - b0[1]
            step_x, step_y = abs(dx) / max(abs(w1), 1e-12), \
                abs(dy) / max(abs(h1), 1e-12)
            # a pan step moves by ≤ ~2 tile extents on at least one axis
            if (dx or dy) and step_x <= 2.001 and step_y <= 2.001:
                bx = b1
                for _ in range(self._LOOKAHEAD):
                    bx = (bx[0] + dx, bx[1] + dy, bx[2] + dx, bx[3] + dy)
                    preds.append((layer, _qbbox(bx), width, height, crs,
                                  time_s))
        elif w0 > 0 and h0 > 0 and 0.4 < w1 / w0 < 0.6 \
                and 0.4 < h1 / h0 < 0.6:
            # zoom-in: predict the next halving centred where the
            # client is heading
            cx, cy = (b1[0] + b1[2]) / 2, (b1[1] + b1[3]) / 2
            nw, nh = w1 / 2, h1 / 2
            bz = (cx - nw / 2, cy - nh / 2, cx + nw / 2, cy + nh / 2)
            preds.append((layer, _qbbox(bz), width, height, crs, time_s))
        self.predicted += len(preds)
        return preds

    # -- key matching ---------------------------------------------------

    @staticmethod
    def _same_key(a: Key, b: Key) -> bool:
        """Float-noise-tolerant key equality.  Predicted bboxes are
        built by arithmetic on quantised client coordinates (b1 + dx,
        halvings), so they can land a few quanta away from the key the
        client actually sends; exact tuple equality would score nearly
        every correct prediction as a miss.  Tolerance is relative to
        the bbox extent — far below one tile step, far above ulp
        noise."""
        if a[0] != b[0] or a[2:] != b[2:]:
            return False
        qa, qb = a[1], b[1]
        ext = max(abs(qa[2] - qa[0]), abs(qa[3] - qa[1]), 1e-12)
        return all(abs(x - y) <= 1e-3 * ext for x, y in zip(qa, qb))

    def _find_near_locked(self, store, key: Key) -> Optional[Key]:
        """Exact dict hit, else a bounded scan (stores are capped at
        _QUEUE_MAX) for a noise-tolerant match."""
        if key in store:
            return key
        for k in store:
            if self._same_key(k, key):
                return k
        return None

    @property
    def warm_fn(self) -> Optional[WarmFn]:
        """The warm callback, or None (none bound, or its server gone)."""
        ref = self._warm_ref
        return ref() if ref is not None else None

    @warm_fn.setter
    def warm_fn(self, fn: Optional[WarmFn]) -> None:
        if fn is None:
            self._warm_ref = None
        elif inspect.ismethod(fn):
            self._warm_ref = weakref.WeakMethod(fn)
        else:
            self._warm_ref = lambda: fn

    def unbind(self, fn: WarmFn) -> None:
        """Drop the warm callback if it is ``fn`` (a closing server's)."""
        if self.warm_fn == fn:
            self.warm_fn = None

    # -- worker ---------------------------------------------------------

    def _enqueue(self, preds: List[Key]) -> None:
        if self.warm_fn is None or not self._enabled():
            with self._lock:
                self.declined_disabled += len(preds)
            return
        with self._lock:
            if self._closed:
                return
            for key in preds:
                if self._find_near_locked(self._pending, key) is not None \
                        or self._find_near_locked(self._ready,
                                                  key) is not None:
                    continue
                self._pending[key] = key
                while len(self._pending) > self._QUEUE_MAX:
                    self._pending.popitem(last=False)
            self._ensure_worker_locked()
        self._wake.set()

    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="gsky-prefetch", daemon=True)
            self._worker.start()

    def _run(self) -> None:
        from ..resilience.cancel import RequestCancelled, cancel_scope
        from ..resilience.pressure import pressure_state
        while True:
            self._wake.wait(timeout=1.0)
            with self._lock:
                if self._closed:
                    return
                self._expire_locked(time.monotonic())
                if not self._pending:
                    self._wake.clear()
                    continue
                key, _ = self._pending.popitem(last=False)
            if not self._enabled():
                with self._lock:
                    self.declined_disabled += 1
                continue
            if pressure_state() >= 1:
                # never push a browning-out process harder
                with self._lock:
                    self.declined_pressure += 1
                continue
            if self._over_budget():
                with self._lock:
                    self.declined_budget += 1
                continue
            warm = self.warm_fn
            if warm is None:
                with self._lock:
                    self.declined_disabled += 1
                continue
            layer, qb, width, height, crs, time_s = key
            warmed_bytes = 0
            try:
                with cancel_scope(self._token):
                    warmed_bytes = warm(
                        layer, qb, width, height, crs, time_s) or 0
            except RequestCancelled:
                return
            except Exception:
                with self._lock:
                    self.warm_errors += 1
                continue
            now = time.monotonic()
            with self._lock:
                self.warmed += 1
                self._budget_window.append((now, int(warmed_bytes)))
                self._ready[key] = now
                self._ready.move_to_end(key)

    def _over_budget(self) -> bool:
        cutoff = time.monotonic() - 60.0
        with self._lock:
            while self._budget_window and self._budget_window[0][0] < cutoff:
                self._budget_window.popleft()
            spent = sum(n for _, n in self._budget_window)
        return spent >= self._budget_bytes()

    def _expire_locked(self, now: float) -> None:
        ttl = self._ttl()
        dead = [k for k, t in self._ready.items() if now - t > ttl]
        for k in dead:
            del self._ready[k]
            stats.record_prefetch("wasted")

    # -- lifecycle / introspection --------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            led = stats.snapshot()["prefetch"]
            return {
                "enabled": self._enabled() and self.warm_fn is not None,
                "predicted": self.predicted,
                "warmed": self.warmed,
                "warm_errors": self.warm_errors,
                "pending": len(self._pending),
                "ready": len(self._ready),
                "hit": led["hit"], "miss": led["miss"],
                "wasted": led["wasted"],
                "declined_pressure": self.declined_pressure,
                "declined_budget": self.declined_budget,
                "declined_disabled": self.declined_disabled,
            }

    def close(self) -> None:
        """Cancel in-flight warms and stop the worker."""
        with self._lock:
            self._closed = True
        self._token.cancel("planner closed")
        self._wake.set()
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout=2.0)

    def reset(self) -> None:
        """Test hook: drop learned state + counters (worker survives)."""
        with self._lock:
            self._pending.clear()
            self._ready.clear()
            self._history.clear()
            self._popularity.clear()
            self._budget_window.clear()
            self.predicted = self.warmed = self.warm_errors = 0
            self.declined_pressure = self.declined_budget = 0
            self.declined_disabled = 0


_default: Optional[PrefetchPlanner] = None
_default_lock = threading.Lock()


def default_planner() -> PrefetchPlanner:
    global _default
    with _default_lock:
        if _default is None:
            _default = PrefetchPlanner()
        return _default


def unbind(fn: WarmFn) -> None:
    """Let the process-wide planner (if any) drop ``fn``."""
    with _default_lock:
        planner = _default
    if planner is not None:
        planner.unbind(fn)


def reset_default_planner() -> None:
    global _default
    with _default_lock:
        old, _default = _default, None
    if old is not None:
        old.close()
