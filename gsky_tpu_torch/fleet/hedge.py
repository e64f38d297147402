"""Hedged dispatch: duplicate a straggling task, take the first result.

Counterpart of `gsky_tpu/fleet/hedge.py`.

The tail-at-scale defence (Dean & Barroso): after waiting an *adaptive*
delay — tracking the observed p99 of recent task latencies — a task
that has not finished is duplicated onto the next node in its ring
preference order, and whichever copy finishes first wins; the loser is
cancelled so its slot frees immediately.  Because the delay tracks the
p99, roughly 1% of tasks hedge under steady state — and a *budget*
bounds it hard: hedges spend from a token pool refilled at
``budget`` tokens per primary dispatch (default 0.1 → hedging can never
add more than ~10% fleet load, no matter how sick the tail gets).

The mechanics are future-agnostic: anything with ``done()``,
``cancel()``, ``result()`` and ``add_done_callback(fn)`` works — gRPC
call futures and ``concurrent.futures.Future`` both qualify.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple


class HedgePolicy:
    """Adaptive hedge delay + token-bucket hedge budget."""

    def __init__(self, percentile: float = 0.99,
                 min_delay_s: float = 0.05, max_delay_s: float = 5.0,
                 initial_delay_s: float = 1.0, budget: float = 0.1,
                 window: int = 256, min_samples: int = 20):
        self.percentile = float(percentile)
        self.min_delay_s = float(min_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.initial_delay_s = float(initial_delay_s)
        self.budget = float(budget)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        self._lat: List[float] = []
        self._i = 0
        self._n = 0
        # token bucket, capped so an idle hour can't bank a hedge storm
        self._tokens = 1.0
        self._token_cap = max(10.0, 1.0)
        # counters (read by /debug)
        self.primaries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.hedges_denied = 0

    def observe(self, latency_s: float) -> None:
        """Feed one completed-task latency into the rolling window."""
        with self._lock:
            if len(self._lat) < self.window:
                self._lat.append(latency_s)
            else:
                self._lat[self._i] = latency_s
                self._i = (self._i + 1) % self.window
            self._n += 1

    def delay_s(self) -> float:
        """Current hedge delay: the windowed p-th percentile latency,
        clamped; the configured initial delay until enough samples."""
        with self._lock:
            lat = list(self._lat)
        if len(lat) < self.min_samples:
            d = self.initial_delay_s
        else:
            lat.sort()
            d = lat[min(int(len(lat) * self.percentile), len(lat) - 1)]
        return min(max(d, self.min_delay_s), self.max_delay_s)

    def on_primary(self) -> None:
        """A primary dispatch earns ``budget`` hedge tokens."""
        with self._lock:
            self.primaries += 1
            self._tokens = min(self._tokens + self.budget,
                               self._token_cap)

    def try_hedge(self) -> bool:
        """Spend one hedge token; False when the budget is exhausted."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.hedges += 1
                return True
            self.hedges_denied += 1
            return False

    def record_win(self) -> None:
        with self._lock:
            self.hedge_wins += 1

    def stats(self) -> dict:
        with self._lock:
            return {"primaries": self.primaries, "hedges": self.hedges,
                    "hedge_wins": self.hedge_wins,
                    "hedges_denied": self.hedges_denied,
                    "budget": self.budget,
                    "tokens": round(self._tokens, 2),
                    "window": len(self._lat)}
        # delay_s() takes the lock itself; callers add it separately


def hedged_call(primary: Callable[[], object],
                hedge: Optional[Callable[[], object]],
                delay_s: float,
                timeout_s: float,
                on_hedge_cancelled: Optional[Callable[[], None]] = None,
                ) -> Tuple[object, bool]:
    """Run ``primary()`` (returns a future); if it has not completed
    after ``delay_s``, launch ``hedge()`` and return whichever future
    finishes first — ``(result, hedge_won)`` — cancelling the loser.

    ``hedge`` is only invoked past the delay (never eagerly), so a
    fast primary costs exactly one dispatch.  ``on_hedge_cancelled``
    fires after the losing hedge is cancelled, letting the caller free
    whatever permit the hedge dispatch consumed.  If the *winner*
    failed, the other future's result is taken when available; both
    failing raises the primary's error.
    """
    done = threading.Event()
    fut1 = primary()
    fut1.add_done_callback(lambda f: done.set())
    if not done.wait(delay_s) and hedge is not None:
        fut2 = None
        try:
            fut2 = hedge()
        except Exception:
            fut2 = None          # hedge dispatch itself failed: ignore
        if fut2 is not None:
            fut2.add_done_callback(lambda f: done.set())
            t_end = time.monotonic() + max(timeout_s, 0.0)
            winner = None
            while winner is None:
                if fut1.done():
                    winner, loser, hedge_won = fut1, fut2, False
                elif fut2.done():
                    winner, loser, hedge_won = fut2, fut1, True
                elif not done.wait(max(t_end - time.monotonic(), 0.01)):
                    winner, loser, hedge_won = fut1, fut2, False
                done.clear()
            # a winner that ERRORED forfeits to a loser that can still
            # answer (or already has)
            try:
                res = winner.result()
            except Exception:
                try:
                    res = loser.result(timeout=max(
                        t_end - time.monotonic(), 0.01))
                    hedge_won = not hedge_won
                    winner, loser = loser, winner
                except Exception:
                    loser.cancel()
                    if loser is fut2 and on_hedge_cancelled is not None:
                        on_hedge_cancelled()
                    raise
            loser.cancel()
            if loser is fut2 and on_hedge_cancelled is not None:
                on_hedge_cancelled()
            return res, hedge_won
    return fut1.result(), False
