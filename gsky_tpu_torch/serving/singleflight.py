"""In-flight deduplication of identical requests (single-flight), over
threads.

Counterpart of `gsky_tpu/serving/singleflight.py`, whose server is
asynchronous; the port's is the standard library's threaded one, a
thread a connection.  When N identical requests arrive while the first
still renders, one thread (the leader) runs the render; the others wait
on a `concurrent.futures.Future` and get its result, or the same
exception: a failing render fails every waiter once instead of running
N times.  Flights are keyed like the response cache, so the window
deduplicated is the cache's miss window; a finished flight is
forgotten at once.

There is no cancellation: the standard library's server cannot see a
client go away, so a leader always renders to the end.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Any, Callable, Dict, Tuple


class SingleFlight:
    """``flight.do(key, fn) -> (result, joined)``: one thread per key at
    a time runs ``fn``; a thread that arrives while it runs gets its
    result (``joined=True``) or its exception."""

    def __init__(self):
        self._lock = threading.Lock()
        self._calls: Dict[str, cf.Future] = {}
        self.leaders = 0
        self.joined = 0

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._calls)

    def do(self, key: str, fn: Callable[[], Any]) -> Tuple[Any, bool]:
        with self._lock:
            fut = self._calls.get(key)
            lead = fut is None
            if lead:
                fut = self._calls[key] = cf.Future()
                self.leaders += 1
            else:
                self.joined += 1
        if not lead:
            return fut.result(), True
        try:
            result = fn()
        except BaseException as e:
            with self._lock:
                self._calls.pop(key, None)
            fut.set_exception(e)
            raise
        with self._lock:
            self._calls.pop(key, None)
        fut.set_result(result)
        return result, False
