"""Adaptive OOM monitor for the worker's decode subprocesses.

Counterpart of `gsky_tpu/worker/oom.py`, in the role of GSKY's
`worker/gdalprocess/oom_monitor.go`: poll ``/proc/meminfo`` at an
interval adapted to the memory fill rate (`getPollInterval`,
`oom_monitor.go:154-174`), and when available memory drops below the
threshold, SIGKILL the largest-RSS decode subprocess so the pool's
supervisor replaces it — a controlled casualty instead of a kernel
OOM-kill of the whole worker (`oom_monitor.go:176-234`).  The host's
``MemAvailable`` reader is the pressure monitor's
(`resilience.pressure.mem_available_bytes`).
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Callable, List, Optional

from ..resilience.pressure import mem_available_bytes

log = logging.getLogger("gsky.worker.oom")

MIN_POLL_S = 0.05
MAX_POLL_S = 2.0


def rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError):
        return 0
    return 0


class OOMMonitor:
    """Watches available memory; kills the biggest child below threshold."""

    def __init__(self, child_pids: Callable[[], List[int]],
                 threshold_bytes: int = 1536 << 20,
                 meminfo_path: str = "/proc/meminfo",
                 kill: Callable[[int], None] = None,
                 on_kill: Callable[[int], None] = None):
        self.child_pids = child_pids
        self.threshold = threshold_bytes
        self.meminfo_path = meminfo_path
        self.kill = kill or (lambda pid: os.kill(pid, signal.SIGKILL))
        # fired after a successful defensive kill: the server wires this
        # to the device supervisor (count the OOM) and the pressure
        # monitor (escalate + shed caches) so the whole node backs off,
        # not just the one replaced child
        self.on_kill = on_kill
        self.kills = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_avail: Optional[int] = None
        self._last_t = 0.0

    # -- polling cadence -----------------------------------------------------

    def poll_interval(self, avail: int) -> float:
        """Faster polling as memory fills faster and headroom shrinks
        (`oom_monitor.go:154-174`)."""
        now = time.monotonic()
        headroom = max(avail - self.threshold, 0)
        fill_rate = 0.0
        if self._last_avail is not None and now > self._last_t:
            fill_rate = (self._last_avail - avail) / (now - self._last_t)
        self._last_avail = avail
        self._last_t = now
        if fill_rate <= 0:
            return MAX_POLL_S
        # time until the threshold at the current fill rate, sampled 4x
        eta = headroom / fill_rate
        return min(max(eta / 4.0, MIN_POLL_S), MAX_POLL_S)

    # -- the check -----------------------------------------------------------

    def check_once(self) -> Optional[int]:
        """Returns the killed pid, if any."""
        avail = mem_available_bytes(self.meminfo_path)
        if avail is None or avail >= self.threshold:
            return None
        victims = [(rss_bytes(pid), pid) for pid in self.child_pids()]
        victims = [v for v in victims if v[0] > 0]
        if not victims:
            return None
        rss, pid = max(victims)
        log.warning("OOM defence: %d bytes available < %d threshold; "
                    "killing pid %d (rss %d)", avail, self.threshold, pid, rss)
        try:
            self.kill(pid)
        except OSError:
            return None
        self.kills += 1
        if self.on_kill is not None:
            try:
                self.on_kill(pid)
            except Exception:   # the defence must outlive its observers
                log.exception("on_kill callback failed")
        return pid

    def _run(self):
        while not self._stop.is_set():
            avail = mem_available_bytes(self.meminfo_path)
            if avail is not None and avail < self.threshold:
                self.check_once()
            interval = self.poll_interval(avail) if avail is not None \
                else MAX_POLL_S
            self._stop.wait(interval)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gsky-oom-monitor")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
