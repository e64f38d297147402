"""Deterministic fault injection.

Counterpart of `gsky_tpu/resilience/faults.py`, with the same spec, the
same kinds and the same per-site draws: a (spec, seed) pair replays the
fault sequence the reference replays.  The sites wired in the port are
``mas`` (in front of both MAS client transports, `index/client.py`),
``decode`` (the window decode, `pipeline/decode.py`, and the scene
load, `pipeline/scene_cache.py`), ``device`` (inside the device
guard's watchdog, `device_guard.supervised_sync`, where the device
kinds ``crash``, ``oom`` and ``hang`` fire, and its guarded readbacks,
which ``corrupt`` poisons), ``worker`` (each RPC attempt of the worker
client, `worker/client.py`), ``pool`` (the decode pool's dispatch to a
subprocess, `worker/pool.py`) and ``node`` (the worker node's RPC
entry, `worker/server.py`).  A worker node installs the preemption
handler (`set_preempt_handler`): a ``node:preempt:<grace>`` rule starts
its drain and warm journal hand-off (`fleet.elastic`), at most once a
process.

Faults are described by a compact spec, normally supplied via the
``GSKY_FAULTS`` environment variable::

    GSKY_FAULTS="mas:error:0.2,worker:latency:500ms,decode:error:0.05"

Each comma-separated clause is ``site:kind:arg``:

``site``
    the name a call site passes to :func:`inject` — the wired sites are
    ``mas`` (index client transport), ``worker`` (worker RPC call),
    ``decode`` (granule window decode + scene-cache load), ``pool``
    (decode subprocess dispatch) and ``node`` (worker-node RPC entry:
    whole-process faults for fleet chaos).
``error:RATE``
    raise :class:`InjectedFault` with probability ``RATE`` (0..1).
``latency:DURATION[:RATE]``
    sleep ``DURATION`` (``500ms``, ``2s``, or bare seconds) with
    probability ``RATE`` (default 1.0) before the real call proceeds.
``slow:DURATION[:RATE]``
    alias of ``latency`` — reads better in node-level chaos specs
    (``node:slow:2s:0.5`` = a degraded node, not a degraded call).
``hang:DURATION[:RATE]``
    sleep ``DURATION`` *without* raising — simulates a wedged node that
    holds the RPC open until the caller's deadline (or a hedge) fires.
``kill:RATE``
    ``os._exit`` the whole process with probability ``RATE`` — the
    worker node dies mid-RPC exactly the way SIGKILL would take it.
``crash:RATE``
    raise :class:`InjectedDeviceFault` with an ``INTERNAL:`` status
    message — the shape a device runtime crash presents.  The device-guard classifier matches the *message*, not
    the type, so the injection rides the real supervisor path
    (suspect -> reinitialize -> warm rehydrate).
``oom:RATE``
    raise :class:`InjectedDeviceFault` with a ``RESOURCE_EXHAUSTED:``
    status message — exercises the guard's trim + escalate + retry
    protocol.
``corrupt:RATE``
    no raise; callers that produce data query :func:`flag` and poison
    their own output — exercises the readback integrity probe and the
    ``GSKY_POOL_AUDIT`` quarantine.  The wired site is ``device``
    (``device_guard.guarded_readback``).
``preempt:GRACE[:RATE]``
    deliver a preemption *notice* with a ``GRACE`` window (``10s``)
    with probability ``RATE`` (default 1.0) — fires at most once per
    process, through the handler installed with
    :func:`set_preempt_handler` (the worker server registers one that
    runs the drain and the warm journal hand-off under the grace
    deadline, `fleet.elastic`).  The current call proceeds normally: a
    graceful preemption finishes admitted work.
``preempt_nograce:RATE``
    a preemption with zero grace — the handler gets ``grace_s=0`` and
    is expected to flush the page journal and exit immediately.  With
    no handler registered this degrades to ``kill`` semantics.

Outcomes are drawn from a per-site ``random.Random`` seeded from
``GSKY_FAULTS_SEED`` (default 0) xor a CRC of the site name, so a given
(spec, seed) pair replays the exact same fault sequence — tests and the
chaos soak are reproducible.

When no spec is configured the module global ``_PLAN`` is ``None`` and
:func:`inject` returns after a single attribute load + ``is None``
check: zero measurable overhead on the serving path.
"""
from __future__ import annotations

import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional


class InjectedFault(ConnectionError):
    """A synthetic transport failure.

    Subclasses ``ConnectionError`` deliberately: injected faults ride the
    exact same recovery paths as real transport failures — the worker
    pool's ``except (ConnectionError, OSError)`` kill-and-retry clause,
    and the retry policy's retryable classification — with no
    test-only except branches anywhere.
    """

    retryable = True

    def __init__(self, site: str, kind: str = "error"):
        super().__init__(f"injected {kind} fault at {site!r}")
        self.site = site


class InjectedDeviceFault(RuntimeError):
    """A synthetic device-runtime failure (kinds ``crash`` / ``oom``).

    Its message carries the status strings (``INTERNAL:`` /
    ``RESOURCE_EXHAUSTED:``) a device guard classifies on, so an
    injected incident takes the path a real runtime error would.
    """

    retryable = True

    def __init__(self, site: str, kind: str):
        status = ("RESOURCE_EXHAUSTED" if kind == "oom" else "INTERNAL")
        super().__init__(
            f"{status}: injected device {kind} fault at {site!r}")
        self.site = site
        self.kind = kind


class _Rule:
    __slots__ = ("kind", "rate", "latency_s", "fired")

    def __init__(self, kind: str, rate: float, latency_s: float = 0.0):
        self.kind = kind
        self.rate = rate
        self.latency_s = latency_s
        # preempt kinds are one-shot per process: a spot reclaim is a
        # single notice, not a fault rolled on every RPC
        self.fired = False


class _SiteState:
    __slots__ = ("rules", "rng", "lock")

    def __init__(self, rules: List[_Rule], rng: random.Random):
        self.rules = rules
        self.rng = rng
        self.lock = threading.Lock()


def _duration(s: str) -> float:
    s = s.strip().lower()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


def parse_spec(spec: str) -> Dict[str, List[_Rule]]:
    """Parse a fault spec into ``{site: [rules]}``; raises ValueError."""
    out: Dict[str, List[_Rule]] = {}
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) < 3:
            raise ValueError(f"bad fault clause {clause!r} "
                             "(want site:kind:arg)")
        site, kind = parts[0].strip(), parts[1].strip()
        if kind in ("error", "kill", "crash", "oom", "corrupt",
                    "preempt_nograce"):
            rule = _Rule(kind, float(parts[2]))
        elif kind in ("latency", "slow", "hang", "preempt"):
            rate = float(parts[3]) if len(parts) > 3 else 1.0
            rule = _Rule(kind, rate, _duration(parts[2]))
        else:
            raise ValueError(f"unknown fault kind {kind!r} in {clause!r}")
        if not 0.0 <= rule.rate <= 1.0:
            raise ValueError(f"rate out of range in {clause!r}")
        out.setdefault(site, []).append(rule)
    return out


def site_rng(site: str, seed: int) -> random.Random:
    """The per-site RNG used for a given seed (exposed for tests)."""
    return random.Random(seed ^ zlib.crc32(site.encode()))


# None when no faults are configured -> inject() is a no-op
_PLAN: Optional[Dict[str, _SiteState]] = None

# GSKY_FAULTS is folded in lazily, on the first inject()/flag()/
# active() call, not at import: a module-level os.environ read latches
# the value before tests or a reload can change it.  An explicit
# configure() supersedes the environment.
_env_folded = False
_env_lock = threading.Lock()


def _ensure_configured() -> None:
    global _env_folded
    if _env_folded:
        return
    with _env_lock:
        if _env_folded:
            return
        spec = os.environ.get("GSKY_FAULTS") or None
        seed = int(os.environ.get("GSKY_FAULTS_SEED", "0") or "0")
        if spec:
            configure(spec, seed)
        _env_folded = True


def configure(spec: Optional[str], seed: int = 0) -> None:
    """Install (or clear, with a falsy spec) the active fault plan."""
    global _PLAN, _env_folded
    _env_folded = True
    if not spec:
        _PLAN = None
        return
    rules = parse_spec(spec)
    _PLAN = {site: _SiteState(rs, site_rng(site, seed))
             for site, rs in rules.items()}


def reset() -> None:
    """Clear the plan and fold GSKY_FAULTS in again at the next call."""
    global _env_folded
    configure(None)
    _env_folded = False


# -- preemption notices -------------------------------------------------------

# fn(grace_s: float, graceful: bool) -> None; must return quickly
_PREEMPT_HANDLER = None
_preempt_lock = threading.Lock()


def set_preempt_handler(fn) -> None:
    """Install the process's preemption handler (last writer wins; pass
    ``None`` to clear), so that a ``node:preempt:<grace>`` fault takes
    the node's own drain path."""
    global _PREEMPT_HANDLER
    with _preempt_lock:
        _PREEMPT_HANDLER = fn


def _deliver_preempt(site: str, grace_s: float, graceful: bool) -> None:
    from .registry import registry
    registry.count_fault(site)
    with _preempt_lock:
        handler = _PREEMPT_HANDLER
    if handler is not None:
        try:
            handler(grace_s, graceful)
        except Exception:  # a broken handler must not fail the RPC
            pass
        return
    if not graceful:
        # no handler to flush state: zero grace degrades to SIGKILL
        os._exit(137)


def active() -> bool:
    _ensure_configured()
    return _PLAN is not None


def inject(site: str) -> None:
    """Apply any configured faults for ``site``.

    May sleep (latency fault) and/or raise :class:`InjectedFault`.
    With no plan configured this is a bool check plus an ``is None``
    check.
    """
    _ensure_configured()
    plan = _PLAN
    if plan is None:
        return
    st = plan.get(site)
    if st is None:
        return
    delay = 0.0
    die = False
    preempt = None   # (grace_s, graceful)
    boom: Optional[Exception] = None
    with st.lock:
        for rule in st.rules:
            if rule.kind == "corrupt":
                continue    # data-poisoning rules fire via flag()
            if rule.kind in ("preempt", "preempt_nograce"):
                if rule.fired:
                    continue
                if rule.rate >= 1.0 or st.rng.random() < rule.rate:
                    rule.fired = True
                    preempt = (rule.latency_s, rule.kind == "preempt")
                continue
            if rule.rate >= 1.0 or st.rng.random() < rule.rate:
                if rule.kind in ("latency", "slow", "hang"):
                    delay += rule.latency_s
                elif rule.kind == "kill":
                    die = True
                    break
                elif rule.kind in ("crash", "oom"):
                    boom = InjectedDeviceFault(site, rule.kind)
                    break
                else:
                    boom = InjectedFault(site)
                    break
    if die:
        # the node dies the way SIGKILL takes it: no flush, no goodbye —
        # callers must detect it via transport failure + phi accrual
        from .registry import registry
        registry.count_fault(site)
        os._exit(137)
    if preempt is not None:
        _deliver_preempt(site, preempt[0], preempt[1])
    if delay > 0.0:
        time.sleep(delay)
    if boom is not None:
        from .registry import registry
        registry.count_fault(site)
        raise boom


def flag(site: str, kind: str) -> bool:
    """Roll the ``kind`` rules for ``site`` and report whether one
    fired — for faults that cannot be expressed as a raise or a sleep
    (``corrupt``: the caller poisons its own data).  Draws from the
    same per-site RNG stream as :func:`inject`, so (spec, seed) replay
    stays deterministic."""
    _ensure_configured()
    plan = _PLAN
    if plan is None:
        return False
    st = plan.get(site)
    if st is None:
        return False
    hit = False
    with st.lock:
        for rule in st.rules:
            if rule.kind != kind:
                continue
            if rule.rate >= 1.0 or st.rng.random() < rule.rate:
                hit = True
                break
    if hit:
        from .registry import registry
        registry.count_fault(site)
    return hit
