"""Port parity, the device guard: `gsky_tpu_torch.device_guard` and the
page pool's lifecycle against `gsky_tpu.device_guard` and the JAX
package's `PagePool`, on the same seeded numpy inputs and the same event
sequences (the port of `tests/test_device_guard.py`, without its worker
crash-loop cases, which belong to the remote workers).

Covered: the classification matrix (plus the three forms in which a CUDA
error reaches the port), the fake-clock state machine with its jittered
backoff and ``dead``, the hang watchdog with an injected hang, the OOM
relief and retry (the reduced variant, the batcher's knee), the
integrity probe and the pool audit's quarantine on the same poisoned
pool in both packages, the journal's replay order, teardown and
rehydrate counts, and the escape hatch: a tile byte-identical with the
guard on and off and equal to the reference's.  Over the servers, an
injected device crash answers 503 with Retry-After in both.

Each package reads ``GSKY_POOL_JOURNAL``; a test that runs both points
it at one file per package before each package's turn.  The port runs
with ``device="cpu"``: its probe, audit and kernels run there."""

import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace
from urllib.parse import parse_qs, urlsplit

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsky_tpu.resilience as jres
from gsky_tpu import device_guard as jdg
from gsky_tpu.device_guard import journal as jjournal
from gsky_tpu.device_guard.supervisor import DeviceSupervisor as JSupervisor
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import scene_cache as jsc
from gsky_tpu.pipeline.batcher import RenderBatcher as JBatcher
from gsky_tpu.pipeline.pages import PagePool as JPagePool
from gsky_tpu.resilience import faults as jfaults
from gsky_tpu.resilience.pressure import default_monitor as jmonitor

import gsky_tpu_torch.resilience as tres
from gsky_tpu_torch import device_guard as tdg
from gsky_tpu_torch.device_guard import journal as tjournal
from gsky_tpu_torch.device_guard.supervisor import (
    DEAD, HEALTHY, MAX_REINIT_FAILURES, SUSPECT)
from gsky_tpu_torch.device_guard.supervisor import \
    DeviceSupervisor as TSupervisor
from gsky_tpu_torch.io.png import decode_png
from gsky_tpu_torch.pipeline import pages as tpages
from gsky_tpu_torch.pipeline.batcher import RenderBatcher as TBatcher
from gsky_tpu_torch.pipeline.pages import PagePool as TPagePool
from gsky_tpu_torch.pipeline.scene_cache import SceneCache
from gsky_tpu_torch.resilience import faults as tfaults
from gsky_tpu_torch.resilience.pressure import default_monitor as tmonitor

from test_torch_server import HOST, NATIVE, T_DATA, _getmap, \
    env  # noqa: F401  (env: a fixture)

PR, PC = 64, 128
PKGS = ("ref", "port")


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    """Per-test journal files and clean resilience state (supervisor,
    faults, pressure) in both packages."""
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "journal.jsonl"))
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    jres.reset()
    tres.reset()
    yield
    jres.reset()
    tres.reset()


def _journal_of(monkeypatch, tmp_path, pkg):
    """Point GSKY_POOL_JOURNAL at ``pkg``'s own file."""
    monkeypatch.setenv("GSKY_POOL_JOURNAL",
                       str(tmp_path / f"journal_{pkg}.jsonl"))


def _scene(seed=0, rows=2 * PR, cols=2 * PC):
    rng = np.random.default_rng(seed)
    return rng.uniform(1.0, 100.0, (rows, cols)).astype(np.float32)


def _pool(pkg, cap=16):
    if pkg == "ref":
        return JPagePool(capacity=cap, page_rows=PR, page_cols=PC)
    return TPagePool(capacity=cap, page_rows=PR, page_cols=PC, device="cpu")


def _dev(pkg, arr):
    return jnp.asarray(arr) if pkg == "ref" else torch.from_numpy(arr)


def _host_pool(pool):
    return np.asarray(pool._pool) if isinstance(pool, JPagePool) \
        else pool._pool.numpy()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both_classify(exc):
    return jdg.classify(exc), tdg.classify(exc)


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
MATRIX = [
    ("RESOURCE_EXHAUSTED", RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
     "oom"),
    ("Resource exhausted", RuntimeError("Resource exhausted: HBM"), "oom"),
    ("INTERNAL", RuntimeError("INTERNAL: stream failed"), "crash"),
    ("XlaRuntimeError", XlaRuntimeError("boom"), "crash"),
    ("caller bug", ValueError("caller bug"), None),
    ("plain failure", RuntimeError("plain failure"), None),
]


@pytest.mark.parametrize("name,exc,want", MATRIX, ids=[m[0] for m in MATRIX])
def test_classify_matrix_as_the_reference(name, exc, want):
    assert _both_classify(exc) == (want, want)


def test_classify_guard_errors_as_the_reference():
    for pkg, dg in (("ref", jdg), ("port", tdg)):
        assert dg.classify(dg.DeviceHang("h", site="s")) == "hang", pkg
        assert dg.classify(dg.DeviceCorruption("c", site="s")) \
            == "corrupt", pkg


def test_injected_faults_ride_the_string_path():
    for kind in ("oom", "crash"):
        assert jdg.classify(jfaults.InjectedDeviceFault("d", kind)) == kind
        assert tdg.classify(tfaults.InjectedDeviceFault("d", kind)) == kind


CUDA_FORMS = [
    ("torch OOM", torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
    ("wrapper rc 2", RuntimeError(
        "launch_paged_render failed: CUDA error 2"), "oom"),
    ("wrapper rc 700", RuntimeError(
        "launch_warp_render failed: CUDA error 700"), "crash"),
    ("wrapper rc 719", RuntimeError(
        "launch_first_valid failed: CUDA error 719"), "crash"),
    ("sync oom", RuntimeError("CUDA error: out of memory\nCUDA kernel "
                              "errors might be asynchronously reported"),
     "oom"),
    ("sync illegal address", RuntimeError(
        "CUDA error: an illegal memory access was encountered"), "crash"),
    ("accelerator error", torch.AcceleratorError(
        "CUDA error: unspecified launch failure"), "crash"),
    ("not CUDA", RuntimeError("CUDA is not mentioned as an error here"),
     None),
]


@pytest.mark.parametrize("name,exc,want", CUDA_FORMS,
                         ids=[c[0] for c in CUDA_FORMS])
def test_classify_cuda_forms(name, exc, want):
    """The three forms in which a CUDA error reaches the port (port
    only: the reference never sees them)."""
    assert tdg.classify(exc) == want


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

def _incident_view(st):
    return (st["hangs"], st["state"], st["incident"])


def test_hang_raises_and_suspects_as_the_reference():
    views = []
    for dg in (jdg, tdg):
        release = threading.Event()
        with pytest.raises(dg.DeviceHang):
            dg.supervised_sync("t.hang", release.wait, deadline_s=0.1)
        release.set()       # let the orphaned thread go
        views.append(_incident_view(dg.default_supervisor().stats()))
    assert views[0] == views[1] == (1, "suspect", "hang")


def test_fast_sync_passes_and_exceptions_propagate():
    def boom():
        raise ValueError("caller bug")

    for dg in (jdg, tdg):
        assert dg.supervised_sync("t.ok", lambda: 7, deadline_s=5.0) == 7
        with pytest.raises(ValueError):
            dg.supervised_sync("t.raise", boom, deadline_s=5.0)
        assert dg.default_supervisor().state() == HEALTHY


def test_injected_hang_fires_inside_the_watchdog(monkeypatch):
    """device:hang sleeps inside the watchdog thread, so a deadline
    shorter than the sleep takes the real hang path."""
    monkeypatch.setenv("GSKY_DEVICE_HANG_S", "0.1")
    for dg, faults in ((jdg, jfaults), (tdg, tfaults)):
        faults.configure("device:hang:30s")
        t0 = time.monotonic()
        with pytest.raises(dg.DeviceHang):
            dg.supervised_sync("t.inj", lambda: 1)
        assert time.monotonic() - t0 < 5.0
        assert dg.default_supervisor().stats()["hangs"] == 1
        faults.configure(None)


def test_staging_hang_is_blamed_on_the_executing_wave():
    """A staging-class site's timeout, while a dispatch's execution
    window is open, is attributed to the dispatch (both packages)."""
    for dg in (jdg, tdg):
        from importlib import import_module
        sup = import_module(dg.__name__ + ".supervisor")
        release = threading.Event()
        with sup.execution_window("dispatch.wave"):
            with pytest.raises(dg.DeviceHang) as ei:
                dg.supervised_sync("wave.stage", release.wait,
                                   deadline_s=0.1)
        release.set()
        assert ei.value.site == "dispatch.wave"
        assert sup.attribute_hang("wave.stage") == "wave.stage"
        sup.reset()


# ---------------------------------------------------------------------------
# the state machine (fake clock)
# ---------------------------------------------------------------------------

def _isolate(monkeypatch):
    """No page pool for either package's rebuild to touch."""
    monkeypatch.setattr(jpages, "_default", None)
    monkeypatch.setattr(tpages, "live_pools", lambda: [])


def _sm_view(st):
    keep = ("state", "state_code", "since_s", "incident", "retry_in_s",
            "reinit_failures", "reinits", "hangs", "crashes", "ooms",
            "incidents", "last_error")
    return {k: st[k] for k in keep}


def test_suspect_backoff_then_inline_rebuild(monkeypatch):
    monkeypatch.setenv("GSKY_DEVICE_REINIT_BACKOFF", "1,8")
    _isolate(monkeypatch)
    views = []
    for Sup, dg in ((JSupervisor, jdg), (TSupervisor, tdg)):
        clock = FakeClock()
        sup = Sup(clock=clock)
        sup.record_crash("t", RuntimeError("INTERNAL: dead stream"))
        assert sup.state() == SUSPECT
        with pytest.raises(dg.DeviceReinitializing) as ei:
            sup.admit("t")
        assert ei.value.retryable and ei.value.retry_after > 0
        assert sup.reinits == 0
        mid = _sm_view(sup.stats())
        clock.t += 1.6      # past the 0.5x..1.5x jitter of the 1 s base
        sup.admit("t")      # the first dispatch past it rebuilds
        assert sup.state() == HEALTHY and sup.reinits == 1
        views.append((mid, _sm_view(sup.stats())))
    assert views[0] == views[1]


def test_repeated_rebuild_failure_goes_dead(monkeypatch):
    monkeypatch.setenv("GSKY_DEVICE_REINIT_BACKOFF", "0.1,0.2")
    views = []
    for Sup, dg in ((JSupervisor, jdg), (TSupervisor, tdg)):
        clock = FakeClock()
        sup = Sup(clock=clock)
        monkeypatch.setattr(sup, "_reinitialize", lambda: False)
        sup.record_hang("t")
        for _ in range(MAX_REINIT_FAILURES):
            clock.t += 1.0
            with pytest.raises(dg.DeviceReinitializing):
                sup.admit("t")
        assert sup.state() == DEAD
        with pytest.raises(dg.DeviceDead) as ei:
            sup.admit("t")
        assert not ei.value.retryable and ei.value.retry_after == 60.0
        views.append(_sm_view(sup.stats()))
    assert views[0] == views[1]
    assert views[1]["state"] == "dead"


def test_backoff_grows_with_failures(monkeypatch):
    monkeypatch.setenv("GSKY_DEVICE_REINIT_BACKOFF", "1,64")
    waits = []
    for Sup, dg in ((JSupervisor, jdg), (TSupervisor, tdg)):
        clock = FakeClock()
        sup = Sup(clock=clock)
        monkeypatch.setattr(sup, "_reinitialize", lambda: False)
        sup.record_crash("t")
        first = sup._next_attempt - clock.t
        clock.t = sup._next_attempt + 0.01
        with pytest.raises(dg.DeviceReinitializing):
            sup.admit("t")
        second = sup._next_attempt - clock.t
        assert 0.5 <= first <= 1.5 and 1.0 <= second <= 3.0
        waits.append((first, second))
    assert waits[0] == waits[1]         # the same seeded jitter


def test_staging_declined_while_suspect():
    for pkg, dg in (("ref", jdg), ("port", tdg)):
        pool = _pool(pkg)
        dev = _dev(pkg, _scene())
        sup = dg.default_supervisor()
        sup.record_crash("t", RuntimeError("INTERNAL: x"))
        try:
            assert pool.table_for(dev, 1, 0, 1, 0, 1) is None
            assert pool.stats()["declined"] == 1
            assert pool.stats()["pinned"] == 0
        finally:
            sup.reset()
        t = pool.table_for(dev, 1, 0, 1, 0, 1)
        assert t is not None and len(t) == 4
        pool.unpin(t)


def test_rebuild_fails_when_the_probe_fails(monkeypatch):
    """The probe really runs: one that raises fails the rebuild (the
    device stays suspect, its failure counted), as on a card whose
    context a sticky error broke."""
    monkeypatch.setenv("GSKY_DEVICE_REINIT_BACKOFF", "0.01,0.02")
    monkeypatch.setattr(tpages, "live_pools", lambda: [])
    real = torch.zeros

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    clock = FakeClock()
    sup = TSupervisor(clock=clock)
    sup.record_crash("t")
    monkeypatch.setattr(torch, "zeros", broken)
    clock.t += 1.0
    with pytest.raises(tdg.DeviceReinitializing):
        sup.admit("t")
    monkeypatch.setattr(torch, "zeros", real)
    st = sup.stats()
    assert st["state"] == "suspect" and st["reinit_failures"] == 1
    assert "illegal memory access" in st["last_error"]
    clock.t += 1.0
    sup.admit("t")
    assert sup.state() == HEALTHY


# ---------------------------------------------------------------------------
# teardown, the probe, rehydrate
# ---------------------------------------------------------------------------

def _raise_internal():
    raise RuntimeError("INTERNAL: GPU stream failed")


def test_run_crash_reinit_rehydrate(monkeypatch, tmp_path):
    """A crash out of run() suspects the device; past the backoff the
    next admit tears the pool down (journaling its hot set), probes the
    device and rehydrates the hottest pages from the scene cache: the
    same pages in the same order in both packages."""
    monkeypatch.setenv("GSKY_DEVICE_REINIT_BACKOFF", "0.01,0.02")
    data = _scene(3)
    serial = 10 ** 9 + 42         # no scene of another test has it
    out = {}
    for pkg, dg in (("ref", jdg), ("port", tdg)):
        _journal_of(monkeypatch, tmp_path, pkg)
        pool = _pool(pkg)
        dev = _dev(pkg, data)
        if pkg == "ref":
            monkeypatch.setattr(jpages, "_default", pool)
            monkeypatch.setitem(jsc.default_scene_cache._scenes,
                                ("dgtest", serial),
                                SimpleNamespace(serial=serial, dev=dev))
        else:
            monkeypatch.setattr(tpages, "live_pools", lambda p=pool: [p])
            pool.cache = SceneCache(device="cpu")
            pool.cache._scenes[("dgtest", serial)] = SimpleNamespace(
                serial=serial, dev=dev)
        t = pool.table_for(dev, serial, 0, 1, 0, 1)
        pool.unpin(t)
        for _ in range(3):          # page (0, 0) the hottest
            t = pool.table_for(dev, serial, 0, 0, 0, 0)
            pool.unpin(t)
        with pytest.raises(dg.DeviceGuardError):
            dg.run("t.dispatch", _raise_internal)
        sup = dg.default_supervisor()
        assert sup.state() == SUSPECT and sup.crashes == 1
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                assert dg.run("t.dispatch", lambda: 11) == 11
                break
            except dg.DeviceReinitializing:
                time.sleep(0.02)
        else:
            pytest.fail("device never readmitted")
        st, ps = sup.stats(), pool.stats()
        assert st["state"] == "healthy" and st["reinits"] == 1
        after = _host_pool(pool)
        out[pkg] = (list(pool._slots), ps["teardowns"], ps["rehydrated"],
                    st["rehydrated_pages"],
                    [after[s] for s in pool._slots.values()])
    ref, port = out["ref"], out["port"]
    assert ref[:4] == port[:4]
    assert port[0][0] == (serial, 0, 0)       # the hottest went first
    assert port[1:4] == (1, 4, 4)
    for a, b in zip(ref[4], port[4]):
        np.testing.assert_array_equal(a, b)   # the same page contents


def test_rehydrate_skips_stale_entries(monkeypatch, tmp_path):
    """Entries of evicted scenes and pages outside the scene's grid are
    skipped without taking a slot."""
    out = {}
    for pkg, journal in (("ref", jjournal), ("port", tjournal)):
        _journal_of(monkeypatch, tmp_path, pkg)
        pool = _pool(pkg)
        dev = _dev(pkg, _scene())           # a 2 x 2 page grid
        # serials no scene of another test in this process has
        live, gone = 10 ** 9 + 5, 10 ** 9 + 6
        if pkg == "ref":
            monkeypatch.setitem(jsc.default_scene_cache._scenes,
                                ("dgstale", live),
                                SimpleNamespace(serial=live, dev=dev))
        else:
            pool.cache = SceneCache(device="cpu")
            pool.cache._scenes[("dgstale", live)] = SimpleNamespace(
                serial=live, dev=dev)
        journal.record_stage(live, 0, 0)    # live
        journal.record_stage(live, 7, 0)    # outside the grid
        journal.record_stage(gone, 0, 0)    # that scene evicted
        out[pkg] = (pool.rehydrate(), list(pool._slots))
    assert out["ref"] == out["port"] == (1, [(10 ** 9 + 5, 0, 0)])


def test_teardown_clears_state(monkeypatch, tmp_path):
    out = {}
    for pkg, journal in (("ref", jjournal), ("port", tjournal)):
        _journal_of(monkeypatch, tmp_path, pkg)
        pool = _pool(pkg, cap=4)            # 3 usable slots
        dev = _dev(pkg, _scene())
        t = pool.table_for(dev, 3, 0, 1, 0, 0)
        pool.unpin(t)
        t = pool.table_for(dev, 3, 0, 0, 0, 0)
        pool.unpin(t)
        gen = pool.handoff()
        pool.teardown()
        assert pool._pool is None and not pool._pins
        assert not pool.handoff_ok(gen)
        t = pool.table_for(dev, 3, 0, 1, 0, 0)
        out[pkg] = (pool.stats()["resident"], pool.stats()["teardowns"],
                    list(t), journal.replay())
        pool.unpin(t)
    assert out["ref"] == out["port"]
    assert out["port"][:2] == (2, 1)
    assert out["port"][3][0] == (3, 0, 0)    # heat journaled at teardown


# ---------------------------------------------------------------------------
# out of memory: relief and retry
# ---------------------------------------------------------------------------

def test_relief_then_retry_succeeds(monkeypatch):
    out = {}
    for pkg, dg, monitor in (("ref", jdg, jmonitor), ("port", tdg, tmonitor)):
        pool = _pool(pkg)
        if pkg == "ref":
            monkeypatch.setattr(jpages, "_default", pool)
        else:
            monkeypatch.setattr(tpages, "live_pools", lambda p=pool: [p])
        t = pool.table_for(_dev(pkg, _scene()), 7, 0, 1, 0, 1)
        pool.unpin(t)
        fired = []
        dg.register_oom_hook(lambda fired=fired: fired.append(1))
        calls = []

        def flaky(calls=calls):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("RESOURCE_EXHAUSTED: HBM exhausted")
            return "ok"

        assert dg.run("t.oom", flaky) == "ok"
        st = dg.default_supervisor().stats()
        out[pkg] = (st["ooms"], st["oom_retries"], st["state"],
                    pool.stats()["trimmed"],
                    monitor().stats()["escalations"], len(fired),
                    len(calls))
    assert out["ref"] == out["port"] == (1, 1, "healthy", 2, 1, 1, 2)


def test_real_cuda_oom_takes_the_relief(monkeypatch):
    """torch's own out-of-memory error rides the same relief and retry
    (port only)."""
    monkeypatch.setattr(tpages, "live_pools", lambda: [])
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return 5

    assert tdg.run("t.oom", flaky) == 5
    st = tdg.default_supervisor().stats()
    assert (st["ooms"], st["oom_retries"], st["state"]) == (1, 1, "healthy")
    assert tmonitor().stats()["escalations"] == 1


def test_reduced_variant_used_for_retry():
    for dg in (jdg, tdg):
        seen = []

        def full():
            raise RuntimeError("RESOURCE_EXHAUSTED: HBM")

        def reduced(seen=seen):
            seen.append("reduced")
            return 3

        assert dg.run("t.oom", full, reduced=reduced) == 3
        assert seen == ["reduced"]


def test_persistent_oom_is_fatal():
    views = []
    for dg in (jdg, tdg):
        def full():
            raise RuntimeError("RESOURCE_EXHAUSTED: HBM")

        with pytest.raises(dg.DeviceGuardError):
            dg.run("t.oom", full)
        st = dg.default_supervisor().stats()
        views.append((st["ooms"], st["state"], st["incident"]))
    assert views[0] == views[1] == (2, "suspect", "oom")


def test_batcher_knee_halves_on_oom():
    knees = []
    for Batcher in (JBatcher, TBatcher):
        b = Batcher()
        b.knee = 8
        b.note_oom()
        seq = [b.knee]
        for _ in range(10):
            b.note_oom()
        knees.append(seq + [b.knee])
    assert knees[0] == knees[1] == [4, 1]


def test_executor_registers_its_batcher_knee(monkeypatch):
    """An OOM's relief halves every live executor's batcher knee, and a
    gone executor's hook goes with it."""
    import gc
    from gsky_tpu_torch.pipeline.executor import WarpExecutor
    monkeypatch.setattr(tpages, "live_pools", lambda: [])
    ex = WarpExecutor(device="cpu")
    ex.batcher.knee = 8
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("launch_paged_render failed: CUDA error 2")
        return 1

    assert tdg.run("t.oom", flaky) == 1
    assert ex.batcher.knee == 4
    assert ex.pool.cache is ex.cache
    from gsky_tpu_torch.device_guard import supervisor
    ref = next(r for r in supervisor._oom_hooks
               if r() == ex.batcher.note_oom)
    del ex
    gc.collect()
    supervisor._live_oom_hooks()
    assert ref() is None and ref not in supervisor._oom_hooks


# ---------------------------------------------------------------------------
# corruption: the probe, injection, the audit
# ---------------------------------------------------------------------------

def test_nan_is_legal_inf_convicts():
    views = []
    for dg in (jdg, tdg):
        ok = np.full((64, 64), np.nan, np.float32)
        dg.integrity_check("t", ok)
        bad = ok.copy()
        bad[5, 5] = np.inf
        with pytest.raises(dg.DeviceCorruption):
            dg.integrity_check("t", bad)
        st = dg.default_supervisor().stats()
        views.append((st["corruptions"], st["state"]))
    assert views[0] == views[1] == (1, "suspect")


def test_guarded_readback_corrupt_injection():
    for dg, faults in ((jdg, jfaults), (tdg, tfaults)):
        faults.configure("device:corrupt:1")
        src = np.ones((32, 32), np.float32)
        with pytest.raises(dg.DeviceCorruption):
            dg.guarded_readback("t.rb", lambda src=src: src)
        assert np.isfinite(src).all()       # the copy was poisoned
        assert dg.default_supervisor().stats()["corruptions"] == 1
        faults.configure(None)


def _stage_both(cap=16, serial=9, i1=1, j1=1, seed=4, unpin=True):
    pools, tables = {}, {}
    for pkg in PKGS:
        pool = _pool(pkg, cap)
        t = pool.table_for(_dev(pkg, _scene(seed)), serial, 0, i1, 0, j1)
        if unpin:
            pool.unpin(t)
        pools[pkg], tables[pkg] = pool, t
    return pools, tables


def test_audit_quarantines_bad_checksum(monkeypatch):
    monkeypatch.setenv("GSKY_POOL_AUDIT", "1")
    pools, _ = _stage_both()
    victim = (9, 0, 1)
    out = {}
    for pkg, pool in pools.items():
        assert len(pool._checksums) == 4    # stage-time CRCs kept
        pool._checksums[victim] = 0xBAD     # a flipped page
        n = pool.audit()
        out[pkg] = (n, victim in pool._slots, pool.stats()["quarantined"],
                    sorted(pool._slots))
        t = pool.table_for(_dev(pkg, _scene(4)), 9, 0, 1, 0, 1)
        assert t is not None                # re-staging heals it
        pool.unpin(t)
    assert out["ref"] == out["port"]
    assert out["port"][:3] == (1, False, 1)


def test_page_crcs_equal_the_reference(monkeypatch):
    monkeypatch.setenv("GSKY_POOL_AUDIT", "1")
    pools, _ = _stage_both()
    assert pools["ref"]._checksums == pools["port"]._checksums


def test_audit_convicts_inf_pages_in_both():
    """The same page poisoned with inf in both pools: the on-device inf
    scan (`pool_inf_counts`) convicts the same page without any CRC."""
    pools, _ = _stage_both()
    key = (9, 1, 0)
    for pkg, pool in pools.items():
        slot = pool._slots[key]
        if pkg == "ref":
            pool._pool = pool._pool.at[slot, 3, 5].set(jnp.inf)
        else:
            pool._pool[slot, 3, 5] = float("inf")
    from gsky_tpu.ops.paged import pool_inf_counts as jcounts
    from gsky_tpu_torch.ops.paged import pool_inf_counts as tcounts
    np.testing.assert_array_equal(np.asarray(jcounts(pools["ref"]._pool)),
                                  tcounts(pools["port"]._pool).numpy())
    got = {pkg: (pool.audit(), sorted(pool._slots))
           for pkg, pool in pools.items()}
    assert got["ref"] == got["port"]
    assert got["port"][0] == 1 and key not in got["port"][1]


def test_audited_corruption_keeps_device_in_service(monkeypatch):
    """With the audit finding the poisoned page, a corruption
    quarantines it and the device stays healthy; with none found, it
    takes the rebuild path."""
    monkeypatch.setenv("GSKY_POOL_AUDIT", "1")
    pools, _ = _stage_both(i1=0, j1=0)
    monkeypatch.setattr(jpages, "_default", pools["ref"])
    monkeypatch.setattr(tpages, "live_pools", lambda: [pools["port"]])
    views = []
    for pkg, dg in (("ref", jdg), ("port", tdg)):
        pools[pkg]._checksums[(9, 0, 0)] = 0xBAD
        sup = dg.default_supervisor()
        sup.record_corruption("t")
        st = sup.stats()
        first = (st["quarantined_pages"], st["state"])
        sup.record_corruption("t")
        views.append((first, sup.stats()["state"]))
    assert views[0] == views[1] == ((1, "healthy"), "suspect")


def test_quarantined_pinned_slot_recycles_on_unpin(monkeypatch):
    monkeypatch.setenv("GSKY_POOL_AUDIT", "1")
    pools, tables = _stage_both(i1=0, j1=0, unpin=False)
    for pkg, pool in pools.items():
        pool._checksums[(9, 0, 0)] = 0xBAD
        free_before = len(pool._free)
        assert pool.audit() == 1
        assert len(pool._free) == free_before       # pinned: held back
        pool.unpin(tables[pkg])
        assert len(pool._free) == free_before + 1   # recycled now


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

JOURNAL_EVENTS = [
    ("stage", (1, 0, 0)), ("stage", (1, 0, 1)), ("heat", (1, 0, 1, 17)),
    ("stage", (2, 3, 0)), ("stage", (3, 1, 1)), ("heat", (3, 1, 1, 2)),
    ("drop", (2,)), ("stage", (2, 5, 5)), ("heat", (1, 0, 0, 4)),
    ("stage", (4, 0, 2)),
]


def _play(journal, events):
    for op, args in events:
        if op == "stage":
            journal.record_stage(*args)
        elif op == "heat":
            journal.record_heat(*args[:3], hits=args[3])
        else:
            journal.record_drop(*args)


@pytest.mark.parametrize("n", [4, 7, len(JOURNAL_EVENTS)])
def test_journal_replay_order_as_the_reference(monkeypatch, tmp_path, n):
    got = {}
    for pkg, journal in (("ref", jjournal), ("port", tjournal)):
        _journal_of(monkeypatch, tmp_path, pkg)
        _play(journal, JOURNAL_EVENTS[:n])
        got[pkg] = (journal.replay(), journal.replay_scored(),
                    journal.export_hot(3), journal.replay_chips())
    assert got["ref"] == got["port"]


def test_journal_replay_orders_hottest_first():
    tjournal.record_stage(1, 0, 0)
    tjournal.record_stage(1, 0, 1)
    tjournal.record_heat(1, 0, 1, hits=17)
    tjournal.record_stage(2, 3, 0)
    assert tjournal.replay() == [(1, 0, 1), (2, 3, 0), (1, 0, 0)]


def test_journal_corrupt_and_foreign_lines_skipped():
    tjournal.record_stage(1, 0, 0)
    with open(tjournal.journal_path(), "a") as fp:
        fp.write("{torn json\n")
        fp.write('{"v": 99, "op": "stage", "serial": 9, '
                 '"pi": 0, "pj": 0}\n')
        fp.write('{"v": 1, "op": "nuke", "serial": 9}\n')
        fp.write('{"v": 1, "op": "stage", "serial": 9, '
                 '"pi": -1, "pj": 0}\n')
        fp.write('{"v": 1, "op": "stage", "serial": "x", '
                 '"pi": 0, "pj": 0}\n')
        fp.write("[1, 2, 3]\n")
    assert tjournal.replay() == jjournal.replay() == [(1, 0, 0)]


def test_journal_disabled_writes_nothing(monkeypatch):
    monkeypatch.setenv("GSKY_POOL_JOURNAL", "0")
    assert not tjournal.journal_enabled()
    tjournal.record_stage(1, 0, 0)
    assert tjournal.replay() == []


def test_journal_merge_and_stats(monkeypatch, tmp_path):
    got = {}
    for pkg, journal in (("ref", jjournal), ("port", tjournal)):
        _journal_of(monkeypatch, tmp_path, pkg)
        n = journal.merge_scored([(7, 0, 0, 5.0), ("x",), (8, -1, 0),
                                  (9, 1, 2)])
        st = journal.stats()
        got[pkg] = (n, journal.replay(), st["entries"], st["present"])
        journal.clear()
        assert not journal.stats()["present"]
    assert got["ref"] == got["port"] == (2, [(7, 0, 0), (9, 1, 2)], 2,
                                         True)


def test_pool_stages_journal_lines(monkeypatch, tmp_path):
    """A pool's cold stages, its hits and its teardown journal the same
    events in both packages, and `drop_scene` voids a scene."""
    got = {}
    for pkg, journal in (("ref", jjournal), ("port", tjournal)):
        _journal_of(monkeypatch, tmp_path, pkg)
        pool = _pool(pkg)
        for serial, seed in ((11, 1), (12, 2)):
            dev = _dev(pkg, _scene(seed))
            for _ in range(1 + serial - 11):
                pool.unpin(pool.table_for(dev, serial, 0, 1, 0, 0))
        pool.drop_scene(11)
        pool.teardown()
        got[pkg] = (journal.replay_scored(), pool.stats()["resident"])
    assert got["ref"] == got["port"]
    assert [e[0] for e in got["port"][0]] == [12, 12]


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

def test_stats_shape_as_the_reference():
    j, t = jdg.default_supervisor().stats(), tdg.default_supervisor().stats()
    assert set(j) == set(t)
    assert {k: v for k, v in t.items() if k != "since_s"} \
        == {k: v for k, v in j.items() if k != "since_s"}
    assert t["state"] == "healthy" and t["state_code"] == HEALTHY


def test_run_passes_noise_through_unclassified():
    for dg in (jdg, tdg):
        def boom():
            raise KeyError("caller bug")

        with pytest.raises(KeyError):
            dg.run("t", boom)
        st = dg.default_supervisor().stats()
        assert st["state"] == "healthy"
        assert st["crashes"] == 0 and st["ooms"] == 0


def test_guard_off_is_a_passthrough(monkeypatch):
    """GSKY_DEVICE_GUARD=0: every entry point returns thunk() as it is,
    with no admission gate, no watchdog thread and no probe."""
    sup = tdg.default_supervisor()
    sup.record_crash("t")               # suspect while the guard is on
    monkeypatch.setenv("GSKY_DEVICE_GUARD", "0")
    assert tdg.run("t", lambda: 5) == 5
    assert sup.staging_ok()
    tfaults.configure("device:corrupt:1")
    src = np.ones((16, 16), np.float32)
    src[0, 0] = np.inf                  # would convict with the guard on
    assert tdg.guarded_readback("t", lambda: src) is src
    assert tdg.supervised_sync(
        "t", lambda: threading.current_thread(), deadline_s=1e-4) \
        is threading.current_thread()


def _port_get(env, url, **kw):  # noqa: F811
    u = urlsplit(url)
    r = env["port"].handle(u.path, parse_qs(u.query,
                                            keep_blank_values=True), HOST)
    return r.status, r.headers.get("Retry-After"), r.body


def _ref_get(env, url):  # noqa: F811
    client = env["jax"]

    async def go():
        resp = await client.client.get(url)
        return resp.status, resp.headers.get("Retry-After"), \
            await resp.read()

    return client.loop.run_until_complete(go())


URL = _getmap("plain", NATIVE[0], style="near", time=T_DATA)


@pytest.mark.parametrize("staged", ["0", "1"])
def test_tile_identical_with_the_guard_on_and_off(env, monkeypatch,  # noqa
                                                  staged):
    """The escape hatch: the same GetMap with GSKY_DEVICE_GUARD=1 and
    =0 gives the same bytes, equal to the reference's (the serial
    ladder and the staged tile path)."""
    monkeypatch.setenv("GSKY_TILE_PIPELINE", staged)
    bodies = {}
    for guard in ("1", "0"):
        monkeypatch.setenv("GSKY_DEVICE_GUARD", guard)
        ref, port = _ref_get(env, URL), _port_get(env, URL)
        assert ref[0] == port[0] == 200
        bodies[guard] = (decode_png(port[2]), ref[2])
    assert bodies["1"][0].tobytes() == bodies["0"][0].tobytes()
    from gsky_tpu.io.png import decode_png as jdecode
    np.testing.assert_array_equal(bodies["1"][0], jdecode(bodies["1"][1]))


def test_device_crash_answers_503_over_http(env):  # noqa: F811
    """An injected device crash answers 503 with Retry-After in both
    servers (the port over its HTTP socket) and leaves both devices
    suspect; the next request past the backoff is served again."""
    jfaults.configure("device:crash:1")
    ref = _ref_get(env, URL)
    jfaults.configure(None)
    tfaults.configure("device:crash:1")
    httpd = env["port"].serve("127.0.0.1", 0)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}{URL}"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url)
        port = (e.value.code, e.value.headers.get("Retry-After"),
                e.value.read())
        tfaults.configure(None)
        assert ref[0] == port[0] == 503
        assert ref[1] is not None and port[1] is not None
        assert int(port[1]) >= 1
        assert b"ServerBusy" in port[2]
        for dg in (jdg, tdg):
            st = dg.default_supervisor().stats()
            assert (st["state"], st["crashes"]) == ("suspect", 1)
        # a request inside the backoff: 503 again, no launch
        assert _port_get(env, URL)[0] == 503
        tdg.default_supervisor()._next_attempt = 0.0
        with urllib.request.urlopen(url) as r:
            assert r.status == 200
        st = tdg.default_supervisor().stats()
        assert (st["state"], st["reinits"]) == ("healthy", 1)
    finally:
        httpd.shutdown()
        httpd.server_close()
