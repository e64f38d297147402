"""Port parity, serving under load: cancel tokens, the memory-pressure
monitor, admission (fixed and adaptive, the weighted-fair queue, a
request cancelled while queued, reconfiguration on reload), brownout,
deadlines and client disconnects, mirroring the reference's
`tests/test_overload.py` case for case.

Unit cases run over both packages (`gsky_tpu` and `gsky_tpu_torch`) or
hold the port's threaded admission against the reference's asyncio one
on the same observation sequences.  The server cases build both servers
over one config (`test_torch_gateway.Env`: the reference through
`aiohttp.test_utils` with Pallas in interpret mode, the port with
``device="cpu"`` through its handler or over a socket) and compare
statuses, OGC exception codes and the ``Retry-After``,
``X-GSKY-Degraded`` and ``X-Gsky-Cache`` headers, and decoded tiles
(nearest: equal; else at most 0.1% of bytes).  Both packages' pressure
monitors, fault plans, cancellation ledgers and breakers are reset
around every test; every wait has a timeout."""

import asyncio
import re
import socket
import threading
import time
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from gsky_tpu import resilience as jres
from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
from gsky_tpu.serving import AdmissionController as JAdmissionController

from gsky_tpu_torch import resilience as tres
from gsky_tpu_torch.io.png import decode_png
from gsky_tpu_torch.pipeline import pages as tpages
from gsky_tpu_torch.pipeline.tile import TilePipeline
from gsky_tpu_torch.resilience import (CancelToken, RequestCancelled,
                                       cancel_scope, cancel_stats)
from gsky_tpu_torch.resilience.pressure import (PressureMonitor,
                                                default_monitor,
                                                staging_allowed)
from gsky_tpu_torch.serving import AdmissionController, AdmissionShed, \
    ServingGateway

from test_torch_gateway import HOST, _layer, garch, getmap, \
    make_env  # noqa: F401
from test_torch_server import NATIVE, _box

PKGS = {"jax": jres, "torch": tres}
TIMEOUT = 30


def _reset_all():
    for res in PKGS.values():
        res.reset()


@pytest.fixture(autouse=True)
def _fresh_overload_state(monkeypatch):
    # the prefetch planners warm on threads of their own: off, so that
    # nothing but the test draws faults or loads scenes
    monkeypatch.setenv("GSKY_PREFETCH", "0")
    _reset_all()
    yield
    _reset_all()


@pytest.fixture(params=sorted(PKGS))
def res(request):
    return PKGS[request.param]


def _force(level):
    """Pin both monitors' state; None resumes measurement from a clean
    monitor (no hysteresis window to wait out)."""
    for res in PKGS.values():
        res.default_monitor().force(level)
        if level is None:
            res.default_monitor().reset()


# ---------------------------------------------------------------------------
# cancel tokens
# ---------------------------------------------------------------------------

class TestCancelToken:
    def test_fire_once_and_check_raises(self, res):
        tok = res.CancelToken()
        tok.check("decode")
        assert tok.cancel("deadline") is True
        assert tok.cancel("again") is False
        assert tok.reason == "deadline"
        with pytest.raises(res.RequestCancelled) as ei:
            tok.check("decode")
        assert isinstance(ei.value, asyncio.CancelledError)
        assert not isinstance(ei.value, Exception)
        assert ei.value.stage == "decode"
        st = res.cancel_stats()
        assert st["fired"] == 1 and st["stages"]["decode"] == 1

    def test_callbacks_fire_once_and_late_registration_runs(self, res):
        tok = res.CancelToken()
        hits = []
        remove = tok.on_cancel(lambda: hits.append("a"))
        tok.on_cancel(lambda: hits.append("b"))
        remove()
        tok.cancel()
        assert hits == ["b"]
        tok.on_cancel(lambda: hits.append("late"))
        assert hits == ["b", "late"]

    def test_scope_rides_the_context_into_a_thread(self, res):
        import contextvars
        with res.cancel_scope() as tok:
            assert res.current_token() is tok
            tok.cancel("client-disconnect")
            ctx = contextvars.copy_context()
        got = []

        def run():
            try:
                ctx.run(res.check_cancel, "dispatch")
            except res.RequestCancelled as e:
                got.append(e.stage)
        t = threading.Thread(target=run)
        t.start()
        t.join(TIMEOUT)
        assert res.current_token() is None
        assert got == ["dispatch"]
        assert res.cancel_stats()["stages"] == {"dispatch": 1}

    def test_check_cancel_without_scope_is_noop(self, res):
        res.check_cancel("anything")

    def test_probe_fires_the_token_at_a_check(self):
        """The port's client-disconnect probe: run by `check`, rate
        limited, and the token fires with the probe's reason."""
        calls = []

        def probe():
            calls.append(1)
            return "client-disconnect" if len(calls) >= 2 else None
        tok = CancelToken(probe=probe, probe_every=0.0)
        tok.check("decode")
        with pytest.raises(RequestCancelled) as ei:
            tok.check("dispatch")
        assert ei.value.reason == "client-disconnect"
        assert tok.cancelled() and len(calls) == 2
        slow = CancelToken(probe=lambda: calls.append(1), probe_every=60.0)
        slow.check("a")
        slow.check("b")
        assert len(calls) == 3


# ---------------------------------------------------------------------------
# the pressure monitor
# ---------------------------------------------------------------------------

def _mon(res, avail_mb, pool=None, clock=None):
    readings = {"avail": avail_mb, "pool": pool}
    mon = res.PressureMonitor(
        avail_reader=lambda: None if readings["avail"] is None
        else int(readings["avail"] * (1 << 20)),
        pool_reader=lambda: readings["pool"],
        clock=clock or time.monotonic)
    return mon, readings


class TestPressureMonitor:
    def test_threshold_crossings_rise_immediately(self, res, monkeypatch):
        monkeypatch.setenv("GSKY_PRESSURE_POLL_S", "0")
        mon, r = _mon(res, 1024)
        assert mon.state() == 0
        r["avail"] = 200
        assert mon.state() == 1
        r["avail"] = 100
        assert mon.state() == 2
        assert mon.transitions == 2
        assert mon.stats()["mem_available_mb"] == 100.0

    def test_pool_occupancy_drives_state(self, res, monkeypatch):
        monkeypatch.setenv("GSKY_PRESSURE_POLL_S", "0")
        mon, r = _mon(res, 8192, pool=0.5)
        assert mon.state() == 0
        r["pool"] = 0.95
        assert mon.state() == 1
        r["pool"] = 0.99
        assert mon.state() == 2

    def test_recovery_is_hysteretic(self, res, monkeypatch):
        monkeypatch.setenv("GSKY_PRESSURE_POLL_S", "0")
        monkeypatch.setenv("GSKY_PRESSURE_CLEAR_S", "10")
        t = [100.0]
        mon, r = _mon(res, 100, clock=lambda: t[0])
        assert mon.state() == 2
        r["avail"] = 8192
        t[0] += 1.0
        assert mon.state() == 2
        t[0] += 5.0
        assert mon.state() == 2
        t[0] += 10.0
        assert mon.state() == 0

    def test_critical_transition_trims_caches(self, res, monkeypatch):
        monkeypatch.setenv("GSKY_PRESSURE_POLL_S", "0")
        mon, r = _mon(res, 1024)
        assert mon.state() == 0 and mon.trims == 0
        r["avail"] = 64
        assert mon.state() == 2
        assert mon.trims == 1
        assert mon.state() == 2
        assert mon.trims == 1

    def test_force_and_disable(self, res, monkeypatch):
        mon, _ = _mon(res, 8192)
        mon.force(2)
        assert mon.state() == 2 and mon.trims == 1
        mon.force(None)
        monkeypatch.setenv("GSKY_PRESSURE", "0")
        assert mon.state() == 0

    def test_escalate_floors_the_state_for_a_while(self, res,
                                                   monkeypatch):
        monkeypatch.setenv("GSKY_PRESSURE_POLL_S", "0")
        t = [10.0]
        mon, _ = _mon(res, 8192, clock=lambda: t[0])
        mon.escalate(2, hold_s=5.0)
        assert mon.state() == 2 and mon.trims == 1
        t[0] += 6.0
        assert mon.state() == 0

    @pytest.mark.parametrize("seed", [0, 1])
    def test_state_sequence_equals_the_reference(self, seed, monkeypatch):
        """Random MemAvailable and pool readings on a shared clock: both
        monitors report the same states, transitions and trims."""
        monkeypatch.setenv("GSKY_PRESSURE_POLL_S", "0.5")
        monkeypatch.setenv("GSKY_PRESSURE_CLEAR_S", "2")
        rng = np.random.default_rng(seed)
        t = [0.0]
        mons = {k: _mon(r, 1024, pool=0.1, clock=lambda: t[0])
                for k, r in PKGS.items()}
        for _ in range(200):
            t[0] += float(rng.uniform(0.0, 1.0))
            avail = float(rng.choice([64, 200, 1024, 4096]))
            pool = float(rng.choice([0.1, 0.92, 0.98]))
            states = []
            for mon, r in mons.values():
                r["avail"], r["pool"] = avail, pool
                states.append(mon.state())
            assert states[0] == states[1]
        (a, _), (b, _) = mons.values()
        assert (a.transitions, a.trims) == (b.transitions, b.trims)

    def test_staging_allowed_tracks_default_monitor(self):
        assert staging_allowed()
        default_monitor().force(2)
        assert not staging_allowed()
        default_monitor().force(1)
        assert staging_allowed()

    def test_page_pool_declines_staging_under_critical_pressure(self):
        pool = tpages.PagePool(capacity=4, device="cpu")
        default_monitor().force(2)
        assert pool.table_for(None, 1, 0, 0, 0, 0) is None
        assert pool.declined == 1
        assert pool.stats()["pinned"] == 0

    def test_live_pool_occupancy_feeds_the_monitor(self, monkeypatch):
        """The port reads a live pool's pinned pages (a warm LRU pool
        full of evictable pages is no pressure)."""
        import torch
        monkeypatch.setenv("GSKY_PRESSURE_POLL_S", "0")
        pool = tpages.PagePool(capacity=5, page_rows=2, page_cols=2,
                               device="cpu")
        scene = torch.zeros((8, 8))
        mon = PressureMonitor(avail_reader=lambda: 8 << 30)
        assert mon.state() == 0          # no pool tensor: no reading
        slots = pool.table_for(scene, 1, 0, 1, 0, 1)   # 4 of 5 pinned
        monkeypatch.setenv("GSKY_PRESSURE_POOL", "0.5")
        assert mon.state() == 1
        assert mon.stats()["pool_occupancy"] >= 0.8
        pool.unpin(slots)                # resident, evictable
        assert pool.stats()["resident"] == 4
        monkeypatch.setenv("GSKY_PRESSURE_CLEAR_S", "0")
        mon.state()
        assert mon.state() == 0
        assert mon.stats()["pool_occupancy"] == 0.0

    def test_critical_relief_empties_caches_and_trims_pools(self):
        import torch
        from gsky_tpu_torch.pipeline.scene_cache import SceneCache
        from gsky_tpu_torch.serving import default_gateway, make_entry
        cache = SceneCache(device="cpu")
        cache._scenes[("k",)] = object()
        cache._order.append(("k",))
        pool = tpages.PagePool(capacity=8, page_rows=2, page_cols=2,
                               device="cpu")
        pool.unpin(pool.table_for(torch.zeros((8, 8)), 1, 0, 1, 0, 1))
        default_gateway.cache.put("key", make_entry(
            b"x" * 10, "image/png", 200, "", "plain", "fp", 60))
        assert len(default_gateway.cache) == 1
        default_monitor().force(2)
        assert default_monitor().trims == 1
        assert not cache._scenes and len(default_gateway.cache) == 0
        assert pool.trimmed == 2 and pool.stats()["resident"] == 2


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def _threads(fns):
    ts = [threading.Thread(target=f) for f in fns]
    for t in ts:
        t.start()
    return ts


def _join(ts):
    for t in ts:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in ts)


class TestAdaptiveAdmission:
    def test_aimd_shrinks_on_latency_and_recovers(self, monkeypatch):
        monkeypatch.setenv("GSKY_ADMIT_INTERVAL_S", "0")
        ac = AdmissionController(limits={"WMS": 16}, adaptive=True)
        st = ac.stats()["classes"]["WMS"]
        assert st["limit"] == 16 and st["ceiling"] == 16
        for _ in range(20):
            ac.observe("WMS", 0.01)
        for _ in range(6):
            ac.observe("WMS", 0.5)
        shrunk = ac.stats()["classes"]["WMS"]["limit"]
        assert shrunk < 16
        assert shrunk >= max(1, 16 // 8)
        assert ac.total_adjustments >= 1
        for _ in range(200):
            ac.observe("WMS", 0.01)
        assert ac.stats()["classes"]["WMS"]["limit"] > shrunk

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_aimd_sequence_equals_the_reference(self, seed, monkeypatch):
        monkeypatch.setenv("GSKY_ADMIT_INTERVAL_S", "0")
        rng = np.random.default_rng(seed)
        a = JAdmissionController(limits={"WMS": 24}, adaptive=True)
        b = AdmissionController(limits={"WMS": 24}, adaptive=True)
        for _ in range(300):
            lat = float(rng.choice([0.01, 0.02, 0.3, 0.8]))
            a.observe("WMS", lat)
            b.observe("WMS", lat)
            sa, sb = a.stats()["classes"]["WMS"], \
                b.stats()["classes"]["WMS"]
            assert (sa["limit"], sa["adjustments"]) == \
                (sb["limit"], sb["adjustments"])
        assert a.stats()["classes"]["WMS"] == b.stats()["classes"]["WMS"]

    def test_fixed_mode_ignores_observations(self):
        ac = AdmissionController(limits={"WMS": 8}, adaptive=False)
        for _ in range(50):
            ac.observe("WMS", 5.0)
        st = ac.stats()["classes"]["WMS"]
        assert st["limit"] == 8 and st["adjustments"] == 0
        assert ac.stats()["adaptive"] is False

    def test_pressure_clamps_effective_limit(self):
        ac = AdmissionController(limits={"WMS": 16}, adaptive=True)
        jac = JAdmissionController(limits={"WMS": 16}, adaptive=True)
        for level, want in ((None, 16), (1, 8), (2, 4)):
            _force(level)
            for c in (ac, jac):
                assert c.stats()["classes"]["WMS"]["effective_limit"] \
                    == want

    def test_stats_keys_equal_the_reference(self):
        a = JAdmissionController(adaptive=True).stats()
        b = AdmissionController(adaptive=True).stats()
        assert a == b

    def test_weighted_fair_queue_prefers_light_tenant(self):
        """One slot, three bulk requests queued before one interactive:
        the interactive tenant is not served last."""
        ac = AdmissionController(limits={"WMS": 1}, queue_deadline_s=5.0,
                                 adaptive=True)
        order = []
        held = threading.Event()

        def hold():
            with ac.admit("WMS", "bulk"):
                order.append("bulk")
                held.set()
                time.sleep(0.2)

        def one(tenant):
            def go():
                with ac.admit("WMS", tenant):
                    order.append(tenant)
                    time.sleep(0.05)
            return go
        ts = _threads([hold])
        assert held.wait(TIMEOUT)
        ts += _threads([one("bulk") for _ in range(3)])
        time.sleep(0.05)
        ts += _threads([one("interactive")])
        _join(ts)
        assert order[0] == "bulk"
        assert "interactive" in order[1:3]

    @pytest.mark.parametrize("adaptive", [True, False])
    def test_cancel_mid_queue_releases_capacity(self, adaptive):
        ac = AdmissionController(limits={"WMS": 1}, queue_deadline_s=2.0,
                                 adaptive=adaptive)
        entered, release = threading.Event(), threading.Event()
        errs, toks = [], []

        def hold():
            with ac.admit("WMS", "a"):
                entered.set()
                release.wait(TIMEOUT)

        def queued():
            with cancel_scope() as tok:
                toks.append(tok)
                try:
                    with ac.admit("WMS", "b"):
                        pass
                except RequestCancelled as e:
                    errs.append(e)
        ts = _threads([hold])
        assert entered.wait(TIMEOUT)
        qt = _threads([queued])
        time.sleep(0.1)
        toks[0].cancel("client-disconnect")
        _join(qt)
        assert errs and errs[0].stage == "admission"
        release.set()
        _join(ts)
        with ac.admit("WMS", "c"):
            pass
        st = ac.stats()["classes"]["WMS"]
        assert st["in_use"] == 0 and st["queued"] == 0
        assert st["cancelled"] >= 1
        assert ac.stats()["tenants"] == {}

    @pytest.mark.parametrize("adaptive", [True, False])
    def test_queue_deadline_sheds(self, adaptive):
        ac = AdmissionController(limits={"WMS": 1}, queue_deadline_s=0.05,
                                 adaptive=adaptive)
        with ac.admit("WMS"):
            with pytest.raises(AdmissionShed) as ei:
                with ac.admit("WMS"):
                    pass
        assert ei.value.retry_after == 1
        assert ei.value.alt_node is None
        st = ac.stats()["classes"]["WMS"]
        assert st["shed"] == 1 and st["in_use"] == 0 and st["queued"] == 0

    def test_fixed_mode_never_exceeds_its_limit(self):
        ac = AdmissionController(limits={"WMS": 2}, queue_deadline_s=5.0,
                                 adaptive=False)
        peak, lock, now = [0], threading.Lock(), [0]

        def go():
            with ac.admit("WMS"):
                with lock:
                    now[0] += 1
                    peak[0] = max(peak[0], now[0])
                time.sleep(0.02)
                with lock:
                    now[0] -= 1
        _join(_threads([go] * 12))
        assert peak[0] == 2
        assert ac.stats()["classes"]["WMS"]["admitted"] == 12

    def test_reconfigure_rereads_environment(self, monkeypatch):
        monkeypatch.setenv("GSKY_ADMIT_WMS", "6")
        monkeypatch.setenv("GSKY_ADMIT_QUEUE_S", "1.5")
        ac = AdmissionController()
        assert ac.stats()["classes"]["WMS"]["ceiling"] == 6
        assert ac.queue_deadline_s == 1.5
        monkeypatch.setenv("GSKY_ADMIT_WMS", "12")
        monkeypatch.setenv("GSKY_ADMIT_QUEUE_S", "2.5")
        ac.reconfigure()
        st = ac.stats()["classes"]["WMS"]
        assert st["ceiling"] == 12 and st["limit"] <= 12
        assert ac.queue_deadline_s == 2.5

    def test_gateway_reload_reconfigures_admission(self, monkeypatch):
        monkeypatch.setenv("GSKY_ADMIT_WCS", "3")
        gw = ServingGateway()
        assert gw.admission.stats()["classes"]["WCS"]["ceiling"] == 3
        monkeypatch.setenv("GSKY_ADMIT_WCS", "9")
        gw.invalidate_for_configs({})
        assert gw.admission.stats()["classes"]["WCS"]["ceiling"] == 9
        assert gw.stats()["admission"]["classes"]["WCS"]["ceiling"] == 9


# ---------------------------------------------------------------------------
# both servers under load
# ---------------------------------------------------------------------------

def _code(body):
    m = re.search(rb'exceptionCode="([^"]*)"', body)
    return m.group(1).decode() if m else None


def _port_many(env, urls):
    out = [None] * len(urls)

    def go(i):
        u = urlsplit(urls[i])
        r = env.port.handle(u.path, parse_qs(u.query,
                                             keep_blank_values=True),
                            HOST)
        out[i] = (r.status, r.content_type, r.read(), r.headers)
    _join(_threads([lambda i=i: go(i) for i in range(len(urls))]))
    return out


def _slow_renders(monkeypatch, seconds):
    for cls, name in ((JTilePipeline, "composite_dispatch"),
                      (TilePipeline, "render_composite_byte")):
        def slow(self, *a, _f=getattr(cls, name), **k):
            time.sleep(seconds)
            return _f(self, *a, **k)
        monkeypatch.setattr(cls, name, slow)


BOXES = [_box(598500.0 + 300.0 * i, 6100000.0 - 200.0 * i, 3000.0)
         for i in range(6)]


def test_admission_sheds_alike(make_env, monkeypatch):
    """Fixed admission of one WMS slot and a 50 ms queue: concurrent
    distinct tiles are either rendered or shed with ServerBusy and
    Retry-After 1, in both servers."""
    monkeypatch.setenv("GSKY_ADMIT_ADAPTIVE", "0")
    monkeypatch.setenv("GSKY_ADMIT_WMS", "1")
    monkeypatch.setenv("GSKY_ADMIT_QUEUE_S", "0.05")
    _slow_renders(monkeypatch, 0.3)
    env = make_env()
    urls = [getmap(box=b) for b in BOXES]
    for got in (env.jax(urls), _port_many(env, urls)):
        statuses = [g[0] for g in got]
        assert set(statuses) <= {200, 503}, statuses
        assert 200 in statuses and 503 in statuses
        for s, _, body, h in got:
            if s == 503:
                assert _code(body) == "ServerBusy"
                assert h["Retry-After"] == "1"
    for gw in env.gateways:
        st = gw.admission.stats()["classes"]["WMS"]
        assert st["shed"] + st["admitted"] == len(urls)
        assert st["in_use"] == 0


def test_brownout_degrades_and_recovers(make_env, garch):
    """Elevated pressure: both servers label the tile ``brownout``,
    render the layer's overview, cache nothing; once it clears, the
    label is gone and the tile is cached."""
    root = garch["root"]
    # the overview reads the collection whose newer granule is cut
    # short: its tile differs from the layer's and is labelled "decode"
    ov = _layer("ov", root, data_source=f"{root}/broken",
                zoom_limit=1000.0)
    env = make_env([_layer("plain", root, overviews=[ov]),
                    _layer("direct", root, data_source=f"{root}/broken")])
    _force(1)
    try:
        (js, jc, jb, jh), (ts, tc, tb, th) = env.both(getmap())
        assert (js, jc) == (ts, tc) == (200, "image/png")
        assert jh["X-GSKY-Degraded"] == th["X-GSKY-Degraded"] == \
            "brownout,decode"
        a, b = jdecode_png(jb), decode_png(tb)
        assert int(np.count_nonzero(a != b)) <= a.size // 1000
        for gw in env.gateways:
            assert gw.cache.stats()["entries"] == 0
    finally:
        _force(None)
    # the brownout tile is the overview's tile
    _, (_, _, direct, _) = env.both(getmap(layer="direct"))
    assert np.array_equal(decode_png(direct), b)
    (js, _, _, jh), (ts, _, tb2, th) = env.both(getmap())
    assert js == ts == 200
    assert "X-GSKY-Degraded" not in jh and "X-GSKY-Degraded" not in th
    assert not np.array_equal(decode_png(tb2), b)
    for gw in env.gateways:
        assert gw.cache.stats()["entries"] >= 1


def test_brownout_png_effort_and_animation_frames(make_env, garch,
                                                  monkeypatch):
    """Under brownout a PNG is written at zlib level 0 (same pixels) and
    an animation keeps every second frame (every fourth when
    critical)."""
    from gsky_tpu_torch.io import png as tpng
    levels = []
    enc = tpng._encode

    def spy(pixels, colour_type, level, extra=()):
        levels.append(level)
        return enc(pixels, colour_type, level, extra)
    monkeypatch.setattr(tpng, "_encode", spy)
    env = make_env()
    _, (_, _, normal, _) = env.both(getmap())
    for gw in env.gateways:
        gw.cache.clear()
    _force(1)
    try:
        _, (s, _, cheap, h) = env.both(getmap())
        assert s == 200 and h["X-GSKY-Degraded"] == "brownout"
        assert levels == [1, 0]
        assert np.array_equal(decode_png(cheap), decode_png(normal))
        anim = getmap(fmt="image/apng", time_=(
            "2020-01-10T00:00:00.000Z,2020-01-11T00:00:00.000Z,"
            "2020-01-12T00:00:00.000Z,2020-01-13T00:00:00.000Z"))
        (js, _, _, jh), (ts, _, _, th) = env.both(anim)
        assert js == ts == 200
        assert th["X-Gsky-Anim-Frames"] == jh["X-Gsky-Anim-Frames"] == "2"
        # the reference streams an animation and sends its headers
        # before the label is known; the port's body is whole and is
        # labelled (ROADMAP C)
        assert th["X-GSKY-Degraded"] == "brownout"
        assert "X-GSKY-Degraded" not in jh
        _force(2)
        (_, _, _, jh), (_, _, _, th) = env.both(anim)
        assert th["X-Gsky-Anim-Frames"] == jh["X-Gsky-Anim-Frames"] == "1"
    finally:
        _force(None)


def test_critical_pressure_declines_staging_to_b2(make_env, monkeypatch):
    """Critical pressure: the port's page pool declines, the tile takes
    the bucketed leg (B2) and equals the paged (B1) tile."""
    from gsky_tpu_torch.ops import paged, warp_render
    calls = {"B1": 0, "B2": 0}
    for key, mod, name in (("B1", paged, "paged_render_scored"),
                           ("B2", warp_render, "warp_render_scored")):
        def counted(*a, _f=getattr(mod, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    env = make_env()
    _, (_, _, paged_tile, _) = env.both(getmap())
    assert calls == {"B1": 1, "B2": 0}
    _force(2)
    try:
        # the critical relief emptied the process gateway, not these
        for gw in env.gateways:
            assert gw.cache.stats()["entries"] == 1
            gw.cache.clear()
        (js, _, jb, jh), (ts, _, tb, th) = env.both(getmap())
    finally:
        _force(None)
    assert js == ts == 200 and th["X-GSKY-Degraded"] == "brownout"
    assert jh["X-GSKY-Degraded"] == "brownout"
    assert calls == {"B1": 1, "B2": 1}
    assert np.array_equal(decode_png(tb), decode_png(paged_tile))
    assert env.port.executor.pool.declined >= 1


def test_deadline_answers_504_and_unwinds(make_env, garch, monkeypatch):
    """A 1.5 s decode latency fault under a 1 s wms_timeout: both
    servers answer 504 within the budget's order; the port's render
    unwinds at a cancellation check and launches nothing."""
    monkeypatch.setenv("GSKY_TILE_PIPELINE", "1")
    from gsky_tpu_torch.ops import paged
    b1 = []
    f = paged.paged_render_scored
    monkeypatch.setattr(paged, "paged_render_scored",
                        lambda *a, **k: b1.append(1) or f(*a, **k))
    from gsky_tpu.pipeline import pages as jpages
    from gsky_tpu.pipeline.scene_cache import default_scene_cache
    root = garch["root"]
    env = make_env([_layer("plain", root, wms_timeout=1),
                     _layer("clean", root)])
    # the reference's scene cache and page pool are process-wide: its
    # scenes must load again, through the fault
    default_scene_cache.clear()
    jpages.reset_default_pool()
    for res in PKGS.values():
        res.faults.configure("decode:latency:1500ms", seed=0)
    t_start = t0 = time.monotonic()
    ref = env.jax1(getmap())
    t_ref = time.monotonic() - t0
    t0 = time.monotonic()
    got = env.torch1(getmap())
    t_port = time.monotonic() - t0
    assert ref[0] == got[0] == 504, (ref[0], got[0])
    assert t_port < 1.45, t_port
    assert t_ref < 1.45, t_ref
    deadline = time.monotonic() + TIMEOUT
    while not cancel_stats()["stages"] and time.monotonic() < deadline:
        time.sleep(0.05)
    st = cancel_stats()
    assert st["fired"] >= 1 and set(st["stages"]) <= {"decode", "dispatch"}
    assert st["stages"], st
    time.sleep(0.2)
    assert b1 == []
    for res in PKGS.values():
        res.faults.reset()
    # both packages' abandoned scene loads hold their cache's load latch
    # until their 1.5 s faults end
    time.sleep(max(0.0, t_start + 3.5 - time.monotonic()))
    # (a layer of the default budget: the reference's first interpret-
    # mode compile of a tile can take longer than 1 s on its own)
    (js, _, _, _), (ts, _, _, _) = env.both(getmap("clean", NATIVE[1]))
    assert js == ts == 200
    assert b1 == [1]


def test_backend_faults_retry_alike(make_env, garch, monkeypatch):
    """mas:error:0.2 at seed 0 over each server's MAS client (the
    in-process store behind the ``mas`` site): every tile answers 200
    and both count the same retries."""
    env = make_env()
    for res in PKGS.values():
        res.faults.configure("mas:error:0.2", seed=0)
    for b in BOXES:
        (js, _, _, _), (ts, _, _, _) = env.both(getmap(box=b))
        assert js == ts == 200
    a, b = jres.registry.stats(), tres.registry.stats()
    assert a["retries"] == b["retries"]
    assert a["faults_injected"] == b["faults_injected"]
    assert b["retries"].get("mas", 0) >= 1


def test_stats_expose_cancel_pressure_and_admission(make_env):
    """The counters the metrics slice will publish (the reference's
    /debug blocks), as `stats()` dicts."""
    env = make_env()
    default_monitor().force(2)
    try:
        assert default_monitor().stats()["state"] == 2
        assert "fired" in cancel_stats()
        adm = env.port.gateway.stats()["admission"]
        assert adm["adaptive"] is True
        assert adm["classes"]["WMS"]["effective_limit"] <= \
            adm["classes"]["WMS"]["limit"]
    finally:
        default_monitor().force(None)


def test_client_disconnect_cancels_and_frees_permit(make_env,
                                                    monkeypatch):
    """A client that drops its connection mid-render: the port's token
    fires with ``client-disconnect`` through the socket probe, nothing
    is sent, and the admission permit comes back."""
    started = threading.Event()
    orig = TilePipeline.render_composite_byte

    def slow(self, *a, **k):
        started.set()
        time.sleep(0.5)
        return orig(self, *a, **k)
    monkeypatch.setattr(TilePipeline, "render_composite_byte", slow)
    env = make_env()
    httpd = env.port.serve("127.0.0.1", 0)
    try:
        sock = socket.create_connection(httpd.server_address, TIMEOUT)
        sock.sendall(f"GET {getmap()} HTTP/1.1\r\nHost: {HOST}\r\n\r\n"
                     .encode())
        assert started.wait(TIMEOUT)
        sock.close()
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            st = env.port.gateway.admission.stats()["classes"]["WMS"]
            if st["in_use"] == 0 and cancel_stats()["fired"] >= 1:
                break
            time.sleep(0.05)
        assert st["in_use"] == 0
        assert cancel_stats()["fired"] >= 1
        assert cancel_stats()["stages"]
        assert env.port.gateway.cache.stats()["entries"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.thread.join(TIMEOUT)


def test_a_live_client_is_answered_over_a_socket(make_env):
    """The probe sees a connected client as alive: a request over a
    socket is answered in full."""
    import urllib.request
    env = make_env()
    httpd = env.port.serve("127.0.0.1", 0)
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{getmap()}",
                                    timeout=TIMEOUT) as r:
            assert r.status == 200 and r.read()[:4] == b"\x89PNG"
        assert cancel_stats()["fired"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.thread.join(TIMEOUT)


# ---------------------------------------------------------------------------
# waves under pressure and cancellation
# ---------------------------------------------------------------------------

@pytest.fixture
def sched(monkeypatch):
    from gsky_tpu_torch.pipeline import waves
    monkeypatch.setenv("GSKY_WAVE_MAX", "8")
    w = waves.WaveScheduler("cpu", tick_ms=0)
    yield w
    w.shutdown()


def _entries(n, token=None, cleaned=None):
    from gsky_tpu_torch.pipeline.waves import _Entry
    out = []
    for i in range(n):
        if token is not None:
            with cancel_scope(token):
                e = _Entry("byte", ("k",), {"i": i},
                           cleanup=lambda i=i: cleaned.append(i))
        else:
            e = _Entry("byte", ("k",), {"i": i},
                       cleanup=lambda i=i: cleaned.append(i))
        out.append(e)
    return out


def test_waves_drop_cancelled_entries_at_assembly(sched):
    cleaned = []
    dead = CancelToken()
    es = _entries(2, dead, cleaned) + _entries(2, None, cleaned)
    dead.cancel("client-disconnect")
    sched._pending.extend(es)
    groups = sched._drain_groups()
    assert [len(g) for g in groups.values()] == [2]
    assert cleaned == [0, 1]            # the dead entries' pins, now
    assert all(e.future.cancelled() for e in es[:2])
    assert sched.stats()["cancelled"] == 2


def test_an_all_cancelled_wave_is_not_launched(sched, monkeypatch):
    from gsky_tpu_torch.pipeline.waves import _StagedWave
    launched = []
    monkeypatch.setattr(sched, "_timed_dispatch",
                        lambda *a: launched.append(a) or ())
    cleaned = []
    dead = CancelToken()
    es = _entries(3, dead, cleaned)
    dead.cancel("deadline")
    assert sched._dispatch_staged(_StagedWave("byte", ("k",), es)) == 0
    assert launched == [] and cleaned == [0, 1, 2]
    assert sched.stats()["cancelled"] == 3
    # a partly cancelled wave still launches
    live = _entries(1, None, cleaned)
    es2 = _entries(1, dead, cleaned) + live
    assert sched._dispatch_staged(_StagedWave("byte", ("k",), es2)) == 2
    assert len(launched) == 1


def test_the_drainer_discards_dead_lanes(sched):
    import torch
    dead = CancelToken()
    es = _entries(1, dead, []) + _entries(1, None, [])
    dead.cancel("client-disconnect")
    sched._ensure_threads()
    sched._put_readback([("byte", es, (torch.arange(2)[:, None],))])
    assert es[1].future.result(TIMEOUT).tolist() == [1]
    deadline = time.monotonic() + TIMEOUT
    while not es[0].future.cancelled() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert es[0].future.cancelled()
    assert sched.stats()["cancelled"] == 1


def test_a_waiting_lane_unwinds_when_its_token_fires(sched):
    tok = CancelToken()
    e, = _entries(1, tok, [])
    errs = []

    def wait():
        try:
            sched._wait(e)
        except RequestCancelled as ex:
            errs.append(ex.stage)
    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.1)
    tok.cancel("client-disconnect")
    t.join(TIMEOUT)
    assert errs == ["wave"]


@pytest.mark.parametrize("level,cap,depth", [(None, 8, 1), (1, 4, 1),
                                             (2, 2, 1)])
def test_brownout_clamps_wave_size_and_runahead(sched, monkeypatch, level,
                                                cap, depth):
    monkeypatch.setenv("GSKY_WAVE_QUEUE", "3")
    _force(level)
    try:
        sched._pending.extend(_entries(12, None, []))
        groups = sched._drain_groups()
        assert sum(len(g) for g in groups.values()) == cap
        st = sched.stats()
        assert st["effective_max"] == cap and st["wave_max"] == 8
        assert st["queue_depth"] == (3 if level is None else depth)
    finally:
        _force(None)
