"""Port parity, the fleet core: `gsky_tpu_torch.fleet` against
`gsky_tpu.fleet`, and the drain on the port's worker service and OWS
server.

The port of `tests/test_fleet.py` without its elastic half (the
autoscaler, preemption and the journal hand-off, ROADMAP A.20): the
consistent-hash ring's preference walks, owners, successors and
bounded-load routes equal the reference's for the same node names and
keys; the phi-accrual states follow the same fake-clock sequence in both;
the hedge decisions and budget, the router's candidates and stats, and
the drain's zero-loss contract hold as in the reference.  The drain is
driven on the worker service, on the port's OWS server over HTTP (a
refused request is 503 with ``Retry-After`` and ``Connection: close``;
``/metrics`` and ``/debug`` keep answering) and on both command lines
(``python -m gsky_tpu_torch.worker.server`` and ``...server.main``) by
SIGTERM.  Every test that starts a server or a process runs under a
time limit of its own (`time_limit`)."""

import concurrent.futures as cf
import gc
import json
import math
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from gsky_tpu import fleet as jfleet

from gsky_tpu_torch.fleet import (DEAD, DRAINING, HEALTHY, SUSPECT,
                                  DrainController, Draining, FleetRouter,
                                  HashRing, HealthMonitor, HedgePolicy,
                                  fleet_stats, hedged_call,
                                  least_loaded_node, tile_route_key)
from gsky_tpu_torch.worker import gskyrpc as pb

from test_torch_worker import REPO, start_process, time_limit

NODES = [f"10.0.0.{i}:11429" for i in range(1, 6)]
KEYS = [f"layer|EPSG:3857|{i}|256x256" for i in range(2000)]


# ---------------------------------------------------------------------------
# hash ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vnodes", [1, 16, 64])
def test_ring_walks_equal_the_reference(vnodes):
    """The same node names and keys give the same preference walks,
    owners, successors and bounded-load routes in both packages."""
    ring = HashRing(NODES, vnodes=vnodes)
    ref = jfleet.HashRing(NODES, vnodes=vnodes)
    for k in KEYS[:400]:
        assert ring.preference(k) == ref.preference(k)
        assert ring.preference(k, 2) == ref.preference(k, 2)
        assert ring.owner(k) == ref.owner(k)
    for n in NODES + ["not-a-member:9"]:
        assert ring.successor(n) == ref.successor(n)
    load = {n: (9 if i == 2 else i) for i, n in enumerate(NODES)}
    for k in KEYS[:200]:
        for bound in (0.0, 1.0, 1.25, 2.0):
            assert ring.route(k, load=load, bound=bound) == \
                ref.route(k, load=load, bound=bound)
        ok = lambda n: n != NODES[0]  # noqa: E731
        assert ring.route(k, eligible=ok, load=load, bound=1.25) == \
            ref.route(k, eligible=ok, load=load, bound=1.25)
    assert ring.generation == ref.generation == 1


def test_ring_stable_assignment():
    ring = HashRing(NODES)
    a = {k: ring.owner(k) for k in KEYS}
    b = {k: HashRing(list(reversed(NODES))).owner(k) for k in KEYS}
    assert a == b          # membership order is irrelevant
    counts = {n: 0 for n in NODES}
    for n in a.values():
        counts[n] += 1
    assert min(counts.values()) > len(KEYS) / len(NODES) / 3


def test_ring_rebalance_moves_only_dead_nodes_arc():
    ring = HashRing(NODES)
    before = {k: ring.owner(k) for k in KEYS}
    dead = NODES[2]
    gen0 = ring.generation
    ring.set_nodes([n for n in NODES if n != dead])
    assert ring.generation == gen0 + 1
    after = {k: ring.owner(k) for k in KEYS}
    moved = [k for k in KEYS if before[k] != after[k]]
    assert all(before[k] == dead for k in moved)
    assert 0 < len(moved) <= 2 * len(KEYS) / len(NODES)
    ring2 = HashRing([n for n in NODES if n != dead])
    assert all(after[k] == ring2.owner(k) for k in moved)
    ref = jfleet.HashRing([n for n in NODES if n != dead])
    assert all(after[k] == ref.owner(k) for k in KEYS)


def test_ring_set_nodes_noop_keeps_generation():
    ring = HashRing(NODES)
    g = ring.generation
    ring.set_nodes(list(reversed(NODES)))
    assert ring.generation == g


def test_ring_preference_walk_distinct_and_deterministic():
    ring = HashRing(NODES, vnodes=32)
    for k in KEYS[:50]:
        pref = ring.preference(k)
        assert len(pref) == len(set(pref)) == len(NODES)
        assert pref == ring.preference(k)
        assert pref[0] == ring.owner(k)


def test_ring_bounded_load_spills_deterministically():
    ring = HashRing(NODES)
    key = KEYS[0]
    pref = ring.preference(key)
    home = pref[0]
    load = {n: 0 for n in NODES}
    load[home] = 10
    routed = ring.route(key, load=load, bound=1.25)
    assert routed[-1] == home
    assert routed[:-1] == [n for n in pref if n != home]
    assert routed == ring.route(key, load=dict(load), bound=1.25)
    assert ring.route(key, load={n: 2 for n in NODES}, bound=1.25) == pref
    assert ring.route(key, load=load, bound=0.0) == pref


def test_ring_route_eligible_filter_falls_back_when_empty():
    ring = HashRing(NODES)
    key = KEYS[1]
    assert ring.route(key, eligible=lambda n: False) == \
        ring.preference(key)
    only = ring.preference(key)[3]
    assert ring.route(key, eligible=lambda n: n == only) == [only]


def test_ring_successor_deterministic_and_distinct():
    ring = HashRing(NODES)
    for n in NODES:
        s = ring.successor(n)
        assert s in NODES and s != n
        assert HashRing(list(reversed(NODES))).successor(n) == s
    assert HashRing(["solo:1"]).successor("solo:1") is None
    assert ring.successor("not-a-member:9") is None


@pytest.mark.parametrize("bbox", [(1.0000001, 2.0, 3.0, 4.0),
                                  (1.1, 2.0, 3.0, 4.0),
                                  (-180.0, -85.0511, 180.0, 85.0511)])
def test_tile_route_key_equals_the_reference(bbox):
    for size in ((256, 256), (512, 128)):
        assert tile_route_key("landsat", "EPSG:3857", bbox, *size) == \
            jfleet.tile_route_key("landsat", "EPSG:3857", bbox, *size)
    a = tile_route_key("landsat", "EPSG:3857",
                       (1.0000001, 2.0, 3.0, 4.0), 256, 256)
    b = tile_route_key("landsat", "EPSG:3857",
                       (1.0000002, 2.0, 3.0, 4.0), 256, 256)
    assert a == b


# ---------------------------------------------------------------------------
# phi-accrual health
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _health_sequence(mod):
    """A scripted heartbeat/failure/draining sequence on a fake clock:
    the (state, phi) of each node after every step."""
    clk = FakeClock()
    mon = mod.HealthMonitor(["a", "b"], interval_s=0, suspect_phi=3.0,
                            dead_phi=8.0, clock=clk)
    out = []

    def snap():
        out.append({n: (mon.state(n), round(mon.phi(n), 6))
                    for n in ("a", "b", "c")})

    snap()
    for dt in (1.0, 1.0, 0.5, 2.0, 1.0):
        mon.record_heartbeat("a")
        mon.record_heartbeat("b")
        clk.t += dt
        snap()
    for dt in (3.0, 3.0, 30.0):
        clk.t += dt
        mon.record_heartbeat("b")
        snap()
    mon.record_failure("b", fatal=True)
    snap()
    mon.record_heartbeat("a")
    mon.record_draining("a")
    snap()
    mon.record_heartbeat("c")
    mon.forget(["c"])
    snap()
    out.append(mon.snapshot())
    return out


def test_health_states_equal_the_reference():
    assert _health_sequence(
        __import__("gsky_tpu_torch.fleet", fromlist=["x"])) \
        == _health_sequence(jfleet)


def test_phi_accrual_state_transitions():
    clk = FakeClock()
    mon = HealthMonitor(["a", "b"], interval_s=0, suspect_phi=3.0,
                        dead_phi=8.0, clock=clk)
    assert mon.state("a") == HEALTHY
    for _ in range(5):
        mon.record_heartbeat("a")
        clk.t += 1.0
    assert mon.state("a") == HEALTHY
    clk.t += 6.0
    assert mon.state("a") == SUSPECT
    clk.t += 60.0
    assert mon.state("a") == DEAD
    mon.record_heartbeat("a")
    assert mon.state("a") == HEALTHY


def test_health_fatal_report_and_draining():
    clk = FakeClock()
    mon = HealthMonitor(["a"], interval_s=0, clock=clk)
    mon.record_heartbeat("a")
    mon.record_failure("a", fatal=True)
    assert mon.state("a") == DEAD
    assert not mon.routable("a")
    mon.record_heartbeat("a")
    assert mon.state("a") == HEALTHY
    mon.record_draining("a")
    assert mon.state("a") == DRAINING
    assert not mon.routable("a")
    snap = mon.snapshot()
    assert snap["a"]["beats"] == 2 and snap["a"]["failures"] == 1


def test_health_active_probe_thread_feeds_states():
    calls = []

    def probe(n):
        calls.append(n)
        return {"a": True, "b": False, "c": DRAINING}[n]

    mon = HealthMonitor(["a", "b", "c"], probe=probe, interval_s=0.01)
    mon.start()
    t_end = time.time() + 5.0
    while time.time() < t_end and len(calls) < 9:
        time.sleep(0.01)
    mon.stop()
    assert mon.state("a") == HEALTHY
    assert mon.snapshot()["b"]["failures"] > 0
    assert mon.state("c") == DRAINING


def test_health_purge_departed_nodes():
    mon = HealthMonitor(NODES[:2])
    for i in range(200):
        n = f"flap-{i}:1"
        mon.record_heartbeat(n)
        assert n in mon.nodes()
        assert mon.forget([n]) == 1
    assert mon.nodes() == sorted(NODES[:2])
    mon.set_nodes([NODES[0], "new:1"])
    assert mon.nodes() == sorted([NODES[0], "new:1"])
    assert mon.state(NODES[1]) == DEAD


# ---------------------------------------------------------------------------
# hedged dispatch
# ---------------------------------------------------------------------------


def _future_returning(value, after_s=0.0):
    ex = cf.ThreadPoolExecutor(1)

    def work():
        if after_s:
            time.sleep(after_s)
        return value

    return lambda: ex.submit(work)


def test_hedge_not_fired_before_delay():
    hedged = []

    def hedge():
        hedged.append(1)
        return _future_returning("hedge")()

    res, won = hedged_call(_future_returning("fast", 0.0), hedge,
                           delay_s=0.5, timeout_s=5.0)
    assert res == "fast" and not won and not hedged


def test_hedge_fires_past_delay_and_wins():
    res, won = hedged_call(_future_returning("slow", 2.0),
                           _future_returning("hedge", 0.05),
                           delay_s=0.05, timeout_s=10.0)
    assert res == "hedge" and won


def test_hedge_loser_cancellation_frees_permit():
    released = []
    ex = cf.ThreadPoolExecutor(1)
    gate = threading.Event()

    def primary():
        return _future_returning("primary", 0.3)()

    def hedge():
        ex.submit(gate.wait, 5.0)
        return ex.submit(lambda: "hedge")

    res, won = hedged_call(primary, hedge, delay_s=0.05, timeout_s=10.0,
                           on_hedge_cancelled=lambda: released.append(1))
    gate.set()
    assert res == "primary" and not won
    assert released == [1]


def test_hedge_errored_winner_forfeits_to_loser():
    def primary():
        ex = cf.ThreadPoolExecutor(1)

        def die():
            time.sleep(0.2)
            raise RuntimeError("primary died")

        return ex.submit(die)

    res, won = hedged_call(primary, _future_returning("hedge", 0.3),
                           delay_s=0.05, timeout_s=10.0)
    assert res == "hedge" and won


def _hedge_decisions(mod):
    """Delays, token spends and stats over one scripted latency feed."""
    pol = mod.HedgePolicy(percentile=0.99, min_delay_s=0.01,
                          initial_delay_s=1.0, budget=0.3, min_samples=10,
                          window=64)
    out = [pol.delay_s()]
    for i in range(150):
        pol.observe(0.005 * (1 + i % 17) + (2.0 if i % 50 == 49 else 0.0))
        if i % 3 == 0:
            pol.on_primary()
        if i % 7 == 0:
            out.append(pol.try_hedge())
        if i % 10 == 0:
            out.append(round(pol.delay_s(), 9))
    out.append(pol.stats())
    return out


def test_hedge_decisions_and_budget_equal_the_reference():
    assert _hedge_decisions(
        __import__("gsky_tpu_torch.fleet", fromlist=["x"])) \
        == _hedge_decisions(jfleet)


def test_hedge_policy_adaptive_delay_and_budget():
    pol = HedgePolicy(percentile=0.99, min_delay_s=0.01,
                      initial_delay_s=1.0, budget=0.5, min_samples=10)
    assert pol.delay_s() == 1.0
    for _ in range(99):
        pol.observe(0.01)
    pol.observe(2.0)
    assert pol.delay_s() == pytest.approx(2.0)
    assert pol.try_hedge()
    assert not pol.try_hedge()
    pol.on_primary()
    pol.on_primary()
    assert pol.try_hedge()
    s = pol.stats()
    assert s["hedges"] == 2 and s["hedges_denied"] == 1


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


def _router_script(mod, name):
    """Candidates and stats of a router through a scripted run."""
    r = mod.FleetRouter(NODES, name=name, vnodes=32, bound=1.25)
    try:
        out = []
        for i, k in enumerate(KEYS[:60]):
            cand = r.candidates(k)
            out.append(cand)
            r.task_started(cand[0])
            if i % 4 == 0:
                r.task_finished(cand[0])
            r.record_locality(f"k{i % 7}", cand[0])
            if i == 10:
                r.node_result(NODES[1], ok=False, fatal=True)
            if i == 20:
                r.node_result(NODES[3], ok=True, draining=True)
            if i == 30:
                r.record_reroute()
                r.record_rr()
            if i == 40:
                r.node_result(NODES[1], ok=True, latency_s=0.02)
        st = r.stats()
        for h in st["health"].values():
            h.pop("phi")             # the wall clock's
        out.append(st)
        out.append(r.locality_rate())
        out.append(r.peers_for(KEYS[0], n=3, exclude=NODES[0]))
        return out
    finally:
        r.close()


def test_router_candidates_and_stats_equal_the_reference(monkeypatch):
    monkeypatch.setenv("GSKY_FLEET", "1")
    monkeypatch.setenv("GSKY_FLEET_HEDGE", "1")
    assert _router_script(
        __import__("gsky_tpu_torch.fleet", fromlist=["x"]), "parity-t") \
        == _router_script(jfleet, "parity-t")


def test_router_candidates_health_gated(monkeypatch):
    monkeypatch.setenv("GSKY_FLEET", "1")
    r = FleetRouter(NODES, name="t1")
    try:
        key = KEYS[0]
        pref = r.ring.preference(key)
        assert r.candidates(key) == pref
        r.monitor.record_failure(pref[0], fatal=True)
        cand = r.candidates(key)
        assert cand[-1] == pref[0]
        assert cand[:-1] == pref[1:]
        assert len(cand) == len(NODES)
        r.node_result(pref[1], ok=True, draining=True)
        assert r.candidates(key)[0] == pref[2]
    finally:
        r.close()


def test_router_locality_ledger_and_stats():
    r = FleetRouter(NODES[:3], name="t2")
    try:
        r.record_locality("k1", "a")
        r.record_locality("k1", "a")
        r.record_locality("k1", "b")
        r.record_locality("k2", "a")
        assert r.locality_hits == 1 and r.locality_misses == 1
        assert r.locality_rate() == 0.5
        st = r.stats()
        assert st["routed"] == 4
        assert st["ring"]["generation"] == 1
        assert st["locality"]["rate"] == 0.5
        assert st["hedge"]["enabled"] in (True, False)
        assert "t2" in fleet_stats()
    finally:
        r.close()


def test_router_disabled_falls_back_to_plain_nodes(monkeypatch):
    monkeypatch.setenv("GSKY_FLEET", "0")
    r = FleetRouter(NODES, name="t3")
    try:
        assert not r.enabled
        assert r.candidates(KEYS[0]) == r.ring.nodes
    finally:
        r.close()


def test_least_loaded_node_names_a_healthy_node():
    # the registry is process-wide: routers of earlier tests out of it
    from gsky_tpu_torch.fleet import router as router_mod
    gc.collect()
    with router_mod._routers_lock:
        router_mod._ROUTERS.clear()
    r = FleetRouter(NODES[:3], name="t4")
    try:
        for n, k in zip(NODES[:3], (3, 1, 2)):
            for _ in range(k):
                r.task_started(n)
        assert least_loaded_node() in NODES[:3]
        r.monitor.record_failure(NODES[1], fatal=True)
        assert least_loaded_node() != NODES[1]
    finally:
        r.close()


def test_router_set_nodes_purges_stale_state():
    r = FleetRouter(NODES[:3], name="churn1")
    try:
        gen0 = r.ring.generation
        for i in range(100):
            n = f"flap-{i}:1"
            r.set_nodes(NODES[:3] + [n])
            r.task_started(n)
            r.record_locality(f"key-{i}", n)
            r.set_nodes(NODES[:3])
        assert r.ring.generation == gen0 + 200
        assert set(r.stats()["load"]) <= set(NODES[:3])
        assert all(v in NODES[:3] for v in r._last_node.values())
        assert r.monitor.nodes() == sorted(NODES[:3])
    finally:
        r.close()


def test_ring_generation_churn_keeps_routing_deterministic():
    r = FleetRouter(NODES[:3], name="churn2", bound=2.0)
    try:
        served = 0
        members = list(NODES[:3])
        for step in range(30):
            if step % 3 == 2 and len(members) > 2:
                members.pop(0)
            else:
                members.append(f"elastic-{step}:1")
            r.set_nodes(members)
            twin = HashRing(sorted(members), vnodes=r.ring.vnodes)
            for k in KEYS[:40]:
                assert r.ring.preference(k) == twin.preference(k)
                cand = r.candidates(k)
                assert cand and set(cand) == set(members)
                served += 1
            load = {n: (7 if i == 0 else 1) for i, n in enumerate(members)}
            cap = math.ceil(2.0 * sum(load.values()) / len(members))
            for k in KEYS[40:60]:
                routed = r.ring.route(k, load=load, bound=2.0)
                under = [n for n in routed if load[n] < cap]
                if under:
                    assert routed[0] in under
        assert served == 30 * 40
    finally:
        r.close()


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------


def test_drain_completes_inflight_and_refuses_new():
    dc = DrainController("test")
    started = threading.Event()
    release = threading.Event()
    done = []

    def worker():
        with dc.track():
            started.set()
            release.wait(5.0)
            done.append(1)

    t = threading.Thread(target=worker)
    t.start()
    started.wait(5.0)
    dc.start_drain()
    with pytest.raises(Draining):
        with dc.track():
            pass
    assert not dc.wait_drained(timeout_s=0.05)
    release.set()
    assert dc.wait_drained(timeout_s=5.0)
    t.join(5.0)
    assert done == [1]
    assert dc.stats() == {"draining": True, "inflight": 0, "refused": 1,
                          "completed": 1, "abandoned": 0}


def test_drain_grace_deadline_abandons_explicitly():
    dc = DrainController("grace")
    started = threading.Event()
    release = threading.Event()

    def worker():
        with dc.track():
            started.set()
            release.wait(5.0)

    t = threading.Thread(target=worker)
    t.start()
    started.wait(5.0)
    dc.start_drain()
    assert not dc.wait_drained(timeout_s=0.05)
    assert dc.abandon_inflight() == 1
    assert dc.stats()["abandoned"] == 1
    release.set()
    t.join(5.0)


def _stub_pool():
    import types
    return types.SimpleNamespace(size=1,
                                 queue=types.SimpleNamespace(maxsize=8),
                                 submit=lambda task: pb.Result(),
                                 close=lambda: None,
                                 stats=lambda: {"size": 1})


def test_worker_service_drain_zero_loss():
    """WorkerService under drain: the in-flight op completes and is
    delivered, new ops answer 'draining:', worker_info still answers
    (it is the drain handshake) and says it is draining."""
    from gsky_tpu_torch.worker.server import WorkerService
    svc = WorkerService(pool=_stub_pool(), device="cpu")
    try:
        gate = threading.Event()
        orig = svc._worker_info

        def tracked():
            with svc.drain.track():
                gate.wait(5.0)
                return orig()

        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(tracked)
            while svc.drain.inflight == 0:
                time.sleep(0.005)
            svc.drain.start_drain()
            r = svc.process(pb.Task(operation="extent"))
            assert r.error.startswith("draining:")
            info = svc.process(pb.Task(operation="worker_info"))
            assert not info.error
            assert json.loads(info.info_json)["draining"] is True
            gate.set()
            assert not fut.result(timeout=5.0).error
        assert svc.drain.wait_drained(timeout_s=5.0)
    finally:
        svc.close()


def _empty_conf(tmp_path):
    conf = tmp_path / "conf"
    conf.mkdir()
    (conf / "config.json").write_text(json.dumps({
        "service_config": {"ows_hostname": "", "mas_address": ""},
        "layers": []}))
    return str(conf)


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_ows_drain_zero_inflight_loss_over_http(tmp_path):
    """OWSServer.shutdown(): the in-flight request finishes and is
    delivered, a new /ows request gets the draining 503 with
    Retry-After and Connection: close, /metrics and /debug keep
    answering; the drain block counts one refused, one completed."""
    from gsky_tpu_torch.server.config import ConfigWatcher
    from gsky_tpu_torch.server.metrics import MetricsLogger
    from gsky_tpu_torch.server.ows import OWSServer, Response
    with time_limit(30):
        watcher = ConfigWatcher(_empty_conf(tmp_path), install_signal=False)
        server = OWSServer(watcher, mas_factory=lambda a: None,
                           device="cpu", gateway=None,
                           metrics=MetricsLogger())
        entered, release = threading.Event(), threading.Event()

        def slow_answer(*a, **k):
            entered.set()
            release.wait(10.0)
            return Response(200, "text/plain", b"ok")

        server._answer = slow_answer
        httpd = server.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with cf.ThreadPoolExecutor(2) as ex:
                inflight = ex.submit(_get, base + "/ows?service=WMS")
                assert entered.wait(10.0)
                shut = ex.submit(server.shutdown, 10.0)
                while not server.drain.draining:
                    time.sleep(0.01)
                status, headers, body = _get(base + "/ows?service=WMS")
                assert status == 503
                assert headers.get("Retry-After") == "5"
                assert headers.get("Connection") == "close"
                assert b"ServerBusy" in body
                # the observability routes are not gated
                assert _get(base + "/metrics")[0] == 200
                status, _, body = _get(base + "/debug")
                assert status == 200
                assert json.loads(body)["drain"]["draining"] is True
                release.set()
                assert inflight.result(10.0)[:1] == (200,)
                assert inflight.result()[2] == b"ok"
                assert shut.result(10.0) is True
        finally:
            release.set()
            httpd.shutdown()
            httpd.server_close()
        st = server.drain.stats()
        assert st["refused"] == 1 and st["completed"] == 1 \
            and st["inflight"] == 0


def test_ows_drain_timeout_reports_false(tmp_path):
    from gsky_tpu_torch.server.config import ConfigWatcher
    from gsky_tpu_torch.server.ows import OWSServer
    watcher = ConfigWatcher(_empty_conf(tmp_path), install_signal=False)
    server = OWSServer(watcher, mas_factory=lambda a: None, device="cpu",
                       gateway=None)
    with server.drain.track():
        t0 = time.monotonic()
        assert server.shutdown(timeout_s=0.2) is False
        assert time.monotonic() - t0 < 2.0
    assert server.drain.stats()["inflight"] == 0


def test_ows_command_line_drains_on_sigterm(tmp_path):
    """``python -m gsky_tpu_torch.server.main`` on SIGTERM: the drain
    runs with the listener open and the process exits 0."""
    with time_limit(30):
        proc, port = start_process(
            [sys.executable, "-m", "gsky_tpu_torch.server.main",
             "-port", "0", "-host", "127.0.0.1", "-conf",
             _empty_conf(tmp_path), "-device", "cpu"],
            "listening on", env={"GSKY_PREWARM": "0"})
        try:
            base = f"http://127.0.0.1:{port}"
            assert _get(base + "/ows?service=WMS&request="
                               "GetCapabilities")[0] == 200
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(20) == 0
            proc.reader.join(5)
            assert "drain complete" in "".join(proc.lines)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(5)


def test_worker_command_line_drains_on_sigterm(tmp_path):
    """``python -m gsky_tpu_torch.worker.server`` on SIGTERM with an RPC
    in flight (its decode held 1.5 s by a pool latency fault): the RPC
    is answered, a new one gets ``draining:``, the process exits 0."""
    from gsky_tpu_torch.worker import WorkerClient
    from gsky_tpu_torch.worker.client import dial
    with time_limit(30):
        proc, port = start_process(
            [sys.executable, "-m", "gsky_tpu_torch.worker.server",
             "-p", "0", "-host", "127.0.0.1", "-n", "1", "-device", "cpu",
             "-oom_threshold", "0"],
            "listening on", env={"GSKY_PREWARM": "0",
                                 "GSKY_FAULTS": "pool:latency:1.5s"})
        addr = f"127.0.0.1:{port}"
        ch, stub = dial(addr)
        c = WorkerClient([addr])
        try:
            path = os.path.join(REPO, "README.md")   # any file: info errs
            with cf.ThreadPoolExecutor(1) as ex:
                fut = ex.submit(stub, pb.Task(operation="info", path=path),
                                timeout=20.0)
                time.sleep(0.5)
                proc.send_signal(signal.SIGTERM)
                time.sleep(0.3)
                late = stub(pb.Task(operation="info", path=path),
                            timeout=10.0)
                assert late.error.startswith("draining:"), late.error
                res = fut.result(20.0)
            # answered by the decode subprocess (an error record for a
            # file no reader claims), not lost to the drain
            assert not res.error, res.error
            assert json.loads(res.info_json)["filename"] == path
            assert proc.wait(20) == 0
        finally:
            c.close()
            ch.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(5)
