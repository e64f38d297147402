"""Port parity, the elastic fleet (`gsky_tpu_torch/fleet/elastic.py`, the
worker's ``preempt``, ``journal_handoff`` and ``page_fetch`` ops) against
the JAX package's (`tests/test_fleet.py` from its elastic half on).

Held equal (exactly): the ring successor, the preempt fault kinds and
their one notice a process, the preemption protocol through each
package's `WorkerService` (what it ships to whom, its counters), the
journal hand-off's ``elastic`` block and merged journal, the demand
signal's samples and the autoscaler's decisions under one scripted
demand trace and fake clock, the reference's env defaults and the port's
constants.  The port alone: a hand-off whose pages come from the
preempted node's pool over the carrier (bytes equal), the pool kept
resident through the preemption's journal flush, a node with an empty
journal warming from a peer's hot set before it reports ready, and two
workers started by ``main`` each with a journal of its own.
"""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest

from gsky_tpu.device_guard import journal as jjournal
from gsky_tpu.fleet import FleetRouter as JFleetRouter
from gsky_tpu.fleet import elastic as jelastic
from gsky_tpu.fleet.ring import HashRing as JHashRing
from gsky_tpu.resilience import faults as jfaults

from gsky_tpu_torch.device_guard import journal as tjournal
from gsky_tpu_torch.fleet import FleetRouter, HashRing
from gsky_tpu_torch.fleet import elastic as telastic
from gsky_tpu_torch.resilience import faults as tfaults
from gsky_tpu_torch.worker import gskyrpc as pb
from gsky_tpu_torch.worker.server import WorkerService, make_server

from test_torch_worker import start_process, time_limit

NODES = [f"10.0.0.{i}:11429" for i in range(1, 6)]
PKG = {"ref": (jelastic, jjournal, jfaults, JFleetRouter),
       "port": (telastic, tjournal, tfaults, FleetRouter)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for el in (jelastic, telastic):
        el.reset_stats()
    yield
    for el in (jelastic, telastic):
        el.reset_stats()
    for f in (jfaults, tfaults):
        f.set_preempt_handler(None)
        f.reset()


def test_successor_for_equal():
    for members in (NODES[:1], NODES[:2], NODES, NODES[::-1],
                    ["a:1", "b:1", "c:1"]):
        for me in members + ["stranger:9"]:
            peers = [n for n in members if n != me]
            assert telastic.successor_for(me, peers) == \
                jelastic.successor_for(me, peers)
        ring, jring = HashRing(members), JHashRing(members)
        for n in members + ["stranger:9"]:
            assert ring.successor(n) == jring.successor(n)
    assert telastic.successor_for("solo:1", []) is None


def test_elastic_knobs_equal(monkeypatch):
    """The reference's elastic env knobs are constants and argument
    defaults in the port (ROADMAP C.18): with the knobs unset, the same
    values; the gate parses alike."""
    for name in ("GSKY_PREEMPT_GRACE_S", "GSKY_ELASTIC_HANDOFF_MAX",
                 "GSKY_ELASTIC_WARM_FRAC", "GSKY_ELASTIC_ALPHA") + tuple(
                     "GSKY_ELASTIC_" + k for k in (
                         "MIN", "MAX", "INTERVAL_S", "UP", "DOWN",
                         "UP_TICKS", "DOWN_TICKS", "COOLDOWN_S",
                         "READY_TIMEOUT_S")):
        monkeypatch.delenv(name, raising=False)
    assert (telastic.PREEMPT_GRACE_S, telastic.HANDOFF_MAX,
            telastic.WARM_FRAC) == \
        (jelastic.preempt_grace_s(), jelastic.handoff_max(),
         jelastic.warm_fraction_target())
    fields = ("min_nodes", "max_nodes", "interval_s", "up", "down",
              "up_ticks", "down_ticks", "cooldown_s", "ready_timeout_s",
              "drain_grace_s")
    got = {}
    for k in PKG:
        el = PKG[k][0]
        client = _Client(PKG[k][3], ["n1:1"])
        a = el.Autoscaler(_Provider(), client, name=f"defaults-{k}")
        d = el.DemandSignal()
        d.sample()
        d.sample()
        got[k] = ({f: getattr(a, f) for f in fields}, d.smoothed)
        a.stop()
        client.fleet.close()
    assert got["port"] == got["ref"]
    for v in ("", "0", "1", "yes", "bogus"):
        monkeypatch.setenv("GSKY_ELASTIC", v)
        assert telastic.elastic_enabled() == jelastic.elastic_enabled()


def test_preempt_fault_kinds_parse_and_fire_once():
    """``node:preempt`` rides the fault spec and delivers one notice a
    process through the handler, in both packages alike."""
    out = {}
    for k in PKG:
        faults = PKG[k][2]
        rules = faults.parse_spec("node:preempt:3s,node:preempt_nograce:0.0")
        kinds = sorted(r.kind for r in rules["node"])
        with pytest.raises(ValueError):
            faults.parse_spec("node:preempt")
        notices = []
        faults.set_preempt_handler(
            lambda grace_s, graceful: notices.append((grace_s, graceful)))
        faults.configure("node:preempt:3s:1.0", seed=7)
        faults.inject("node")
        faults.inject("node")                  # one notice, not two
        faults.configure("node:preempt_nograce:1.0", seed=7)
        faults.inject("node")
        faults.configure("node:preempt:1s:0.5", seed=3)
        for _ in range(20):
            faults.inject("node")
        faults.set_preempt_handler(None)
        faults.reset()
        out[k] = (kinds, notices)
    assert out["port"] == out["ref"]
    assert out["port"][1][:2] == [(3.0, True), (0.0, False)]
    assert len(out["port"][1]) == 3


def _pool_stub(submit=lambda task: pb.Result()):
    return types.SimpleNamespace(size=1, queue=types.SimpleNamespace(
        maxsize=8), submit=submit, close=lambda: None,
        stats=lambda: {"size": 1})


def _services():
    """Each package's `WorkerService` over a stub decode pool."""
    from gsky_tpu.worker import gskyrpc_pb2 as jpb
    from gsky_tpu.worker.server import WorkerService as JWorkerService
    jsvc = JWorkerService(pool=types.SimpleNamespace(
        size=1, queue=types.SimpleNamespace(maxsize=8),
        submit=lambda task: jpb.Result(), close=lambda: None))
    return {"ref": (jsvc, jpb), "port": (WorkerService(pool=_pool_stub(),
                                                       device="cpu"), pb)}


def test_preemption_protocol_equal(tmp_path, monkeypatch):
    """The notice drains under the grace deadline, ships the scored
    journal to the named successor, exits through ``preempt_exit``; a
    second notice does nothing.  Both packages ship the same document
    and count alike."""
    out = {}
    svcs = _services()
    for k, (svc, mpb) in svcs.items():
        el, jr = PKG[k][0], PKG[k][1]
        monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / f"{k}.jsonl"))
        jr.record_stage(5, 0, 0)
        jr.record_heat(5, 0, 1, hits=9)
        jr.record_stage(6, 2, 1)
        shipped = []
        monkeypatch.setattr(
            el, "control_rpc",
            lambda addr, op, doc=None, timeout=5.0:
                shipped.append((addr, op, doc)) or {"accepted": 1})
        svc.advertise_addr = "me:1"
        exited = threading.Event()
        svc.preempt_exit = exited.set
        task = mpb.Task(operation="preempt")
        task.path = json.dumps({"grace_s": 1.0, "successor": "peer:1",
                                "peers": ["peer:1", "peer:2"]})
        t0 = time.monotonic()
        r = svc.process(task)
        assert not r.error
        assert exited.wait(10.0)
        waited = time.monotonic() - t0
        assert 0.5 <= waited < 5.0             # held to the grace window
        assert svc.drain.draining
        again = svc.begin_preemption(5.0)
        out[k] = (json.loads(r.info_json), shipped, el.counters(), again,
                  jr.replay_scored())
        svc.close()
    assert out["port"] == out["ref"]
    _, shipped, counters, again, _ = out["port"]
    assert shipped[0][:2] == ("peer:1", "journal_handoff")
    assert shipped[0][2]["peers"] == ["peer:2"]
    assert shipped[0][2]["source"] == "me:1"
    assert {tuple(e[:3]) for e in shipped[0][2]["entries"]} == \
        {(5, 0, 0), (5, 0, 1), (6, 2, 1)}
    assert counters["preemptions"]["graceful"] == 1
    assert counters["handoffs_shipped"] == 1 and again is False


def test_preemption_keeps_the_pool_resident(tmp_path, monkeypatch):
    """The port's journal flush on preemption writes the hot set's heat
    and keeps the pool, so page_fetch serves the successor through the
    grace window (the reference tears its pool down there)."""
    monkeypatch.setenv("GSKY_FABRIC", "1")
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "j.jsonl"))
    monkeypatch.setattr(telastic, "control_rpc",
                        lambda *a, **kw: {"accepted": 1})
    svc = WorkerService(pool=_pool_stub(), device="cpu")
    pool = svc.executor.pool
    page = np.arange(pool.page_rows * pool.page_cols,
                     dtype=np.float32).reshape(pool.page_rows, -1)
    assert pool.stage_page(42, 1, 2, page)
    svc.advertise_addr = "me:1"
    exited = threading.Event()
    svc.preempt_exit = exited.set
    svc.begin_preemption(0.5, successor="peer:1")
    assert exited.wait(10.0)
    res = svc.process(pb.Task(operation="page_fetch", path=json.dumps(
        {"pages": [[42, 1, 2], [1, 1, 1]]})))
    assert not res.error
    from gsky_tpu_torch.fabric import pagerpc
    got = pagerpc.decode_result(res.info_json, res.raster)
    assert list(got) == [(42, 1, 2)]
    assert got[(42, 1, 2)].tobytes() == page.tobytes()
    heat = [json.loads(ln) for ln in open(tmp_path / "j.jsonl")
            if '"heat"' in ln]
    assert [(h["serial"], h["pi"], h["pj"]) for h in heat] == [(42, 1, 2)]
    svc.close()


def test_journal_handoff_elastic_block_equal(tmp_path, monkeypatch):
    """The successor's half with the fabric off: the entries merge into
    its journal hottest first, every page counts cold, and
    ``worker_info``'s ``elastic`` block reports them, alike in both (the
    port's block adds this process's elastic ``counters``)."""
    monkeypatch.delenv("GSKY_FABRIC", raising=False)
    out = {}
    for k, (svc, mpb) in _services().items():
        el, jr = PKG[k][0], PKG[k][1]
        monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / f"{k}.jsonl"))
        task = mpb.Task(operation="journal_handoff")
        task.path = json.dumps({
            "v": 1, "source": "dead:1", "peers": [],
            "entries": [[7, 0, 0, 12.0], [7, 0, 1, 3.0],
                        ["bad"], [8, -1, 0, 1.0]]})
        r = svc.process(task)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                el.counters()["handoff_pages"]["cold"] < 2:
            time.sleep(0.02)
        info = json.loads(svc.process(
            mpb.Task(operation="worker_info")).info_json)["elastic"]
        counters = info.pop("counters", None)
        bad = svc.process(mpb.Task(operation="journal_handoff", path="{"))
        out[k] = (json.loads(r.info_json), jr.replay_scored(), info,
                  el.counters(), bad.error)
        if k == "port":
            assert counters == el.counters()
        svc.close()
    assert out["port"] == out["ref"]
    accepted, scored, info, counters, bad = out["port"]
    assert accepted == {"accepted": 2}
    assert [s[:3] for s in scored] == [(7, 0, 0), (7, 0, 1)]
    assert info["handoff"] == {"entries": 2, "filled": 0, "cold": 2,
                               "active": 0}
    assert info["ready"] is True and info["warm_fraction"] == 0.0
    assert bad == "elastic: malformed handoff"


def test_handoff_pulls_the_pages_from_the_preempted_pool(tmp_path,
                                                         monkeypatch):
    """Two port workers behind the carrier: the successor, handed the
    preempted node's entries, pulls their pages from that node's
    executor pool over page_fetch (bytes equal, none cold), and its
    ``worker_info`` reports them ready and warm."""
    monkeypatch.setenv("GSKY_FABRIC", "1")
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "j.jsonl"))
    src = WorkerService(pool=_pool_stub(), device="cpu")
    dst = WorkerService(pool=_pool_stub(), device="cpu")
    rng = np.random.default_rng(18)
    pr, pc = src.executor.pool.page_rows, src.executor.pool.page_cols
    keys = [((1 << 52) + 5, i, j) for i in range(3) for j in range(2)]
    pages = {k: rng.uniform(0, 1, (pr, pc)).astype(np.float32)
             for k in keys}
    for k, p in pages.items():
        assert src.executor.pool.stage_page(*k, p)
    servers = [make_server(s, "127.0.0.1:0").start() for s in (src, dst)]
    try:
        with time_limit(30):
            src_addr = f"127.0.0.1:{servers[0].port}"
            from gsky_tpu_torch.worker import WorkerClient
            c = WorkerClient([src_addr])
            got = c.page_fetch(keys[:2] + [(1, 1, 1)])
            c.close()
            assert sorted(got) == keys[:2]
            r = dst.process(pb.Task(operation="journal_handoff",
                                    path=json.dumps({
                                        "v": 1, "source": src_addr,
                                        "peers": [],
                                        "entries": [list(k) + [9.0 - i]
                                                    for i, k in
                                                    enumerate(keys)]})))
            assert json.loads(r.info_json) == {"accepted": len(keys)}
            while dst._handoff["active"]:
                time.sleep(0.02)
        info = json.loads(dst.process(pb.Task(
            operation="worker_info")).info_json)["elastic"]
        assert info["handoff"] == {"entries": 6, "filled": 6, "cold": 0,
                                   "active": 0}
        assert info["counters"]["handoff_pages"] == {"peer": 6, "cold": 0}
        assert info["ready"] is True
        for k, p in pages.items():
            assert dst.executor.pool.read_page(*k).tobytes() == p.tobytes()
        assert dst.executor.pool.stats()["peer_filled"] == 6
        assert src.executor.pool.stats()["hits"] == 0   # passive reads
        assert telastic.probe_info(src_addr)["elastic"]["ready"] is True
        assert telastic.probe_info("127.0.0.1:9", timeout=1.0) is None
    finally:
        for s in servers:
            s.stop(grace=1.0)
        src.close()
        dst.close()


def test_warm_boot_takes_a_peers_hot_set(tmp_path, monkeypatch):
    """A node that starts with an empty journal (as one the autoscaler
    launches: C.18 gives each node its own) reports not ready while its
    warm boot runs; the boot takes the first answering peer's hot set
    (``journal_export``, a dead peer skipped), pulls those pages from
    the peer's pool over page_fetch (bytes equal, none cold) and then
    reports ready and warm.  A node with a journal of its own asks no
    peer for one."""
    monkeypatch.setenv("GSKY_FABRIC", "1")
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "src.jsonl"))
    src = WorkerService(pool=_pool_stub(), device="cpu")
    dst = WorkerService(pool=_pool_stub(), device="cpu")
    rng = np.random.default_rng(24)
    pr, pc = src.executor.pool.page_rows, src.executor.pool.page_cols
    keys = [((1 << 52) + 9, i, j) for i in range(2) for j in range(3)]
    pages = {k: rng.uniform(0, 1, (pr, pc)).astype(np.float32)
             for k in keys}
    for k, p in pages.items():
        assert src.executor.pool.stage_page(*k, p)
    src.executor.pool.flush_heat()
    hot = tjournal.export_hot(telastic.HANDOFF_MAX)
    assert {e[:3] for e in hot} == set(keys)
    # both services share this process's journal; the peer's export
    # answers the source's hot set while the booting node's is empty
    monkeypatch.setattr(tjournal, "export_hot",
                        lambda limit=2048: hot[:limit])
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "dst.jsonl"))
    asked = []
    real_export = src._journal_export
    monkeypatch.setattr(src, "_journal_export",
                        lambda: asked.append(1) or real_export())
    server = make_server(src, "127.0.0.1:0").start()
    try:
        src_addr = f"127.0.0.1:{server.port}"
        monkeypatch.setenv("GSKY_FABRIC_PAGE_PEERS", src_addr)
        exported = telastic.control_rpc(src_addr, "journal_export")
        assert exported["source"] is None and \
            [tuple(e[:3]) for e in exported["entries"]] == \
            [e[:3] for e in hot]
        dst.warming = True
        info = json.loads(dst.process(pb.Task(
            operation="worker_info")).info_json)["elastic"]
        assert info["ready"] is False and info["warm_fraction"] == 1.0
        with time_limit(30):
            n = dst.warm_boot(["127.0.0.1:9", src_addr])
        assert n == len(keys) and dst.warming is False
        assert {tuple(e) for e in tjournal.replay()} == set(keys)
        for k, p in pages.items():
            assert dst.executor.pool.read_page(*k).tobytes() == p.tobytes()
        st = dst.executor.pool.stats()
        assert st["peer_filled"] == len(keys) and st["staged"] == len(keys)
        info = json.loads(dst.process(pb.Task(
            operation="worker_info")).info_json)["elastic"]
        assert info["ready"] is True and info["warm_fraction"] == 1.0
        assert len(asked) == 2
        dst.warm_boot([src_addr])             # its journal is its own now
        assert len(asked) == 2
    finally:
        server.stop(grace=1.0)
        src.close()
        dst.close()


# -- the demand signal and the autoscaler (decisions equal) -----------------

class _Admission:
    def __init__(self, trace):
        self.trace = iter(trace)

    def stats(self):
        in_use, queued, limit = next(self.trace)
        return {"classes": {"WMS": {"in_use": in_use, "queued": queued,
                                    "effective_limit": limit},
                           "WCS": {"in_use": 0, "queued": 0, "limit": 0}}}


def test_demand_signal_equal():
    trace = [(1, 0, 4), (4, 6, 4), (4, 9, 2), (0, 0, 4), (2, 2, 8)] * 2
    press = iter([0, 1, 2, 0, 0] * 2)
    out = {}
    for k in PKG:
        el = PKG[k][0]
        r = PKG[k][3](NODES[:2], name=f"demand-{k}")
        r.task_started(NODES[0])
        press = iter([0, 1, 2, 0, 0] * 2)
        d = el.DemandSignal(admission=_Admission(trace), router=r,
                            occupancy=lambda: 0.25,
                            pressure=lambda: next(press), node_conc=2,
                            alpha=0.5)
        out[k] = [(d.sample(), d.last_raw, dict(d.last_parts))
                  for _ in range(10)]
        r.close()
    assert out["port"] == out["ref"]


class _Provider:
    def __init__(self):
        self.launched, self.preempted, self.terminated = [], [], []

    def launch(self):
        addr = f"prov-{len(self.launched) + 1}:1"
        self.launched.append(addr)
        return addr

    def preempt(self, addr, grace_s, successor=None, peers=()):
        self.preempted.append((addr, grace_s, successor, sorted(peers)))
        return True

    def terminate(self, addr):
        self.terminated.append(addr)

    def alive(self, addr):
        return addr not in self.terminated


class _Client:
    def __init__(self, router_cls, nodes):
        self.fleet = router_cls(list(nodes), name="elastic-fake")
        self.nodes = list(nodes)

    def set_nodes(self, addrs):
        self.nodes = list(addrs)
        self.fleet.set_nodes(addrs)


# one scripted run: (demand, ready, external event) a tick
SCRIPT = ([(1.5, False, None)] * 2 + [(1.5, False, None)] * 2
          + [(0.0, True, None)] + [(0.1, True, None)] * 4
          + [(0.5, True, "drain n2:1")] + [(0.5, True, None)] * 3
          + [(0.9, True, None)] * 4 + [(0.0, True, None)] * 6)


def _scaler_run(k):
    el = PKG[k][0]
    now = [0.0]
    provider = _Provider()
    client = _Client(PKG[k][3], ["n1:1", "n2:1"])
    box = {"demand": 0.0, "ready": False}

    class Demand(el.DemandSignal):
        def sample(self):
            self.smoothed = self.last_raw = box["demand"]
            return box["demand"]

    a = el.Autoscaler(provider, client, name="scripted", min_nodes=2,
                      max_nodes=4, interval_s=0.01, up=0.8, down=0.25,
                      up_ticks=2, down_ticks=3, cooldown_s=5.0,
                      ready_timeout_s=100.0, drain_grace_s=0.01,
                      demand=Demand(),
                      probe=lambda addr: {"elastic": {
                          "ready": box["ready"], "warm_fraction": 0.75}},
                      clock=lambda: now[0])
    samples = []
    for demand, ready, event in SCRIPT:
        box["demand"], box["ready"] = demand, ready
        if event:
            node = event.split()[1]
            client.fleet.monitor.record_heartbeat(node)
            client.fleet.monitor.record_draining(node)
        samples.append((a.tick(), list(client.nodes), a.node_counts()))
        now[0] += 1.5
    time.sleep(0.2)                   # the retire threads' terminate
    st = a.stats()
    a.stop()
    client.fleet.close()
    return (a.decisions, samples, provider.launched,
            provider.preempted, sorted(provider.terminated),
            el.counters(), st["pending"], st["leaving"])


def test_autoscaler_decisions_equal():
    """Scale-up on sustained demand, the readiness wait, the cooldown,
    the join, scale-down with a preemption notice to the victim naming
    its successor, an external preemption (a node draining) purged and
    refilled to the floor: the same decisions, node sets and counters
    in both packages."""
    out = {k: _scaler_run(k) for k in PKG}
    assert out["port"] == out["ref"]
    decisions = out["port"][0]
    dirs = [d["dir"] for d in decisions]
    assert dirs.count("up") >= 2 and "join" in dirs and "down" in dirs
    assert "preempted" in dirs
    counters = out["port"][5]
    assert counters["decisions"]["up"] == dirs.count("up")
    assert counters["decisions"]["down"] == dirs.count("down")
    assert counters["preemptions"]["graceful"] == 1


def test_elastic_dormant_and_stats():
    for el in (telastic, jelastic):
        # autoscalers of earlier tests whose retire threads still run
        with el._scalers_lock:
            el._SCALERS.clear()
        assert el.dormant()
    telastic.note_decision("up")
    jelastic.note_decision("up")
    assert not telastic.dormant()
    assert telastic.elastic_stats() == jelastic.elastic_stats()


# -- journals of their own -------------------------------------------------

def test_provider_gives_each_node_its_journal(monkeypatch, tmp_path):
    """`LocalSubprocessProvider` starts the port's worker on its device
    with a ``GSKY_POOL_JOURNAL`` of the node's own, overriding a shared
    one in the environment (an explicit one in ``extra_env`` wins)."""
    launched = []

    class Proc:
        def __init__(self, cmd, env, **kw):
            launched.append((cmd, env))

        def poll(self):
            return None

    import subprocess
    monkeypatch.setattr(telastic, "subprocess", types.SimpleNamespace(
        Popen=Proc, DEVNULL=subprocess.DEVNULL, STDOUT=subprocess.STDOUT))
    monkeypatch.setenv("GSKY_POOL_JOURNAL", "/shared/journal.jsonl")
    prov = telastic.LocalSubprocessProvider(journal_dir=str(tmp_path),
                                            device="cpu")
    addrs = [prov.launch(), prov.launch()]
    assert len(set(addrs)) == 2 and prov.addrs() == sorted(addrs)
    journals = [env["GSKY_POOL_JOURNAL"] for _, env in launched]
    assert len(set(journals)) == 2
    assert all(j.startswith(str(tmp_path)) for j in journals)
    for (cmd, env), addr in zip(launched, addrs):
        assert cmd[1:3] == ["-m", "gsky_tpu_torch.worker.server"]
        assert cmd[cmd.index("-device") + 1] == "cpu"
        assert env["GSKY_ELASTIC_SELF"] == addr
        assert cmd[cmd.index("-p") + 1] == addr.rsplit(":", 1)[1]
    explicit = telastic.LocalSubprocessProvider(
        extra_env={"GSKY_POOL_JOURNAL": "0"}, device="cpu")
    explicit.launch()
    assert launched[-1][1]["GSKY_POOL_JOURNAL"] == "0"


def test_workers_started_by_main_get_their_own_journals(tmp_path):
    """Two workers from ``python -m gsky_tpu_torch.worker.server`` with
    no ``GSKY_POOL_JOURNAL``: each keeps its journal under the temporary
    directory in a directory named by its port, and a hand-off to one
    lands in its journal alone."""
    env = {"GSKY_PREWARM": "0", "TMPDIR": str(tmp_path)}
    saved = os.environ.pop("GSKY_POOL_JOURNAL", None)
    procs = []
    try:
        with time_limit(30):
            for _ in range(2):
                procs.append(start_process(
                    [sys.executable, "-m", "gsky_tpu_torch.worker.server",
                     "-p", "0", "-host", "127.0.0.1", "-n", "1",
                     "-device", "cpu", "-oom_threshold", "0"],
                    "listening on", env=env))
            for i, (_, port) in enumerate(procs):
                doc = {"v": 1, "source": None, "peers": [],
                       "entries": [[100 + i, 0, j, 5.0]
                                   for j in range(i + 1)]}
                got = telastic.control_rpc(f"127.0.0.1:{port}",
                                           "journal_handoff", doc)
                assert got == {"accepted": i + 1}
            paths = [tmp_path / f"gsky-worker-{port}" /
                     "gsky_pool_journal.jsonl" for _, port in procs]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and \
                    not all(p.exists() for p in paths):
                time.sleep(0.05)
            for i, p in enumerate(paths):
                serials = {json.loads(ln)["serial"] for ln in open(p)}
                assert serials == {100 + i}
                info = telastic.probe_info(f"127.0.0.1:{procs[i][1]}")
                assert info["elastic"]["handoff"]["entries"] == i + 1
    finally:
        if saved is not None:
            os.environ["GSKY_POOL_JOURNAL"] = saved
        for proc, _ in procs:
            proc.kill()
            proc.wait(5)


def test_launched_node_takes_a_peers_hot_set(tmp_path):
    """A node started by ``main`` with the fabric on and a page peer,
    its journal empty (its own, under the temporary directory): its warm
    boot writes the peer's hot set (``journal_export``) into its
    journal, and its readiness then measures that hot set: the peer
    holds none of the pages here, so the node reports 0.0 warm, not
    ready."""
    env = {"GSKY_PREWARM": "0", "TMPDIR": str(tmp_path), "GSKY_FABRIC": "1"}
    saved = os.environ.pop("GSKY_POOL_JOURNAL", None)
    cmd = [sys.executable, "-m", "gsky_tpu_torch.worker.server", "-p", "0",
           "-host", "127.0.0.1", "-n", "1", "-device", "cpu",
           "-oom_threshold", "0"]
    procs = []
    try:
        with time_limit(40):
            procs.append(start_process(cmd, "listening on", env=env))
            peer = f"127.0.0.1:{procs[0][1]}"
            doc = {"v": 1, "source": None, "peers": [],
                   "entries": [[300, 0, j, 5.0 - j] for j in range(3)]}
            assert telastic.control_rpc(peer, "journal_handoff", doc) == \
                {"accepted": 3}
            hot = telastic.control_rpc(peer, "journal_export")["entries"]
            assert [e[:3] for e in hot] == [[300, 0, j] for j in range(3)]
            procs.append(start_process(cmd, "listening on", env=dict(
                env, GSKY_FABRIC_PAGE_PEERS=peer)))
            node = f"127.0.0.1:{procs[1][1]}"
            path = tmp_path / f"gsky-worker-{procs[1][1]}" / \
                "gsky_pool_journal.jsonl"
            while not path.exists() or "warm boot restored" not in \
                    "".join(procs[1][0].lines):
                time.sleep(0.05)
            info = telastic.probe_info(node)["elastic"]
            assert info["ready"] is False and info["warm_fraction"] == 0.0
            got = telastic.control_rpc(node, "journal_export")["entries"]
            assert got == hot
    finally:
        if saved is not None:
            os.environ["GSKY_POOL_JOURNAL"] = saved
        for proc, _ in procs:
            proc.kill()
            proc.wait(5)
