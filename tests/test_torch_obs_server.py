"""Port parity, observability through the servers: the port's
`OWSServer` against the JAX package's over `test_torch_server`'s
archive and config, both with no serving gateway, waves off and the
staged tile path on (``GSKY_TILE_PIPELINE=1``: the reference's
default, whose ``tile.*`` spans the comparison needs).

One request sequence runs through both once (module fixture): a fused
GetMap, a masked GetMap, WMS GetCapabilities, a GetMap to an unknown
namespace (404), a WCS GetCoverage and a WPS Execute.  Then:

1. ``/metrics``, parsed strictly: the port's family set is the
   reference's minus the families of subsystems not ported yet, each
   named below with its ROADMAP item; the request, batch-flush and
   wave-dispatch counters moved alike, and so did every histogram's
   ``_count`` the port has.
2. The fused GetMap's ``/debug/trace/<id>`` trees hold the same
   multiset of (span, parent) names; `tools/trace_view.py` renders the
   port's tree unchanged and finds the same critical path.
3. ``/debug`` has the reference's top-level keys but the listed ones.
4. The metrics-log records are equal field for field, apart from
   times, durations and ids; the ``cache`` block has the same tiers
   (its counters are the process's and differ); ``raw_url`` compares
   percent-decoded (the reference's is aiohttp's re-quoted target).
5. An injected MAS fault's retries tick
   ``gsky_trace_events_total{kind="retry"}`` in both and land on both
   traces' roots.

The same comparisons (answers, counter and histogram deltas, span
trees) for a GetMap with waves on and one with the render batcher on,
a three-frame APNG animation and a two-tile GetCoverage through the
export engine.

Also the port alone: a tile's bytes with tracing off equal those with
it on, ``/debug/trace`` in its three forms, and ``/debug/profile`` on a
CPU server (a Chrome trace written; an overlapping capture gets 409)."""

import copy
import gc
import importlib
import json
import os
import sys
import threading
from collections import Counter
from urllib.parse import parse_qs, quote, unquote, urlsplit

import numpy as np
import pytest

from gsky_tpu import fabric as jfabric
from gsky_tpu import fleet as jfleet
from gsky_tpu.fabric import replay as jreplay
from gsky_tpu.fabric import replicate as jreplicate
from gsky_tpu.fleet import elastic as jelastic
from gsky_tpu.fleet import router as jfleet_router
from gsky_tpu.obs import metrics as jom
from gsky_tpu.obs import recorder as jrecorder
from gsky_tpu.obs.prom import parse_exposition
from gsky_tpu.ops import expr as jexpr
from gsky_tpu.ops import paged as jpaged
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import waves as jwaves
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher
from gsky_tpu.server.metrics import MetricsLogger as JMetricsLogger
from gsky_tpu.server.ows import OWSServer as JOWSServer

from gsky_tpu_torch import fabric as tfabric
from gsky_tpu_torch import fleet as tfleet
from gsky_tpu_torch.fabric import replay as treplay
from gsky_tpu_torch.fleet import elastic as telastic
from gsky_tpu_torch.fleet import router as tfleet_router
from gsky_tpu_torch.io.png import decode_png
from gsky_tpu_torch.obs import metrics as tom
from gsky_tpu_torch.obs import recorder as trecorder
from gsky_tpu_torch.ops import expr as texpr
from gsky_tpu_torch.ops import kernel_launches
from gsky_tpu_torch.ops import paged as tpaged
from gsky_tpu_torch.pipeline import pages as tpages
from gsky_tpu_torch.pipeline import waves as twaves
from gsky_tpu_torch.server.config import ConfigWatcher
from gsky_tpu_torch.server.metrics import MetricsLogger
from gsky_tpu_torch.server.ows import OWSServer

from test_torch_server import (HOST, MASKED, MULTI, NATIVE, T_DATA,
                               T_FRAMES, T_MASK, UNPORTED_NS, _JaxClient,
                               _bbox, _getmap,
                               env)  # noqa: F401  (env: a fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import trace_view  # noqa: E402

jres = importlib.import_module("gsky_tpu.resilience")
tres = importlib.import_module("gsky_tpu_torch.resilience")

# the reference's families whose subsystem the port has not yet, by the
# ROADMAP item that brings it: none since A.21 (`autoplan.plan_block`,
# ``gsky_plan_block_shape``, compared in `test_serving_modes_alike`)
NOT_PORTED = {}
# the cache fabric's and the elastic fleet's families, compared with the
# reference's in `test_fabric_elastic_families_alike`
FABRIC_ELASTIC_FAMILIES = (
    "gsky_fabric_replay_total", "gsky_fabric_page_fills_total",
    "gsky_elastic_nodes", "gsky_elastic_decisions_total",
    "gsky_preemptions_total", "gsky_handoff_pages_total")
# the reference's fabric gauge and /debug fabric keys that the port
# leaves out (ROADMAP C.18): the replication round they report, and
# the per-tier gates that are the master gate here, have no caller
FABRIC_LEFT_OUT = "gsky_fabric_replica_pages"
DEBUG_FABRIC_LEFT_OUT = {"replay_enabled", "pages_enabled",
                         "replicate_enabled", "replicate"}
# the reference's /debug blocks the port does not carry: jax is torch
# here; kernels (the reference's Pallas-vs-XLA race verdicts: the port
# runs no races)
DEBUG_NOT_PORTED = {"jax", "kernels"}

_POLY = ('{"type": "Polygon", "coordinates": [[[148.0, -35.4], '
         '[148.4, -35.4], [148.4, -35.1], [148.0, -35.4]]]}')
SEQUENCE = {
    "fused": _getmap("plain", NATIVE[0], style="near", time=T_DATA),
    "masked": _getmap("masked", MASKED[0], time=T_MASK),
    "capabilities": "/ows?service=WMS&request=GetCapabilities",
    "no namespace": _getmap("plain", NATIVE[0], ns="nope"),
    "coverage": (f"/ows?service=WCS&request=GetCoverage&coverage=plain"
                 f"&crs=EPSG:3857&bbox={_bbox(NATIVE[1])}&width=64"
                 f"&height=48&format=GeoTIFF&time={T_DATA}"),
    "drill": (f"/ows/{UNPORTED_NS}?service=WPS&request=Execute"
              f"&identifier=vrt_drill&datainputs="
              f"{quote('geometry=' + _POLY)}"),
}
STATUS = {"fused": 200, "masked": 200, "capabilities": 200,
          "no namespace": 404, "coverage": 200, "drill": 200}


def _port_get(server, url, **kw):
    u = urlsplit(url)
    r = server.handle(u.path, parse_qs(u.query, keep_blank_values=True),
                      HOST, remote="127.0.0.1", raw_url=url, **kw)
    return r.status, r.content_type, r.read()


def _scrape(get):
    status, _, body = get("/metrics")
    assert status == 200
    return parse_exposition(body.decode())


def _samples(fams, name):
    fam = fams.get(name)
    return {} if fam is None else fam["samples"]


def _delta(before, after, name):
    a, b = _samples(after, name), _samples(before, name)
    return {k: v - b.get(k, 0.0) for k, v in a.items()
            if v - b.get(k, 0.0)}


@pytest.fixture(scope="module")
def oenv(env):  # noqa: F811
    mp = pytest.MonkeyPatch()
    mp.setenv("GSKY_TILE_PIPELINE", "1")
    # process-wide state that decides whether a family renders, made the
    # same in both packages: no wave scheduler, no animation served, no
    # admission class, no breaker, no fused expression render counted
    # (an earlier test's leaves gsky_expr_fused_total in one package
    # only); and empty flight recorders
    jwaves.reset_waves()
    twaves.reset_waves()
    jpaged.reset_expr_fused_stats()
    tpaged.reset_expr_fused_stats()
    # the expression compile caches' traffic (gsky_expr_cache_*): an
    # earlier file's server in the same worker may have parsed in one
    # package only
    jexpr.reset_expr_cache()
    with texpr._cache_lock:
        texpr._cache.clear()
        texpr._cache_hits = texpr._cache_misses = 0
    jom.reset_temporal()
    tom.reset_temporal()
    jres.reset()
    tres.reset()
    jrecorder.reset_recorder()
    trecorder.reset_recorder()
    # no replication round planned, no elastic counter off zero: the
    # reference's fabric gauge and the elastic families render in neither
    jreplicate.reset_stats()
    jelastic.reset_stats()
    telastic.reset_stats()
    # fleet routers (and autoscalers) that earlier tests left unreachable
    # (a client's router and its probe form a cycle) would render
    # gsky_fleet_* and the /debug fleet block in one package only
    gc.collect()
    for reg in (jfleet_router, tfleet_router):
        with reg._routers_lock:
            reg._ROUTERS.clear()
    from gsky_tpu.serving import default_gateway as jgw
    from gsky_tpu.serving.admission import AdmissionController as JAdm
    from gsky_tpu_torch.serving import default_gateway as tgw
    from gsky_tpu_torch.serving.admission import AdmissionController
    mp.setattr(jgw, "admission", JAdm())
    mp.setattr(tgw, "admission", AdmissionController())
    # no mesh dispatcher and no mesh wave observed: the gsky_mesh_*
    # families render in neither package (a mesh test earlier in the
    # same worker leaves its counts in one)
    from gsky_tpu.mesh import dispatch as jmd
    from gsky_tpu_torch.mesh import dispatch as tmd
    for md in (jmd, tmd):
        mp.setattr(md, "_default", None)
    for om in (jom, tom):
        for fam in ("MESH_WAVES", "MESH_CHIP_OCCUPANCY",
                    "MESH_SHARD_SKEW_MS"):
            mp.setattr(getattr(om, fam), "_children", {})
    recs = {"ref": [], "port": []}
    jml, tml = JMetricsLogger(), MetricsLogger()
    jml.write = lambda info: recs["ref"].append(copy.deepcopy(info))
    tml.write = lambda info: recs["port"].append(copy.deepcopy(info))
    jmas, tmas = env["jax_mas"], env["tmas"]
    jserver = JOWSServer(
        JConfigWatcher(env["conf"], mas_factory=lambda a: jmas,
                       install_signal=False),
        mas_factory=lambda a: jmas, metrics=jml, gateway=None,
        fabric=None)
    tserver = OWSServer(ConfigWatcher(env["conf"],
                                      mas_factory=lambda a: tmas,
                                      install_signal=False),
                        mas_factory=lambda a: tmas, device="cpu",
                        gateway=None, metrics=tml)
    client = _JaxClient(jserver)
    ref_get = client.get
    port_get = lambda url: _port_get(tserver, url)  # noqa: E731
    before = {"ref": _scrape(ref_get), "port": _scrape(port_get)}
    answers = {}
    for name, url in SEQUENCE.items():
        answers[name] = (ref_get(url), port_get(url))
    after = {"ref": _scrape(ref_get), "port": _scrape(port_get)}
    yield {"ref_get": ref_get, "port_get": port_get, "port": tserver,
           "answers": answers, "before": before, "after": after,
           "recs": recs, "env": env}
    client.close()
    tserver.close()
    jres.reset()
    tres.reset()
    mp.undo()


def test_sequence_answers_alike(oenv):
    for name, (ref, port) in oenv["answers"].items():
        assert port[:2] == ref[:2], (name, port[:2], port[2][:300])
        assert ref[0] == STATUS[name], (name, ref[2][:300])
    ref, port = oenv["answers"]["fused"]
    assert np.array_equal(decode_png(port[2]), decode_png(ref[2]))


def test_metric_families_equal_but_the_unported(oenv):
    ref, port = set(oenv["after"]["ref"]), set(oenv["after"]["port"])
    assert port == ref - set(NOT_PORTED), (sorted(port - ref),
                                           sorted(ref - port))
    assert not port & set(NOT_PORTED)


@pytest.mark.parametrize("family", ["gsky_requests_total",
                                    "gsky_batch_flushes_total",
                                    "gsky_wave_dispatches_total",
                                    "gsky_plan_route_total",
                                    "gsky_trace_events_total"])
def test_counters_moved_alike(oenv, family):
    d = {k: _delta(oenv["before"][k], oenv["after"][k], family)
         for k in ("ref", "port")}
    assert d["port"] == d["ref"]
    if family == "gsky_requests_total":
        got = {(dict(lab)["service"], int(dict(lab)["status"])): v
               for (_, lab), v in d["port"].items()}
        svc = {"fused": "WMS", "masked": "WMS", "capabilities": "WMS",
               "no namespace": "WMS", "coverage": "WCS", "drill": "WPS"}
        want = Counter((svc[n], STATUS[n]) for n in SEQUENCE)
        assert got == {k: float(v) for k, v in want.items()}


FLEET_FAMILIES = ("gsky_fleet_nodes", "gsky_fleet_routed_total",
                  "gsky_fleet_rerouted_total", "gsky_fleet_hedges_total")


def test_fleet_families_alike(oenv):
    """One fleet router in each package, fed the same events: the
    ``gsky_fleet_*`` families and the ``/debug`` fleet block render
    alike (the phi values, the wall clock's, aside)."""
    nodes = ["10.0.0.1:11429", "10.0.0.2:11429", "10.0.0.3:11429"]
    routers = []
    try:
        for mod in (jfleet, tfleet):
            r = mod.FleetRouter(nodes, name="parity")
            for k in ("a", "a", "b"):
                r.record_locality(k, nodes[0])
            r.record_reroute()
            r.record_rr()
            r.node_result(nodes[1], ok=False, fatal=True)
            r.node_result(nodes[2], ok=True, draining=True)
            r.hedge.on_primary()
            assert r.hedge.try_hedge()
            assert not r.hedge.try_hedge()
            r.hedge.record_win()
            routers.append(r)
        fams = {k: _scrape(oenv[k + "_get"]) for k in ("ref", "port")}
        for fam in FLEET_FAMILIES:
            assert _samples(fams["port"], fam) == \
                _samples(fams["ref"], fam), fam
            assert _samples(fams["port"], fam), fam
        docs = {k: json.loads(oenv[k + "_get"]("/debug")[2])["fleet"]
                for k in ("ref", "port")}
        for d in docs.values():
            for h in d["parity"]["health"].values():
                h.pop("phi")
        assert docs["port"] == docs["ref"]
    finally:
        for r in routers:
            r.close()
        routers.clear()
        gc.collect()


class _Provider:
    def launch(self):
        return "10.0.0.9:11429"

    def alive(self, addr):
        return True


class _Scaled:
    """The surface an autoscaler scales, over one package's router."""

    def __init__(self, mod, nodes):
        self.fleet = mod.FleetRouter(nodes, name="elastic-parity")
        self.nodes = list(nodes)

    def set_nodes(self, addrs):
        self.nodes = list(addrs)
        self.fleet.set_nodes(addrs)


def test_fabric_elastic_families_alike(oenv, monkeypatch):
    """The same fabric and elastic events in each package: an owner's
    replay fetch, a page staged from a peer, the gate on, an
    autoscaler's scale-up with one node pending, a preemption and a
    hand-off.  The six families both packages carry render alike (the
    counters' deltas, the gauges' values), and so do the /debug fabric
    block's gate and page counters and the elastic block; the
    reference's replica gauge (0: nothing plans) and its per-tier gate
    keys are the port's only differences."""
    import asyncio
    monkeypatch.setenv("GSKY_FABRIC", "1")
    nodes = ["10.0.0.1:11429", "10.0.0.2:11429"]
    before = {k: _scrape(oenv[k + "_get"]) for k in ("ref", "port")}
    scalers, scaled = [], []
    try:
        for pkg, fab, rep, el, fl in (
                ("ref", jfabric, jreplay, jelastic, jfleet),
                ("port", tfabric, treplay, telastic, tfleet)):
            f = rep.ReplayFabric("http://me:1", ["http://peer:1"])
            f.is_owner = lambda key: True
            got = f.fetch("k")
            if asyncio.iscoroutine(got):
                got = asyncio.new_event_loop().run_until_complete(got)
            assert got is None and f.outcomes == {"owner_local": 1}
            pool = (jpages if pkg == "ref" else tpages).PagePool(
                capacity=4, page_rows=4, page_cols=4,
                **({} if pkg == "ref" else {"device": "cpu"}))
            assert pool.stage_page(7, 0, 0, np.ones((4, 4), np.float32))
            client = _Scaled(fl, nodes)
            scaled.append(client)
            a = el.Autoscaler(_Provider(), client, name="parity",
                              min_nodes=1, max_nodes=3, up_ticks=1,
                              cooldown_s=0.0, clock=lambda: 0.0,
                              probe=lambda addr: None)
            a.demand.sample = lambda: 2.0
            a.tick()
            scalers.append(a)
            el.note_preemption(True)
            el.note_handoff_pages("peer", 3)
            el.note_handoff_pages("cold", 1)
        after = {k: _scrape(oenv[k + "_get"]) for k in ("ref", "port")}
        for fam in FABRIC_ELASTIC_FAMILIES:
            d = {k: _delta(before[k], after[k], fam)
                 for k in ("ref", "port")}
            if fam == "gsky_elastic_nodes":
                d = {k: _samples(after[k], fam) for k in d}
            assert fam in after["port"] and fam in after["ref"], fam
            assert d["port"] == d["ref"], fam
        assert _samples(after["port"], "gsky_elastic_nodes")
        assert FABRIC_LEFT_OUT not in after["port"]
        assert _samples(after["ref"], FABRIC_LEFT_OUT) == \
            {(FABRIC_LEFT_OUT, ()): 0.0}
        docs = {k: json.loads(oenv[k + "_get"]("/debug")[2])
                for k in ("ref", "port")}
        fab = {k: docs[k]["fabric"] for k in docs}
        assert set(fab["port"]) == set(fab["ref"]) - DEBUG_FABRIC_LEFT_OUT
        assert fab["port"]["enabled"] is fab["ref"]["enabled"] is True
        for gate in DEBUG_FABRIC_LEFT_OUT - {"replicate"}:
            assert fab["ref"][gate] is True, gate
        assert set(fab["port"]["pages"]) == set(fab["ref"]["pages"])
        el_docs = {k: docs[k]["elastic"] for k in docs}
        for d in el_docs.values():
            for ev in d["autoscalers"]["parity"]["decisions"]:
                ev.pop("t")
        assert el_docs["port"] == el_docs["ref"]
    finally:
        for a in scalers:
            a.stop()
        for c in scaled:
            c.fleet.close()
        scalers.clear()
        jelastic.reset_stats()
        telastic.reset_stats()
        gc.collect()


@pytest.mark.parametrize("family", ["gsky_request_seconds",
                                    "gsky_stage_seconds",
                                    "gsky_encode_seconds"])
def test_histogram_counts_alike(oenv, family):
    def counts(k):
        d = _delta(oenv["before"][k], oenv["after"][k], family)
        return {lab: v for (name, lab), v in d.items()
                if name == family + "_count"}
    ref, port = counts("ref"), counts("port")
    assert port == ref and port


def _records(oenv, pkg, url):
    return [r for r in oenv["recs"][pkg]
            if unquote(r["url"]["raw_url"]) == unquote(url)]


def _trace_of(oenv, pkg, name):
    rec = _records(oenv, pkg, SEQUENCE[name])[0]
    get = oenv[pkg + "_get"]
    status, _, body = get(f"/debug/trace/{rec['trace_id']}")
    assert status == 200
    return json.loads(body)


def _tree(trace):
    by_id = {s["span_id"]: s["name"] for s in trace["spans"]}
    return Counter((s["name"], by_id.get(s["parent_id"]))
                   for s in trace["spans"])


def test_fused_getmap_span_tree_equal(oenv):
    ref, port = (_trace_of(oenv, k, "fused") for k in ("ref", "port"))
    assert _tree(port) == _tree(ref)
    names = set(_tree(port))
    assert {("tile.dispatch", "ows.request"),
            ("tile.readback", "ows.request"),
            ("encode", "ows.request")} <= names
    assert port["status"] == ref["status"] == 200
    assert port["attrs"]["verb"] == ref["attrs"]["verb"] == "WMS.GetMap"
    # tools/trace_view.py reads the port's tree unchanged
    assert [s["name"] for s in trace_view.critical_path(port)] == \
        [s["name"] for s in trace_view.critical_path(ref)]
    text = trace_view.render(port)
    assert text.splitlines()[0].startswith(
        f"trace {port['trace_id']}  ows.request")
    assert "tile.dispatch" in text
    assert text.splitlines()[-1].startswith("critical path")


def test_masked_getmap_span_tree_equal(oenv):
    ref, port = (_trace_of(oenv, k, "masked") for k in ("ref", "port"))
    assert _tree(port) == _tree(ref)


def test_debug_keys_equal_but_the_unported(oenv):
    docs = {}
    for k in ("ref", "port"):
        status, ctype, body = oenv[k + "_get"]("/debug")
        assert status == 200 and ctype.startswith("application/json")
        docs[k] = json.loads(body)
    assert set(docs["port"]) == set(docs["ref"]) - DEBUG_NOT_PORTED \
        | {"torch"}
    torch_block = dict(docs["port"]["torch"])
    launches = torch_block.pop("kernels")
    assert torch_block == {"backend": "cpu", "devices": 1, "name": ""}
    # the kernel wrappers' launch counts (none on the CPU's plain paths)
    assert set(launches) == set(kernel_launches())
    assert all(isinstance(n, int) and n >= 0 for n in launches.values())
    for k in ("requests", "tile_stages", "cache", "trace"):
        assert set(docs["port"][k]) <= set(docs["ref"][k]) | {"gates"}, k
    assert set(docs["port"]["device"]) == set(docs["ref"]["device"])
    assert set(docs["port"]["device"]["journal"]) \
        == set(docs["ref"]["device"]["journal"])
    assert set(docs["port"]["tile_stages"]["encode_pool"]) \
        == set(docs["ref"]["tile_stages"]["encode_pool"])
    assert docs["port"]["requests"]["WMS.GetMap"]["count"] >= 3


_TIMES = (("req_time",), ("req_duration",), ("trace_id",),
          ("device", "duration"), ("rpc", "duration"),
          ("indexer", "duration"))


def _comparable(rec):
    rec = copy.deepcopy(rec)
    for path in _TIMES:
        d = rec
        for k in path[:-1]:
            d = d[k]
        d.pop(path[-1])
    cache = rec.pop("cache")
    rec["url"]["raw_url"] = unquote(rec["url"]["raw_url"])
    return rec, sorted(cache)


@pytest.mark.parametrize("name", sorted(SEQUENCE))
def test_metrics_records_equal(oenv, name):
    url = SEQUENCE[name]
    got = {}
    for k in ("ref", "port"):
        recs = _records(oenv, k, url)
        assert len(recs) == 1, (k, len(recs))
        got[k] = recs[0]
    assert _comparable(got["port"]) == _comparable(got["ref"])
    port = got["port"]
    assert port["http_status"] == STATUS[name]
    assert port["trace_id"] and port["req_duration"] > 0
    if name == "fused":
        assert port["device"]["platform"] == "cpu"
        assert port["device"]["duration"] > 0
        assert port["indexer"]["num_granules"] > 0


def test_trace_off_keeps_the_bytes(oenv, monkeypatch):
    url = SEQUENCE["fused"]
    on = oenv["port_get"](url)
    n0 = oenv["port"].metrics.summary()["trace"]["recorded"]
    monkeypatch.setenv("GSKY_TRACE", "0")
    off = oenv["port_get"](url)
    assert off == on
    assert oenv["port"].metrics.summary()["trace"]["recorded"] == n0
    assert off[2] == oenv["answers"]["fused"][1][2]


def test_debug_trace_forms(oenv):
    get = oenv["port_get"]
    status, _, body = get("/debug/trace")
    doc = json.loads(body)
    assert status == 200 and doc["stats"]["recorded"] >= len(SEQUENCE)
    assert {t["name"] for t in doc["traces"]} == {"ows.request"}
    status, ctype, body = get("/debug/trace?format=jsonl")
    lines = [json.loads(ln) for ln in body.decode().splitlines()]
    assert ctype == "application/x-ndjson"
    assert [t["trace_id"] for t in lines] == \
        [t["trace_id"] for t in doc["traces"]]
    status, _, body = get("/debug/trace?slowest=1")
    slow = json.loads(body)
    assert status == 200 and slow["dur_s"] == max(
        t["dur_s"] for t in lines)
    assert get("/debug/trace/0123456789abcdef")[0] == 404
    status, ctype, body = get("/metrics")
    assert ctype == "text/plain; charset=utf-8"


def test_debug_profile_on_the_cpu(oenv):
    srv = oenv["port"]
    out = {}

    def capture():
        out["first"] = _port_get(srv, "/debug/profile?seconds=1.5")

    t = threading.Thread(target=capture)
    t.start()
    try:
        # an overlapping capture is refused while the first one runs
        for _ in range(200):
            if srv._profile_mutex.locked():
                break
            threading.Event().wait(0.01)
        second = _port_get(srv, "/debug/profile?seconds=0.1")
        assert second[0] == 409 and "error" in json.loads(second[2])
        oenv["port_get"](SEQUENCE["fused"])
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    status, _, body = out["first"]
    doc = json.loads(body)
    assert status == 200 and doc["seconds"] == 1.5
    with open(os.path.join(doc["trace_dir"], "trace.json")) as fp:
        events = json.load(fp)["traceEvents"]
    assert events
    # clamped and defaulted
    assert json.loads(_port_get(srv, "/debug/profile?seconds=0")[2])[
        "seconds"] == 0.1


def test_mas_retries_tick_trace_events(oenv):
    env = oenv["env"]
    url = _getmap("plain", NATIVE[1], style="near", time=T_DATA)
    fam = "gsky_trace_events_total"
    got = {}
    for k, res, mas in (("ref", jres, env["jax_mas"]),
                        ("port", tres, env["tmas"])):
        get = oenv[k + "_get"]
        before = _scrape(get)
        old = mas._retry
        mas._retry = res.RetryPolicy(max_attempts=3, base_delay=0.001,
                                     max_delay=0.002)
        res.faults.configure("mas:error:1.0", seed=0)
        try:
            status = get(url)[0]
        finally:
            res.faults.reset()
            mas._retry = old
            res.reset()
            mas._breaker = res.get_breaker(f"mas:{mas.address}")
        d = _delta(before, _scrape(get), fam)
        retry = d.get((fam, (("kind", "retry"),)), 0.0)
        trace = _trace_of_last(oenv, k)
        events = [e["name"] for e in trace["spans"][0].get("events", ())]
        got[k] = (status, retry, events.count("retry"))
    assert got["port"] == got["ref"]
    assert got["port"][1] > 0 and got["port"][2] == got["port"][1]


def _trace_of_last(oenv, pkg):
    rec = oenv["recs"][pkg][-1]
    status, _, body = oenv[pkg + "_get"](f"/debug/trace/{rec['trace_id']}")
    assert status == 200
    return json.loads(body)


# the comparison under the other serving modes: (knobs, url)
MODES = {
    "waves": ({"GSKY_WAVES": "1"},
              _getmap("plain", MULTI[0], style="near", time=T_DATA)),
    "batcher": ({"GSKY_RENDER_BATCH": "1"},
                _getmap("plain", MULTI[1], style="near", time=T_DATA)),
    # the three frames wait the longest tick for one another, so that
    # they meet in one wave in both packages on a loaded host too
    "animation": ({"GSKY_WAVES": "1", "GSKY_WAVE_TICK_MS": "100"},
                  _getmap("plain", NATIVE[1], style="near", time=T_FRAMES,
                          fmt="image/apng")),
    "export": ({}, f"/ows?service=WCS&request=GetCoverage&coverage=plain"
                   f"&crs=EPSG:3857&bbox={_bbox(NATIVE[0])}&width=1100"
                   f"&height=40&format=GeoTIFF&time={T_DATA}"),
}
MODE_FAMILIES = ("gsky_requests_total", "gsky_wave_dispatches_total",
                 "gsky_batch_flushes_total", "gsky_plan_route_total",
                 "gsky_anim_sequences_total", "gsky_dap_streamed_bytes_total")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serving_modes_alike(oenv, monkeypatch, mode):
    knobs, url = MODES[mode]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    jwaves.reset_waves()
    twaves.reset_waves()
    try:
        got = {}
        for k in ("ref", "port"):
            get = oenv[k + "_get"]
            before = _scrape(get)
            ans = get(url)
            after = _scrape(get)
            deltas = {f: _delta(before, after, f) for f in MODE_FAMILIES}
            # the tile decisions: as many in both, each labelled with its
            # package's own block (a Pallas block, a CUDA tile)
            deltas["gsky_plan_block_shape"] = sum(_delta(
                before, after, "gsky_plan_block_shape").values())
            counts = {f: {lab: v for (n, lab), v in
                          _delta(before, after, f).items()
                          if n == f + "_count"}
                      for f in ("gsky_stage_seconds", "gsky_wave_occupancy")}
            got[k] = (ans, deltas, counts, _tree(_trace_of_last(oenv, k)))
    finally:
        jwaves.reset_waves()
        twaves.reset_waves()
    (ref, rd, rc, rt), (port, pd, pc, pt) = got["ref"], got["port"]
    assert port[:2] == ref[:2] and ref[0] == 200, (port[:2], ref[2][:300])
    assert pd == rd
    assert pc == rc
    assert pt == rt
    if mode in ("waves", "animation"):
        assert pd["gsky_wave_dispatches_total"]
        assert pd["gsky_plan_block_shape"] > 0
    if mode == "batcher":
        assert pd["gsky_batch_flushes_total"]
    if mode == "animation":
        assert pt[("encode", "ows.request")] == 3
    if mode == "export":
        assert {("export.plan", "ows.request"),
                ("export.warp_stage", "ows.request"),
                ("export.decode_stage", "ows.request")} <= set(pt)
