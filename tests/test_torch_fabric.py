"""Port parity, the cache fabric (`gsky_tpu_torch/fabric/`) against the
JAX package's `gsky_tpu/fabric/`, on the same seeded inputs.

Held equal, each with its tolerance: ring owners and candidates, the
replication plan (exact); the page RPC's manifests (offsets, lengths,
CRCs) and blobs byte for byte for the same staged pages (the reference's
pool staged, the port handed a copy through `carry.pool_from_reference`);
what `decode_result` keeps of a corrupted or budget-cut answer; the
order in which `fill_from_peers` asks its peers and the pages it stages;
the replay fetch's outcome for every case of the reference's matrix
(`tests/test_fabric.py`) and the entries it rebuilds.  The gateway tier
runs through two port servers over HTTP (a peer's bytes equal the
owner's), and with ``GSKY_FABRIC=0`` a server answers byte for byte as a
fabric-less one.

The C.18 test: a scene's serial names its content in the port (a hash of
its file's identity), a per-process counter in the reference.  Two nodes
that loaded two scenes in opposite orders, node B peer-filled from node
A: the reference's B renders A's pixels into its tile; the port's B
renders its own cold render's bytes.  Everything runs on the CPU: the
port with ``device="cpu"`` (plain versions), the reference with
GSKY_PALLAS=interpret.
"""

import asyncio
import itertools
import json
import threading
import time
import urllib.request
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

import jax.numpy as jnp

from gsky_tpu import fabric as jfabric
from gsky_tpu import resilience as jres
from gsky_tpu.device_guard import journal as jjournal
from gsky_tpu.fabric import pagerpc as jpagerpc
from gsky_tpu.fabric import replay as jreplay
from gsky_tpu.fabric import replicate as jreplicate
from gsky_tpu.fleet.ring import HashRing as JHashRing
from gsky_tpu.geo.crs import parse_crs as jparse_crs
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.io import write_geotiff as jwrite_geotiff
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import scene_cache as jscene_cache
from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
from gsky_tpu.pipeline.types import Granule as JGranule
from gsky_tpu.resilience import deadline_scope as jdeadline_scope
from gsky_tpu.serving.response_cache import make_entry as jmake_entry

from gsky_tpu_torch import fabric as tfabric
from gsky_tpu_torch import resilience as tres
from gsky_tpu_torch.carry import pool_from_reference
from gsky_tpu_torch.device_guard import journal as tjournal
from gsky_tpu_torch.fabric import pagerpc as tpagerpc
from gsky_tpu_torch.fabric import replay as treplay
from gsky_tpu_torch.fabric import replicate as treplicate
from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import GeoTransform
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.pipeline import scene_cache as tscene_cache
from gsky_tpu_torch.pipeline.executor import WarpExecutor
from gsky_tpu_torch.pipeline.pages import PagePool
from gsky_tpu_torch.pipeline.types import Granule
from gsky_tpu_torch.resilience import deadline_scope
from gsky_tpu_torch.server.config import ConfigWatcher
from gsky_tpu_torch.server.ows import OWSServer
from gsky_tpu_torch.serving import ResponseCache, ServingGateway
from gsky_tpu_torch.serving.response_cache import make_entry

from fixtures import make_archive

A, B, C = "http://gw-a:80", "http://gw-b:80", "http://gw-c:80"
REPLAY = {"ref": jreplay, "port": treplay}


@pytest.fixture(autouse=True)
def _fabric_env(monkeypatch, tmp_path):
    monkeypatch.setenv("GSKY_FABRIC", "1")
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "journal.jsonl"))
    for mod in (jres, tres):
        mod.reset()
    jreplicate.reset_stats()
    yield
    for mod in (jres, tres):
        mod.reset()


def _run(x):
    """The reference's coroutines run to their end; the port's values
    pass through."""
    if asyncio.iscoroutine(x):
        return asyncio.new_event_loop().run_until_complete(x)
    return x


# -- the ring and the replication plan (exact) ------------------------------

def test_ring_owner_and_candidates_equal():
    keys = [f"key{i}" for i in range(300)]
    fabs = {k: REPLAY[k].ReplayFabric(A, [B, C]) for k in REPLAY}
    for key in keys:
        assert fabs["port"].owner(key) == fabs["ref"].owner(key)
        assert fabs["port"].candidates(key) == fabs["ref"].candidates(key)
        assert fabs["port"].is_owner(key) == fabs["ref"].is_owner(key)
    assert {fabs["port"].owner(k) for k in keys} == {A, B, C}
    for f in fabs.values():
        f.set_peers([B])                      # C leaves
        f.set_peers([B])                      # no change: no bump
    assert fabs["port"].ring.generation == fabs["ref"].ring.generation
    assert [fabs["port"].owner(k) for k in keys] == \
        [fabs["ref"].owner(k) for k in keys]
    assert fabs["port"].stats() == fabs["ref"].stats()


@pytest.mark.parametrize("replicas", [None, 1, 2, 3])
def test_replication_plan_equal(replicas):
    # None: the port's REPLICAS against the reference's default
    # (GSKY_FABRIC_REPLICAS unset)
    rng = np.random.default_rng(18)
    scored = sorted(((int(s), int(pi), int(pj), float(sc))
                     for s, pi, pj, sc in zip(
                         rng.integers(1, 1 << 52, 40),
                         rng.integers(0, 8, 40), rng.integers(0, 4, 40),
                         rng.uniform(0.0, 50.0, 40))),
                    key=lambda e: -e[3])
    nodes = ["w1:1", "w2:1", "w3:1", "w4:1"]
    r = jreplicate.replica_count() if replicas is None else replicas
    assert r == (treplicate.REPLICAS if replicas is None else replicas)
    for top in (0.0, 10.0):
        for score in (0.0, 2.5, 5.0, 10.0):
            assert treplicate.replicas_for(score, top, r) == \
                jreplicate.replicas_for(score, top, r)
    for n in nodes:
        assert treplicate.plan(scored, nodes, n, replicas) == \
            jreplicate.plan(scored, nodes, n, replicas)
        assert treplicate.plan(scored, nodes, n, replicas,
                               budget_pages=3) == \
            jreplicate.plan(scored, nodes, n, replicas, budget_pages=3)
    jr, tr = JHashRing(nodes, vnodes=32), treplicate.HashRing(nodes,
                                                              vnodes=32)
    for s, pi, pj, _ in scored:
        assert treplicate.replication_targets(tr, (s, pi, pj), 2) == \
            jreplicate.replication_targets(jr, (s, pi, pj), 2)


# -- the page RPC (bytes equal) ----------------------------------------------

def _staged_pair():
    """The reference's pool staged from a seeded scene (pages of two
    serials), and the port's copy of it."""
    rng = np.random.default_rng(7)
    jp = jpages.PagePool(capacity=32, page_rows=8, page_cols=128)
    for serial in (7, (1 << 52) + 11):
        scene = rng.uniform(-5, 5, (40, 300)).astype(np.float32)
        scene[3, :17] = np.nan
        slots = jp.table_for(jnp.asarray(scene), serial, 0, 2, 0, 2)
        jp.unpin(slots)
    tp = pool_from_reference(np.asarray(jp._pool), jp._slots, device="cpu")
    return jp, tp


WANT = [[7, 0, 0], [7, 2, 1], [1, 1, 1], [(1 << 52) + 11, 1, 2],
        [7, 9, 9], ["x"], [(1 << 52) + 11, 0, 0]]


@pytest.mark.parametrize("budget", [None, 2 * 8 * 128 * 4,
                                    2 * 8 * 128 * 4 + 100, 1])
def test_page_fetch_manifest_and_blob_equal(budget):
    jp, tp = _staged_pair()
    doc = {"v": 1, "pages": WANT}
    if budget is not None:
        doc["max_bytes"] = budget
    jm, jb = jpagerpc.serve_page_fetch(jp, doc)
    tm, tb = tpagerpc.serve_page_fetch(tp, doc)
    assert tm == jm
    assert tb == jb
    n = {None: 4, 2 * 8 * 128 * 4: 2, 2 * 8 * 128 * 4 + 100: 2,
         1: 1}[budget]
    assert len(tm["pages"]) == n            # the coldest tail cut
    got = {k: tpagerpc.decode_result(json.dumps(m), b)
           for k, m, b in (("ref", jm, jb), ("port", tm, tb))}
    assert set(got["port"]) == set(got["ref"])
    for key, page in got["port"].items():
        assert page.tobytes() == got["ref"][key].tobytes()
        assert page.tobytes() == tp.read_page(*key).tobytes()


def test_read_pages_copy_outlives_an_eviction():
    """A page served to a peer is a copy taken under the pool's lock:
    the slot evicted and restaged with another page afterwards leaves
    the served bytes as they were."""
    pool = PagePool(capacity=1, page_rows=4, page_cols=4, device="cpu")
    page = np.arange(16, dtype=np.float32).reshape(4, 4)
    assert pool.stage_page(7, 0, 0, page)
    (key, got), = pool.read_pages([(9, 9, 9), (7, 0, 0)], 2)
    m, blob = tpagerpc.serve_page_fetch(pool, {"pages": [[7, 0, 0]]})
    assert pool.stage_page(7, 0, 1, page + 100)     # the one slot reused
    assert not pool.has_page(7, 0, 0)
    assert key == (7, 0, 0) and got.tobytes() == page.tobytes()
    assert tpagerpc.decode_result(json.dumps(m), blob)[key].tobytes() == \
        page.tobytes()
    assert pool.read_pages([(7, 0, 0)], 4) == []


def test_decode_drops_a_corrupted_page_in_both():
    jp, tp = _staged_pair()
    doc = {"pages": [[7, 0, 0], [7, 0, 1], [7, 1, 0]]}
    m, blob = tpagerpc.serve_page_fetch(tp, doc)
    bad = bytearray(blob)
    bad[m["pages"][1]["off"] + 5] ^= 0xFF
    short = json.loads(json.dumps(m))
    short["pages"][2]["len"] -= 4
    out = {}
    for k, mod in (("ref", jpagerpc), ("port", tpagerpc)):
        d0 = mod.stats()["integrity_drops"]
        got = mod.decode_result(json.dumps(m), bytes(bad))
        got2 = mod.decode_result(json.dumps(short), blob)
        assert mod.stats()["integrity_drops"] - d0 == 2
        assert mod.decode_result("not json", blob) == {}
        assert mod.decode_result(json.dumps({"pages": []}), blob) == {}
        out[k] = (sorted(got), sorted(got2))
    assert out["port"] == out["ref"] == (
        [(7, 0, 0), (7, 1, 0)], [(7, 0, 0), (7, 0, 1)])


def test_encode_request_equal():
    keys = [(7, 0, 0), (np.int64(8), 1, 2)]
    assert tpagerpc.encode_request(keys, 1000) == \
        jpagerpc.encode_request(keys, 1000)
    assert tpagerpc.encode_request(keys) == jpagerpc.encode_request(keys)


def test_stage_page_refuses_shape_mismatch_in_both():
    out = {}
    for k, pool in (("ref", jpages.PagePool(capacity=3, page_rows=4,
                                            page_cols=4)),
                    ("port", PagePool(capacity=3, page_rows=4,
                                      page_cols=4, device="cpu"))):
        page = np.arange(16, dtype=np.float32).reshape(4, 4)
        r = [pool.stage_page(7, 0, 0, np.zeros((8, 8), np.float32)),
             pool.stage_page(7, 0, 0, page),
             pool.stage_page(7, 0, 0, page + 1),     # resident: kept
             pool.stage_page(7, 0, 1, page * 2),
             pool.stage_page(7, 0, 2, page * 3),     # evicts the LRU
             pool.has_page(7, 0, 0), pool.has_page(7, 0, 2)]
        st = pool.stats()
        out[k] = (r, pool.read_page(7, 0, 2).tobytes(),
                  pool.read_page(9, 9, 9), pool.peer_filled,
                  {f: st[f] for f in ("staged", "hits", "evictions",
                                      "declined", "peer_filled",
                                      "resident")})
    assert out["port"] == out["ref"]
    assert out["port"][0] == [False, True, True, True, True, False, True]


# -- filling a pool from peers (the order asked, the pages staged) ----------

def _fill(pkg, entries, peers, holders, prefer=None):
    pool = (jpages.PagePool(capacity=32, page_rows=4, page_cols=4)
            if pkg == "ref" else
            PagePool(capacity=32, page_rows=4, page_cols=4, device="cpu"))
    asked = []

    def fetch(peer, keys, max_bytes, timeout):
        asked.append((peer, [tuple(k) for k in keys]))
        return {k: np.full((4, 4), float(k[0] + k[1] + k[2]), np.float32)
                for k in keys if peer in holders.get(tuple(k), ())}

    mod = jpagerpc if pkg == "ref" else tpagerpc
    n = mod.fill_from_peers(pool, entries, peers=peers, fetch=fetch,
                            prefer=prefer)
    return n, asked, sorted(pool._slots), pool.peer_filled


@pytest.mark.parametrize("case", ["one peer", "second round", "prefer",
                                  "prefer misses", "nobody"])
def test_fill_from_peers_equal(case):
    rng = np.random.default_rng(3)
    entries = [(int(s), int(i), int(j)) for s, i, j in zip(
        rng.integers(1, 99, 12), rng.integers(0, 4, 12),
        rng.integers(0, 4, 12))]
    peers = ["w1:1", "w2:1", "w3:1"]
    everywhere = {k: peers + ["dying:1"] for k in entries}
    holders, prefer, use = {
        "one peer": (everywhere, None, ["w1:1"]),
        "second round": ({k: ["w2:1"] for k in entries}, None, peers),
        "prefer": (everywhere, "dying:1", peers),
        "prefer misses": ({k: (["dying:1"] if i % 2 else ["w3:1"])
                           for i, k in enumerate(entries)}, "dying:1",
                          peers),
        "nobody": ({}, "dying:1", peers)}[case]
    got = {k: _fill(k, entries, use, holders, prefer) for k in REPLAY}
    assert got["port"] == got["ref"]
    n, asked, _, filled = got["port"]
    assert n == filled
    if case == "prefer":
        assert asked == [("dying:1", entries)] and n == len(set(entries))
    if case == "one peer":
        assert asked[0][1] == entries         # hottest first
    if case == "second round":
        # w2 is asked for a key in the round where the ring names it,
        # first or second
        ring = JHashRing(peers, vnodes=32)
        reach = {k for k in entries
                 if "w2:1" in ring.preference(json.dumps(k), 2)}
        assert n == len(reach) and 0 < n < len(set(entries))


def test_rehydrate_asks_the_page_peers_first(monkeypatch, tmp_path):
    monkeypatch.setenv("GSKY_FABRIC_PAGE_PEERS", "w1:1")
    # the reference re-stages the rest from its process-wide scene
    # cache, where an earlier test's scene may hold serial 8 (C.18)
    monkeypatch.setattr(jscene_cache.default_scene_cache, "_scenes", {})
    out = {}
    for k, jmod, mod, fetch_name in (
            ("ref", jjournal, jpagerpc, "_grpc_fetch"),
            ("port", tjournal, tpagerpc, "_rpc_fetch")):
        monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / f"{k}.jsonl"))
        jmod.record_stage(7, 0, 0)
        jmod.record_heat(7, 0, 0, hits=5)
        jmod.record_stage(8, 1, 1)
        monkeypatch.setattr(
            mod, fetch_name,
            lambda peer, keys, mb, t: {kk: np.full((4, 4), 3.0, np.float32)
                                       for kk in keys if kk[0] == 7})
        pool = (jpages.PagePool(capacity=8, page_rows=4, page_cols=4)
                if k == "ref" else
                PagePool(capacity=8, page_rows=4, page_cols=4,
                         device="cpu"))
        out[k] = (pool.rehydrate(), pool.peer_filled,
                  pool.read_page(7, 0, 0).tobytes(), pool.has_page(8, 1, 1),
                  pool.stats()["rehydrated"])
        monkeypatch.setenv("GSKY_FABRIC", "0")
        pool2 = (jpages.PagePool(capacity=8, page_rows=4, page_cols=4)
                 if k == "ref" else
                 PagePool(capacity=8, page_rows=4, page_cols=4,
                          device="cpu"))
        monkeypatch.setattr(mod, "fill_from_peers",
                            lambda *a, **kw: pytest.fail("fabric off"))
        pool2.rehydrate()
        out[k] += (pool2.peer_filled,)
        monkeypatch.setenv("GSKY_FABRIC", "1")
    assert out["port"] == out["ref"]
    assert out["port"][:2] == (1, 1)


# -- the gateway tier's fetch matrix (outcomes equal) ------------------------

def _entry(mod, body=b"not-actually-png", max_age=300):
    return mod(body, "image/png", 200, "ns", "landsat", "fp0123", max_age)


def _owned_by(fab, owner, n=1, prefix="k"):
    out, i = [], 0
    while len(out) < n:
        if fab.owner(f"{prefix}{i}") == owner:
            out.append(f"{prefix}{i}")
        i += 1
    return out


def _matrix(pkg, case, monkeypatch):
    rep = REPLAY[pkg]
    calls = []
    ent = _entry(jmake_entry if pkg == "ref" else make_entry)

    def ok(url, timeout):
        calls.append(url)
        if case == "singleflight":
            time.sleep(0.1)
        headers, body = rep.encode_entry(ent)
        return 200, dict(headers, **{"Content-Type": "image/png"}), body

    def down(url, timeout):
        calls.append(url)
        raise OSError("connection refused")

    transport = {"hit": ok, "owner local": ok, "singleflight": ok,
                 "404": lambda u, t: (calls.append(u), (404, {}, b""))[1],
                 "503": lambda u, t: (calls.append(u), (503, {}, b""))[1],
                 "deadline": ok, "transport error": down,
                 "open breaker": down, "disabled": ok}[case]
    if case == "disabled":
        monkeypatch.setenv("GSKY_FABRIC", "0")
    fab = rep.ReplayFabric(A, [B, C], transport=transport,
                           max_attempts=1 if case == "open breaker" else 2)
    key = _owned_by(fab, A if case == "owner local" else B)[0]
    if case == "open breaker":
        res = jres if pkg == "ref" else tres
        brk = res.get_breaker(f"fabric:{fab.candidates(key)[0]}")
        while brk.allow():
            brk.record_failure()
    if case == "deadline":
        scope = jdeadline_scope if pkg == "ref" else deadline_scope

        async def ref_go():
            with scope(0.0):
                return await fab.fetch(key)
        if pkg == "ref":
            got = [_run(ref_go())]
        else:
            with scope(0.0):
                got = [fab.fetch(key)]
    elif case == "singleflight":
        if pkg == "ref":
            async def go():
                return await asyncio.gather(*(fab.fetch(key)
                                              for _ in range(3)))
            got = _run(go())
        else:
            got = [None] * 3
            start = threading.Barrier(3)

            def one(i):
                start.wait()
                got[i] = fab.fetch(key)
            ts = [threading.Thread(target=one, args=(i,)) for i in range(3)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
    else:
        got = [_run(fab.fetch(key))]
    if pkg == "port":
        fab.close()
    bodies = [None if g is None else (g.body, g.etag, g.content_type,
                                      g.status, g.max_age) for g in got]
    return fab.outcomes, len(calls), bodies


@pytest.mark.parametrize("case", [
    "hit", "owner local", "404", "503", "deadline", "transport error",
    "open breaker", "disabled", "singleflight"])
def test_replay_fetch_matrix_equal(case, monkeypatch):
    got = {}
    for pkg in REPLAY:
        for mod in (jres, tres):
            mod.reset()
        got[pkg] = _matrix(pkg, case, monkeypatch)
    assert got["port"] == got["ref"]
    outcomes, calls, bodies = got["port"]
    want = {"hit": ({"hit": 1}, 1), "owner local": ({"owner_local": 1}, 0),
            "404": ({"miss": 1}, 2), "503": ({"error": 2, "miss": 1}, 2),
            "deadline": ({"deadline": 1}, 0),
            "transport error": ({"error": 2, "miss": 1}, 2),
            "open breaker": ({"breaker_open": 1, "miss": 1}, 0),
            "disabled": ({"disabled": 1}, 0),
            "singleflight": ({"hit": 3}, 1)}[case]
    assert (outcomes, calls) == want
    assert all((b is not None) == (case in ("hit", "singleflight"))
               for b in bodies)


@pytest.mark.parametrize("case", ["intact", "corrupt", "aged 100",
                                  "aged out", "no-store", "404",
                                  "origin 503", "no headers"])
def test_replay_validators_equal(case):
    out = {}
    for pkg, mk in (("ref", jmake_entry), ("port", make_entry)):
        rep = REPLAY[pkg]
        headers, body = rep.encode_entry(_entry(mk, max_age=300))
        headers["Content-Type"] = "image/png"
        status = 200
        if case == "corrupt":
            body = body[:-1] + b"X"
        elif case.startswith("aged"):
            headers["X-Gsky-Fabric-Age"] = "100" if case == "aged 100" \
                else "300"
        elif case == "no-store":
            headers["X-Gsky-Fabric-NoStore"] = "1"
        elif case == "404":
            status = 404
        elif case == "origin 503":
            headers["X-Gsky-Fabric-Status"] = "503"
        elif case == "no headers":
            headers = {"Content-Type": "image/png"}
        ent = rep.entry_from_response(status, headers, body)
        out[pkg] = None if ent is None else (
            ent.body, ent.etag, ent.status, ent.namespace, ent.layer,
            ent.layer_fp, ent.max_age, ent.headers,
            round(ent.expires - time.monotonic()))
    assert out["port"] == out["ref"]
    assert (out["port"] is not None) == (case in ("intact", "aged 100"))
    if case == "aged 100":
        assert 199 <= out["port"][-1] <= 200


def test_default_fabric_needs_the_ring(monkeypatch):
    for mod in (treplay, jreplay):
        monkeypatch.delenv("GSKY_FABRIC_SELF", raising=False)
        monkeypatch.setenv("GSKY_FABRIC_PEERS", B)
        assert mod.default_fabric() is None
        monkeypatch.setenv("GSKY_FABRIC_SELF", A)
        f = mod.default_fabric()
        assert f is not None and f.ring.nodes == [A, B]
    # the reference's knobs that are constants in the port (C.18): its
    # defaults, and its sub-gates follow the master gate when unset
    assert tfabric.TIMEOUT_S == jfabric.fabric_timeout_s()
    assert tpagerpc.BATCH_BYTES == jpagerpc.batch_bytes()
    monkeypatch.setenv("GSKY_FABRIC_PAGE_PEERS", " w1:1, ,w2:1 ")
    assert tfabric.page_peer_addrs() == jfabric.page_peer_addrs() == \
        ["w1:1", "w2:1"]
    for gate in ("0", "off", "1", "yes"):
        monkeypatch.setenv("GSKY_FABRIC", gate)
        assert tfabric.fabric_enabled() == jfabric.fabric_enabled() == \
            jfabric.pages_enabled() == jfabric.replay_enabled() == \
            jfabric.replicate_enabled()


# -- the gateway tier through port servers over HTTP ------------------------

DATE = "2020-01-10T00:00:00.000Z"
BBOX = "16478548,-4211230,16489679,-4198025"


@pytest.fixture(scope="module")
def arch(tmp_path_factory):
    return make_archive(str(tmp_path_factory.mktemp("tfab") / "data"))


def _server(tmp_path, arch, name, fabric):
    from gsky_tpu_torch.index.store import MASStore
    from gsky_tpu_torch.index.crawler import extract
    conf = tmp_path / f"conf-{name}"
    conf.mkdir()
    (conf / "config.json").write_text(json.dumps({
        "service_config": {"ows_hostname": "", "mas_address": "inproc"},
        "layers": [{"name": "landsat", "title": "L",
                    "data_source": arch["root"],
                    "rgb_products": ["LC08_20200110_T1"],
                    "dates": [DATE]}]}))
    store = MASStore()
    for p in arch["paths"]:
        store.ingest(extract(p, approx_stats=True))
    mas = MASClient(store)
    return OWSServer(ConfigWatcher(str(conf), mas_factory=lambda a: mas,
                                   install_signal=False),
                     mas_factory=lambda a: mas, device="cpu",
                     gateway=ServingGateway(cache=ResponseCache()),
                     fabric=fabric)


def _getmap():
    return (f"/ows?service=WMS&request=GetMap&version=1.3.0"
            f"&layers=landsat&crs=EPSG:3857&bbox={BBOX}"
            f"&width=64&height=64&format=image/png&time={DATE}")


def _get(base, url):
    try:
        with urllib.request.urlopen(base + url, timeout=60) as r:
            return r.status, dict(r.headers.items()), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers.items()), e.read()


def _handle(server, url):
    u = urlsplit(url)
    r = server.handle(u.path, parse_qs(u.query, keep_blank_values=True),
                      "h")
    return r.status, r.headers, r.read()


def test_peer_replay_through_two_port_servers(tmp_path, arch):
    """A renders and caches; B, which does not own the key, replays A's
    bytes over A's real /fabric/replay (``X-Gsky-Cache: peer``, a
    ``gateway.fabric`` span), keeps them and then hits."""
    from gsky_tpu_torch import obs
    server_a = _server(tmp_path, arch, "a", None)
    httpd_a = server_a.serve("127.0.0.1", 0)
    a_url = f"http://127.0.0.1:{httpd_a.server_address[1]}"
    fab = treplay.ReplayFabric("http://127.0.0.1:9/b", [a_url])
    fab.is_owner = lambda key: False
    server_b = _server(tmp_path, arch, "b", fab)
    httpd_b = server_b.serve("127.0.0.1", 0)
    b_url = f"http://127.0.0.1:{httpd_b.server_address[1]}"
    try:
        sa, ha, body_a = _get(a_url, _getmap())
        assert (sa, ha["X-Gsky-Cache"]) == (200, "miss")
        sb, hb, body_b = _get(b_url, _getmap())
        assert (sb, hb["X-Gsky-Cache"]) == (200, "peer")
        assert body_b == body_a and "Age" in hb
        assert hb.get("Cache-Control") == ha.get("Cache-Control")
        sb2, hb2, body_b2 = _get(b_url, _getmap())
        assert (sb2, hb2["X-Gsky-Cache"], body_b2) == (200, "hit", body_a)
        assert _get(a_url, "/fabric/replay?key=deadbeef")[0] == 404
        assert _get(a_url, "/fabric/replay")[0] == 404
        st = fab.stats()
        assert st["outcomes"] == {"hit": 1} and st["peer_ewma_ms"]
        # B's peer answer is a trace with the gateway.fabric span
        traces = [t for t in obs.default_recorder().traces()
                  if any(sp["name"] == "gateway.fabric"
                         for sp in t["spans"])]
        assert traces and all(
            sp["attrs"].get("hit") for t in traces for sp in t["spans"]
            if sp["name"] == "gateway.fabric")
        debug = json.loads(_get(b_url, "/debug")[2])
        assert debug["fabric"]["replay"]["outcomes"] == {"hit": 1}
        assert debug["fabric"]["enabled"] is True
    finally:
        for h in (httpd_a, httpd_b):
            h.shutdown()
            h.server_close()
        server_a.close()
        server_b.close()


def test_replay_endpoint_and_peer_bytes_under_brownout(tmp_path, arch,
                                                       monkeypatch):
    """A gateway under brownout answers a peer 404 with
    ``X-Gsky-Fabric-NoStore``; one that replays a peer's bytes under its
    own brownout serves them ``no-store``."""
    from gsky_tpu_torch.server import ows
    owner = _server(tmp_path, arch, "owner", None)
    status, _, body = _handle(owner, _getmap())
    assert status == 200
    key = next(iter(owner.gateway.cache._entries))
    hits0 = owner.gateway.cache.hits
    st, hd, got = _handle(owner, "/fabric/replay?key=" + key)
    assert st == 200 and got == body
    assert owner.gateway.cache.hits == hits0      # peek: no hit counted
    assert treplay.entry_from_response(200, hd, got).body == body
    monkeypatch.setattr(ows, "brownout_level", lambda: 1)
    st, hd, _ = _handle(owner, "/fabric/replay?key=" + key)
    assert st == 404 and hd["X-Gsky-Fabric-NoStore"] == "1"

    hd_ok = dict(treplay.encode_entry(owner.gateway.cache.peek(key))[0],
                 **{"Content-Type": "image/png"})
    fab = treplay.ReplayFabric("http://me:1", ["http://owner:1"],
                               transport=lambda u, t: (200, hd_ok, body))
    fab.is_owner = lambda k: False
    other = _server(tmp_path, arch, "other", fab)
    st, hd, got = _handle(other, _getmap())
    assert (st, hd["X-Gsky-Cache"], hd["Cache-Control"], got) == \
        (200, "peer", "no-store", body)
    owner.close()
    other.close()


def test_fabric_off_is_byte_identical(tmp_path, arch, monkeypatch):
    """GSKY_FABRIC=0: a server handed a live fabric answers byte for
    byte as a fabric-less one and never asks a peer; by default (no
    fabric given, the gate off or no ring) a server has none."""
    monkeypatch.setenv("GSKY_FABRIC", "0")

    def boom(url, timeout):   # pragma: no cover - must not run
        raise AssertionError("GSKY_FABRIC=0 must not ask a peer")

    fab = treplay.ReplayFabric(A, [B], transport=boom)
    fab.is_owner = lambda key: False
    off = _server(tmp_path, arch, "off", fab)
    plain = _server(tmp_path, arch, "plain", None)
    s_off, h_off, b_off = _handle(off, _getmap())
    s_ref, h_ref, b_ref = _handle(plain, _getmap())
    assert (s_off, b_off) == (s_ref, b_ref) and s_ref == 200
    assert h_off == h_ref
    assert fab.outcomes == {"disabled": 1}
    assert "fabric" not in json.loads(_handle(plain, "/debug")[2])
    assert _handle(off, "/fabric/replay?key=x")[0] == 404
    monkeypatch.delenv("GSKY_FABRIC")
    from gsky_tpu_torch.server import ows
    assert _server(tmp_path, arch, "dflt",
                   ows._FABRIC_DEFAULT).fabric is None
    monkeypatch.setenv("GSKY_FABRIC", "1")
    assert _server(tmp_path, arch, "noring",
                   ows._FABRIC_DEFAULT).fabric is None
    monkeypatch.setenv("GSKY_FABRIC_SELF", A)
    monkeypatch.setenv("GSKY_FABRIC_PEERS", B)
    ringed = _server(tmp_path, arch, "ringed", ows._FABRIC_DEFAULT)
    assert ringed.fabric is not None and ringed.fabric.self_addr == A
    for s in (off, plain, ringed):
        s.close()


# -- C.18: serials that name content ---------------------------------------

UTM = "EPSG:32755"
GT = (600000.0, 30.0, 0.0, 6100000.0, 0.0, -30.0)


def _two_scenes(root):
    """Two single-band int16 GeoTIFFs on one 30 m grid, of different
    values (seeded)."""
    rng = np.random.default_rng(18)
    paths = []
    for i in range(2):
        data = rng.integers(100 + 2000 * i, 1900 + 2000 * i,
                            (300, 700)).astype(np.int16)
        p = f"{root}/scene{i}.tif"
        jwrite_geotiff(p, data, JGT(*GT), jparse_crs(UTM), nodata=-999)
        paths.append(p)
    return paths


def _granule(cls, path):
    return cls(path=path, ds_name=path, namespace="b", base_namespace="b",
               band=1, time_index=None, timestamp=0.0, srs=UTM,
               geo_transform=list(GT), nodata=-999.0, array_type="Int16")


TILE = (64, 96)
DST = (600000.0 + 30.0 * 37, 30.0, 0.0, 6100000.0 - 30.0 * 21, 0.0, -30.0)


def _peer_fill(dst_pool, src_pool, mod):
    """Fill ``dst_pool`` with every page ``src_pool`` holds, over the
    page RPC's codec (the source serving, the destination staging)."""
    keys = list(src_pool._slots)

    def fetch(peer, ks, max_bytes, timeout):
        m, blob = mod.serve_page_fetch(src_pool, {"pages": ks,
                                                  "max_bytes": max_bytes})
        return mod.decode_result(json.dumps(m), blob)
    return mod.fill_from_peers(dst_pool, keys, peers=["node-a:1"],
                               fetch=fetch)


def test_c18_peer_filled_pages_name_the_same_scene(tmp_path, monkeypatch):
    """Node A loads scene 0 then scene 1, renders scene 0; node B (a
    second process: its counter starts at 1 again) loads scene 1 then
    scene 0 and is peer-filled from A.  The reference's B renders A's
    scene-0 pixels into its scene-1 tile; the port's B renders scene 1's
    own pixels, bytes equal to a cold render, and its scene-0 tile
    reads A's pages without a cold stage."""
    for k, v in (("GSKY_PALLAS", "interpret"), ("GSKY_WAVES", "0"),
                 ("GSKY_RENDER_BATCH", "0"), ("GSKY_POOL_JOURNAL", "0")):
        monkeypatch.setenv(k, v)
    paths = _two_scenes(str(tmp_path))
    crs_j, crs_t = jparse_crs(UTM), parse_crs(UTM)
    H, W = TILE

    # -- the reference -----------------------------------------------
    jg = [_granule(JGranule, p) for p in paths]

    def jnode(order):
        monkeypatch.setattr(jscene_cache, "_scene_serial",
                            itertools.count(1))
        cache = jscene_cache.SceneCache()
        for i in order:
            assert cache.get(jg[i]) is not None
        pool = jpages.PagePool(capacity=64)
        return cache, pool

    def jrender(cache, pool, i):
        monkeypatch.setattr(jpages, "_default", pool)
        c, v = JWarpExecutor().warp_mosaic_scenes(
            [jg[i]], [0], [1.0], JGT(*DST), crs_j, H, W, 1, "near",
            cache=cache)
        return np.asarray(c[0]), np.asarray(v[0])

    ja_cache, ja_pool = jnode([0, 1])
    ja0 = jrender(ja_cache, ja_pool, 0)
    jb_cache, jb_pool = jnode([1, 0])
    assert _peer_fill(jb_pool, ja_pool, jpagerpc) > 0
    jb1 = jrender(jb_cache, jb_pool, 1)
    jcold_cache, jcold_pool = jnode([1, 0])
    jcold1 = jrender(jcold_cache, jcold_pool, 1)
    # the reference's B: A's scene 0 where its scene 1 should be
    assert np.array_equal(jb1[0], ja0[0])
    assert not np.array_equal(jb1[0], jcold1[0])

    # -- the port ----------------------------------------------------
    tg = [_granule(Granule, p) for p in paths]

    def tnode(order):
        monkeypatch.setattr(tscene_cache, "_scene_serial",
                            itertools.count(1))
        cache = tscene_cache.SceneCache(device="cpu")
        for i in order:
            assert cache.get(tg[i]) is not None
        return WarpExecutor(device="cpu", cache=cache,
                            pool=PagePool(capacity=64, device="cpu"))

    def trender(ex, i):
        c, v = ex.warp_mosaic_scenes([tg[i]], [0], [1.0],
                                     GeoTransform(*DST), crs_t, H, W, 1,
                                     "near")
        return c[0].numpy(), v[0].numpy()

    ta = tnode([0, 1])
    ta0 = trender(ta, 0)
    tb = tnode([1, 0])
    assert _peer_fill(tb.pool, ta.pool, tpagerpc) > 0
    staged0 = tb.pool.stats()["staged"]
    tb1 = trender(tb, 1)
    tcold = tnode([1, 0])
    tcold1 = trender(tcold, 1)
    assert tb1[0].tobytes() == tcold1[0].tobytes()
    assert np.array_equal(tb1[1], tcold1[1]) and tb1[1].any()
    assert not np.array_equal(tb1[0], ta0[0])
    assert tb.pool.stats()["staged"] > staged0       # scene 1 staged cold
    # scene 0 on B: A's pages, no cold stage, A's bytes
    staged1, hits1 = tb.pool.stats()["staged"], tb.pool.stats()["hits"]
    tb0 = trender(tb, 0)
    assert tb0[0].tobytes() == ta0[0].tobytes()
    assert tb.pool.stats()["staged"] == staged1
    assert tb.pool.stats()["hits"] > hits1
    # the reference's and the port's cold renders agree (nearest)
    assert np.array_equal(tcold1[0], jcold1[0])
    assert np.array_equal(ta0[0], ja0[0])


def test_content_serials_are_stable_and_distinct(tmp_path, monkeypatch):
    """A file's scene has one serial in every cache and process (a hash
    in [2**52, 2**53)); another file, another level or a rewritten file
    has another; a scene with no file keeps the counter."""
    paths = _two_scenes(str(tmp_path))
    tg = [_granule(Granule, p) for p in paths]
    serials = []
    for order in ([0, 1], [1, 0]):
        monkeypatch.setattr(tscene_cache, "_scene_serial",
                            itertools.count(1))
        cache = tscene_cache.SceneCache(device="cpu")
        got = {i: cache.get(tg[i]).serial for i in order}
        serials.append(got)
    assert serials[0] == serials[1]
    s0, s1 = serials[0][0], serials[0][1]
    assert s0 != s1 and all((1 << 52) <= s < (1 << 53) for s in (s0, s1))
    assert json.loads(json.dumps(s0)) == s0
    assert tscene_cache.content_serial(tg[0], 2, (150, 350)) != s0
    missing = _granule(Granule, str(tmp_path / "absent.tif"))
    n = tscene_cache.content_serial(missing, 1, (1, 1))
    assert 0 < n < (1 << 52)
    import os
    st = os.stat(paths[0])
    os.utime(paths[0], ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
    assert tscene_cache.content_serial(tg[0], 1, (300, 700)) != s0


def test_rehydrate_after_teardown_restores_its_own_pages(tmp_path,
                                                          monkeypatch):
    """Two pools of one process page the same scene (one serial, its
    content's) into one journal.  After a teardown each rehydrates the
    pages it held, not the other's; a fresh pool (a warm boot) takes
    the whole journal."""
    monkeypatch.setenv("GSKY_POOL_JOURNAL", str(tmp_path / "one.jsonl"))
    paths = _two_scenes(str(tmp_path))
    g = _granule(Granule, paths[0])
    pools = []
    for rect in ((0, 0, 0, 1), (1, 1, 0, 0)):
        cache = tscene_cache.SceneCache(device="cpu")
        sc = cache.get(g)
        pool = PagePool(capacity=16, page_rows=128, page_cols=512,
                        device="cpu")
        pool.cache = cache
        pool.unpin(pool.table_for(sc.dev, sc.serial, *rect))
        pools.append((pool, sc.serial))
    (a, s), (b, _) = pools
    held = {k: list(p._slots) for k, p in (("a", a), ("b", b))}
    assert held == {"a": [(s, 0, 0), (s, 0, 1)], "b": [(s, 1, 0)]}
    b.teardown()
    assert b.rehydrate() == 1 and list(b._slots) == held["b"]
    a.teardown()
    assert a.rehydrate() == 2 and sorted(a._slots) == held["a"]
    fresh = PagePool(capacity=16, page_rows=128, page_cols=512,
                     device="cpu")
    fresh.cache = a.cache
    assert fresh.rehydrate() == 3
    assert sorted(fresh._slots) == sorted(held["a"] + held["b"])
