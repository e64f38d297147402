"""Port parity, the serving gateway and per-request degradation: the
port's `OWSServer` with a private `ServingGateway` against the JAX
package's with its own, on one config.json over one seeded archive.

The archive: `fixtures.make_archive` (two overlapping UTM-55S granules
and a NetCDF stack) and a copy of its two granules, one of them then cut
short (unreadable), in a second collection.  The reference runs its
serial GetMap ladder (GSKY_TILE_PIPELINE=0), waves and the render
batcher off, Pallas in interpret mode, through `aiohttp.test_utils`; the
port with ``device="cpu"`` through its handler, and over a socket.  A
spy counts each package's single-band renders (the reference's
`TilePipeline.composite_dispatch`, the port's `render_composite_byte`).

What is held equal in both packages: the ``X-Gsky-Cache`` sequence,
``Cache-Control``, 304 on a matching ``If-None-Match``, renders, flight
and cache counters; each ``ETag`` is the SHA-256 form of its own body
and equal where the bodies are (JPEG, nearest); ``Age`` within
``max_age``; ``X-GSKY-Degraded`` and the decoded bodies of a partial
render.  The scenarios mirror the reference's `tests/test_serving.py`."""

import asyncio
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
from gsky_tpu.resilience import TooManyFailures as JTooManyFailures
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher
from gsky_tpu.server.metrics import MetricsLogger as JMetricsLogger
from gsky_tpu.server.ows import OWSServer as JOWSServer
from gsky_tpu.serving import ResponseCache as JResponseCache
from gsky_tpu.serving import ServingGateway as JServingGateway
from gsky_tpu.serving import make_entry as jmake_entry
from gsky_tpu.serving import quantise_bbox as jquantise_bbox

from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.png import decode_png
from gsky_tpu_torch.pipeline.tile import TilePipeline
from gsky_tpu_torch.resilience import TooManyFailures
from gsky_tpu_torch.server.config import ConfigWatcher
from gsky_tpu_torch.server.ows import OWSServer, _replay
from gsky_tpu_torch.serving import ResponseCache, ServingGateway, \
    SingleFlight, default_gateway, make_entry, quantise_bbox

from fixtures import make_archive
from test_torch_server import MERC, NATIVE, T_DATA, _bbox

HOST = "gsky.example"
BOX_B = NATIVE[1]
# EPSG:4326 (lat/lon for 1.3.0) inside the data collection
LL = (148.10, -35.22, 148.14, -35.19)
SIZE = 64


@pytest.fixture(scope="module")
def garch(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = str(tmp_path_factory.mktemp("gateway"))
    for k, v in (("GSKY_TILE_PIPELINE", "0"), ("GSKY_WAVES", "0"),
                 ("GSKY_RENDER_BATCH", "0"), ("GSKY_PALLAS", "interpret"),
                 ("GSKY_DEGRADE_MAX_FRACTION", "0.5"),
                 ("GSKY_KERNEL_LEDGER", f"{root}/ledger.jsonl")):
        mp.setenv(k, v)
    mp.setattr(jpt, "_FAILED", set())
    jpages.reset_default_pool()
    arch = make_archive(f"{root}/data", scenes=2, size=512)
    os.makedirs(f"{root}/broken")
    tifs = [p for p in arch["paths"] if p.endswith(".tif")]
    broken = []
    for p in tifs:
        q = f"{root}/broken/{os.path.basename(p)}"
        with open(p, "rb") as src, open(q, "wb") as dst:
            dst.write(src.read())
        broken.append(q)
    jstore, tstore = JMASStore(), MASStore()
    for p in arch["paths"] + broken:
        for ex, st in ((jextract, jstore), (extract, tstore)):
            rec = ex(p)
            assert not rec.get("error"), rec
            for ds in rec["geo_metadata"]:
                if p.endswith(".tif"):
                    ds["namespace"] = "B4"
            st.ingest(rec)
    # the newer granule of the copy becomes unreadable after its crawl
    with open(broken[1], "r+b") as fp:
        fp.truncate(16)
    yield {"root": root, "jmas": JMASClient(jstore), "tmas": MASClient(tstore)}
    jpages.reset_default_pool()
    mp.undo()


def _layer(name, root, **extra):
    lay = {"name": name, "title": name, "data_source": f"{root}/data",
           "rgb_products": ["B4"], "time_generator": "mas",
           "resample": "near", "wcs_max_tile_width": 32,
           "wcs_max_tile_height": 32}
    lay.update(extra)
    return lay


class Env:
    """Both servers over one config directory, each with a private
    gateway."""

    def __init__(self, tmp_path, garch, layers, jcache=None, tcache=None):
        from aiohttp.test_utils import TestClient, TestServer
        self.conf = tmp_path / "conf"
        self.conf.mkdir()
        self.write({"service_config": {"ows_hostname": HOST,
                                       "mas_address": "inproc"},
                    "layers": layers})
        jmas, tmas = garch["jmas"], garch["tmas"]
        self.jwatcher = JConfigWatcher(str(self.conf),
                                       mas_factory=lambda a: jmas,
                                       install_signal=False)
        self.jserver = JOWSServer(
            self.jwatcher, mas_factory=lambda a: jmas,
            metrics=JMetricsLogger(), fabric=None,
            gateway=JServingGateway(cache=jcache or JResponseCache()))
        self.twatcher = ConfigWatcher(str(self.conf),
                                      mas_factory=lambda a: tmas,
                                      install_signal=False)
        self.port = OWSServer(self.twatcher, mas_factory=lambda a: tmas,
                              device="cpu",
                              gateway=ServingGateway(
                                  cache=tcache or ResponseCache()))
        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(self.jserver.app()),
                                 loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def write(self, cfg):
        (self.conf / "config.json").write_text(json.dumps(cfg))

    def read(self):
        return json.loads((self.conf / "config.json").read_text())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()

    def jax(self, urls, headers=None):
        """The reference's answers to ``urls``, sent concurrently:
        [(status, content type, body, headers)]."""
        async def one(u):
            r = await self.client.get(u, headers=headers or {})
            return r.status, r.content_type, await r.read(), r.headers

        async def every():
            return await asyncio.gather(*(one(u) for u in urls))
        return self.loop.run_until_complete(every())

    def jax1(self, url, headers=None):
        return self.jax([url], headers)[0]

    def torch1(self, url, headers=None):
        u = urlsplit(url)
        r = self.port.handle(u.path, parse_qs(u.query,
                                              keep_blank_values=True),
                             HOST, headers=headers)
        return r.status, r.content_type, r.read(), r.headers

    def both(self, url, headers=None):
        return self.jax1(url, headers), self.torch1(url, headers)

    @property
    def gateways(self):
        return self.jserver.gateway, self.port.gateway


@pytest.fixture
def make_env(tmp_path, garch):
    made = []

    def make(layers=None, **kw):
        root = garch["root"]
        env = Env(tmp_path, garch, layers or [_layer("plain", root)], **kw)
        made.append(env)
        return env
    yield make
    for env in made:
        env.close()


@pytest.fixture
def renders(monkeypatch):
    """Single-band renders per package, each slowed a little so that
    concurrent requests overlap."""
    calls = {"jax": 0, "torch": 0}
    for key, cls, name in (("jax", JTilePipeline, "composite_dispatch"),
                           ("torch", TilePipeline, "render_composite_byte")):
        def counting(self, *a, _f=getattr(cls, name), _k=key, **k):
            calls[_k] += 1
            time.sleep(0.3)
            return _f(self, *a, **k)
        monkeypatch.setattr(cls, name, counting)
    return calls


def getmap(layer="plain", box=NATIVE[0], *, crs=MERC, version="1.3.0",
           fmt="image/png", time_=T_DATA, size=SIZE, extra=""):
    key = "crs" if version == "1.3.0" else "srs"
    return (f"/ows?service=WMS&request=GetMap&version={version}"
            f"&layers={layer}&styles=&{key}={crs}&bbox={_bbox(box)}"
            f"&width={size}&height={size}&format={fmt}&time={time_}{extra}")


def getcoverage(layer="plain", box=NATIVE[0], *, size=SIZE, extra=""):
    return (f"/ows?service=WCS&request=GetCoverage&version=1.0.0"
            f"&coverage={layer}&crs={MERC}&bbox={_bbox(box)}"
            f"&width={size}&height={size}&format=GeoTIFF&time={T_DATA}"
            f"{extra}")


def _etag_of(body):
    return '"' + hashlib.sha256(body).hexdigest()[:32] + '"'


def _cache(h):
    return h.get("X-Gsky-Cache")


# ---------------------------------------------------------------------------
# the HTTP cache contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["image/png", "image/jpeg"])
def test_miss_hit_then_304(make_env, renders, fmt):
    env = make_env()
    url = getmap(fmt=fmt)
    seen = {}
    for pkg, get in (("jax", env.jax1), ("torch", env.torch1)):
        s1, c1, b1, h1 = get(url)
        s2, c2, b2, h2 = get(url)
        s3, _, b3, h3 = get(url, {"If-None-Match": h1["ETag"]})
        s4, _, b4, h4 = get(url, {"If-None-Match": '"nope"'})
        assert (s1, s2, s3, s4) == (200, 200, 304, 200), pkg
        assert c1 == c2 == fmt and b2 == b4 == b1 and b3 == b""
        assert h1["ETag"] == h2["ETag"] == h3["ETag"] == _etag_of(b1)
        assert 0 <= int(h2["Age"]) <= 300 and int(h1["Age"]) == 0
        seen[pkg] = ([_cache(h) for h in (h1, h2, h3, h4)],
                     [h["Cache-Control"] for h in (h1, h2, h3, h4)],
                     b1, h1["ETag"])
    assert seen["jax"][:2] == seen["torch"][:2] == (
        ["miss", "hit", "hit", "hit"], ["max-age=300"] * 4)
    if fmt == "image/jpeg":     # nearest: the same bytes, the same ETag
        assert seen["jax"][2:] == seen["torch"][2:]
    assert renders == {"jax": 1, "torch": 1}
    for gw in env.gateways:
        assert gw.cache.hits == 3 and gw.cache.misses == 1


def test_age_reflects_cache_residency(make_env):
    env = make_env()
    url = getmap()
    for gw, get in zip(env.gateways, (env.jax1, env.torch1)):
        get(url)
        (ent,) = list(gw.cache._entries.values())
        ent.expires -= 120
        _, _, _, h = get(url)
        assert _cache(h) == "hit"
        assert 120 <= int(h["Age"]) <= ent.max_age
        assert h["Cache-Control"] == "max-age=300"


SPELLINGS = {
    "1.1.1 lon/lat": (getmap(box=(LL[1], LL[0], LL[3], LL[2]),
                             crs="EPSG:4326"),
                      getmap(box=LL, crs="EPSG:4326", version="1.1.1")),
    "case": (getmap(), getmap().replace("service=", "SERVICE=")
             .replace("layers=", "LAYERS=").replace("image/png",
                                                    "IMAGE/PNG")),
    "parameter order": (getmap(), "/ows?" + "&".join(
        reversed(urlsplit(getmap()).query.split("&")))),
    "float formatting": (getmap(), getmap().replace(
        _bbox(NATIVE[0]), ",".join(f"{v:.4f}" for v in NATIVE[0]))),
}


@pytest.mark.parametrize("case", sorted(SPELLINGS))
def test_equivalent_spellings_share_an_entry(make_env, renders, case):
    env = make_env()
    first, second = SPELLINGS[case]
    assert first != second
    for get in (env.jax1, env.torch1):
        s1, _, b1, h1 = get(first)
        s2, _, b2, h2 = get(second)
        assert s1 == s2 == 200 and b1 == b2
        assert (_cache(h1), _cache(h2)) == ("miss", "hit")
    assert renders == {"jax": 1, "torch": 1}


def test_cached_response_replay_keeps_content_disposition(make_env):
    """An in-RAM GetCoverage is cached as a GetMap is, its attachment
    name with it."""
    env = make_env()
    url = getcoverage()
    for get in (env.jax1, env.torch1):
        s1, c1, b1, h1 = get(url)
        s2, c2, b2, h2 = get(url)
        assert (s1, s2) == (200, 200) and c1 == c2 == "image/geotiff"
        assert (_cache(h1), _cache(h2)) == ("miss", "hit") and b1 == b2
        assert h2["Content-Disposition"] == h1["Content-Disposition"]
        assert h1["ETag"] == h2["ETag"] == _etag_of(b1)


def test_non_200_replay_has_no_validators():
    ent = make_entry(b"<err/>", "text/xml", 404, "", "lay", "fp", 300)
    resp = _replay({"if-none-match": "*"}, ent, "join")
    assert resp.status == 404
    for k in ("ETag", "Cache-Control", "Age"):
        assert k not in resp.headers
    assert resp.headers["X-Gsky-Cache"] == "join"


def test_304_over_a_socket(make_env):
    env = make_env()
    httpd = env.port.serve("127.0.0.1", 0)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + getmap(), timeout=60) as r:
            assert r.headers["X-Gsky-Cache"] == "miss"
            etag, body = r.headers["ETag"], r.read()
        assert etag == _etag_of(body)
        req = urllib.request.Request(base + getmap(),
                                     headers={"If-None-Match": etag})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 304
        assert e.value.headers["Content-Length"] == "0"
        assert e.value.headers["ETag"] == etag
        assert e.value.read() == b""
        # the connection carries the next request
        with urllib.request.urlopen(base + getmap(), timeout=60) as r:
            assert r.headers["X-Gsky-Cache"] == "hit" and r.read() == body
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# single-flight
# ---------------------------------------------------------------------------

N_THREADS = 8


def test_concurrent_identical_requests_render_once(make_env, renders):
    env = make_env()
    url = getmap()
    jres = env.jax([url] * N_THREADS)
    barrier = threading.Barrier(N_THREADS)
    tres = [None] * N_THREADS

    def one(i):
        barrier.wait()
        tres[i] = env.torch1(url)
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for res in (jres, tres):
        assert all(r[0] == 200 for r in res)
        assert len({r[2] for r in res}) == 1
        tags = sorted(_cache(r[3]) for r in res)
        assert tags == ["join"] * (N_THREADS - 1) + ["miss"]
    assert renders == {"jax": 1, "torch": 1}
    for gw in env.gateways:
        st = gw.stats()["singleflight"]
        assert (st["leaders"], st["joined"], st["inflight"]) == \
            (1, N_THREADS - 1, 0)
        assert len(gw.cache) == 1


def test_singleflight_shares_an_error():
    flight = SingleFlight()
    started, release = threading.Event(), threading.Event()
    calls, out = [], {}

    def fail():
        calls.append(1)
        started.set()
        release.wait(30)
        raise RuntimeError("backend down")

    def joiner():
        started.wait(30)
        try:
            flight.do("k", fail)
        except RuntimeError as e:
            out["joiner"] = e
    t = threading.Thread(target=joiner)
    t.start()
    lead = threading.Thread(target=lambda: out.setdefault(
        "leader", _raises(lambda: flight.do("k", fail))))
    lead.start()
    assert started.wait(30)
    deadline = time.monotonic() + 30
    while flight.joined == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    release.set()
    t.join(30)
    lead.join(30)
    assert not t.is_alive() and not lead.is_alive()
    assert len(calls) == 1
    assert out["joiner"] is out["leader"]
    assert (flight.leaders, flight.joined, flight.inflight) == (1, 1, 0)


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error is the result
        return e
    return None


def test_flight_and_cache_under_thread_stress():
    """More threads than cores on a few keys, with a short switch
    interval: every call is a leader or a joiner, each flight's result
    reaches its joiners, nothing stays in flight, and the cache's byte
    count is its entries' bodies."""
    import sys
    flight, cache = SingleFlight(), ResponseCache(max_bytes=4000,
                                                  max_entry_bytes=4000)
    n_threads, rounds, keys = 4 * (os.cpu_count() or 2), 50, 5
    ran, bad = [0] * keys, []
    lock = threading.Lock()

    def work(t):
        for r in range(rounds):
            k = (t + r) % keys

            def fn():
                with lock:
                    ran[k] += 1
                return k
            got, _ = flight.do(f"k{k}", fn)
            if got != k:
                bad.append((k, got))
            cache.put(f"k{k}:{r % 7}", make_entry(
                bytes(100 + k), "t", 200, "", "l", "f", 60))
            cache.get(f"k{(k + 1) % keys}:{r % 7}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not bad
    assert flight.leaders + flight.joined == n_threads * rounds
    assert flight.leaders == sum(ran) and flight.inflight == 0
    assert cache.bytes == sum(len(e.body)
                              for e in cache._entries.values())
    assert cache.bytes <= cache.max_bytes


def test_singleflight_sequential_calls_are_fresh_flights():
    flight = SingleFlight()
    assert flight.do("k", lambda: 1) == (1, False)
    assert flight.do("k", lambda: 2) == (2, False)
    assert (flight.leaders, flight.joined) == (2, 0)


# ---------------------------------------------------------------------------
# reload invalidation
# ---------------------------------------------------------------------------

def test_reload_invalidates_the_changed_layer(make_env, renders):
    env = make_env()
    cfg = env.read()
    second = dict(cfg["layers"][0], name="second", title="second")
    cfg["layers"].append(second)
    env.write(cfg)
    env.jwatcher.reload()
    env.twatcher.reload()
    urls = [getmap(), getmap(layer="second")]
    for get in (env.jax1, env.torch1):
        assert [_cache(get(u)[3]) for u in urls] == ["miss", "miss"]
        assert [_cache(get(u)[3]) for u in urls] == ["hit", "hit"]
    cfg["layers"][0]["offset_value"] = 5.0
    env.write(cfg)
    env.jwatcher.reload()
    env.twatcher.reload()
    for gw in env.gateways:
        assert gw.cache.invalidations >= 1
    for get in (env.jax1, env.torch1):
        assert [_cache(get(u)[3]) for u in urls] == ["miss", "hit"]
    assert renders == {"jax": 3, "torch": 3}


def test_listeners_do_not_accumulate(make_env):
    import gc
    env = make_env()
    watcher, tmas = env.twatcher, env.port.mas_factory("")
    n0 = len(watcher._listeners)
    for _ in range(5):
        OWSServer(watcher, mas_factory=lambda a: tmas, device="cpu",
                  gateway=env.port.gateway)
    assert len(watcher._listeners) == n0
    for _ in range(3):
        OWSServer(watcher, mas_factory=lambda a: tmas, device="cpu",
                  gateway=ServingGateway())
    gc.collect()
    watcher.reload()
    assert len(watcher._listeners) == n0


def test_sighup_runs_listeners_off_the_signal_thread(make_env):
    env = make_env()
    seen, done = {}, threading.Event()

    def listener(configs):
        seen["thread"] = threading.current_thread()
        done.set()
    env.twatcher.add_listener(listener)
    env.twatcher._on_hup()
    assert done.wait(30)
    assert seen["thread"] is not threading.current_thread()


def test_failing_listener_is_logged_not_raised(make_env, caplog):
    env = make_env()
    env.twatcher.add_listener(lambda configs: 1 / 0)
    got = []
    env.twatcher.add_listener(got.append)
    env.twatcher.reload()
    assert len(got) == 1 and "" in got[0]
    assert "config reload listener failed" in caplog.text


def test_default_gateway_and_raw_server(make_env, garch):
    env = make_env()
    tmas = garch["tmas"]
    assert OWSServer(env.twatcher, mas_factory=lambda a: tmas,
                     device="cpu").gateway is default_gateway
    raw = OWSServer(env.twatcher, mas_factory=lambda a: tmas,
                    device="cpu", gateway=None)
    u = urlsplit(getmap())
    r = raw.handle(u.path, parse_qs(u.query, keep_blank_values=True), HOST)
    assert r.status == 200 and "X-Gsky-Cache" not in r.headers
    assert "ETag" not in r.headers


# ---------------------------------------------------------------------------
# what is never cached
# ---------------------------------------------------------------------------

NOT_CACHED = {
    "animation": getmap(fmt="image/apng", time_=T_DATA.replace(
        ",", ",2020-01-11T00:00:00.000Z,")),
    "cache_max_age 0": getmap(layer="nocache"),
    "shard": getcoverage(extra="&wshard=1"),
    "auto-sized": getcoverage(size=0),
    "degraded": getmap(layer="broken"),
}


@pytest.mark.parametrize("case", sorted(NOT_CACHED))
def test_no_entry(make_env, garch, case):
    root = garch["root"]
    env = make_env([_layer("plain", root),
                    _layer("nocache", root, cache_max_age=0),
                    _layer("broken", root,
                           data_source=f"{root}/broken")])
    url = NOT_CACHED[case]
    (js, _, _, jh), (ts, _, _, th) = env.both(url)
    assert js == ts == 200, (js, ts)
    want = "miss" if case == "degraded" else None
    assert _cache(jh) == _cache(th) == want
    (js, _, _, jh), (ts, _, _, th) = env.both(url)
    assert _cache(jh) == _cache(th) == want
    for gw in env.gateways:
        assert len(gw.cache) == 0


def test_byte_budget_evicts_lru(make_env):
    env = make_env()
    a, b = getmap(fmt="image/jpeg"), getmap(box=BOX_B, fmt="image/jpeg")
    size = len(env.torch1(a)[2])
    for gw in env.gateways:
        gw.cache.clear()
        gw.cache.max_bytes = int(size * 1.5)
    for gw, get in zip(env.gateways, (env.jax1, env.torch1)):
        tags = [_cache(get(u)[3]) for u in (a, b, b, a)]
        assert tags == ["miss", "miss", "hit", "miss"]
        assert gw.cache.evictions == 2 and len(gw.cache) == 1


def test_stale_replay_on_too_many_failures(make_env, monkeypatch):
    env = make_env()
    url = getmap()
    for get in (env.jax1, env.torch1):
        assert _cache(get(url)[3]) == "miss"
    for gw in env.gateways:
        for ent in gw.cache._entries.values():
            ent.expires = time.monotonic() - 1.0   # past TTL, in grace

    def down(exc):
        def fail(self, *a, **k):
            raise exc("1/1 decode failures exceed the degradation budget",
                      site="decode")
        return fail
    monkeypatch.setattr(JTilePipeline, "composite_dispatch",
                        down(JTooManyFailures))
    monkeypatch.setattr(TilePipeline, "render_composite_byte",
                        down(TooManyFailures))
    (js, _, jb, jh), (ts, _, tb, th) = env.both(url)
    assert js == ts == 200 and jb and tb
    for h in (jh, th):
        assert _cache(h) == "stale"
        assert h["Cache-Control"] == "no-store"
        assert h["X-GSKY-Degraded"] == "stale-cache"
        assert "ETag" not in h
    # no entry to fall back on: the failure is the answer
    ref, got = env.both(getmap(box=BOX_B))
    assert ref[0] == got[0] == 503


# ---------------------------------------------------------------------------
# per-request degradation
# ---------------------------------------------------------------------------

def test_partial_render_is_labelled(make_env, garch):
    """One of the broken collection's two granules cannot be read: 1 of
    2 failures is within GSKY_DEGRADE_MAX_FRACTION 0.5, so both packages
    answer 200 with the same label and the same tile."""
    root = garch["root"]
    env = make_env([_layer("broken", root, data_source=f"{root}/broken"),
                    _layer("plain", root)])
    url = getmap(layer="broken")
    (js, jc, jb, jh), (ts, tc, tb, th) = env.both(url)
    assert (js, jc) == (ts, tc) == (200, "image/png")
    assert jh["X-GSKY-Degraded"] == th["X-GSKY-Degraded"]
    assert th["X-GSKY-Degraded"]
    a, b = jdecode_png(jb), decode_png(tb)
    assert np.array_equal(a, b)
    assert (a[..., 3] > 0).any()
    # a clean request of the same server carries no label
    _, (_, _, _, h) = env.both(getmap())
    assert "X-GSKY-Degraded" not in h


@pytest.mark.parametrize("waves", ["0", "1"])
def test_partial_export_is_labelled(make_env, garch, monkeypatch, waves):
    """A multi-tile GetCoverage through the export engine: with waves on
    its tiles are rendered together on the engine's worker threads, and
    the partial decode marked there reaches the request."""
    from gsky_tpu.pipeline import waves as jwaves
    from gsky_tpu_torch.pipeline import waves as twaves
    monkeypatch.setenv("GSKY_WAVES", waves)
    jwaves.reset_waves()
    twaves.reset_waves()
    root = garch["root"]
    env = make_env([_layer("broken", root, data_source=f"{root}/broken")])
    try:
        (js, _, _, jh), (ts, _, _, th) = env.both(getcoverage("broken"))
    finally:
        jwaves.reset_waves()
        twaves.reset_waves()
    assert js == ts == 200
    assert th.get("X-GSKY-Degraded") == jh.get("X-GSKY-Degraded")
    assert th["X-GSKY-Degraded"] == "decode"
    st = env.port.last_export
    assert st["tiles"] == 4
    assert (st.get("plan_batches", 0) > 0) == (waves == "1"), st


# ---------------------------------------------------------------------------
# the response cache, unit cases (both packages' caches)
# ---------------------------------------------------------------------------

PKG = {"jax": (JResponseCache, jmake_entry, jquantise_bbox),
       "torch": (ResponseCache, make_entry, quantise_bbox)}


def _ent(mk, body=b"x" * 40, max_age=60):
    return mk(body, "image/png", 200, "", "lay", "fp", max_age)


def _lru_byte_budget(RC, mk):
    rc = RC(max_bytes=100, max_entry_bytes=100)
    for i in range(3):
        assert rc.put(f"k{i}", _ent(mk))
    assert rc.evictions == 1
    assert rc.get("k0") is None
    assert rc.get("k1") is not None and rc.get("k2") is not None
    assert rc.bytes <= 100


def _lru_recency(RC, mk):
    rc = RC(max_bytes=100, max_entry_bytes=100)
    rc.put("a", _ent(mk))
    rc.put("b", _ent(mk))
    assert rc.get("a") is not None
    rc.put("c", _ent(mk))
    assert rc.get("b") is None and rc.get("a") is not None


def _ttl_expiry(RC, mk):
    rc = RC()
    rc.put("k", _ent(mk, max_age=1))
    assert rc.get("k") is not None
    rc._entries["k"].expires = 0.0
    assert rc.get("k") is None
    assert rc.expirations == 1


def _rejects_oversize_and_zero_ttl(RC, mk):
    rc = RC(max_bytes=1000, max_entry_bytes=10)
    assert not rc.put("big", _ent(mk, body=b"y" * 11))
    assert not rc.put("nottl", _ent(mk, body=b"y", max_age=0))
    assert len(rc) == 0


def _invalidate_by_fingerprint(RC, mk):
    rc = RC()
    rc.put("a", mk(b"1", "t", 200, "ns1", "lay", "OLD", 60))
    rc.put("b", mk(b"2", "t", 200, "ns1", "lay2", "KEEP", 60))
    rc.put("c", mk(b"3", "t", 200, "gone", "lay", "X", 60))
    assert rc.invalidate({"ns1": {"KEEP", "NEW"}}) == 2
    assert rc.get("b") is not None
    assert rc.get("a") is None and rc.get("c") is None


def _stale_grace(RC, mk):
    rc = RC(stale_grace=600)
    rc.put("k", _ent(mk))
    rc._entries["k"].expires = time.monotonic() - 1.0
    assert rc.get("k") is None and rc.get_stale("k") is not None
    rc._entries["k"].expires = time.monotonic() - 601.0
    assert rc.get_stale("k") is None and len(rc) == 0


UNIT = {f.__name__.lstrip("_"): f for f in (
    _lru_byte_budget, _lru_recency, _ttl_expiry,
    _rejects_oversize_and_zero_ttl, _invalidate_by_fingerprint,
    _stale_grace)}


@pytest.mark.parametrize("pkg", sorted(PKG))
@pytest.mark.parametrize("case", sorted(UNIT))
def test_response_cache_unit(case, pkg):
    RC, mk, _ = PKG[pkg]
    UNIT[case](RC, mk)


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_quantise_bbox_spelling_collision(pkg):
    q = PKG[pkg][2]
    a = q(16478548.0, -4211230.0, 16489679.0, -4198025.0, 256, 256)
    b = q(16478548.0000001, -4211229.9999999, 16489679.0000002,
          -4198025.0000001, 256, 256)
    assert a == b
    assert a != q(16478548.0, -4211230.0, 16489679.0, -4198026.0, 256,
                  256)
    assert a == PKG["jax"][2](16478548.0, -4211230.0, 16489679.0,
                              -4198025.0, 256, 256)


def test_etag_is_the_bodys_sha256():
    body = b"\x89PNG tile"
    assert make_entry(body, "image/png", 200, "", "l", "f", 300).etag == \
        jmake_entry(body, "image/png", 200, "", "l", "f", 300).etag == \
        _etag_of(body)
