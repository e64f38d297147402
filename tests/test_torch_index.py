"""The port's index (`gsky_tpu_torch/index`): crawler rulesets, the
eo-datasets YAML extractors, the sharded store, the masapi HTTP service
and the MAS client's HTTP transport, against the JAX package's.

Records and query answers are compared exactly (they are JSON).  The
reference's masapi is its aiohttp app, served on 127.0.0.1 from a
thread's event loop; the port's is its standard-library server; both
answer the same requests over the same records with the same status,
content type and body bytes.
"""

from __future__ import annotations

import asyncio
import copy
import json
import os
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
from aiohttp import web

from gsky_tpu.index import api as japi
from gsky_tpu.index import crawler as jcrawler
from gsky_tpu.index import rulesets as jrules
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.sharded import MASShardedStore as JSharded
from gsky_tpu.index.store import MASStore as JMASStore

from gsky_tpu_torch import carry
from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import GeoTransform
from gsky_tpu_torch.index import api as tapi
from gsky_tpu_torch.index import crawler as tcrawler
from gsky_tpu_torch.index import rulesets as trules
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.sharded import MASShardedStore
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.geotiff import write_geotiff
from gsky_tpu_torch.io.netcdf import write_netcdf3
from gsky_tpu_torch.resilience import reset_breakers

TIMEOUT = 30

# a product name of each built-in rule's family
PRODUCTS = {
    "landsat": "LC80900852020001LGN00_B4.TIF",
    "modis43A4": "LHTC_2020001.h29v12.006.2020010.nc",
    "lhtc": "COMPOSITE_HIGH_NBAR_2020_PER_20.nc",
    "modis1": "MCD43A4.A2020001.h29v12.006.2020010123456.hdf",
    "modis-fc": "FC.v302.MCD43A4.h29v12.2020.006.PV.jp2",
    "modis2": "MOD09_L2.A2020001.0000.006.2020001123456.hdf",
    "modisJP": "FC.v302.MCD43A4.h29v12.2020.006.nc",
    "modisJP_LR": "FC_LR.v302.MCD43A4.h29v12.2020.006.nc",
    "sentinel2": "T55HFA_20200105T001109_B04.jp2",
    "himawari8": ("20200101001000-P1S-ABOM_OBS_B07-PRJ_GEOS141_2000-"
                  "HIMAWARI8-AHI.nc"),
    "agdc_landsat1": "LS5_TM_NBAR_3577_15_-40_2010.nc",
    "agdc_landsat2": "LS8_OLI_TIRS_NBAR_3577_15_-40_2020.nc",
    "elevation_ga": "Elevation_1secSRTM_DEMs_v1.0_DEM-S_Tiles_e148s35dems.nc",
    "agdc_dem": "SRTM_DEM_15_-40_20000211000000.nc",
    "chirps2.0": "chirps-v2.0.2020.dekads.nc",
    "era-interim": "tas_3hrs_ERAI_historical_surface_19790101_19791231.nc",
    "sentinel2_ard_nbar_nbart":
        "ga_s2am_ard_55HFA_20200105T001109_final_NBART_B04.TIF",
    "sentinel2_ard_qa_supp": "S2A_OPER_20200105T001109_QA_01_FMASK.TIF",
    "barra": "BARRA_R_20200105T0600Z.nc",
    "ereef": "gbr4_roms_2020.nc",
    "default": "anything.bin",
}


def _rule_table(rules):
    return [(r.collection, r.namespace, r.srs_text, r.proj4_text, r.pattern,
             r.match_full_path, r.bbox,
             vars(r.geo_loc) if r.geo_loc else None, r.compute_stats)
            for r in rules]


def test_builtin_table_equals_reference():
    assert _rule_table(trules.BUILTIN_RULESETS) == \
        _rule_table(jrules.BUILTIN_RULESETS)
    assert {r.collection for r in trules.BUILTIN_RULESETS} == set(PRODUCTS)


def _record(ns="band", stamps=(), src=""):
    return {"filename": "/x/y", "file_type": "GTiff", "geo_metadata": [
        {"namespace": ns, "timestamps": list(stamps),
         "timestamps_source": src, "proj_wkt": "EPSG:32755", "proj4": "",
         "polygon": "POLYGON ((0 0,1 0,1 1,0 1,0 0))"}]}


@pytest.mark.parametrize("family", sorted(PRODUCTS))
def test_builtin_rule_matches_its_family(family):
    path = "/data/arch/" + PRODUCTS[family]
    trule, tm = trules.match_rule(path)
    jrule, jm = jrules.match_rule(path)
    assert trule.collection == jrule.collection == family
    assert tm.groupdict() == jm.groupdict()
    for rec0 in (_record(), _record(stamps=["2001-01-01T00:00:00.000Z"],
                                    src="filename")):
        t = trules.apply_ruleset(trule, tm, copy.deepcopy(rec0), path)
        j = jrules.apply_ruleset(jrule, jm, copy.deepcopy(rec0), path)
        assert t == j


@pytest.mark.parametrize("mode,want", [
    ("ns_dataset", "band"), ("ns_path", "HIGH"),
    ("ns_combine", "HIGH_band")])
def test_apply_ruleset_namespace_modes(mode, want):
    spec = {"collection": "c", "namespace": mode,
            "pattern": r"^COMPOSITE_(?P<namespace>LOW|HIGH)_(?P<year>\d{4})"
                       r"(?P<month>\d\d)(?P<day>\d\d)\.nc$"}
    path = "/d/COMPOSITE_HIGH_20200304.nc"
    out = []
    for mod in (trules, jrules):
        rule = mod.RuleSet.from_json(spec)
        rec = mod.apply_ruleset(rule, rule.match(path), _record(), path)
        out.append(rec)
    assert out[0] == out[1]
    ds = out[0]["geo_metadata"][0]
    assert ds["namespace"] == want
    assert ds["timestamps"] == ["2020-03-04T00:00:00.000Z"]


def test_timestamps_from_groups_equal_reference():
    cases = [{"year": "2020", "julian_day": "060"},
             {"year": "2020", "month": "02", "day": "29", "hour": "13",
              "minute": "7"},
             {"start_year": "1979", "start_month": "3"},
             {"year": "2020", "month": "13", "day": "1"},
             {"hour": "1"}]
    for g in cases:
        assert trules.timestamp_from_groups(g) == \
            jrules.timestamp_from_groups(g)


# ---------------------------------------------------------------------------
# crawler records
# ---------------------------------------------------------------------------

UTM = "EPSG:32755"
WKT = "POLYGON((147 -36,150 -36,150 -33,147 -33,147 -36))"
DATES = ("2020001", "2020017", "2020033")


def _write_archive(root):
    """Two collections: Landsat-named GeoTIFFs (the built-in ``landsat``
    rule dates them) and a NetCDF stack."""
    rng = np.random.default_rng(5)
    paths = []
    os.makedirs(f"{root}/landsat")
    os.makedirs(f"{root}/stack")
    for k, d in enumerate(DATES):
        for band in ("B4", "B5"):
            p = f"{root}/landsat/LC8090085{d}LGN00_{band}.TIF"
            data = rng.integers(0, 3000, (48, 64)).astype(np.int16)
            write_geotiff(p, data, GeoTransform(600000.0 + 300 * k, 30.0,
                                                0.0, 6100000.0, 0.0, -30.0),
                          parse_crs(UTM), nodata=-999, tile_size=32)
            paths.append(p)
    stack = rng.normal(size=(4, 20, 30)).astype(np.float32)
    p = f"{root}/stack/sst.nc"
    write_netcdf3(p, {"sst": stack}, 150.0 + 0.1 * np.arange(30),
                  -30.0 - 0.1 * np.arange(20),
                  times=1.6e9 + 86400.0 * np.arange(4), nodata=-9999.0)
    paths.append(p)
    return paths


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("index"))
    paths = _write_archive(root)
    jrecs = [jcrawler.extract(p) for p in paths]
    trecs = [tcrawler.extract(p) for p in paths]
    return {"root": root, "paths": paths, "jrecs": jrecs, "trecs": trecs}


def test_crawler_records_take_builtin_rules(archive):
    assert archive["trecs"] == archive["jrecs"]
    rec = archive["trecs"][0]
    assert rec["geo_metadata"][0]["timestamps"] == \
        ["2020-01-01T00:00:00.000Z"]


def test_crawler_records_with_a_rules_file(archive, tmp_path):
    rules = {"rule_sets": [{
        "collection": "mine", "namespace": "ns_combine",
        "pattern": r"LC8(?P<path>\d{3})(?P<row>\d{3})(?P<year>\d{4})"
                   r"(?P<julian_day>\d{3})LGN00_(?P<namespace>B\d)",
        "bbox": [148.0, -35.0, 149.0, -34.0]}]}
    p = tmp_path / "rules.json"
    p.write_text(json.dumps(rules))
    tr, jr = trules.load_rulesets(str(p)), jrules.load_rulesets(str(p))
    assert _rule_table(tr) == _rule_table(jr)
    for path in archive["paths"]:
        t = tcrawler.extract(path, rules=tr)
        assert t == jcrawler.extract(path, rules=jr)
    ds = tcrawler.extract(archive["paths"][1], rules=tr)["geo_metadata"][0]
    assert ds["namespace"].startswith("B5_")
    assert ds["polygon"].startswith("POLYGON ((148.0 -35.0,")
    # a bad rule leaves the record as the extractor made it
    bad = [trules.RuleSet(collection="bad", pattern="(")]
    assert tcrawler.extract(archive["paths"][0], rules=bad) == \
        jcrawler.extract(archive["paths"][0], rules=[
            jrules.RuleSet(collection="bad", pattern="(")])


def test_geo_loc_rule_gives_the_subsampled_swath_record():
    """The record the subsampled swath of the geolocation tests (and of
    chip_smoke's phase 18) was given by hand comes from a rule."""
    from test_torch_geoloc import LL, SUB, SUB_OFF, _sub_geo_loc
    spec = {"collection": "swath_sub", "pattern": r"^swath_sub_.*\.nc$",
            "srs_text": LL,
            "proj4_text": "+proj=longlat +datum=WGS84 +no_defs",
            "bbox": [146.9, -35.3, 148.3, -33.8],
            "geo_loc": {"x_dataset_template": 'NETCDF:"{filename}":lon',
                        "y_dataset_template": "lat",
                        "line_offset": SUB_OFF, "pixel_offset": SUB_OFF,
                        "line_step": SUB, "pixel_step": SUB}}
    path = "/d/swath_sub_2020.nc"
    rec = {"filename": path, "file_type": "NetCDF", "geo_metadata": [
        {"namespace": "bt", "proj_wkt": "", "proj4": "", "polygon": "",
         "timestamps": ["2020-01-01T00:00:00.000Z"]}]}
    want = _sub_geo_loc(copy.deepcopy(rec))
    for mod in (trules, jrules):
        rule = mod.RuleSet.from_json(spec)
        got = mod.apply_ruleset(rule, rule.match(path),
                                copy.deepcopy(rec), path)
        assert got == want


S2_YAML = """\
format: {name: GeoTiff}
extent: {center_dt: '2020-01-05 00:11:09.024000Z'}
grid_spatial:
  projection:
    spatial_reference: %s
    valid_data:
      coordinates: [[[600000, 6100000], [709800, 6100000],
                     [709800, 5990200], [600000, 6100000]]]
image:
  bands:
    nbart_red:
      path: bands/red.tif
      info: {geotransform: [600000, 10, 0, 6100000, 0, -10],
             width: 10980, height: 10980}
    fmask: {path: bands/fmask.tif, info: {width: 5490, height: 5490}}
    solar_zenith: {path: bands/sz.tif}
"""

LS_YAML = """\
crs: %s
geometry:
  coordinates: [[[600000, 6100000], [700000, 6100000], [700000, 6000000],
                 [600000, 6100000]]]
properties: {datetime: '2020-01-17T23:50:41.5Z'}
measurements:
  nbart_red: {path: LC08_red.tif}
  oa:fmask: {path: LC08_fmask.tif}
"""


@pytest.mark.parametrize("srs", ["EPSG:32755", "not a reference system"])
@pytest.mark.parametrize("family", ["sentinel2", "landsat"])
def test_yaml_extractors_equal_reference(tmp_path, family, srs):
    p = tmp_path / f"{family}.yaml"
    p.write_text((S2_YAML if family == "sentinel2" else LS_YAML) % srs)
    t = tcrawler.extract_yaml(str(p), family)
    assert t == jcrawler.extract_yaml(str(p), family)
    assert len(t["geo_metadata"]) >= 2 and t["geo_metadata"][0]["timestamps"]


def test_yaml_without_pyyaml_names_it(tmp_path, monkeypatch):
    p = tmp_path / "s2.yaml"
    p.write_text(S2_YAML % "EPSG:32755")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="PyYAML"):
        tcrawler.extract_sentinel2_yaml(str(p))


def test_crawler_main_equals_reference(archive, tmp_path, capsys):
    p = tmp_path / "r.json"
    p.write_text(json.dumps({"rule_sets": [{
        "collection": "x", "namespace": "ns_path",
        "pattern": r"_(?P<namespace>B\d)\.TIF$"}]}))
    out = {}
    for name, mod in (("t", tcrawler), ("j", jcrawler)):
        for fmt in ("json", "tsv"):
            assert mod.main(["-conc", "2", "-fmt", fmt, "-rules", str(p),
                             archive["root"]]) == 0
            out[name, fmt] = sorted(capsys.readouterr().out.splitlines())
    assert out["t", "json"] == out["j", "json"]
    assert out["t", "tsv"] == out["j", "tsv"]
    assert len(out["t", "tsv"]) == len(archive["paths"])


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

def _queries(root):
    wkt = ("POLYGON((147.0 -36.0,150.0 -36.0,150.0 -33.0,147.0 -33.0,"
           "147.0 -36.0))")
    out = []
    for gpath in (root, f"{root}/landsat", f"{root}/stack",
                  f"{root}/absent"):
        out += [
            ("intersects", gpath, dict(srs="EPSG:4326", wkt=wkt,
                                       metadata="gdal")),
            ("intersects", gpath, dict(srs="EPSG:4326", wkt=wkt,
                                       time="2020-01-10T00:00:00.000Z",
                                       until="2020-02-10T00:00:00.000Z")),
            ("intersects", gpath, dict(srs="EPSG:4326", wkt=wkt,
                                       metadata="gdal", limit=2)),
            ("timestamps", gpath, dict(
                time="2000-01-01T00:00:00.000Z",
                until="2030-01-01T00:00:00.000Z")),
            ("extents", gpath, {}),
        ]
    return out


def test_sharded_store_equals_reference(archive, tmp_path):
    root = archive["root"]
    js = JSharded(root, db_dir=str(tmp_path / "j"))
    ts = carry.store_from_reference(
        archive["jrecs"], MASShardedStore(root, db_dir=str(tmp_path / "t")))
    js.ingest_many(copy.deepcopy(archive["jrecs"]))
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j")) == ["landsat.sqlite",
                                                "stack.sqlite"]
    for op, gpath, kw in _queries(root):
        assert getattr(ts, op)(gpath, **kw) == getattr(js, op)(gpath, **kw)
    tok = ts.timestamps(root)["token"]
    assert ts.timestamps(root, token=tok) == js.timestamps(root, token=tok)
    assert not os.path.exists(tmp_path / "t" / "absent.sqlite")
    # a shard that appears later joins the next root-spanning query
    late = copy.deepcopy(archive["jrecs"][0])
    late["filename"] = f"{root}/late/{os.path.basename(late['filename'])}"
    MASStore(str(tmp_path / "t" / "late.sqlite")).ingest(late)
    kw = dict(srs="EPSG:4326", wkt=WKT)
    assert late["filename"] in ts.intersects(root, **kw)["files"]
    assert late["filename"] not in js.intersects(root, **kw)["files"]


def test_store_generation_extents_and_files(archive, tmp_path):
    db = str(tmp_path / "m.sqlite")
    t, j = MASStore(db), JMASStore(str(tmp_path / "j.sqlite"))
    assert t.generation == j.generation == 0
    for rec in archive["jrecs"]:
        t.ingest(copy.deepcopy(rec))
        j.ingest(copy.deepcopy(rec))
    assert t.generation == j.generation == len(archive["jrecs"])
    assert MASStore(db).generation == t.generation   # persisted
    assert t.list_files() == j.list_files()
    for gp in (archive["root"], f"{archive['root']}/stack"):
        assert t.extents(gp) == j.extents(gp)
        assert t.extents(gp, ["sst"]) == j.extents(gp, ["sst"])


# ---------------------------------------------------------------------------
# masapi over HTTP
# ---------------------------------------------------------------------------

class RefServer:
    """The reference's aiohttp masapi on 127.0.0.1, on its own loop."""

    def __init__(self, app):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

        async def start():
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            return runner

        self.runner = asyncio.run_coroutine_threadsafe(
            start(), self.loop).result(TIMEOUT)
        self.port = self.runner.addresses[0][1]

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(TIMEOUT)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()
        self.loop.close()


class PortServer:
    def __init__(self, api):
        self.httpd = api.serve("127.0.0.1", 0)
        self.port = self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.thread.join(TIMEOUT)
        assert not self.httpd.thread.is_alive()


def fetch(port, path, query="", form=None):
    """(status, content type, body) of a GET, or of a POST of ``form``
    urlencoded."""
    url = f"http://127.0.0.1:{port}{urllib.parse.quote(path)}"
    if query:
        url += "?" + query
    data = None
    req = urllib.request.Request(url)
    if form is not None:
        data = urllib.parse.urlencode(form).encode()
        req = urllib.request.Request(url, data=data, headers={
            "Content-Type": "application/x-www-form-urlencoded"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture
def masapis(archive):
    """The reference's and the port's masapi over the same records."""
    jstore, tstore = JMASStore(), carry.store_from_reference(
        archive["jrecs"])
    jstore.ingest_many(copy.deepcopy(archive["jrecs"]))
    tcache = tapi.MasQueryCache()
    ref = RefServer(japi.build_app(jstore))
    port = PortServer(tapi.build_app(tstore, cache=tcache))
    try:
        yield {"ref": ref.port, "port": port.port, "jstore": jstore,
               "tstore": tstore, "cache": tcache, "root": archive["root"]}
    finally:
        port.close()
        ref.close()
        reset_breakers()


def _both(m, path, query="", form=None):
    a = fetch(m["ref"], path, query, form)
    b = fetch(m["port"], path, query, form)
    assert a == b, (path, query, a[:2], b[:2], a[2][:300], b[2][:300])
    return b


def test_masapi_get_equals_reference(masapis):
    for op, gpath, kw in _queries(masapis["root"]):
        q = urllib.parse.urlencode({op: "", **{k: str(v)
                                               for k, v in kw.items()}})
        status, ctype, body = _both(masapis, gpath, q)
        assert status == 200 and ctype == "application/json; charset=utf-8"
        assert json.loads(body) == getattr(masapis["tstore"], op)(
            gpath, **kw)
    # the query value wins over the form's; an empty one falls through
    root = masapis["root"]
    _both(masapis, root, "timestamps&time=", form={
        "time": "2020-01-10T00:00:00.000Z"})
    _both(masapis, root, "intersects&metadata=&srs=EPSG:4326&wkt=",
          form={"metadata": "gdal", "wkt": "POLYGON((147 -36,150 -36,"
                "150 -33,147 -33,147 -36))"})


def test_masapi_post_wkt_equals_reference(masapis):
    big = ", ".join(f"{147.0 + 3.0 * k / 4000} -36.0" for k in range(4000))
    wkt = f"POLYGON(({big}, 150.0 -33.0, 147.0 -33.0, 147.0 -36.0))"
    status, _, body = _both(masapis, masapis["root"], "intersects",
                            form={"srs": "EPSG:4326", "wkt": wkt,
                                  "metadata": "gdal"})
    assert status == 200 and len(json.loads(body)["gdal"]) == 6


@pytest.mark.parametrize("query", [
    "", "nothing=1", "intersects&time=yesterday", "intersects&nseg=x",
    "timestamps&until=soon", "intersects&srs=EPSG:99999&wkt=POINT(1%202)"])
def test_masapi_errors_equal_reference(masapis, query):
    status, ctype, body = _both(masapis, masapis["root"], query)
    assert status == 400 and "error" in json.loads(body)


def test_masapi_generation_invalidates(masapis, archive):
    root = masapis["root"]
    q = "timestamps&time=2000-01-01T00:00:00.000Z"
    first = _both(masapis, root, q)
    _both(masapis, root, q)
    hits = masapis["cache"].hits
    assert hits >= 1
    extra = copy.deepcopy(archive["jrecs"][0])
    extra["filename"] = extra["filename"].replace("2020001", "2021001")
    for ds in extra["geo_metadata"]:
        ds["timestamps"] = ["2021-01-01T00:00:00.000Z"]
    masapis["jstore"].ingest(copy.deepcopy(extra))
    masapis["tstore"].ingest(copy.deepcopy(extra))
    second = _both(masapis, root, q)
    assert second != first
    assert "2021-01-01T00:00:00.000Z" in json.loads(second[2])["timestamps"]
    assert masapis["cache"].hits == hits


def test_masapi_shared_cache_promotion(archive, tmp_path):
    path = str(tmp_path / "shared.sqlite")
    jstore = JMASStore()
    jstore.ingest_many(copy.deepcopy(archive["jrecs"]))
    tstore = carry.store_from_reference(archive["jrecs"])
    q = urllib.parse.urlencode({"intersects": "", "metadata": "gdal",
                                "srs": "EPSG:4326", "wkt": WKT})
    bodies = []
    for mk_store, mk_app, mk_cache, Server in (
            (lambda: jstore, japi.build_app, japi.SharedResponseCache,
             RefServer),
            (lambda: tstore, tapi.build_app, tapi.SharedResponseCache,
             PortServer)):
        shared = mk_cache(path + Server.__name__)
        srv = Server(mk_app(mk_store(), shared_cache=shared))
        bodies.append(fetch(srv.port, archive["root"], q))
        srv.close()
        # a second masapi with an empty LRU answers from the shared file
        lru, shared2 = (japi if Server is RefServer else tapi
                        ).MasQueryCache(), mk_cache(path + Server.__name__)
        srv = Server(mk_app(mk_store(), cache=lru, shared_cache=shared2))
        bodies.append(fetch(srv.port, archive["root"], q))
        bodies.append(fetch(srv.port, archive["root"], q))
        srv.close()
        assert (shared2.hits, lru.hits, lru.misses) == (1, 1, 1)
    assert len(set(bodies)) == 1 and bodies[0][0] == 200


def test_masapi_shared_cache_from_the_environment(archive, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("GSKY_MAS_SHARED_CACHE", str(tmp_path / "env.db"))
    api = tapi.build_app(MASStore())
    assert api.shared_cache.path == str(tmp_path / "env.db")


def test_masapi_main_serves(archive, tmp_path):
    """``python -m gsky_tpu_torch.index.api``: ingest a crawl file and
    answer over HTTP."""
    import subprocess
    crawl = tmp_path / "crawl.tsv"
    crawl.write_text("".join(f"{r['filename']}\tgdal\t{json.dumps(r)}\n"
                             for r in archive["trecs"]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsky_tpu_torch.index.api", "-host",
         "127.0.0.1", "-port", "0", "-ingest", str(crawl)],
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        line = proc.stdout.readline()
        assert line.startswith("masapi listening on 127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])
        status, _, body = fetch(port, archive["root"], "extents")
        store = carry.store_from_reference(archive["trecs"])
        assert status == 200 and json.loads(body) == \
            store.extents(archive["root"])
    finally:
        proc.terminate()
        proc.wait(TIMEOUT)


# ---------------------------------------------------------------------------
# the MAS client over HTTP
# ---------------------------------------------------------------------------

def test_client_over_http_equals_in_process(masapis):
    root = masapis["root"]
    wkt = "POLYGON((147 -36,150 -36,150 -33,147 -33,147 -36))"
    inproc = MASClient(masapis["tstore"])
    for port in (masapis["port"], masapis["ref"]):
        http = MASClient(f"127.0.0.1:{port}", timeout=TIMEOUT)
        for gp in (root, f"{root}/landsat"):
            kw = dict(srs="EPSG:4326", wkt=wkt)
            assert http.intersects(gp, **kw) == inproc.intersects(gp, **kw)
            assert http.intersects(gp, namespaces="B5", **kw) == \
                inproc.intersects(gp, namespaces="B5", **kw)
            assert http.timestamps(gp) == inproc.timestamps(gp)
            assert http.extents(gp) == inproc.extents(gp)
            assert http.file_list(gp, srs="EPSG:4326", wkt=wkt) == \
                inproc.file_list(gp, srs="EPSG:4326", wkt=wkt)
        assert http.requests == 10
    # the JAX client sees the port's masapi as the reference's
    jc = JMASClient(f"127.0.0.1:{masapis['port']}", timeout=TIMEOUT)
    assert [d.file_path for d in jc.intersects(root, srs="EPSG:4326",
                                               wkt=wkt)] == \
        [d.file_path for d in inproc.intersects(root, srs="EPSG:4326",
                                                wkt=wkt)]


class FlakyStore:
    """A store whose first ``fails`` queries raise (a 500 from masapi)."""

    def __init__(self, store, fails):
        self.store = store
        self.fails = fails
        self.generation = 0

    def intersects(self, *a, **kw):
        if self.fails > 0:
            self.fails -= 1
            raise RuntimeError("database is locked")
        return self.store.intersects(*a, **kw)


def test_client_retries_5xx_not_4xx(archive):
    store = FlakyStore(carry.store_from_reference(archive["jrecs"]), 2)
    srv = PortServer(tapi.build_app(store))
    try:
        c = MASClient(f"127.0.0.1:{srv.port}", timeout=TIMEOUT)
        got = c.intersects(archive["root"], srs="EPSG:4326", wkt=WKT)
        assert c.requests == 3 and len(got) >= 1
        with pytest.raises(RuntimeError,
                           match="MAS error: cannot parse time"):
            c.intersects(archive["root"], time="yesterday")
        assert c.requests == 4
        store.fails = 3
        with pytest.raises(Exception, match="mas unavailable after 3"):
            c.intersects(archive["root"])
        assert c.requests == 7
    finally:
        srv.close()
        reset_breakers()


# ---------------------------------------------------------------------------
# the resilience pieces the client and the range sources use
# ---------------------------------------------------------------------------

def test_retry_delays_and_outcomes_equal_reference():
    import random
    from gsky_tpu.resilience import retry as jretry
    from gsky_tpu_torch.resilience import retry as tretry
    for kw in ({}, {"max_attempts": 5, "base_delay": 0.05, "jitter": 0.0},
               {"max_attempts": 4, "max_delay": 0.15}):
        assert list(tretry.RetryPolicy(**kw).delays(random.Random(3))) == \
            list(jretry.RetryPolicy(**kw).delays(random.Random(3)))

    class Answered(Exception):
        retryable = False

    def script(errors):
        it = iter(errors)

        def fn():
            e = next(it)
            if e is not None:
                raise e
            return "ok"
        return fn

    for errors in ([OSError("reset"), TimeoutError("slow"), None],
                   [Answered("400")], [ConnectionError("x")] * 3):
        out = []
        for mod in (tretry, jretry):
            slept = []
            try:
                got = mod.call_with_retry(
                    script(list(errors)), mod.RetryPolicy(), site="t",
                    sleep=slept.append, rng=random.Random(1))
            except Exception as e:
                got = (type(e).__name__, str(e))
            out.append((got, slept))
        assert out[0] == out[1]


def test_breaker_transitions_equal_reference():
    from gsky_tpu.resilience.breaker import CircuitBreaker as JBreaker
    from gsky_tpu_torch.resilience import BreakerOpen, CircuitBreaker
    now = [0.0]
    t = CircuitBreaker("t", failure_threshold=2, reset_timeout=10.0,
                       clock=lambda: now[0])
    j = JBreaker("j", failure_threshold=2, reset_timeout=10.0,
                 clock=lambda: now[0], register=False)
    steps = ["allow", "fail", "allow", "fail", "allow", "tick", "allow",
             "allow", "fail", "allow", "tick", "allow", "ok", "allow"]
    for step in steps:
        got = []
        for b in (t, j):
            if step == "allow":
                got.append(b.allow())
            elif step == "fail":
                b.record_failure()
            elif step == "ok":
                b.record_success()
            got.append(b.state)
        if step == "tick":
            now[0] += 10.0
        assert got[:len(got) // 2] == got[len(got) // 2:], step
    assert isinstance(t.open_error(), BreakerOpen)


def test_clamp_timeout():
    from gsky_tpu_torch.resilience import (DeadlineExceeded, clamp_timeout,
                                           deadline_scope)
    assert clamp_timeout(60.0) == 60.0
    with deadline_scope(5.0):
        assert 0.0 < clamp_timeout(60.0) <= 5.0
        assert clamp_timeout(1.0) == 1.0
    with deadline_scope(-1.0):
        with pytest.raises(DeadlineExceeded):
            clamp_timeout(60.0)
    assert clamp_timeout(None) is None
