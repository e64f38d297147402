"""Port parity, WCS: the port's GetCoverage (`server/ows.py`, the staged
export engine `pipeline/export.py`, `pipeline/extent.py`, the GeoTIFF
and NetCDF bodies) against the JAX package's on one config.json over
one seeded archive.

The archive: `fixtures.make_archive` (two UTM-55S granules and a
NetCDF stack), the two-CRS collection of `test_torch_server` and the
masked set of `test_torch_mosaic`; each package's crawler indexes it
into its own MAS store.  The reference runs with waves and the render
batcher off, Pallas in interpret mode (its B4 run with
``interpret=True``), no serving gateway, through `aiohttp.test_utils`;
the port with ``device="cpu"`` and no serving gateway through its
handler.  Exports are about 200 x 150 pixels in 64 x 64 tiles, so the
edge tiles are ragged.

Bounds: status and content type equal; decoded values bit-exact for
nearest, within 2 ulp for bilinear and cubic, nodata (-9999) at the
same pixels; the executor's leg counts (``paged_engaged``,
``paged_declined``) equal over an export.  Every HTTP wait has a
timeout."""

import asyncio
import json
import os
import re
import urllib.request
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from gsky_tpu.geo.crs import parse_crs as jparse_crs
from gsky_tpu.geo.transform import BBox as JBBox
from gsky_tpu.geo.transform import split_bbox as jsplit_bbox
from gsky_tpu.geo.transform import suggest_output_size as jsuggest
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.geo.transform import transform_bbox as jtransform_bbox
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.geotiff import GeoTIFF as JGeoTIFF
from gsky_tpu.io.netcdf import NetCDF as JNetCDF
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import scene_cache as jscene_cache
from gsky_tpu.pipeline import tile as jtile
from gsky_tpu.pipeline.extent import \
    compute_reprojection_extent as jcompute_extent
from gsky_tpu.pipeline.types import GeoTileRequest as JGeoTileRequest
from gsky_tpu.server import ows as jows
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher
from gsky_tpu.server.metrics import MetricsLogger as JMetricsLogger
from gsky_tpu.server.ows import OWSServer as JOWSServer
from gsky_tpu.server.params import parse_wcs as jparse_wcs

from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.transform import BBox, GeoTransform, split_bbox, \
    suggest_output_size
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.geotiff import GeoTIFFWriter
from gsky_tpu_torch.pipeline.extent import compute_reprojection_extent
from gsky_tpu_torch.pipeline.scene_cache import SceneCache
from gsky_tpu_torch.pipeline.types import GeoTileRequest
from gsky_tpu_torch.server import ows
from gsky_tpu_torch.server.config import ConfigWatcher
from gsky_tpu_torch.server.ows import OWSServer
from gsky_tpu_torch.server.params import OWSError, parse_wcs

from fixtures import make_archive
from test_torch_mosaic import CLOUD_SHADOW
from test_torch_mosaic import _write_archive as write_masked_archive
from test_torch_server import DRILL_VRT, _write_multi

MERC, UTM55 = "EPSG:3857", "EPSG:32755"
HOST = "gsky.example"
METHODS = ("near", "bilinear", "cubic")
T_DATA = "2020-01-10T00:00:00.000Z,2020-01-12T00:00:00.000Z"
T_MULTI = "2020-01-14T00:00:00.000Z,2020-01-18T00:00:00.000Z"
T_MASK = "2020-01-01T00:00:00.000Z,2020-03-01T00:00:00.000Z"
T_NC = "2020-01-11T00:00:00.000Z"
NODATA = -9999.0
TIMEOUT = 120          # seconds any HTTP wait may take


def _merc_box(x, y, w_m, h_m, crs=UTM55):
    """An EPSG:3857 box w_m x h_m (metres) east and south of the point
    (x, y) of ``crs``."""
    c = jtransform_bbox(JBBox(x, y, x + 1.0, y + 1.0), jparse_crs(crs),
                        jparse_crs(MERC))
    return (c.xmin, c.ymin - h_m, c.xmin + w_m, c.ymin)


# 200 x 150 pixels at ~37 m (30 m on the ground): 4 x 3 tiles of 64,
# the last column 8 wide and the last row 22 high
EXPORT = _merc_box(596000.0, 6102000.0, 7400.0, 5550.0)
SIZE = (200, 150)
MULTI = _merc_box(599000.0, 6099500.0, 5600.0, 4200.0)
MASKED = _merc_box(592000.0, 6103000.0, 7400.0, 5550.0)
NC_BOX = (16480000.0, -4205000.0, 16530000.0, -4168000.0)


def _bbox(box):
    return ",".join(repr(float(v)) for v in box)


def _styles(band):
    return [{"name": m, "title": m, "rgb_products": [band], "resample": m}
            for m in METHODS]


def _config(root):
    data, multi = f"{root}/data", f"{root}/multi"
    bands, qa = f"{root}/mask/bands", f"{root}/mask/qa"
    small = {"wcs_max_tile_width": 64, "wcs_max_tile_height": 64}
    return {
        "service_config": {"ows_hostname": HOST, "mas_address": "inproc"},
        "layers": [
            dict(name="cov", title="Landsat B4", data_source=data,
                 rgb_products=["B4"], time_generator="mas",
                 styles=_styles("B4"),
                 default_geo_bbox=[148.0, -35.3, 148.25, -35.1], **small),
            dict(name="cov_stream", data_source=data, rgb_products=["B4"],
                 time_generator="mas", styles=_styles("B4"),
                 wcs_max_tile_width=256, wcs_max_tile_height=256),
            dict(name="cov_multi", data_source=multi, rgb_products=["B4"],
                 time_generator="mas", styles=_styles("B4"), **small),
            dict(name="cov_masked", data_source=bands,
                 rgb_products=["LC08_B4"], resample="bilinear",
                 time_generator="mas",
                 mask={"id": "pixel_qa", "data_source": qa,
                       "bit_tests": CLOUD_SHADOW}, **small),
            dict(name="cov_nc", data_source=data,
                 rgb_products=["phot_veg", "bare_soil",
                               "total = phot_veg + bare_soil"],
                 time_generator="mas", resample="bilinear", **small),
            dict(name="cov_fusion", rgb_products=["B4"],
                 input_layers=[
                     {"name": "in_data", "data_source": data,
                      "rgb_products": ["B4"]},
                     {"name": "in_multi", "data_source": multi,
                      "rgb_products": ["B4"]}], **small),
            dict(name="cov_small", data_source=data, rgb_products=["B4"],
                 time_generator="mas", wcs_max_width=100,
                 wcs_max_height=100, **small),
            dict(name="cov_hidden", data_source=data, rgb_products=["B4"],
                 disable_services=["wcs"]),
            # DAP4: a default size of 100 x 130 is 2 x 3 tiles of 64
            dict(name="dap_nc", data_source=data,
                 rgb_products=["phot_veg"], time_generator="mas",
                 default_geo_bbox=[147.5, -36.5, 149.5, -34.5],
                 default_geo_size=[100, 130], **small),
            dict(name="dap_off", data_source=data,
                 rgb_products=["phot_veg"], time_generator="mas",
                 disable_services=["dap4"]),
        ],
        "processes": [
            {"identifier": "fc_drill", "title": "Fractional cover",
             "abstract": "Mean fractional cover over a polygon",
             "max_area": 5.0,
             "data_sources": [{"data_source": data,
                               "rgb_products": ["phot_veg", "bare_soil"]}],
             "approx": False,
             "literal_data": [{"identifier": "start_datetime",
                               "title": "Start"}],
             "complex_data": [{"identifier": "geometry",
                               "title": "Geometry"}]},
            {"identifier": "fc_deciles", "drill_algo": "deciles",
             "approx": False, "year_step": 1,
             "data_sources": [{"data_source": data,
                               "rgb_products": ["phot_veg"]}]},
            {"identifier": "vrt_drill",
             "data_sources": [{"data_source": data,
                               "rgb_products": ["phot_veg"],
                               "vrt_url": "drill.vrt"}]},
        ],
    }


class _JaxClient:
    """The reference server behind one aiohttp test client on its own
    event loop; every request waits at most TIMEOUT seconds."""

    def __init__(self, server):
        from aiohttp.test_utils import TestClient, TestServer
        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(server.app()), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def request(self, url, data=None):
        async def go():
            if data is None:
                resp = await self.client.get(url)
            else:
                resp = await self.client.post(url, data=data)
            return resp.status, resp.content_type, await resp.read()
        return self.loop.run_until_complete(
            asyncio.wait_for(go(), TIMEOUT))

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


@pytest.fixture(scope="module")
def wenv(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = str(tmp_path_factory.mktemp("wcs"))
    for key, v in (("GSKY_TILE_PIPELINE", "0"), ("GSKY_WAVES", "0"),
                   ("GSKY_RENDER_BATCH", "0"), ("GSKY_PALLAS", "interpret"),
                   ("GSKY_KERNEL_LEDGER", f"{root}/ledger.jsonl")):
        mp.setenv(key, v)
    mp.setattr(jpt, "_FAILED", set())
    b4 = jpt.mosaic_first_valid_pallas

    def b4_interpret(stack, valid, interpret=False):
        return b4(stack, valid, interpret=True)

    mp.setattr(jpt, "mosaic_first_valid_pallas", b4_interpret)
    jpages.reset_default_pool()

    arch = make_archive(f"{root}/data", scenes=2, size=512)
    for d in ("multi", "mask/bands", "mask/qa", "tmp", "tmp_port",
              "conf/cluster"):
        os.makedirs(f"{root}/{d}")
    paths = [(p, "B4" if p.endswith(".tif") else None)
             for p in arch["paths"]]
    paths += _write_multi(f"{root}/multi")
    paths += write_masked_archive(f"{root}/mask")
    jstore, tstore = JMASStore(), MASStore()
    for p, ns in paths:
        for ex, st in ((jextract, jstore), (extract, tstore)):
            rec = ex(p)
            assert not rec.get("error"), rec
            for ds in rec["geo_metadata"]:
                ds["namespace"] = ns or ds["namespace"]
            st.ingest(rec)
    conf = f"{root}/conf"
    with open(f"{conf}/config.json", "w") as fp:
        json.dump(_config(root), fp)
    with open(f"{conf}/drill.vrt", "w") as fp:
        fp.write(DRILL_VRT)
    cluster = _config(root)
    cluster["service_config"]["ows_cluster_nodes"] = ["127.0.0.1:1",
                                                     "127.0.0.1:2"]
    with open(f"{conf}/cluster/config.json", "w") as fp:
        json.dump(cluster, fp)

    jmas, tmas = JMASClient(jstore), MASClient(tstore)
    jserver = JOWSServer(
        JConfigWatcher(conf, mas_factory=lambda a: jmas,
                       install_signal=False),
        mas_factory=lambda a: jmas, metrics=JMetricsLogger(),
        gateway=None, fabric=None, temp_dir=f"{root}/tmp")
    tserver = OWSServer(ConfigWatcher(conf, mas_factory=lambda a: tmas,
                                      install_signal=False),
                        mas_factory=lambda a: tmas, device="cpu",
                        temp_dir=f"{root}/tmp_port", gateway=None)
    client = _JaxClient(jserver)
    yield {"root": root, "jax": client, "jserver": jserver,
           "port": tserver, "jmas": jmas, "tmas": tmas, "conf": conf}
    client.close()
    jpages.reset_default_pool()
    mp.undo()


def port_get(wenv, url, body=None):
    """The port's answer through its handler: (status, type, body)."""
    u = urlsplit(url)
    r = wenv["port"].handle(u.path, parse_qs(u.query,
                                             keep_blank_values=True),
                            HOST, body)
    return r.status, r.content_type, r.read()


def both(wenv, url, body=None):
    return wenv["jax"].request(url, body), port_get(wenv, url, body)


def _legs(server):
    """The (paged_engaged, paged_declined) of a server's executor: the
    port's own, the reference's process-wide default one."""
    ex = server.executor if isinstance(server, OWSServer) \
        else jtile.default_executor
    return ex.paged_engaged, ex.paged_declined


def both_legs(wenv, url):
    """`both`, and the leg counts each package's executor took."""
    j0 = _legs(wenv["jserver"])
    ref = wenv["jax"].request(url)
    j1 = _legs(wenv["jserver"])
    t0 = _legs(wenv["port"])
    got = port_get(wenv, url)
    t1 = _legs(wenv["port"])
    return ref, got, tuple(b - a for a, b in zip(j0, j1)), \
        tuple(b - a for a, b in zip(t0, t1))


def getcoverage(layer, box, *, style="", time=T_DATA, size=SIZE,
                fmt="GeoTIFF", crs=MERC, ns=""):
    w, h = size
    q = (f"service=WCS&request=GetCoverage&version=1.0.0&coverage={layer}"
         f"&crs={crs}&bbox={_bbox(box)}&width={w}&height={h}"
         f"&format={fmt}")
    if style:
        q += f"&styles={style}"
    if time:
        q += f"&time={time}"
    return f"/ows{'/' + ns if ns else ''}?{q}"


def read_tiff(wenv, body):
    """Every band of a GeoTIFF body, (bands, H, W) float32, read by the
    reference's reader."""
    path = f"{wenv['root']}/tmp/body.tif"
    with open(path, "wb") as fp:
        fp.write(body)
    t = JGeoTIFF(path)
    try:
        return np.stack([np.asarray(t.read(b + 1), np.float32)
                         for b in range(t.count)]), t.gt.to_gdal()
    finally:
        t.close()


def read_nc(wenv, body, names):
    path = f"{wenv['root']}/tmp/body.nc"
    with open(path, "wb") as fp:
        fp.write(body)
    nc = JNetCDF(path)
    try:
        return {n: np.asarray(nc.read_slice(n, None), np.float32)
                for n in names}
    finally:
        nc.close()


def assert_close(ref, got, exact, what=""):
    """Nodata at the same pixels; elsewhere bit-exact, or within 2 ulp
    of float32."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    nd = ref == NODATA
    assert np.array_equal(nd, got == NODATA), \
        (what, int(np.count_nonzero(nd != (got == NODATA))))
    if exact:
        assert np.array_equal(ref, got), \
            (what, int(np.count_nonzero(ref != got)))
    else:
        tol = 2 * np.spacing(np.maximum(np.abs(ref), np.abs(got)))
        bad = np.abs(ref - got) > tol
        assert not bad.any(), (what, int(bad.sum()),
                               float(np.abs(ref - got).max()))


def _same_status(ref, got, ctype):
    assert got[:2] == ref[:2], (got[:2], ref[:2], got[2][:300], ref[2][:300])
    assert ref[:2] == (200, ctype), ref[2][:400]


def _code(body):
    m = re.search(rb'exceptionCode="([^"]*)"', body)
    return m.group(1).decode() if m else ""


# ---------------------------------------------------------------------------
# tile maths and auto-size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(200, 150, 64, 64), (1024, 1024, 256, 256),
                                  (5, 7, 64, 64), (4096, 4096, 1024, 1024),
                                  (1000, 333, 300, 128)])
def test_split_bbox(dims):
    w, h, tw, th = dims
    box = (16478548.0, -4211230.0, 16489679.0, -4198025.0)
    want = jsplit_bbox(JBBox(*box), w, h, tw, th)
    got = split_bbox(BBox(*box), w, h, tw, th)

    def flat(ts):
        return [(t[0].xmin, t[0].ymin, t[0].xmax, t[0].ymax) + tuple(t[1:])
                for t in ts]

    assert flat(got) == flat(want)
    assert sum(t[3] * t[4] for t in got) == w * h


@pytest.mark.parametrize("case", [
    ((590000.0, 30.0, 0.0, 6105000.0, 0.0, -30.0), 512, 512, UTM55, MERC),
    ((590000.0, 30.0, 0.0, 6105000.0, 0.0, -30.0), 7681, 7821, UTM55,
     "EPSG:4326"),
    ((147.5, 0.015625, 0.0, -34.5, 0.0, -0.015625), 128, 128, "EPSG:4326",
     MERC),
    ((147.5, 0.015625, 0.0, -34.5, 0.0, -0.015625), 128, 128, "EPSG:4326",
     UTM55),
])
def test_suggest_output_size(case):
    g, w, h, src, dst = case
    rb, rw, rh = jsuggest(JGT.from_gdal(g), w, h, jparse_crs(src),
                          jparse_crs(dst))
    gb, gw, gh = suggest_output_size(GeoTransform.from_gdal(g), w, h,
                                     parse_crs(src), parse_crs(dst))
    assert (gw, gh) == (rw, rh)
    assert (gb.xmin, gb.ymin, gb.xmax, gb.ymax) == \
        (rb.xmin, rb.ymin, rb.xmax, rb.ymax)


@pytest.mark.parametrize("case", [
    ("B4", EXPORT, MERC, T_DATA), ("B4", (148.1, -35.25, 148.2, -35.15),
                                   "EPSG:4326", T_DATA),
    ("phot_veg", NC_BOX, MERC, T_NC), ("B4", (0.0, 0.0, 1.0, 1.0),
                                       MERC, T_DATA),
])
def test_compute_reprojection_extent(wenv, case):
    band, box, crs, t = case
    from gsky_tpu.index.store import parse_time as jparse_time
    kw = dict(collection=f"{wenv['root']}/data", bands=[band],
              width=0, height=0, start_time=jparse_time(t.split(",")[0]),
              polygon_segments=10)
    want = jcompute_extent(wenv["jmas"], JGeoTileRequest(
        bbox=JBBox(*box), crs=jparse_crs(crs), **kw))
    got = compute_reprojection_extent(wenv["tmas"], GeoTileRequest(
        bbox=BBox(*box), crs=parse_crs(crs), **kw))
    assert got == want
    assert (got[0] > 0) == (box[0] != 0.0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

WCS_QUERIES = [
    {"request": "GetCoverage", "coverage": "cov,other", "crs": MERC,
     "bbox": "1,2,3,4", "width": "200", "height": "150.0",
     "format": "NetCDF", "time": "2020-01-11T00:00:00.000Z,"
                                 "2020-01-10T00:00:00.000Z"},
    {"request": "GetCoverage", "coverageid": "cov", "srs": "EPSG:4326",
     "bbox": "148,-35.3,148.2,-35.1", "styles": "near",
     "subset": "time(1,2);wavelength(3)"},
    {"request": "GetCoverage", "identifier": "cov", "version": "",
     "subset": "band(,5)"},
    {"request": "DescribeCoverage"},
    {"request": "GetCoverage", "bbox": "1,2,3,4"},
    {"request": "GetCoverage", "crs": "EPSG:999999"},
    {"request": "GetCoverage", "crs": MERC, "bbox": "4,3,2,1"},
    {"request": "GetCoverage", "width": "wide"},
    {"request": "GetCoverage", "subset": "nonsense"},
    {"request": "GetCoverage", "subset": "time(a,b)"},
]


def _wcs_fields(p):
    return (p.request, p.version, p.coverages, p.styles,
            None if p.crs is None else p.crs.name(),
            None if p.bbox is None else (p.bbox.xmin, p.bbox.ymin,
                                         p.bbox.xmax, p.bbox.ymax),
            p.width, p.height, p.format, p.times, p.axes, p.axis_idx,
            p.bands_override)


@pytest.mark.parametrize("i", range(len(WCS_QUERIES)))
def test_parse_wcs(i):
    q = WCS_QUERIES[i]
    try:
        want = ("ok", _wcs_fields(jparse_wcs(dict(q))))
    except Exception as e:           # the reference's OWSError
        want = ("error", str(e), getattr(e, "code", ""))
    try:
        got = ("ok", _wcs_fields(parse_wcs(dict(q))))
    except OWSError as e:
        got = ("error", str(e), e.code)
    assert got == want


# ---------------------------------------------------------------------------
# GetCoverage bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_geotiff_export(wenv, method):
    """A 12-tile export through both packages' engines: the same legs,
    the same values."""
    ref, got, jlegs, tlegs = both_legs(
        wenv, getcoverage("cov", EXPORT, style=method))
    _same_status(ref, got, "image/geotiff")
    a, agt = read_tiff(wenv, ref[2])
    b, bgt = read_tiff(wenv, got[2])
    assert bgt == agt
    assert a.shape == (1, SIZE[1], SIZE[0])
    assert_close(a, b, method == "near", method)
    assert (a != NODATA).mean() > 0.5
    assert tlegs == jlegs and tlegs[0] > 0, (tlegs, jlegs)
    stats = wenv["port"].last_export
    assert stats["tiles"] == 12 and stats["index_queries"] == 1
    assert stats["paged_engaged"] == tlegs[0]
    assert stats["paged_declined"] == tlegs[1]
    assert stats["scenes_warmed"] == 2 and stats["dedup_saved"] > 0


def test_engine_equals_the_serial_leg(wenv, monkeypatch):
    """GSKY_EXPORT_PIPELINE=0 renders tile by tile through the modular
    route; the engine's coverage is the same to the bit, over the same
    legs, and the reference's serial leg agrees."""
    url = getcoverage("cov", EXPORT, style="cubic")
    engine = port_get(wenv, url)
    monkeypatch.setenv("GSKY_EXPORT_PIPELINE", "0")
    ref, serial, jlegs, tlegs = both_legs(wenv, url)
    a, _ = read_tiff(wenv, engine[2])
    b, _ = read_tiff(wenv, serial[2])
    assert np.array_equal(a, b)
    assert_close(read_tiff(wenv, ref[2])[0], b, False)
    assert tlegs == jlegs


@pytest.mark.parametrize("method", METHODS)
def test_multi_crs_export(wenv, method):
    """Tiles over two source CRSs: B2 per group, then the combine."""
    ref, got, jlegs, tlegs = both_legs(
        wenv, getcoverage("cov_multi", MULTI, style=method, time=T_MULTI,
                          size=(150, 110)))
    _same_status(ref, got, "image/geotiff")
    a, _ = read_tiff(wenv, ref[2])
    b, _ = read_tiff(wenv, got[2])
    assert_close(a, b, method == "near", method)
    assert (a != NODATA).mean() > 0.5
    assert tlegs == jlegs


def test_uncacheable_scenes_take_memo_windows(wenv, monkeypatch):
    """Scene caches that take no scene: the engine decodes each source's
    window over the whole export once and warps it per tile (B2)."""
    port = wenv["port"]
    monkeypatch.setattr(jscene_cache, "default_scene_cache",
                        jscene_cache.SceneCache(max_scene_px=1))
    monkeypatch.setattr(port.executor, "cache",
                        SceneCache(max_scene_px=1, device="cpu"))
    for method in ("near", "bilinear"):
        ref, got = both(wenv, getcoverage("cov", EXPORT, style=method))
        _same_status(ref, got, "image/geotiff")
        assert_close(read_tiff(wenv, ref[2])[0], read_tiff(wenv, got[2])[0],
                     method == "near", method)
        st = port.last_export
        assert st["scenes_uncacheable"] == 2 and st["windows_decoded"] == 2


def test_masked_export(wenv, monkeypatch):
    """A layer with a mask band goes through the masked route in both
    engines: one B4 mosaic a tile with data."""
    from gsky_tpu_torch.ops import first_valid
    calls = []
    real = first_valid.mosaic_first_valid_kernel

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(first_valid, "mosaic_first_valid_kernel", counted)
    ref, got = both(wenv, getcoverage("cov_masked", MASKED, time=T_MASK))
    _same_status(ref, got, "image/geotiff")
    a, _ = read_tiff(wenv, ref[2])
    b, _ = read_tiff(wenv, got[2])
    assert_close(a, b, False)
    assert 0.5 < (a != NODATA).mean() < 1.0     # the collar is out
    assert len(calls) == 12


def test_netcdf_export(wenv):
    """Three bands of a NetCDF stack, one of them an expression, as a
    NetCDF body."""
    ref, got = both(wenv, getcoverage("cov_nc", NC_BOX, time=T_NC,
                                      fmt="NetCDF", size=(160, 120)))
    _same_status(ref, got, "application/x-netcdf")
    names = ["phot_veg", "bare_soil", "total"]
    a, b = read_nc(wenv, ref[2], names), read_nc(wenv, got[2], names)
    for n in names:
        assert_close(a[n], b[n], False, n)
        assert (a[n] != NODATA).mean() > 0.5


def test_netcdf_export_of_landsat(wenv):
    ref, got = both(wenv, getcoverage("cov", EXPORT, style="near",
                                      fmt="netcdf"))
    _same_status(ref, got, "application/x-netcdf")
    assert_close(read_nc(wenv, ref[2], ["B4"])["B4"],
                 read_nc(wenv, got[2], ["B4"])["B4"], True)


def test_fusion_layer_export(wenv):
    ref, got = both(wenv, getcoverage("cov_fusion", MULTI, time=T_MULTI,
                                      size=(150, 110)))
    _same_status(ref, got, "image/geotiff")
    assert_close(read_tiff(wenv, ref[2])[0], read_tiff(wenv, got[2])[0],
                 True)


def test_single_tile_export(wenv):
    ref, got, jlegs, tlegs = both_legs(
        wenv, getcoverage("cov", EXPORT, style="bilinear", size=(60, 45)))
    _same_status(ref, got, "image/geotiff")
    assert_close(read_tiff(wenv, ref[2])[0], read_tiff(wenv, got[2])[0],
                 False)
    assert tlegs == jlegs == (1, 0)


@pytest.mark.parametrize("method", ["near", "cubic"])
def test_streamed_geotiff(wenv, monkeypatch, method):
    """Past WCS_STREAM_PIXELS (a strict >) with 256-aligned tiles, the
    GeoTIFF streams its tiles to disk through `write_region`; at the
    threshold it is built in RAM.  Both bodies hold the reference's
    values, and no temp file is left."""
    w, h = 300, 260
    url = getcoverage("cov_stream", EXPORT, style=method, size=(w, h))
    monkeypatch.setattr(jows, "WCS_STREAM_PIXELS", w * h - 1)
    monkeypatch.setattr(ows, "WCS_STREAM_PIXELS", w * h - 1)
    writes = []
    real = GeoTIFFWriter.write_region

    def spy(self, x0, y0, data):
        writes.append((x0, y0) + data.shape)
        return real(self, x0, y0, data)

    monkeypatch.setattr(GeoTIFFWriter, "write_region", spy)
    ref, got = both(wenv, url)
    _same_status(ref, got, "image/geotiff")
    a, _ = read_tiff(wenv, ref[2])
    b, _ = read_tiff(wenv, got[2])
    assert_close(a, b, method == "near", method)
    assert sorted(writes) == [(0, 0, 1, 256, 256), (0, 256, 1, 4, 256),
                              (256, 0, 1, 256, 44), (256, 256, 1, 4, 44)]
    monkeypatch.setattr(ows, "WCS_STREAM_PIXELS", w * h)
    writes.clear()
    inram = port_get(wenv, url)
    assert not writes
    assert np.array_equal(read_tiff(wenv, inram[2])[0], b)
    left = [f for f in os.listdir(f"{wenv['root']}/tmp_port")
            if f.startswith("wcs_")]
    assert not left, left


def test_failed_export_unlinks_its_stream_file(wenv, monkeypatch):
    """A tile that fails fails the export: 500, and the partial stream
    file is closed and unlinked."""
    from gsky_tpu_torch.pipeline import export
    monkeypatch.setattr(ows, "WCS_STREAM_PIXELS", 1000)

    def boom(self, req, gs):
        raise RuntimeError("tile render failed")

    monkeypatch.setattr(export.ExportPipeline, "_render_tile", boom)
    status, _, body = port_get(wenv, getcoverage("cov_stream", EXPORT,
                                                 size=(300, 260)))
    assert status == 500 and b"tile render failed" in body
    assert not [f for f in os.listdir(f"{wenv['root']}/tmp_port")
                if f.startswith(("wcs_", "dap_"))]


def test_failed_body_write_unlinks_its_file(wenv, monkeypatch):
    """An in-RAM coverage whose body fails to write: 500, and the
    partial file is unlinked."""
    def broken(path, *a, **k):
        with open(path, "wb") as fp:
            fp.write(b"II*\0")
        raise OSError("disk full")

    monkeypatch.setattr(ows, "write_geotiff", broken)
    status, _, body = port_get(wenv, getcoverage("cov", EXPORT,
                                                 style="near"))
    assert status == 500 and b"disk full" in body
    assert not os.listdir(f"{wenv['root']}/tmp_port")


def test_auto_size(wenv):
    """width = height = 0: the size that keeps the source resolution."""
    box = _merc_box(596000.0, 6102000.0, 3000.0, 2000.0)
    ref, got = both(wenv, getcoverage("cov", box, style="near",
                                      size=(0, 0)))
    _same_status(ref, got, "image/geotiff")
    a, agt = read_tiff(wenv, ref[2])
    b, bgt = read_tiff(wenv, got[2])
    assert agt == bgt and a.shape == b.shape and a.shape[1] > 40
    assert_close(a, b, True)


def test_over_a_socket(wenv, monkeypatch):
    """GetCoverage over HTTP: an in-RAM body with its Content-Length, and
    a streamed GeoTIFF sent from its file, which is gone afterwards."""
    httpd = wenv["port"].serve("127.0.0.1", 0)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        url = getcoverage("cov", EXPORT, style="near")
        with urllib.request.urlopen(base + url, timeout=TIMEOUT) as r:
            assert r.headers["Content-Type"] == "image/geotiff"
            assert "attachment" in r.headers["Content-Disposition"]
            body = r.read()
            assert int(r.headers["Content-Length"]) == len(body)
        assert np.array_equal(read_tiff(wenv, body)[0],
                              read_tiff(wenv, port_get(wenv, url)[2])[0])
        monkeypatch.setattr(ows, "WCS_STREAM_PIXELS", 1000)
        url = getcoverage("cov_stream", EXPORT, style="near",
                          size=(300, 260))
        with urllib.request.urlopen(base + url, timeout=TIMEOUT) as r:
            streamed = r.read()
            assert int(r.headers["Content-Length"]) == len(streamed)
        ref = wenv["jax"].request(url)
        assert_close(read_tiff(wenv, ref[2])[0],
                     read_tiff(wenv, streamed)[0], True)
        assert not [f for f in os.listdir(f"{wenv['root']}/tmp_port")
                    if f.startswith("wcs_")]
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# documents and errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("req", ["GetCapabilities", "DescribeCoverage",
                                 "DescribeCoverage&coverage=cov,cov_nc"])
def test_wcs_documents(wenv, req):
    ref, got = both(wenv, f"/ows?service=WCS&request={req}")
    assert got == ref


WCS_ERRORS = {
    "unknown coverage": getcoverage("nope", EXPORT),
    "no coverage": f"/ows?service=WCS&request=GetCoverage&crs={MERC}"
                   f"&bbox={_bbox(EXPORT)}&width=10&height=10",
    "no bbox": "/ows?service=WCS&request=GetCoverage&coverage=cov"
               "&width=10&height=10",
    "oversize": getcoverage("cov_small", EXPORT),
    "bad format": getcoverage("cov", EXPORT, fmt="image/png"),
    "wcs disabled": getcoverage("cov_hidden", EXPORT),
    "unknown style": getcoverage("cov", EXPORT, style="sepia"),
    "describe unknown": "/ows?service=WCS&request=DescribeCoverage"
                        "&coverage=nope",
    "bad request": "/ows?service=WCS&request=GetSomething",
    "no data": getcoverage("cov", (0.0, 0.0, 1000.0, 1000.0), size=(0, 0)),
}


@pytest.mark.parametrize("case", sorted(WCS_ERRORS))
def test_wcs_errors(wenv, case):
    ref, got = both(wenv, WCS_ERRORS[case])
    assert got[:2] == ref[:2], (got, ref)
    assert ref[1] == "application/vnd.ogc.se_xml"
    assert _code(got[2]) == _code(ref[2])


def test_cluster_shards_answer_501(wenv):
    status, ctype, body = port_get(wenv, getcoverage("cov", EXPORT,
                                                     ns="cluster"))
    assert (status, ctype) == (501, "application/vnd.ogc.se_xml")
    assert _code(body) == "OperationNotSupported"
    assert b"ROADMAP A.10" in body
    # the namespace's other requests are served
    status, _, _ = port_get(wenv, "/ows/cluster?service=WCS"
                                  "&request=GetCapabilities")
    assert status == 200


@pytest.fixture
def waves_on(monkeypatch):
    """Both packages with waves (and the planner) on: the engine
    co-submits neighbouring tiles; schedulers shut down afterwards."""
    from gsky_tpu.pipeline import waves as jwaves
    from gsky_tpu_torch.pipeline import waves as twaves
    monkeypatch.setenv("GSKY_WAVES", "1")
    jwaves.reset_waves()
    twaves.reset_waves()
    yield twaves
    jwaves.reset_waves()
    twaves.reset_waves()


@pytest.mark.parametrize("method", ["near", "bilinear"])
def test_export_with_waves(wenv, waves_on, monkeypatch, method):
    """Waves on: a paged tile is a wave lane whose result comes back on
    the host, taken there by the encode stage; the tiles that share a
    source go in batches of GSKY_EXPORT_COSUBMIT (4).  The coverage is
    the reference's, and the one the per-call path gives."""
    url = getcoverage("cov", EXPORT, style=method)
    ref, got, jlegs, tlegs = both_legs(wenv, url)
    _same_status(ref, got, "image/geotiff")
    b, _ = read_tiff(wenv, got[2])
    assert_close(read_tiff(wenv, ref[2])[0], b, method == "near", method)
    assert tlegs == jlegs
    st = wenv["port"].last_export
    assert st["plan_batches"] >= 1 and st["plan_batched_tiles"] > 1
    assert waves_on.wave_stats()["cpu"]["requests"] == tlegs[0]
    monkeypatch.setenv("GSKY_WAVES", "0")
    percall = port_get(wenv, url)
    assert np.array_equal(read_tiff(wenv, percall[2])[0], b)
