"""Port parity, the OWS front end: the port's `OWSServer` against the JAX
package's on the same config.json over the same seeded archive.

The archive: `fixtures.make_archive` (two UTM-55S granules and a NetCDF
stack), two UTM-55S and two UTM-56S granules in a second collection
(every tile over it is a two-group, two-CRS mosaic), the masked set of
`test_torch_mosaic` (LC08_B4, LC08_B5 and pixel_qa over three dates)
and the Sentinel-2-shaped set of `test_torch_rgb` (B02, B03 and B04 of
two overlapping tiles).  Each package's crawler indexes it into its own
MAS store.

The reference runs its serial GetMap ladder (GSKY_TILE_PIPELINE=0),
waves and the render batcher off, Pallas in interpret mode (its B4
wrapped to run with ``interpret=True``, as `test_torch_mosaic` does), a
hermetic kernel ledger and no serving gateway, through
`aiohttp.test_utils`.  The port runs with ``device="cpu"`` and no
serving gateway (each test counts its renders) through its handler,
and once over a real socket.

Bounds: status and content type equal; decoded RGBA identical for
nearest, the placeholder, the empty tile and the palette; at most 0.1%
of decoded bytes differ for bilinear, cubic, NDVI and band algebra;
exception bodies carry the same ``exceptionCode``.  Requests the port
cannot serve yet get 501 naming their ROADMAP item."""

import asyncio
import json
import os
import re
import urllib.error
import urllib.request
from urllib.parse import parse_qs, quote, urlsplit
from xml.etree import ElementTree

import numpy as np
import pytest
import torch

from gsky_tpu.geo.crs import parse_crs as jparse_crs
from gsky_tpu.geo.transform import BBox as JBBox
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.geo.transform import transform_bbox as jtransform_bbox
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.geotiff import write_geotiff as jwrite_geotiff
from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import scene_cache as jscene_cache
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher
from gsky_tpu.server.metrics import MetricsLogger as JMetricsLogger
from gsky_tpu.server.ows import OWSServer as JOWSServer

from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.png import decode_png, encode_png
from gsky_tpu_torch.pipeline.scene_cache import SceneCache
from gsky_tpu_torch.server.config import ConfigWatcher
from gsky_tpu_torch.server.ows import OWSServer

from fixtures import make_archive
from test_torch_mosaic import CLOUD_SHADOW
from test_torch_mosaic import _write_archive as write_masked_archive
from test_torch_rgb import INSIDE as S2_INSIDE
from test_torch_rgb import OVERLAP_BOX as S2_OVERLAP
from test_torch_rgb import _write_archive as write_s2_archive

UTM55, UTM56, MERC = "EPSG:32755", "EPSG:32756", "EPSG:3857"
HOST = "gsky.example"
NDVI = "ndvi=(LC08_B5-LC08_B4)/(LC08_B5+LC08_B4)"
# TIME ranges (start inclusive, end exclusive) over the data
# collection's two dates, the two-CRS collection's four, both, and the
# masked set's three
T_DATA = "2020-01-10T00:00:00.000Z,2020-01-12T00:00:00.000Z"
T_MULTI = "2020-01-14T00:00:00.000Z,2020-01-18T00:00:00.000Z"
T_ALL = "2020-01-10T00:00:00.000Z,2020-01-18T00:00:00.000Z"
T_MASK = "2020-01-01T00:00:00.000Z,2020-03-01T00:00:00.000Z"
METHODS = ("near", "bilinear", "cubic")


def _styles(band):
    return [{"name": m, "title": m, "rgb_products": [band], "resample": m}
            for m in METHODS]


def _write_multi(root):
    """Two UTM-55S granules and two UTM-56S granules, one namespace, over
    the data collection's overlap: every tile there mosaics two source
    CRSs."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:400, 0:400].astype(np.float32)
    u55, u56 = jparse_crs(UTM55), jparse_crs(UTM56)
    # the UTM-56S origins: the UTM-55S ones carried across the zone line
    ox, oy = u55.transform_to(u56, np.array([597000.0, 599000.0]),
                              np.array([6101000.0, 6099500.0]))
    out = []
    for i, (crs, x0, y0) in enumerate([
            (u55, 596000.0, 6100500.0), (u55, 599000.0, 6098000.0),
            (u56, float(ox[0]), float(oy[0])),
            (u56, float(ox[1]), float(oy[1]))]):
        field = 1500 + 900 * np.sin(xx / (17 + 4 * i)) * np.cos(yy / 23)
        data = (field + rng.normal(0, 50, field.shape)).astype(np.int16)
        data[(xx + yy) < 60] = -999
        p = os.path.join(root, f"B4_202001{14 + i:02d}_{crs.epsg}.tif")
        jwrite_geotiff(p, data, JGT(x0, 30.0, 0.0, y0, 0.0, -30.0), crs,
                       nodata=-999)
        out.append((p, "B4"))
    return out


def _box(x, y, size, crs=UTM55):
    """An EPSG:3857 box of ``size`` metres from the point (x, y) east
    and south."""
    c = jtransform_bbox(JBBox(x, y, x + 1.0, y + 1.0), jparse_crs(crs),
                        jparse_crs(MERC))
    return (c.xmin, c.ymin - size, c.xmin + size, c.ymin)


def _bbox(box):
    return ",".join(repr(float(v)) for v in box)


NATIVE = [_box(598500.0, 6100000.0, 3500.0),
          _box(600500.0, 6097000.0, 4000.0)]
MULTI = [_box(599500.0, 6099000.0, 3000.0),
         _box(601000.0, 6097500.0, 2500.0)]
MASKED = [_box(592000.0, 6103000.0, 7000.0)]
# over the newer data granule's nodata corner, which the older fills
CORNER = _box(597000.0, 6101800.0, 4000.0)
FAR = _box(300000.0, 6900000.0, 3000.0)


def _config(root, legend):
    data, multi = f"{root}/data", f"{root}/multi"
    bands, qa = f"{root}/mask/bands", f"{root}/mask/qa"
    s2 = f"{root}/s2"
    mask = {"id": "pixel_qa", "data_source": qa, "bit_tests": CLOUD_SHADOW}
    return {
        "service_config": {"ows_hostname": HOST, "mas_address": "inproc"},
        "layers": [
            {"name": "plain", "data_source": data, "rgb_products": ["B4"],
             "time_generator": "mas", "styles": _styles("B4"),
             "default_geo_bbox": [147.9, -35.5, 148.4, -35.0],
             "feature_info_max_dates": 5},
            {"name": "palette", "data_source": data, "rgb_products": ["B4"],
             "time_generator": "mas", "clip_value": 3000,
             "palette": {"interpolate": True, "colours": [
                 {"R": 0, "G": 0, "B": 128, "A": 255},
                 {"R": 40, "G": 200, "B": 40, "A": 200},
                 {"R": 255, "G": 255, "B": 0, "A": 255}]}},
            {"name": "multi", "data_source": multi, "rgb_products": ["B4"],
             "time_generator": "mas", "styles": _styles("B4")},
            {"name": "masked", "data_source": bands,
             "rgb_products": ["LC08_B4"], "resample": "bilinear",
             "time_generator": "mas", "mask": mask, "clip_value": 2000},
            {"name": "ndvi", "data_source": bands, "rgb_products": [NDVI],
             "resample": "bilinear", "time_generator": "mas",
             "mask": mask},
            {"name": "fusion", "rgb_products": ["B4"],
             "input_layers": [
                 {"name": "in_data", "data_source": data,
                  "rgb_products": ["B4"]},
                 {"name": "in_multi", "data_source": multi,
                  "rgb_products": ["B4"]}]},
            {"name": "indexed", "data_source": data, "rgb_products": ["B4"],
             "time_generator": "mas",
             "default_geo_bbox": [148.0, -35.3, 148.2, -35.1],
             "index_res_limit": 0.00005, "index_tile_x_size": 0.5,
             "index_tile_y_size": 0.25},
            {"name": "zoomed", "data_source": data, "rgb_products": ["B4"],
             "time_generator": "mas", "zoom_limit": 50.0,
             "overviews": [{"name": "zoomed_ov", "data_source": multi,
                            "rgb_products": ["B4"], "zoom_limit": 500.0}]},
            {"name": "placeholder", "data_source": data,
             "rgb_products": ["B4"], "time_generator": "mas",
             "zoom_limit": 50.0, "nodata_legend_path": legend},
            {"name": "hidden", "data_source": data, "rgb_products": ["B4"],
             "disable_services": ["wms"]},
            {"name": "rgb", "data_source": data,
             "rgb_products": ["B4", "B4", "B4"], "time_generator": "mas"},
            {"name": "algebra", "data_source": data,
             "rgb_products": ["twice=B4*2"], "time_generator": "mas"},
            {"name": "ndvi_fused", "data_source": bands,
             "rgb_products": [NDVI], "resample": "bilinear",
             "time_generator": "mas"},
            {"name": "truecolour", "data_source": s2,
             "rgb_products": ["B04", "B03", "B02"],
             "time_generator": "mas",
             "styles": [{"name": m, "title": m,
                         "rgb_products": ["B04", "B03", "B02"],
                         "resample": m} for m in METHODS] + [
                 {"name": "two", "title": "two",
                  "rgb_products": ["B04", "B03"]},
                 {"name": "four", "title": "four",
                  "rgb_products": ["B04", "B03", "B02", "B04"]},
                 {"name": "scaled", "title": "scaled",
                  "rgb_products": ["B04", "B03", "B02"],
                  "offset_value": -200.0, "clip_value": 2400.0}]},
            {"name": "phot_veg", "data_source": data,
             "rgb_products": ["phot_veg"], "time_generator": "mas"},
            # GetFeatureInfo reads other bands than the layer renders
            {"name": "info", "data_source": bands, "rgb_products": [NDVI],
             "resample": "bilinear", "time_generator": "mas",
             "feature_info_bands": ["LC08_B4", "LC08_B5"],
             "feature_info_max_dates": 2},
            {"name": "legend_file", "data_source": data,
             "rgb_products": ["B4"], "legend_path": legend},
        ],
    }


# a namespace of what the port cannot serve yet, remote workers and peer
# shards (ROADMAP A.10), beside a WPS process over a VRT, which it serves
UNPORTED_NS = "unported"

# the VRT template of the ``vrt_drill`` processes: a Python pixel
# function over the data granule, values under 20 set to nodata
DRILL_VRT = """<VRTDataset>
  <VRTRasterBand band="1" subClass="VRTDerivedRasterBand">
    <PixelFunctionType>threshold</PixelFunctionType>
    <PixelFunctionLanguage>python</PixelFunctionLanguage>
    <PixelFunctionCode><![CDATA[
def threshold(in_ar, out_ar, *args, **kwargs):
    v = in_ar[0]
    out_ar[:] = v
    out_ar[v < 20] = -1
]]></PixelFunctionCode>
    <SimpleSource metadata-template="1">
      <SourceFilename>{{ .Data.Path }}</SourceFilename>
    </SimpleSource>
  </VRTRasterBand>
</VRTDataset>"""


def _unported_config(root):
    data = f"{root}/data"
    return {
        "service_config": {
            "ows_hostname": HOST, "mas_address": "inproc",
            "worker_nodes": ["127.0.0.1:6000"],
            "ows_cluster_nodes": ["http://127.0.0.1:1", "http://127.0.0.1:2"]},
        "layers": [{"name": "plain", "data_source": data,
                    "rgb_products": ["B4"]}],
        "processes": [{"identifier": "vrt_drill",
                       "data_sources": [{"data_source": data,
                                         "rgb_products": ["phot_veg"],
                                         "vrt_url": "drill.vrt"}]}],
    }


class _JaxClient:
    """The reference server behind one aiohttp test client on its own
    event loop."""

    def __init__(self, server):
        from aiohttp.test_utils import TestClient, TestServer
        self.loop = asyncio.new_event_loop()
        self.client = TestClient(TestServer(server.app()), loop=self.loop)
        self.loop.run_until_complete(self.client.start_server())

    def get(self, url):
        async def go():
            resp = await self.client.get(url)
            return resp.status, resp.content_type, await resp.read()
        return self.loop.run_until_complete(go())

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = str(tmp_path_factory.mktemp("ows"))
    for env_key, v in (("GSKY_TILE_PIPELINE", "0"), ("GSKY_WAVES", "0"),
                       ("GSKY_RENDER_BATCH", "0"),
                       ("GSKY_PALLAS", "interpret"),
                       ("GSKY_KERNEL_LEDGER", f"{root}/ledger.jsonl")):
        mp.setenv(env_key, v)
    mp.setattr(jpt, "_FAILED", set())
    b4 = jpt.mosaic_first_valid_pallas
    b4_calls = []

    def b4_interpret(stack, valid, interpret=False):
        b4_calls.append(tuple(stack.shape))
        return b4(stack, valid, interpret=True)

    mp.setattr(jpt, "mosaic_first_valid_pallas", b4_interpret)
    jpages.reset_default_pool()

    arch = make_archive(f"{root}/data", scenes=2, size=512)
    os.makedirs(f"{root}/multi")
    os.makedirs(f"{root}/mask/bands")
    os.makedirs(f"{root}/mask/qa")
    os.makedirs(f"{root}/s2")
    paths = [(p, "B4" if p.endswith(".tif") else None)
             for p in arch["paths"]]
    paths += _write_multi(f"{root}/multi")
    paths += write_masked_archive(f"{root}/mask")
    paths += write_s2_archive(f"{root}/s2")
    jstore, tstore = JMASStore(), MASStore()
    for p, ns in paths:
        for ex, st in ((jextract, jstore), (extract, tstore)):
            rec = ex(p)
            assert not rec.get("error"), rec
            for ds in rec["geo_metadata"]:
                ds["namespace"] = ns or ds["namespace"]
            st.ingest(rec)
    legend = f"{root}/legend.png"
    tile = np.zeros((24, 40), np.uint8)
    tile[4:20, 6:34] = np.arange(28, dtype=np.uint8)[None] * 9
    with open(legend, "wb") as fp:
        fp.write(encode_png([tile]))
    conf = f"{root}/conf"
    os.makedirs(f"{conf}/sub")
    for d in (conf, f"{conf}/sub"):
        with open(f"{d}/config.json", "w") as fp:
            json.dump(_config(root, legend), fp)
    os.makedirs(f"{conf}/{UNPORTED_NS}")
    with open(f"{conf}/{UNPORTED_NS}/config.json", "w") as fp:
        json.dump(_unported_config(root), fp)
    with open(f"{conf}/{UNPORTED_NS}/drill.vrt", "w") as fp:
        fp.write(DRILL_VRT)

    jmas, tmas = JMASClient(jstore), MASClient(tstore)
    jserver = JOWSServer(
        JConfigWatcher(conf, mas_factory=lambda a: jmas,
                       install_signal=False),
        mas_factory=lambda a: jmas, metrics=JMetricsLogger(),
        gateway=None, fabric=None)
    tserver = OWSServer(ConfigWatcher(conf, mas_factory=lambda a: tmas,
                                      install_signal=False),
                        mas_factory=lambda a: tmas, device="cpu",
                        gateway=None)
    client = _JaxClient(jserver)
    yield {"root": root, "jax": client, "port": tserver,
           "b4_calls": b4_calls, "conf": conf, "tmas": tmas,
           "jax_mas": jmas}
    client.close()
    # the worker client of the unported namespace: its fleet router
    # leaves the process-wide registry
    tserver.close()
    jpages.reset_default_pool()
    mp.undo()


@pytest.fixture
def wrappers(monkeypatch):
    """Calls of the port's kernel wrappers while the test runs (on the
    CPU each runs its kernel's plain version): B1, B2, B4."""
    from gsky_tpu_torch.ops import first_valid, paged, warp_render
    calls = {"B1": 0, "B2": 0, "B4": 0}
    for key, mod, name in (("B1", paged, "paged_render_scored"),
                           ("B2", warp_render, "warp_render_scored"),
                           ("B4", first_valid,
                            "mosaic_first_valid_kernel")):
        def counted(*a, _f=getattr(mod, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _getmap(layer, box, *, style="", time=None, size=(96, 80),
            crs=MERC, version="1.3.0", fmt="image/png", ns=""):
    h, w = size
    q = (f"service=WMS&request=GetMap&version={version}&layers={layer}"
         f"&styles={style}&{'crs' if version == '1.3.0' else 'srs'}={crs}"
         f"&bbox={_bbox(box)}&width={w}&height={h}&format={fmt}")
    if time:
        q += f"&time={time}"
    return f"/ows{'/' + ns if ns else ''}?{q}"


def _both(env, url):
    """(reference (status, type, body), port (status, type, body))."""
    ref = env["jax"].get(url)
    u = urlsplit(url)
    r = env["port"].handle(u.path, parse_qs(u.query,
                                            keep_blank_values=True), HOST)
    return ref, (r.status, r.content_type, r.body)


def _same_tile(ref, got, exact, what=""):
    assert got[:2] == ref[:2], (what, got[:2], ref[:2], got[2][:300])
    assert ref[:2] == (200, "image/png"), (what, ref[2][:300])
    a, b = jdecode_png(ref[2]), decode_png(got[2])
    assert a.shape == b.shape
    diff = int(np.count_nonzero(a != b))
    if exact:
        assert diff == 0, (what, diff)
    else:
        assert diff <= a.size // 1000, (what, diff, a.size)
    return a


def _code(body):
    m = re.search(rb'exceptionCode="([^"]*)"', body)
    return m.group(1).decode() if m else ""


# ---------------------------------------------------------------------------
# GetMap parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_plain_layer(env, wrappers, method):
    for box in NATIVE:
        ref, got = _both(env, _getmap("plain", box, style=method,
                                      time=T_DATA))
        img = _same_tile(ref, got, method == "near", method)
        assert (img[..., 3] > 0).mean() > 0.5      # mostly data
    # the fused ladder: one B1 launch a tile
    assert wrappers == {"B1": len(NATIVE), "B2": 0, "B4": 0}


def test_palette(env):
    ref, got = _both(env, _getmap("palette", NATIVE[0], time=T_DATA))
    img = _same_tile(ref, got, True)
    # the palette's colours, not the grey ramp
    assert (img[..., 2] != img[..., 0]).any()


def test_no_time_serves_the_newest_date(env):
    """The layer's dates come from the MAS ?timestamps op; a GetMap
    without TIME renders the newest, 2020-01-17."""
    ref, got = _both(env, _getmap("multi", MULTI[0], style="near"))
    newest = _same_tile(ref, got, True)
    assert newest[..., 3].any()
    _, last = _both(env, _getmap("multi", MULTI[0], style="near",
                                 time="2020-01-17T00:00:00.000Z"))
    assert np.array_equal(decode_png(last[2]), newest)
    _, first = _both(env, _getmap("multi", MULTI[0], style="near",
                                  time="2020-01-14T00:00:00.000Z"))
    assert not np.array_equal(decode_png(first[2]), newest)


def test_wms_111_axis_order(env):
    """EPSG:4326: 1.1.1 takes lon,lat; 1.3.0 lat,lon.  Both packages
    read both orders alike, and the two orders give one tile."""
    ll = (148.10, -35.22, 148.14, -35.19)
    ref, got = _both(env, _getmap("plain", ll, style="near", time=T_DATA,
                                  crs="EPSG:4326", version="1.1.1"))
    a = _same_tile(ref, got, True)
    latlon = (ll[1], ll[0], ll[3], ll[2])
    ref, got = _both(env, _getmap("plain", latlon, style="near",
                                  time=T_DATA, crs="EPSG:4326"))
    assert np.array_equal(_same_tile(ref, got, True), a)


def test_zoom_limit_overview_and_placeholder(env):
    far_out = _box(595000.0, 6103000.0, 12000.0)   # ~170 m a pixel
    ref, got = _both(env, _getmap("zoomed", far_out, time=T_ALL))
    ov = _same_tile(ref, got, True, "overview")
    # the overview layer renders the two-CRS collection
    _, multi = _both(env, _getmap("multi", far_out, style="near",
                                  time=T_ALL))
    assert np.array_equal(decode_png(multi[2]), ov)
    ref, got = _both(env, _getmap("placeholder", far_out, size=(100, 90)))
    img = _same_tile(ref, got, True, "placeholder")
    assert img[4, 6, 3] == 255 and img[24 + 4, 40 + 6, 3] == 255


@pytest.mark.parametrize("method", METHODS)
def test_multi_crs_layer(env, wrappers, method):
    for box in MULTI:
        ref, got = _both(env, _getmap("multi", box, style=method,
                                      time=T_MULTI))
        img = _same_tile(ref, got, method == "near", method)
        assert (img[..., 3] > 0).mean() > 0.5
    # the fused ladder declines (two groups); `_render_fused` warps each
    # source-CRS group through B2
    assert wrappers == {"B1": 0, "B2": 2 * len(MULTI), "B4": 0}


def test_uncacheable_scenes_take_the_window_leg(env, wrappers,
                                                monkeypatch):
    """Scene caches that take no scene: both packages decline the fused
    route and the cached-scene leg, and warp the decoded windows, one B2
    launch per source CRS."""
    from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
    port = env["port"]
    monkeypatch.setattr(jscene_cache, "default_scene_cache",
                        jscene_cache.SceneCache(max_scene_px=1))
    monkeypatch.setattr(port.executor, "cache",
                        SceneCache(max_scene_px=1, device="cpu"))
    legs = []
    for ex in (JWarpExecutor, type(port.executor)):
        def spy(self, *a, _f=ex.warp_mosaic, **k):
            legs.append(type(self).__module__.split(".")[0])
            return _f(self, *a, **k)
        monkeypatch.setattr(ex, "warp_mosaic", spy)
    for layer, box, time in (("plain", CORNER, T_DATA),
                             ("multi", MULTI[0], T_MULTI)):
        ref, got = _both(env, _getmap(layer, box, style="near", time=time))
        img = _same_tile(ref, got, True, layer)
        assert (img[..., 3] > 0).mean() > 0.5
    ref, got = _both(env, _getmap("plain", CORNER, style="bilinear",
                                  time=T_DATA))
    _same_tile(ref, got, False)
    assert legs == ["gsky_tpu", "gsky_tpu_torch"] * 3
    assert wrappers == {"B1": 0, "B2": 1 + 2 + 1, "B4": 0}


@pytest.mark.parametrize("layer", ["masked", "ndvi"])
def test_masked_layers(env, wrappers, layer):
    calls = env["b4_calls"]
    n0 = len(calls)
    ref, got = _both(env, _getmap(layer, MASKED[0], time=T_MASK))
    img = _same_tile(ref, got, False, layer)
    assert (img[..., 3] > 0).mean() > 0.3      # clouds and shadows masked
    # both packages mosaic each namespace through B4
    assert len(calls) - n0 == wrappers["B4"] == (1 if layer == "masked"
                                                 else 2)
    assert wrappers["B1"] == wrappers["B2"] == 0


def test_netcdf_layer(env, wrappers):
    """A NetCDF-3 variable's timestep is a cached scene on both sides
    (read at a power-of-two stride when zoomed out)."""
    for ll in ((147.8, -35.3, 148.3, -34.9), (147.5, -36.5, 149.5, -34.5)):
        box = jtransform_bbox(JBBox(*ll), jparse_crs("EPSG:4326"),
                              jparse_crs(MERC))
        ref, got = _both(env, _getmap(
            "phot_veg", (box.xmin, box.ymin, box.xmax, box.ymax),
            time="2020-01-11T00:00:00.000Z", size=(64, 64)))
        img = _same_tile(ref, got, True)
        assert (img[..., 3] > 0).mean() > 0.5
    assert wrappers["B1"] + wrappers["B2"] == 2


def test_fusion_layer(env, wrappers):
    """Two input layers through `process`, composed first-valid: the
    data collection's tile (B1), then the two-CRS one's (B2 a group)."""
    for box in (NATIVE[0], MULTI[0]):
        ref, got = _both(env, _getmap("fusion", box, time=T_ALL))
        img = _same_tile(ref, got, True)
        assert (img[..., 3] > 0).mean() > 0.5
    assert wrappers == {"B1": 2, "B2": 4, "B4": 0}


# the Sentinel-2-shaped collection: a box inside one tile (one granule
# per band: the RGBA rung) and one over the two tiles' overlap (six
# granules: the planes rung, one B2 launch)
S2_BOXES = {"rgba": S2_INSIDE, "planes": S2_OVERLAP}


@pytest.mark.parametrize("method", METHODS)
def test_rgb_layer(env, wrappers, method):
    for rung, box in S2_BOXES.items():
        ref, got = _both(env, _getmap("truecolour", box, style=method,
                                      time=T_DATA))
        img = _same_tile(ref, got, method == "near", rung)
        assert (img[..., 3] > 0).mean() > 0.5
        assert (img[..., 0] != img[..., 1]).any()   # colour, not grey
    # the RGBA rung runs plain torch ops; the planes rung one B2 launch
    assert wrappers == {"B1": 0, "B2": 1, "B4": 0}


@pytest.mark.parametrize("style", ["two", "four", "scaled"])
def test_rgb_layer_band_counts_and_fixed_scaling(env, wrappers, style):
    for rung, box in S2_BOXES.items():
        ref, got = _both(env, _getmap("truecolour", box, style=style,
                                      time=T_DATA))
        if style == "two":
            # both PNG encoders refuse two bands: a 500 from both, after
            # the planes rung rendered them
            assert got[:2] == ref[:2] == (500,
                                          "application/vnd.ogc.se_xml")
            assert b"cannot encode 2 bands" in got[2]
            continue
        _same_tile(ref, got, True, (style, rung))
    # two and four bands: the planes rung over both boxes
    assert wrappers["B2"] == (1 if style == "scaled" else 2)


def test_one_namespace_rgb_style(env, wrappers):
    """``B4, B4, B4`` over two granules of one namespace: the planes
    rung selects it three times (a grey tile)."""
    ref, got = _both(env, _getmap("rgb", NATIVE[0], time=T_DATA))
    img = _same_tile(ref, got, True)
    assert (img[..., 0] == img[..., 1]).all() and img[..., 3].any()
    assert wrappers == {"B1": 0, "B2": 1, "B4": 0}


@pytest.fixture
def expr_stats():
    """Both packages' fused band-algebra counters, zeroed."""
    from gsky_tpu.ops import paged as jpaged
    from gsky_tpu_torch.ops import paged as tpaged
    jpaged.reset_expr_fused_stats()
    tpaged.reset_expr_fused_stats()
    return lambda: (jpaged.expr_fused_stats(), tpaged.expr_fused_stats())


ALGEBRA = {"algebra": (NATIVE[0], T_DATA), "ndvi_fused": (MASKED[0], T_MASK)}


@pytest.mark.parametrize("layer", sorted(ALGEBRA))
def test_band_algebra_layer(env, wrappers, expr_stats, layer):
    """An expression layer without a mask band: fused band algebra, one
    B1 launch at the expression's slot count in both packages."""
    box, time = ALGEBRA[layer]
    ref, got = _both(env, _getmap(layer, box, time=time))
    img = _same_tile(ref, got, layer == "algebra", layer)
    assert (img[..., 3] > 0).mean() > 0.3
    assert wrappers == {"B1": 1, "B2": 0, "B4": 0}
    jst, tst = expr_stats()
    assert tst == jst == {"programs": 1, "paths": {"percall": 1}}


def test_band_algebra_escape_hatch(env, wrappers, expr_stats, monkeypatch):
    """GSKY_EXPR_FUSE=0: both packages take the modular route (B1 for the
    per-namespace mosaic, then the interpreter): the same tile."""
    url = _getmap("ndvi_fused", MASKED[0], time=T_MASK)
    _, fused = _both(env, url)
    monkeypatch.setenv("GSKY_EXPR_FUSE", "0")
    ref, got = _both(env, url)
    _same_tile(ref, got, False)
    assert np.array_equal(decode_png(got[2]), decode_png(fused[2]))
    jst, tst = expr_stats()
    assert tst["paths"] == jst["paths"] == {"percall": 1, "unfused": 1}


def test_index_res_limit_layer(env):
    box = _box(594000.0, 6102000.0, 9000.0)
    ref, got = _both(env, _getmap("indexed", box, time=T_DATA))
    a = _same_tile(ref, got, True)
    _, whole = _both(env, _getmap("plain", box, style="near", time=T_DATA))
    assert np.array_equal(decode_png(whole[2]), a)


def test_index_subdivision_matches_the_reference(env):
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    from gsky_tpu.pipeline.types import GeoTileRequest as JRequest
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.tile import TilePipeline
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    box = _box(594000.0, 6102000.0, 9000.0)
    kw = dict(bands=["B4"], width=96, height=80, index_res_limit=0.00005,
              index_tile_x_size=0.5, index_tile_y_size=0.25,
              spatial_extent=(148.0, -35.3, 148.2, -35.1))
    jreq = JRequest(collection="x", bbox=JBBox(*box),
                    crs=jparse_crs(MERC), **kw)
    treq = GeoTileRequest(collection="x", bbox=BBox(*box),
                          crs=parse_crs(MERC), **kw)
    subs = TilePipeline._index_subdivision(treq)
    assert len(subs) == 8
    assert subs == JTilePipeline._index_subdivision(None, jreq)
    got = TilePipeline(env["tmas"], device="cpu").index(
        GeoTileRequest(collection=f"{env['root']}/data", bbox=BBox(*box),
                       crs=parse_crs(MERC), **kw))
    assert len(got) == 2


def test_empty_tile(env):
    ref, got = _both(env, _getmap("plain", FAR, style="near", time=T_DATA))
    img = _same_tile(ref, got, True)
    assert not img[..., 3].any()


def test_staged_reference_path_equals_the_port(env, monkeypatch):
    """The reference's default GetMap path (GSKY_TILE_PIPELINE=1, the
    staged pipeline) claims its serial ladder's bytes; hold it against
    the port."""
    monkeypatch.setenv("GSKY_TILE_PIPELINE", "1")
    ref, got = _both(env, _getmap("plain", NATIVE[0], style="near",
                                  time=T_DATA))
    _same_tile(ref, got, True)


def test_over_a_socket(env):
    httpd = env["port"].serve("127.0.0.1", 0)
    try:
        port = httpd.server_address[1]
        url = _getmap("plain", NATIVE[0], style="near", time=T_DATA)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}") as r:
            status, ctype, body = r.status, r.headers["Content-Type"], \
                r.read()
        ref = env["jax"].get(url)
        _same_tile(ref, (status, ctype, body), True)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}"
                                   + _getmap("nope", NATIVE[0]))
        assert e.value.code == 400
        assert _code(e.value.read()) == "LayerNotDefined"
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# errors and documents
# ---------------------------------------------------------------------------

ERRORS = {
    "missing layer": _getmap("nope", NATIVE[0]),
    "oversize": _getmap("plain", NATIVE[0], size=(600, 256)),
    "missing bbox": "/ows?service=WMS&request=GetMap&layers=plain"
                    "&crs=EPSG:3857&width=64&height=64",
    "no layers": f"/ows?service=WMS&request=GetMap&crs=EPSG:3857"
                 f"&bbox={_bbox(NATIVE[0])}&width=64&height=64",
    "wms disabled": _getmap("hidden", NATIVE[0]),
    "unknown namespace": _getmap("plain", NATIVE[0], ns="nope"),
    "unknown style": _getmap("plain", NATIVE[0], style="sepia"),
    "bad version": "/ows?service=WMS&request=GetMap&version=1.2.0",
    "bad crs": _getmap("plain", NATIVE[0], crs="EPSG:999999"),
    "not ogc": "/ows?foo=bar",
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_reference_errors(env, case):
    ref, got = _both(env, ERRORS[case])
    assert got[:2] == ref[:2], (got, ref)
    assert ref[1] == "application/vnd.ogc.se_xml"
    assert _code(got[2]) == _code(ref[2])


def test_capabilities(env):
    for ns in ("", "sub"):
        url = f"/ows{'/' + ns if ns else ''}?service=WMS" \
              f"&request=GetCapabilities"
        ref, got = _both(env, url)
        assert got[:2] == ref[:2] == (200, "text/xml")
        assert got[2] == ref[2]
        names = [e.text for e in ElementTree.fromstring(got[2]).iter(
            "{http://www.opengis.net/wms}Name")]
        assert "plain" in names and "hidden" not in names
        assert b"2020-01-10T00:00:00.000Z,2020-01-11T00:00:00.000Z" \
            in got[2]


# ---------------------------------------------------------------------------
# waves, the staged path and TIME animations
# ---------------------------------------------------------------------------

# frames at the data collection's two dates, then half a day after the
# second (no exact match: the nearest date, 2020-01-11)
T_FRAMES = ("2020-01-10T00:00:00.000Z,2020-01-11T00:00:00.000Z,"
            "2020-01-11T12:00:00.000Z")
FRAME_DATES = ("2020-01-10T00:00:00.000Z", "2020-01-11T00:00:00.000Z",
               "2020-01-11T00:00:00.000Z")
T_MASK_FRAMES = "2020-01-10T00:00:00.000Z,2020-02-11T00:00:00.000Z"


@pytest.fixture
def waves_on(monkeypatch):
    """Both packages with their default wave path and staged GetMap
    path; their schedulers shut down afterwards."""
    from gsky_tpu.pipeline import waves as jwaves
    from gsky_tpu_torch.pipeline import waves as twaves
    monkeypatch.setenv("GSKY_WAVES", "1")
    monkeypatch.setenv("GSKY_TILE_PIPELINE", "1")
    jwaves.reset_waves()
    twaves.reset_waves()
    yield twaves
    jwaves.reset_waves()
    twaves.reset_waves()


def _jax_get_headers(env, url):
    async def go():
        resp = await env["jax"].client.get(url)
        return (resp.status, resp.content_type, await resp.read(),
                dict(resp.headers))
    return env["jax"].loop.run_until_complete(go())


def _port_get(env, url):
    u = urlsplit(url)
    return env["port"].handle(u.path, parse_qs(u.query,
                                               keep_blank_values=True), HOST)


def _frames(body):
    from gsky_tpu_torch.io.png import apng_frames
    return [decode_png(f) for f in apng_frames(body)]


def _same_frames(a, b, exact):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        diff = int(np.count_nonzero(x != y))
        assert diff == 0 if exact else diff <= x.size // 1000, diff


@pytest.mark.parametrize("method", ["near", "bilinear"])
def test_animation_matches_reference(env, wrappers, waves_on, method):
    url = _getmap("plain", NATIVE[0], style=method, time=T_FRAMES,
                  fmt="image/apng")
    status, ctype, body, headers = _jax_get_headers(env, url)
    got = _port_get(env, url)
    assert (got.status, got.content_type) == (status, ctype) == \
        (200, "image/apng")
    assert got.headers["X-Gsky-Anim-Frames"] == \
        headers["X-Gsky-Anim-Frames"] == "3"
    ref_frames, frames = _frames(body), _frames(got.body)
    _same_frames(ref_frames, frames, method == "near")
    assert wrappers["B1"] >= 1 and wrappers["B2"] == 0
    st = waves_on.wave_stats()["cpu"]
    assert st["requests"] == 3 and st["failed"] == 0
    # each frame is the port's lone GetMap at the date it resolved to
    for f, date in zip(frames, FRAME_DATES):
        one = _port_get(env, _getmap("plain", NATIVE[0], style=method,
                                     time=date))
        assert np.array_equal(decode_png(one.body), f)
    assert (frames[1] == frames[2]).all()


def test_animation_container_equals_reference_for_same_frames(env):
    from gsky_tpu.io.png import encode_apng as jencode_apng
    from gsky_tpu_torch.io.png import encode_apng
    got = _port_get(env, _getmap("plain", NATIVE[0], style="near",
                                 time=T_DATA, fmt="image/apng"))
    from gsky_tpu_torch.io.png import apng_frames
    pngs = apng_frames(got.body)
    for delay in (500, 120):
        assert encode_apng(pngs, delay) == jencode_apng(pngs, delay)
    assert encode_apng(pngs) == got.body


def test_mp4_is_a_labelled_apng_stub(env, waves_on):
    url = _getmap("plain", NATIVE[0], style="near", time=T_FRAMES,
                  fmt="video/mp4")
    status, ctype, body, headers = _jax_get_headers(env, url)
    got = _port_get(env, url)
    assert (got.status, got.content_type) == (status, ctype)
    assert got.headers["X-Gsky-Anim-Container"] == \
        headers["X-Gsky-Anim-Container"] == "apng-stub"
    _same_frames(_frames(body), _frames(got.body), True)


def test_anim_off_serves_one_image(env, monkeypatch):
    monkeypatch.setenv("GSKY_ANIM", "0")
    ref, got = _both(env, _getmap("plain", NATIVE[0], style="near",
                                  time=T_DATA, fmt="image/apng"))
    assert ref[0] == got[0] == 200
    a, b = jdecode_png(ref[2]), decode_png(got[2])
    assert np.array_equal(a, b)


def test_masked_animation_takes_the_serial_leg(env, wrappers, waves_on):
    url = _getmap("masked", MASKED[0], time=T_MASK_FRAMES, fmt="image/apng")
    status, ctype, body, headers = _jax_get_headers(env, url)
    got = _port_get(env, url)
    assert (got.status, got.content_type) == (status, ctype) == \
        (200, "image/apng")
    assert got.headers["X-Gsky-Anim-Frames"] == \
        headers["X-Gsky-Anim-Frames"] == "2"
    _same_frames(_frames(body), _frames(got.body), False)
    assert wrappers["B4"] >= 2 and wrappers["B1"] == 0
    assert not waves_on.wave_stats()


def test_animation_frame_cap(env, monkeypatch, waves_on):
    monkeypatch.setenv("GSKY_ANIM_MAX_FRAMES", "2")
    url = _getmap("plain", NATIVE[0], style="near", time=T_FRAMES,
                  fmt="image/apng")
    status, _, body, headers = _jax_get_headers(env, url)
    got = _port_get(env, url)
    assert got.headers["X-Gsky-Anim-Frames"] == \
        headers["X-Gsky-Anim-Frames"] == "2"
    _same_frames(_frames(body), _frames(got.body), True)


@pytest.mark.parametrize("method", METHODS)
def test_staged_path_with_waves(env, wrappers, waves_on, method):
    """The default GetMap path of both packages (staged, waves on)."""
    for box in NATIVE:
        ref, got = _both(env, _getmap("plain", box, style=method,
                                      time=T_DATA))
        _same_tile(ref, got, method == "near", method)
    assert wrappers["B1"] == len(NATIVE)
    assert waves_on.wave_stats()["cpu"]["requests"] == len(NATIVE)


STAGED = {"rgba": ("truecolour", S2_INSIDE, T_DATA),
          "planes": ("truecolour", S2_OVERLAP, T_DATA),
          "four bands": ("truecolour", S2_OVERLAP, T_DATA),
          "algebra": ("algebra", NATIVE[0], T_DATA),
          "ndvi": ("ndvi_fused", MASKED[0], T_MASK)}


@pytest.mark.parametrize("case", sorted(STAGED))
def test_staged_path_with_waves_rgb_and_algebra(env, wrappers, waves_on,
                                                expr_stats, case):
    layer, box, time = STAGED[case]
    style = "four" if case == "four bands" else ""
    ref, got = _both(env, _getmap(layer, box, style=style, time=time))
    _same_tile(ref, got, case != "ndvi", case)
    jst, tst = expr_stats()
    if layer == "truecolour":
        assert wrappers["B2"] == (0 if case == "rgba" else 1)
        assert not waves_on.wave_stats() and tst == jst == \
            {"programs": 0, "paths": {}}
    else:
        # an expression tile is a lane of the wave: one B1 launch
        assert wrappers == {"B1": 1, "B2": 0, "B4": 0}
        assert waves_on.wave_stats()["cpu"]["requests"] == 1
        assert tst == jst == {"programs": 1, "paths": {"wave": 1}}


def test_rgb_animation_composites_its_bands(env, waves_on):
    """As the reference does, a multi-band style's animation frames go
    through the composite route, which composites the three namespaces
    into one plane: grey frames, unlike the lone RGB GetMap."""
    url = _getmap("truecolour", S2_INSIDE, style="near", time=T_FRAMES,
                  fmt="image/apng")
    status, ctype, body, headers = _jax_get_headers(env, url)
    got = _port_get(env, url)
    assert (got.status, got.content_type) == (status, ctype) == \
        (200, "image/apng")
    assert got.headers["X-Gsky-Anim-Frames"] == \
        headers["X-Gsky-Anim-Frames"] == "3"
    frames = _frames(got.body)
    _same_frames(_frames(body), frames, True)
    for f in frames:
        assert (f[..., 0] == f[..., 1]).all() and f[..., 3].any()
    lone = decode_png(_port_get(env, _getmap(
        "truecolour", S2_INSIDE, style="near", time=FRAME_DATES[0])).body)
    assert (lone[..., 0] != lone[..., 1]).any()


def test_band_algebra_animation_takes_the_serial_leg(env, wrappers,
                                                     waves_on, expr_stats):
    url = _getmap("algebra", NATIVE[0], time=T_FRAMES, fmt="image/apng")
    status, ctype, body, headers = _jax_get_headers(env, url)
    got = _port_get(env, url)
    assert (got.status, got.content_type) == (status, ctype) == \
        (200, "image/apng")
    assert got.headers["X-Gsky-Anim-Frames"] == \
        headers["X-Gsky-Anim-Frames"] == "3"
    frames = _frames(got.body)
    _same_frames(_frames(body), frames, True)
    # each frame through the modular route (the mosaic a wave lane), as
    # a lone GetMap at its date with the fused route off would render it
    assert wrappers["B1"] >= 1
    jst, tst = expr_stats()
    assert tst["paths"] == jst["paths"] == {}


def test_animation_over_a_socket(env, waves_on):
    httpd = env["port"].serve("127.0.0.1", 0)
    try:
        port = httpd.server_address[1]
        url = _getmap("plain", NATIVE[0], style="near", time=T_FRAMES,
                      fmt="image/apng")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}",
                                    timeout=60) as r:
            assert r.headers["Content-Type"] == "image/apng"
            assert r.headers["X-Gsky-Anim-Frames"] == "3"
            body = r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert len(_frames(body)) == 3


_POLY = ('{"type": "Polygon", "coordinates": [[[148.0, -35.4], '
         '[148.4, -35.4], [148.4, -35.1], [148.0, -35.4]]]}')
UNPORTED = {
    # served since the fleet slice (ROADMAP A.10's worker half, A.20's
    # core): the namespace's worker node refuses connections, so both
    # packages answer the backend's 503: item "503"
    "worker_nodes": (_getmap("plain", NATIVE[0], ns=UNPORTED_NS), "503"),
    "cluster shards": (
        f"/ows/{UNPORTED_NS}?service=WCS&request=GetCoverage"
        f"&coverage=plain&crs=EPSG:3857&bbox={_bbox(NATIVE[0])}"
        f"&width=64&height=64&format=GeoTIFF", "503"),
    # served since ROADMAP A.8's first half: item None
    "wps over a vrt": (
        f"/ows/{UNPORTED_NS}?service=WPS&request=Execute"
        f"&identifier=vrt_drill&datainputs="
        f"{quote('geometry=' + _POLY)}", None),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_requests_name_their_item(env, case):
    """The requests of the ``unported`` namespace: each one the port
    cannot serve answers 501 naming its ROADMAP item; the WPS process
    over a VRT in the same namespace is served, its document equal to
    the reference's; a GetMap and a GetCoverage through the namespace's
    ``worker_nodes``, whose node is down, answer the reference's 503
    ``ServerBusy`` with ``Retry-After``."""
    url, item = UNPORTED[case]
    u = urlsplit(url)
    r = env["port"].handle(u.path, parse_qs(u.query,
                                            keep_blank_values=True), HOST)
    if item == "503":
        ref = env["jax"].get(url)
        assert ref[:2] == (503, "application/vnd.ogc.se_xml"), ref[2][:300]
        assert (r.status, r.content_type) == ref[:2]
        assert _code(r.body) == _code(ref[2]) == "ServerBusy"
        assert b"backend unavailable" in r.body
        assert int(r.headers["Retry-After"]) >= 1
        return
    if item is None:
        ref = env["jax"].get(url)
        assert ref[:2] == (200, "text/xml"), ref[2][:300]
        assert (r.status, r.content_type) == ref[:2]
        # equal but for the status's creationTime, which is the clock's
        stamp = re.compile(rb'creationTime="[^"]*"')
        assert stamp.sub(b"", r.body) == stamp.sub(b"", ref[2])
        assert re.search(rb"\d{4}-\d{2}-\d{2},\d", r.body)
        return
    assert (r.status, r.content_type) == (501,
                                          "application/vnd.ogc.se_xml")
    assert _code(r.body) == "OperationNotSupported"
    assert f"ROADMAP {item}".encode() in r.body


def _crawl_file(env):
    """The data collection's crawler records as a JSON-lines file, the
    GeoTIFFs in namespace B4."""
    path = f"{env['root']}/crawl.jsonl"
    with open(path, "w") as fp:
        for name in sorted(os.listdir(f"{env['root']}/data")):
            rec = extract(f"{env['root']}/data/{name}")
            for ds in rec["geo_metadata"]:
                if name.endswith(".tif"):
                    ds["namespace"] = "B4"
            fp.write(json.dumps(rec) + "\n")
    return path


def test_server_defaults_to_cuda(env):
    from gsky_tpu_torch.server import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    watcher = ConfigWatcher(env["conf"], install_signal=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OWSServer(watcher)
    with pytest.raises(RuntimeError, match="CUDA"):
        main.main(["-conf", env["conf"], "-local_mas", _crawl_file(env),
                   "-port", "0"])
    assert main.main(["-conf", env["conf"], "-check_conf"]) == 0


def test_main_serves_getmap_on_the_cpu(env):
    """``python -m gsky_tpu_torch.server.main -device cpu``: it prints
    the prewarm line before it listens (the lattice cut to wave size 1
    and 32 x 32 tiles over 64 x 64 scenes, so that the plain versions'
    launches stay short on a loaded CPU), and a GetMap over HTTP equals
    the handler's answer."""
    import socket
    import subprocess
    import sys
    import threading
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsky_tpu_torch.server.main", "-device",
         "cpu", "-host", "127.0.0.1", "-port", str(port), "-conf",
         env["conf"], "-local_mas", _crawl_file(env)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, GSKY_PREWARM_WAVE_SIZES="1",
                            GSKY_PREWARM_SIZES="32",
                            GSKY_PREWARM_BUCKET="64"))
    watchdog = threading.Timer(120, proc.kill)   # a hang fails the test
    watchdog.start()
    try:
        lines = []
        while not lines or "listening" not in lines[-1]:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
        warm = [ln for ln in lines if ln.startswith("prewarm: ")]
        assert len(warm) == 1 and "(0 fresh compile(s))" in warm[0], lines
        url = _getmap("plain", NATIVE[0], style="near", time=T_DATA)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}",
                                    timeout=60) as r:
            body = r.read()
        _, want = _both(env, url)
        assert np.array_equal(decode_png(body), decode_png(want[2]))
    finally:
        watchdog.cancel()
        proc.terminate()
        proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# a compressed archive behind each package's masapi over HTTP
# ---------------------------------------------------------------------------

LZW_SIZE = (480, 520)
LZW_DOYS = ("010", "026", "042")          # 2020-01-10, -01-26, -02-11
T_LZW_OLD = "2020-01-01T00:00:00.000Z,2020-01-30T00:00:00.000Z"
T_LZW_NEW = "2020-02-01T00:00:00.000Z,2020-02-20T00:00:00.000Z"
T_LZW_ALL = "2020-01-01T00:00:00.000Z,2020-03-01T00:00:00.000Z"
LZW_TILES = [_box(593000.0 + 2500.0 * k, 6103000.0 - 1500.0 * k, 3000.0)
             for k in range(3)]
LZW_SMALL = [_box(596000.0 + 300.0 * k, 6100000.0 - 200.0 * k, 1500.0)
             for k in range(5)]
LZW_BANDS = {"B4": "LC08_B4", "B5": "LC08_B5", "pixel_qa": "pixel_qa"}


def _write_lzw_archive(root):
    """Three dates of LC08_B4, LC08_B5 (int16, nodata -999) and pixel_qa
    (uint16, fill 1, cloud and shadow blobs), LZW + predictor 2, named
    ``LC8<path><row><year><doy>LGN00_<band>.TIF`` so that the built-in
    ``landsat`` rule dates them."""
    from test_torch_codec import write_lzw_geotiff
    from test_torch_mosaic import CLEAR, CLOUD, SHADOW, QA_FILL, _blobs
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    rng = np.random.default_rng(61)
    H, W = LZW_SIZE
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    paths = []
    for i, doy in enumerate(LZW_DOYS):
        gt = GeoTransform(590000.0 + 450.0 * i, 30.0, 0.0,
                          6105000.0 - 300.0 * i, 0.0, -30.0)
        collar = (xx + yy) < 40 + 15 * i
        b4 = 800 + 600 * np.sin(xx / (29 + 3 * i)) * np.cos(yy / 37) \
            + rng.normal(0, 40, (H, W))
        b5 = 2600 + 900 * np.cos(xx / 41) * np.sin(yy / (23 + 2 * i)) \
            + rng.normal(0, 60, (H, W))
        qa = np.full((H, W), CLEAR, np.uint16)
        qa[_blobs(rng, 6, (H, W))] = CLOUD
        qa[_blobs(rng, 4, (H, W), 8, 20)] = SHADOW
        qa[collar] = QA_FILL
        for band, arr, nd in (("B4", b4.astype(np.int16), -999),
                              ("B5", b5.astype(np.int16), -999),
                              ("pixel_qa", qa, QA_FILL)):
            arr[collar] = nd
            sub = "qa" if band == "pixel_qa" else "bands"
            p = f"{root}/{sub}/LC80900852020{doy}LGN00_{band}.TIF"
            write_lzw_geotiff(p, arr, gt, parse_crs(UTM55), nodata=nd,
                              tile_size=128, overviews=(2, 4))
            paths.append(p)
    return paths


def _lzw_config(root, mas_address):
    bands, qa = f"{root}/lzw/bands", f"{root}/lzw/qa"
    mask = {"id": "pixel_qa", "data_source": qa, "bit_tests": CLOUD_SHADOW}
    return {
        "service_config": {"ows_hostname": HOST, "mas_address": mas_address,
                           "mas_timeout": 30},
        "layers": [
            {"name": "lzw", "data_source": bands,
             "rgb_products": ["LC08_B4"], "time_generator": "mas",
             "styles": _styles("LC08_B4")},
            {"name": "lzw_masked", "data_source": bands,
             "rgb_products": ["LC08_B4"], "resample": "bilinear",
             "time_generator": "mas", "mask": mask, "clip_value": 2000}],
        "processes": [
            {"identifier": "lzw_drill", "approx": False,
             "data_sources": [{"data_source": bands,
                               "rgb_products": ["LC08_B4"]}]}],
    }


@pytest.fixture(scope="module")
def lzw_env(env):
    """The port's masapi over a `MASShardedStore` (shards ``bands`` and
    ``qa``) and the reference's aiohttp masapi over its `MASStore`, the
    same crawler records in both; each package's `OWSServer` reaches its
    own over HTTP (a config ``mas_address``, no ``mas_factory``)."""
    from gsky_tpu.index import api as japi
    from gsky_tpu_torch.index import api as tapi
    from gsky_tpu_torch.index.sharded import MASShardedStore
    from test_torch_index import RefServer
    root = env["root"]
    os.makedirs(f"{root}/lzw/bands")
    os.makedirs(f"{root}/lzw/qa")
    paths = _write_lzw_archive(f"{root}/lzw")
    jstore, tstore = JMASStore(), MASShardedStore(f"{root}/lzw")
    for p in paths:
        jrec, trec = jextract(p), extract(p)
        assert trec == jrec and not trec.get("error")
        band = os.path.basename(p).split("LGN00_")[1][:-4]
        for rec in (jrec, trec):
            for ds in rec["geo_metadata"]:
                assert ds["timestamps"] == [
                    f"2020-01-{int(p.split('LGN00')[0][-2:]):02d}"
                    "T00:00:00.000Z"] or ds["timestamps"][0].startswith(
                        "2020-02-11")
                ds["namespace"] = LZW_BANDS[band]
        jstore.ingest(jrec)
        tstore.ingest(trec)
    tapi_ = tapi.MasAPI(tstore)
    port_mas = tapi_.serve("127.0.0.1", 0)
    ref_mas = RefServer(japi.build_app(jstore))
    confs = {}
    for side, port in (("jax", ref_mas.port),
                       ("port", port_mas.server_address[1])):
        confs[side] = f"{root}/lzw_conf_{side}"
        os.makedirs(confs[side])
        with open(f"{confs[side]}/config.json", "w") as fp:
            json.dump(_lzw_config(root, f"127.0.0.1:{port}"), fp)
    jserver = JOWSServer(JConfigWatcher(confs["jax"], install_signal=False),
                         metrics=JMetricsLogger(), gateway=None,
                         fabric=None)
    tserver = OWSServer(ConfigWatcher(confs["port"], install_signal=False),
                        device="cpu", gateway=None)
    client = _JaxClient(jserver)
    try:
        yield {"jax": client, "port": tserver, "masapi": tapi_,
               "paths": paths}
    finally:
        client.close()
        port_mas.shutdown()
        port_mas.server_close()
        ref_mas.close()


def _lzw_both(lzw_env, url):
    return _both({"jax": lzw_env["jax"], "port": lzw_env["port"]}, url)


def test_lzw_window_routed_tiles_over_http_mas(lzw_env, wrappers,
                                               monkeypatch):
    """Small tiles over the newest date, whose scene is not resident,
    stream through the ranged window path until the fourth decline of
    the scene promotes it: the same decisions as the reference's."""
    monkeypatch.setenv("GSKY_INGEST_WINDOW_FRAC", "0.05")
    jcache = jscene_cache.default_scene_cache
    tcache = lzw_env["port"].executor.cache
    j0, t0 = jcache.window_routed, tcache.window_routed
    for box in LZW_SMALL:
        ref, got = _lzw_both(lzw_env, _getmap("lzw", box, style="near",
                                              time=T_LZW_NEW))
        _same_tile(ref, got, True, "window-routed")
    # each tile asks the cache twice while the scene is not resident
    # (the one-dispatch composite, then `render`'s fused route): tile 1
    # is declined twice and renders on the modular route (the decoded
    # window warped by B2), tile 2 is declined once and the fourth ask
    # promotes the scene; from then on every tile is one B1 launch
    assert tcache.window_routed - t0 == jcache.window_routed - j0 == 3
    assert wrappers == {"B1": 4, "B2": 1, "B4": 0}


@pytest.mark.parametrize("method", ["near", "bilinear"])
def test_lzw_fused_tiles_over_http_mas(lzw_env, wrappers, method):
    for box in LZW_TILES:
        ref, got = _lzw_both(lzw_env, _getmap("lzw", box, style=method,
                                              time=T_LZW_OLD))
        img = _same_tile(ref, got, method == "near", method)
        assert (img[..., 3] > 0).mean() > 0.5
    assert wrappers == {"B1": len(LZW_TILES), "B2": 0, "B4": 0}
    assert lzw_env["masapi"].cache.hits >= 1


def test_lzw_masked_tiles_over_http_mas(lzw_env, wrappers):
    for box in LZW_TILES[:2]:
        ref, got = _lzw_both(lzw_env, _getmap("lzw_masked", box,
                                              time=T_LZW_ALL))
        _same_tile(ref, got, False, "masked")
    assert wrappers["B4"] == 2


def test_lzw_drill_over_http_mas(lzw_env, monkeypatch):
    from test_torch_wps import _rows, _same_csv
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")
    geom = {"type": "Polygon", "coordinates": [[
        [148.05, -35.30], [148.12, -35.30], [148.12, -35.25],
        [148.05, -35.25], [148.05, -35.30]]]}
    url = ("/ows?service=WPS&request=Execute&identifier=lzw_drill"
           f"&datainputs={quote('geometry=' + json.dumps(geom))}")
    blocks = _same_csv(*_lzw_both(lzw_env, url))
    assert len(_rows(blocks[0])) == 3
