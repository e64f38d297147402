"""Port parity, the grids of satellite archives: curvilinear swaths
(full-resolution and subsampled geolocation arrays), the geostationary
full disk, sinusoidal HDF4-EOS tiles, Australian Albers GeoTIFFs and GMT
grids, served through the port's normal entry points against the JAX
package on the same seeded archive.

- `GeolocGrid.invert`: within 1e-9 px of the reference's.
- Fused GetMap tiles (`render_composite_byte`): nearest bytes
  identical, bilinear and cubic within 0.1% of bytes; the executors'
  leg counts (``paged_engaged`` / ``paged_declined``) equal (the reference counts no gate declines apart, so
  ``paged_gated``, a part of the declines, is the port's alone); for
  curvilinear granules the `_geoloc_ctrl` grid (float32)
  and the step it ended at identical.
- The masked curvilinear tile (`TilePipeline.process` with a QA band):
  validity identical, data within 2 ulp, kernel B4 reached in both
  packages (the reference's `mosaic_first_valid_pallas` spied and run
  in interpret mode; the port's wrapper counted).
- Drills over curvilinear (polygon and point), HDF4 and GMT stacks:
  dates and counts equal, values within rtol 1e-5, the reference's B3
  (`masked_stats_pallas`, interpret mode) spied.
- WCS GetCoverage over a curvilinear layer: values bit-exact for
  nearest, within 2 ulp otherwise, nodata at the same pixels.

The reference runs with GSKY_PALLAS=interpret, waves and the render
batcher off; the port with ``device="cpu"``, the plain versions of the
kernels."""

import dataclasses
import datetime as dt
import json
import os

import numpy as np
import pytest
from urllib.parse import parse_qs, urlsplit

from gsky_tpu.geo.crs import CRS_SINU_MODIS as JSINU
from gsky_tpu.geo.crs import EPSG3577 as J3577
from gsky_tpu.geo.crs import parse_crs as jparse_crs
from gsky_tpu.geo.geoloc import GeolocGrid as JGeolocGrid
from gsky_tpu.geo.transform import BBox as JBBox
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.geo.transform import transform_bbox as jtransform_bbox
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.geotiff import write_geotiff as jwrite_geotiff
from gsky_tpu.io.gmt import write_gmt as jwrite_gmt
from gsky_tpu.io.hdf4 import write_hdf4 as jwrite_hdf4
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.pipeline import drill as jdrill
from gsky_tpu.pipeline import drill_cache as jDC
from gsky_tpu.pipeline import pages as jpages
from gsky_tpu.pipeline import tile as jtile
from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
from gsky_tpu.pipeline.types import GeoDrillRequest as JDrillRequest
from gsky_tpu.pipeline.types import GeoTileRequest as JRequest
from gsky_tpu.pipeline.types import MaskSpec as JMaskSpec
from gsky_tpu.server.config import ConfigWatcher as JConfigWatcher
from gsky_tpu.server.metrics import MetricsLogger as JMetricsLogger
from gsky_tpu.server.ows import OWSServer as JOWSServer

from gsky_tpu_torch.geo.crs import parse_crs
from gsky_tpu_torch.geo.geoloc import GeolocGrid, load_geoloc_grid
from gsky_tpu_torch.geo.transform import BBox
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.netcdf import write_netcdf3_raw
from gsky_tpu_torch.ops import first_valid as tfv
from gsky_tpu_torch.pipeline import decode as tdecode
from gsky_tpu_torch.pipeline import drill as tdrill
from gsky_tpu_torch.pipeline.tile import TilePipeline
from gsky_tpu_torch.pipeline.types import GeoDrillRequest, \
    GeoTileRequest, MaskSpec
from gsky_tpu_torch.server.config import ConfigWatcher
from gsky_tpu_torch.server.ows import OWSServer

from test_torch_formats import _no_builtin_rule
from test_torch_mosaic import _same_result
from test_torch_wcs import _JaxClient, assert_close, read_tiff

MERC = "EPSG:3857"
LL = "EPSG:4326"
HOST = "gsky.example"
METHODS = ("near", "bilinear", "cubic")


def _ts(d):
    return dt.datetime.strptime(d, "%Y%m%d").replace(
        tzinfo=dt.timezone.utc).timestamp()


T0, T1 = _ts("20200101"), _ts("20200301")

# ---------------------------------------------------------------------------
# the archive
# ---------------------------------------------------------------------------

SW_H, SW_W = 300, 240          # swath rows, cols
SUB = 5                        # geolocation subsampling of the third swath
SUB_OFF = 2.0                  # its line / pixel offset


def _swath_lonlat(r, c, k=0):
    """A rotated, curved swath over south-eastern Australia at about
    450 m: lon/lat of raster pixel centre (r, c) (float64)."""
    lon = 147.0 + 0.1 * k + 0.004 * c + 0.0012 * r \
        + 4e-6 * (c - 120.0) ** 2
    lat = -34.0 - 0.05 * k - 0.003 * r + 0.0005 * c \
        - 3e-6 * (r - 150.0) ** 2
    return lon, lat


def _write_swath(path, k, rng, sub=False, times=None):
    """A CF curvilinear swath: ``bt`` (f32, fill -9999, a fill block)
    and ``qa`` (int16 bit flags), 2-D lon/lat, no 1-D axis variables.
    ``sub``: lon/lat every SUB-th pixel from SUB_OFF; ``times``: a
    (T, H, W) ``bt`` stack over a time axis."""
    rr, cc = np.mgrid[0:SW_H, 0:SW_W].astype(np.float64)
    bt = 250.0 + 30.0 * np.sin(cc / (17.0 + 3 * k)) * np.cos(rr / 23.0) \
        + rng.normal(0, 2.0, (SW_H, SW_W))
    bt = bt.astype(np.float32)
    bt[:12, :20] = -9999.0
    qa = np.zeros((SW_H, SW_W), np.int16)
    yy, xx = np.mgrid[0:SW_H, 0:SW_W]
    for _ in range(5):
        cy, cx = rng.uniform(0, SW_H), rng.uniform(0, SW_W)
        qa[(yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(8, 25) ** 2] |= 8
    qa[rng.uniform(size=qa.shape) < 0.02] |= 2
    if sub:
        gi = SUB_OFF + SUB * np.arange((SW_H - 2) // SUB + 1)
        gj = SUB_OFF + SUB * np.arange((SW_W - 2) // SUB + 1)
        lon, lat = _swath_lonlat(*np.meshgrid(gi + 0.5, gj + 0.5,
                                              indexing="ij"), k=k)
        dims = [("y", SW_H), ("x", SW_W), ("gy", len(gi)), ("gx", len(gj))]
        gdims = ("gy", "gx")
    else:
        lon, lat = _swath_lonlat(rr + 0.5, cc + 0.5, k=k)
        dims = [("y", SW_H), ("x", SW_W)]
        gdims = ("y", "x")
    variables = [
        ("lon", gdims, {"standard_name": "longitude"}, lon),
        ("lat", gdims, {"standard_name": "latitude"}, lat)]
    if times is not None:
        dims = [("time", len(times))] + dims
        stack = np.stack([bt + 3.0 * i for i in range(len(times))])
        stack[2, 100:140, 60:90] = -9999.0
        variables += [
            ("time", ("time",), {"standard_name": "time", "units":
                                 "seconds since 1970-01-01 00:00:00"},
             np.asarray(times, np.float64)),
            ("bt", ("time", "y", "x"),
             {"_FillValue": np.float32(-9999.0)}, stack)]
    else:
        variables += [
            ("bt", ("y", "x"), {"_FillValue": np.float32(-9999.0)}, bt),
            ("qa", ("y", "x"), {}, qa)]
    write_netcdf3_raw(path, dims, variables, {"Conventions": "CF-1.6"})


def _sub_geo_loc(rec):
    """The crawler flags only full-resolution geolocation arrays; the
    subsampled swath's record gets its ``geo_loc`` (offsets, steps) and
    footprint the way a ruleset would give them."""
    for ds in rec["geo_metadata"]:
        ds["geo_loc"] = {"x_var": "lon", "y_var": "lat",
                         "line_offset": SUB_OFF, "pixel_offset": SUB_OFF,
                         "line_step": float(SUB),
                         "pixel_step": float(SUB), "srs": LL}
        ds["proj_wkt"] = LL
        ds["proj4"] = "+proj=longlat +datum=WGS84 +no_defs"
        ds["polygon"] = ("POLYGON ((146.9 -35.3,148.3 -35.3,148.3 -33.8,"
                         "146.9 -33.8,146.9 -35.3))")
    return rec


GEOS_N, GEOS_RES = 550, 20000.0      # a 20 km full disk


def _write_geos(path):
    """A Himawari-shaped full disk at 20 km (the real one is 5500 px at
    2 km): CF ``geostationary`` mapping, x/y in metres, space filled."""
    x = -5.5e6 + GEOS_RES * (np.arange(GEOS_N) + 0.5)
    y = 5.5e6 - GEOS_RES * (np.arange(GEOS_N) + 0.5)
    X, Y = np.meshgrid(x, y)
    band = (280.0 + 20.0 * np.sin(X / 4.1e5) * np.cos(Y / 3.3e5)) \
        .astype(np.float32)
    band[(X / 5.43e6) ** 2 + (Y / 5.41e6) ** 2 >= 1.0] = -999.0
    write_netcdf3_raw(path, [("y", GEOS_N), ("x", GEOS_N)], [
        ("x", ("x",), {"standard_name": "projection_x_coordinate"}, x),
        ("y", ("y",), {"standard_name": "projection_y_coordinate"}, y),
        ("geostationary", (), {
            "grid_mapping_name": "geostationary",
            "perspective_point_height": 35785863.0,
            "longitude_of_projection_origin": 140.7,
            "sweep_angle_axis": "y", "semi_major_axis": 6378137.0,
            "inverse_flattening": 298.257223563},
         np.zeros((), np.int32)),
        ("tbb", ("y", "x"), {"grid_mapping": "geostationary",
                             "_FillValue": np.float32(-999.0)}, band),
    ], {"Conventions": "CF-1.6"})


SINU_N, SINU_RES = 240, 463.31271653


def _write_sinu(path, k, rng):
    """A MODIS-shaped sinusoidal HDF4-EOS tile (deflate, int16 fill
    -3000) over the Australian Capital Territory."""
    x0, y0 = JSINU.from_lonlat(148.8, -35.1)
    gt = JGT(float(x0), SINU_RES, 0.0, float(y0), 0.0, -SINU_RES)
    yy, xx = np.mgrid[0:SINU_N, 0:SINU_N].astype(np.float32)
    ndvi = (3000 + 2500 * np.sin(xx / (13.0 + k)) * np.cos(yy / 19.0)
            + rng.normal(0, 80, xx.shape)).astype(np.int16)
    ndvi[:10, :30] = -3000
    jwrite_hdf4(path, {"sur_refl_b01": ndvi}, gt=gt, crs=JSINU,
                fills={"sur_refl_b01": -3000.0}, compress="deflate")


AEA_N, AEA_RES = 400, 25.0
AEA_X0, AEA_Y0 = 1548000.0, -3952000.0


def _write_albers(path, rng):
    """A DEA-shaped int16 Albers (EPSG:3577) tile at 25 m."""
    yy, xx = np.mgrid[0:AEA_N, 0:AEA_N].astype(np.float32)
    v = (1200 + 700 * np.sin(xx / 29.0) * np.cos(yy / 37.0)
         + rng.normal(0, 30, xx.shape)).astype(np.int16)
    v[(xx + yy) < 60] = -999
    jwrite_geotiff(path, v, JGT(AEA_X0, AEA_RES, 0.0, AEA_Y0, 0.0,
                                -AEA_RES), J3577, nodata=-999)


def _write_gmt(path, k, rng):
    data = (5.0 + 3.0 * rng.uniform(size=(64, 64)) + k).astype(np.float32)
    data[:5, :5] = np.nan
    jwrite_gmt(path, data, (148.0, 148.64), (-35.64, -35.0))


DRILL_T = 6


def _write_archive(root):
    rng = np.random.default_rng(44)
    files = {}
    # collection directories: none is a prefix of another (the MAS
    # scopes a collection by path prefix)
    for sub in ("swath", "subsampled", "geos", "sinu", "albers", "gmt",
                "drill"):
        os.makedirs(os.path.join(root, sub))
    for k, date in enumerate(("20200110", "20200126")):
        p = os.path.join(root, "swath", f"swath_{date}.nc")
        _write_swath(p, k, rng)
        files.setdefault("swath", []).append(p)
    p = os.path.join(root, "subsampled", "swath_sub_20200211.nc")
    _write_swath(p, 0, rng, sub=True)
    files["swath_sub"] = [p]
    p = os.path.join(root, "geos", "ahi_fd_20200115.nc")
    _write_geos(p)
    files["geos"] = [p]
    for k, date in enumerate(("2020017", "2020025")):
        p = os.path.join(root, "sinu", f"vi_tile.A{date}.h29v12.hdf")
        _write_sinu(p, k, rng)
        files.setdefault("sinu", []).append(p)
    p = os.path.join(root, "albers", "dea_albers_20200120.tif")
    _write_albers(p, rng)
    files["albers"] = [p]
    for k, date in enumerate(("20200112", "20200128")):
        p = os.path.join(root, "gmt", f"relief_{date}.grd")
        _write_gmt(p, k, rng)
        files.setdefault("gmt", []).append(p)
    times = _ts("20200105") + 8 * 86400.0 * np.arange(DRILL_T)
    p = os.path.join(root, "drill", "swath_stack.nc")
    _write_swath(p, 0, rng, times=times)
    files["drill"] = [p]
    return files


NAMESPACES = {"gmt": "relief", "sinu": "sur_refl_b01", "albers": "albers"}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("geoloc_archive"))
    files = _write_archive(root)
    jstore, tstore = JMASStore(), MASStore()
    for fam, paths in files.items():
        for p in paths:
            _no_builtin_rule(p)
            jrec, trec = jextract(p), extract(p)
            assert not trec.get("error"), trec
            assert trec == jrec
            for rec in (jrec, trec):
                if fam == "swath_sub":
                    _sub_geo_loc(rec)
                for ds in rec["geo_metadata"]:
                    ds["namespace"] = NAMESPACES.get(fam, ds["namespace"])
            jstore.ingest(jrec)
            tstore.ingest(trec)
    return {"root": root, "files": files, "jstore": jstore,
            "tstore": tstore}


# ---------------------------------------------------------------------------
# GeolocGrid
# ---------------------------------------------------------------------------

def _grid_pair(wrap=False, sub=False):
    if sub:
        gi = SUB_OFF + SUB * np.arange(60)
        gj = SUB_OFF + SUB * np.arange(48)
        lon, lat = _swath_lonlat(*np.meshgrid(gi + 0.5, gj + 0.5,
                                              indexing="ij"))
        kw = dict(line_offset=SUB_OFF, pixel_offset=SUB_OFF,
                  line_step=SUB, pixel_step=SUB)
    else:
        rr, cc = np.mgrid[0:120, 0:90].astype(np.float64)
        lon, lat = _swath_lonlat(rr + 0.5, cc + 0.5)
        kw = {}
    if wrap:
        lon = lon + 32.9           # 179.9 .. 180.9: across the seam
        lon = np.where(lon > 180.0, lon - 360.0, lon)
    lon = lon.copy()
    lon[3, 4] = np.nan             # a missing sample
    return GeolocGrid(lon, lat, **kw), JGeolocGrid(lon, lat, **kw), lon, lat


@pytest.mark.parametrize("case", ["full", "subsampled", "antimeridian"])
def test_geoloc_invert_matches_reference(case):
    t, j, lon, lat = _grid_pair(wrap=case == "antimeridian",
                                sub=case == "subsampled")
    assert t._wraps == j._wraps == (case == "antimeridian")
    np.testing.assert_array_equal(t._bi, j._bi)
    np.testing.assert_array_equal(t._bj, j._bj)
    rng = np.random.default_rng(3)
    lo, hi = np.nanmin(lon), np.nanmax(lon)
    if case == "antimeridian":
        x = rng.uniform(179.95, 180.8, 3000)
        x = np.where(x > 180.0, x - 360.0, x)
    else:
        x = rng.uniform(lo - 0.2, hi + 0.2, 3000)   # some off the swath
    y = rng.uniform(np.nanmin(lat) - 0.2, np.nanmax(lat) + 0.2, 3000)
    x[:5] = np.nan
    y[5:8] = np.inf
    tc, tr = t.invert(x.reshape(60, 50), y.reshape(60, 50))
    jc, jr = j.invert(x.reshape(60, 50), y.reshape(60, 50))
    np.testing.assert_array_equal(np.isnan(tc), np.isnan(jc))
    ok = np.isfinite(jc)
    assert ok.sum() > 2900
    assert np.max(np.abs(tc[ok] - jc[ok])) <= 1e-9
    assert np.max(np.abs(tr[ok] - jr[ok])) <= 1e-9


def test_load_geoloc_grid_reads_the_record(archive):
    p = archive["files"]["swath_sub"][0]
    gl = {"x_var": "lon", "y_var": "lat", "line_offset": SUB_OFF,
          "pixel_offset": SUB_OFF, "line_step": SUB, "pixel_step": SUB}
    g = load_geoloc_grid(p, gl)
    assert g is not None and g.gx.shape == (60, 48)
    assert (g.pixel_step, g.line_offset) == (SUB, SUB_OFF)
    assert load_geoloc_grid(p, gl) is g                  # cached
    assert load_geoloc_grid(p, {"x_var": "nope", "y_var": "lat"}) is None


# ---------------------------------------------------------------------------
# fused GetMap tiles
# ---------------------------------------------------------------------------

def _merc_box(lon0, lat0, lon1, lat1):
    b = jtransform_bbox(JBBox(lon0, lat0, lon1, lat1), jparse_crs(LL),
                        jparse_crs(MERC))
    return (b.xmin, b.ymin, b.xmax, b.ymax)


def _albers_box(dx0, dy0, dx1, dy1, crs=MERC):
    b = jtransform_bbox(JBBox(AEA_X0 + dx0, AEA_Y0 - dy1, AEA_X0 + dx1,
                              AEA_Y0 - dy0), J3577, jparse_crs(crs))
    return (b.xmin, b.ymin, b.xmax, b.ymax)


# (collection, namespace, box, crs, (height, width), env)
TILES = {
    "swath": ("swath", "bt", _merc_box(147.3, -34.7, 147.8, -34.25), MERC,
              (112, 128), {}),
    "swath_edge": ("swath", "bt", _merc_box(146.8, -34.5, 147.3, -34.0),
                   MERC, (96, 96), {}),
    "swath_bucketed": ("swath", "bt", _merc_box(146.8, -35.3, 148.4, -33.8),
                       MERC, (128, 128), {"GSKY_PAGE_SLOTS": "1"}),
    "swath_sub": ("subsampled", "bt", _merc_box(147.3, -34.7, 147.8, -34.25),
                  MERC, (112, 128), {}),
    "swath_4326": ("swath", "bt", (147.35, -34.6, 147.75, -34.2), LL,
                   (96, 96), {}),
    "geos": ("geos", "tbb", _merc_box(145.0, -32.0, 153.0, -26.0), MERC,
             (96, 128), {}),
    # the disk's western limb: half the tile maps to space (NaN
    # control points), half to the disk
    "geos_limb": ("geos", "tbb", _merc_box(55.0, -10.0, 70.0, 10.0),
                  MERC, (96, 96), {}),
    "sinu": ("sinu", "sur_refl_b01", _merc_box(149.0, -35.75, 149.9, -35.2),
             MERC, (96, 128), {}),
    "albers": ("albers", "albers", _albers_box(500, 600, 9000, 8800),
               MERC, (128, 128), {}),
    "albers_native": ("albers", "albers",
                      _albers_box(800, 700, 9000, 8900, "EPSG:3577"),
                      "EPSG:3577", (96, 96), {}),
}


def _env(**extra):
    saved = {}

    class _Env:
        def __enter__(self):
            for k, v in {"GSKY_PALLAS": "interpret", "GSKY_WAVES": "0",
                         "GSKY_RENDER_BATCH": "0", **extra}.items():
                saved[k] = os.environ.get(k)
                os.environ[k] = v
            jpages.reset_default_pool()

        def __exit__(self, *a):
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            jpages.reset_default_pool()
    return _Env()


# the first swath date alone: the fused composite takes one group, and
# each swath file is a group of its own (its own geolocation arrays)
T_FIRST = _ts("20200120")


def _tile_reqs(archive, case, method, end=None):
    coll, ns, box, crs, (h, w), _ = TILES[case]
    if end is None:
        end = T_FIRST if coll == "swath" else T1
    coll = os.path.join(archive["root"], coll)
    jreq = JRequest(collection=coll, bands=[ns], bbox=JBBox(*box),
                    crs=jparse_crs(crs), width=w, height=h,
                    start_time=T0, end_time=end, resample=method)
    treq = GeoTileRequest(collection=coll, bands=[ns], bbox=BBox(*box),
                          crs=parse_crs(crs), width=w, height=h,
                          start_time=T0, end_time=end, resample=method)
    return jreq, treq


def _legs(ex):
    return ex.paged_engaged, ex.paged_declined


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(TILES))
def test_fused_tile_matches_reference(archive, case, method):
    jreq, treq = _tile_reqs(archive, case, method)
    with _env(**TILES[case][5]):
        jex = JWarpExecutor()
        jp = JTilePipeline(JMASClient(archive["jstore"]), executor=jex)
        jt = jp.render_composite_byte(jreq)
        tp = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        tt = tp.render_composite_byte(treq)
        jg, tg = jp.index(jreq), tp.index(treq)
    assert jt is not None and tt is not None
    jt, tt = np.asarray(jt), tt.numpy()
    assert tt.dtype == np.uint8 and tt.shape == jt.shape
    assert (tt != 255).any()
    if case in ("swath_edge", "geos_limb", "albers", "swath_bucketed"):
        assert (tt == 255).any()          # the tile crosses the data edge
    diff = np.count_nonzero(jt != tt)
    if method == "near":
        assert diff == 0
    else:
        assert diff <= jt.size // 1000, f"{diff} bytes differ"
    assert _legs(tp.executor) == _legs(jex)
    assert sum(_legs(tp.executor)) == 1
    assert tp.executor.paged_gated == 0
    if case == "swath_bucketed":
        assert _legs(tp.executor) == (0, 1)
    assert [(g.path, g.namespace, g.band) for g in tg] == \
        [(g.path, g.namespace, g.band) for g in jg]
    if tg[0].geo_loc:
        dst = treq.dst_gt()
        jdst = jreq.dst_gt()
        for tgr, jgr in zip(tg, jg):
            tc, ts = tp.executor._geoloc_ctrl(tgr, dst, treq.crs,
                                              treq.height, treq.width)
            jc, js = jex._geoloc_ctrl(jgr, jdst, jreq.crs, jreq.height,
                                      jreq.width)
            assert ts == js and tc.dtype == np.float32
            np.testing.assert_array_equal(tc, np.asarray(jc))
        assert sum(tp.executor.geoloc_steps.values()) == len(tg)
        assert tp.executor.geoloc_seconds > 0


def test_curved_swath_refines_the_step(archive):
    """A zoomed-in tile over the curved swath validates the inversion
    at cell midpoints: both packages end at the same step, below 16."""
    box = _merc_box(147.40, -34.40, 147.47, -34.34)
    req_kw = dict(bands=["bt"], width=256, height=256, start_time=T0,
                  end_time=T_FIRST, resample="near")
    coll = os.path.join(archive["root"], "swath")
    with _env():
        jex = JWarpExecutor()
        jp = JTilePipeline(JMASClient(archive["jstore"]), executor=jex)
        jreq = JRequest(collection=coll, bbox=JBBox(*box),
                        crs=jparse_crs(MERC), **req_kw)
        treq = GeoTileRequest(collection=coll, bbox=BBox(*box),
                              crs=parse_crs(MERC), **req_kw)
        tp = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        g = tp.index(treq)[0]
        jg = jp.index(jreq)[0]
        tc, ts = tp.executor._geoloc_ctrl(g, treq.dst_gt(), treq.crs,
                                          256, 256)
        jc, js = jex._geoloc_ctrl(jg, jreq.dst_gt(), jreq.crs, 256, 256)
    assert ts == js
    np.testing.assert_array_equal(tc, np.asarray(jc))
    assert tc.shape == (2, 256 // ts + 1, 256 // ts + 1)


# ---------------------------------------------------------------------------
# the masked curvilinear tile (B4)
# ---------------------------------------------------------------------------

@pytest.fixture
def b4_spies(monkeypatch, tmp_path):
    """The reference's B4 in interpret mode and the port's wrapper, both
    counted: (reference stack shapes, port stack shapes)."""
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setattr(jpt, "_FAILED", set())
    jcalls, tcalls = [], []
    orig = jpt.mosaic_first_valid_pallas

    def spy(stack, valid, interpret=False):
        jcalls.append(tuple(stack.shape))
        return orig(stack, valid, interpret=True)

    monkeypatch.setattr(jpt, "mosaic_first_valid_pallas", spy)
    torig = tfv.mosaic_first_valid_kernel

    def tspy(stack, valid):
        tcalls.append(tuple(stack.shape))
        return torig(stack, valid)

    monkeypatch.setattr(tfv, "mosaic_first_valid_kernel", tspy)
    return jcalls, tcalls


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mask", ["value", "bit_tests"])
def test_masked_curvilinear_tile_matches_reference(archive, b4_spies,
                                                   method, mask):
    spec = dict(id="qa", value="1000") if mask == "value" \
        else dict(id="qa", bit_tests=["1000", "1000", "10", "10"])
    jreq, treq = _tile_reqs(archive, "swath", method, end=T1)
    jreq = dataclasses.replace(jreq, mask=JMaskSpec(**spec))
    treq = dataclasses.replace(treq, mask=MaskSpec(**spec))
    with _env():
        jres = JTilePipeline(JMASClient(archive["jstore"]),
                             executor=JWarpExecutor()).process(jreq)
        tp = TilePipeline(MASClient(archive["tstore"]), device="cpu")
        tres = tp.process(treq)
    jcalls, tcalls = b4_spies
    # two dates of bt in one mosaic: B4 at T = 2 in both packages
    assert jcalls == tcalls == [(2, 112, 128)]
    _same_result(jres, tres, nulp=0 if method == "near" else 2)
    ok = tres.valid["bt"].numpy()
    assert ok.any() and not ok.all()


def test_decode_skips_curvilinear_granules(archive):
    """The windowed decode has no affine grid for a swath: it skips the
    granule and counts the skip, as the reference does."""
    _, treq = _tile_reqs(archive, "swath", "near")
    g = TilePipeline(MASClient(archive["tstore"]), device="cpu") \
        .index(treq)[0]
    n = tdecode.geoloc_skips
    assert tdecode.decode_window(g, treq.bbox, treq.crs,
                                 device="cpu") is None
    assert tdecode.geoloc_skips == n + 1


# ---------------------------------------------------------------------------
# drills (B3)
# ---------------------------------------------------------------------------

@pytest.fixture
def b3_spy(monkeypatch, tmp_path):
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_WAVES", "0")
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setattr(jpt, "_FAILED", set())
    calls = []
    orig = jpt.masked_stats_pallas

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return orig(*a, **kw)

    monkeypatch.setattr(jpt, "masked_stats_pallas", spy)
    yield calls
    jDC.default_drill_cache.clear()


DRILLS = {
    "swath_polygon": ("drill", "bt",
                      "POLYGON((147.3 -34.3,147.7 -34.35,147.65 -34.7,"
                      "147.25 -34.6,147.3 -34.3))"),
    "swath_point": ("drill", "bt", "POINT(147.5 -34.5)"),
    "swath_tiny": ("drill", "bt",
                   "POLYGON((147.5 -34.5,147.501 -34.5,147.501 -34.501,"
                   "147.5 -34.5))"),
    "swath_sub": ("subsampled", "bt",
                  "POLYGON((147.3 -34.3,147.7 -34.35,147.65 -34.7,"
                  "147.25 -34.6,147.3 -34.3))"),
    "hdf4": ("sinu", "sur_refl_b01",
             "POLYGON((149.0 -35.3,149.5 -35.25,149.6 -35.7,"
             "149.1 -35.65,149.0 -35.3))"),
    "gmt": ("gmt", "relief",
            "POLYGON((148.1 -35.1,148.5 -35.15,148.45 -35.5,"
            "148.05 -35.45,148.1 -35.1))"),
}


@pytest.mark.parametrize("deciles", [0, 3])
@pytest.mark.parametrize("case", sorted(DRILLS))
def test_drill_matches_reference(archive, b3_spy, case, deciles):
    coll, ns, wkt = DRILLS[case]
    kw = dict(collection=os.path.join(archive["root"], coll), bands=[ns],
              geometry_wkt=wkt, approx=False, deciles=deciles)
    jp = jdrill.DrillPipeline(JMASClient(archive["jstore"]))
    tp = tdrill.DrillPipeline(MASClient(archive["tstore"]), device="cpu")
    jres = jp.process(JDrillRequest(**kw))
    tres = tp.process(GeoDrillRequest(**kw))
    n_dates = {"drill": DRILL_T, "subsampled": 1}.get(coll, 2)
    assert tres.dates == jres.dates and len(tres.dates) == n_dates
    assert set(tres.values) == set(jres.values)
    for k in jres.values:
        assert [int(c) for c in tres.counts[k]] == \
            [int(c) for c in jres.counts[k]], k
        np.testing.assert_allclose(np.asarray(tres.values[k], np.float64),
                                   np.asarray(jres.values[k], np.float64),
                                   rtol=1e-5, equal_nan=True, err_msg=k)
    assert min(tres.counts[ns]) > 0
    # warm drills reduce the resident stacks through B3 (one call per
    # file in the reference)
    assert len(b3_spy) == len({p for p in archive["files"][
        {"subsampled": "swath_sub"}.get(coll, coll)]})
    if case == "swath_point":
        assert max(tres.counts[ns]) <= 2


def test_drill_geoloc_mask_matches_reference(archive):
    """The containment mask and its raster window, for the full and the
    subsampled geolocation arrays."""
    from gsky_tpu.geo import geometry as jgeom
    from gsky_tpu_torch.geo import geometry as tgeom
    for coll, wkt in (("drill", DRILLS["swath_polygon"][2]),
                      ("subsampled", DRILLS["swath_sub"][2]),
                      ("drill", DRILLS["swath_point"][2])):
        tds = MASClient(archive["tstore"]).intersects(
            os.path.join(archive["root"], coll), srs=LL, wkt=wkt,
            namespaces="bt")
        jds = JMASClient(archive["jstore"]).intersects(
            os.path.join(archive["root"], coll), srs=LL, wkt=wkt,
            namespaces="bt")
        t = tdrill._geoloc_drill_mask(tds[0], tgeom.from_wkt(wkt),
                                      SW_H, SW_W)
        j = jdrill._geoloc_drill_mask(jds[0], jgeom.from_wkt(wkt),
                                      SW_H, SW_W)
        assert t[1] == j[1]
        np.testing.assert_array_equal(t[0], j[0])
        assert t[0].any()


# ---------------------------------------------------------------------------
# WCS over a curvilinear layer
# ---------------------------------------------------------------------------

def _styles(band):
    return [{"name": m, "title": m, "rgb_products": [band], "resample": m}
            for m in METHODS]


@pytest.fixture(scope="module")
def wcs_env(archive):
    mp = pytest.MonkeyPatch()
    root = archive["root"]
    for key, v in (("GSKY_TILE_PIPELINE", "0"), ("GSKY_WAVES", "0"),
                   ("GSKY_RENDER_BATCH", "0"), ("GSKY_PALLAS", "interpret"),
                   ("GSKY_KERNEL_LEDGER", f"{root}/ledger.jsonl")):
        mp.setenv(key, v)
    jpages.reset_default_pool()
    conf = f"{root}/conf"
    for d in (conf, f"{root}/tmp", f"{root}/tmp_port"):
        os.makedirs(d, exist_ok=True)
    small = {"wcs_max_tile_width": 64, "wcs_max_tile_height": 64}
    cfg = {"service_config": {"ows_hostname": HOST, "mas_address": "inproc"},
           "layers": [dict(name="swath", data_source=f"{root}/swath",
                           rgb_products=["bt"], time_generator="mas",
                           styles=_styles("bt"), **small)]}
    with open(f"{conf}/config.json", "w") as fp:
        json.dump(cfg, fp)
    jmas, tmas = JMASClient(archive["jstore"]), MASClient(archive["tstore"])
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
    yield {"root": root, "jax": client, "port": tserver}
    client.close()
    jpages.reset_default_pool()
    mp.undo()


@pytest.mark.parametrize("method", METHODS)
def test_wcs_over_curvilinear_layer(wcs_env, method):
    box = _merc_box(147.3, -34.75, 147.85, -34.3)
    url = (f"/ows?service=WCS&request=GetCoverage&version=1.0.0"
           f"&coverage=swath&crs={MERC}&bbox="
           f"{','.join(repr(float(v)) for v in box)}&width=150&height=140"
           f"&format=GeoTIFF&styles={method}"
           f"&time=2020-01-10T00:00:00.000Z")
    j0 = _legs(jtile.default_executor)
    ref = wcs_env["jax"].request(url)
    j1 = _legs(jtile.default_executor)
    ex = wcs_env["port"].executor
    t0 = _legs(ex)
    u = urlsplit(url)
    r = wcs_env["port"].handle(u.path, parse_qs(u.query,
                                                keep_blank_values=True),
                               HOST)
    got = (r.status, r.content_type, r.read())
    t1 = _legs(ex)
    assert ref[:2] == (200, "image/geotiff"), ref[2][:300]
    assert got[:2] == ref[:2], got[2][:300]
    rv, rgt = read_tiff(wcs_env, ref[2])
    gv, ggt = read_tiff(wcs_env, got[2])
    assert ggt == rgt and gv.shape == rv.shape == (1, 140, 150)
    assert_close(rv, gv, method == "near", method)
    assert (rv != -9999.0).any() and (rv == -9999.0).any()
    assert tuple(b - a for a, b in zip(t0, t1)) == \
        tuple(b - a for a, b in zip(j0, j1))
