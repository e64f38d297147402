"""Port parity, drill tier: the port's WPS polygon drill and its host
modules against the JAX package, on the same seeded inputs.

- `ops/drill`: elementwise ops and sorts bit-exact (compared with
  ``==``, since a sort may place -0.0 and 0.0 either way); sums within
  rtol 1e-5 (float32 reassociation).
- NetCDF-3: files written by either package read back identically by
  the other (arrays, timestamps, CRS, nodata); both writers emit the
  same bytes; the crawlers' records are equal.
- `rasterize` (ALL_TOUCHED) masks and `tiled_geometries` WKT identical.
- Expression evaluation identical; calls of transcendental functions
  within 2 ulp (numpy's float64 libm against XLA's).
- `DrillPipeline` as a whole on a small archive (48 steps x 64 x 64,
  float32 and int16, two variables a file): the JAX reference runs with
  GSKY_PALLAS=interpret, GSKY_WAVES=0, GSKY_DRILL_CACHE=sync, so its
  resident-stack path reaches kernel B3 (`masked_stats_pallas`, spied
  on); the port runs with ``device="cpu"``, B3's plain version.  Dates
  and counts equal, values within rtol 1e-5; on integer data whose sums
  stay below 2**24 the values are equal and `drill_csv` is
  byte-identical.
- NetCDF-4 (HDF5, written with h5py): reader, crawler record and drill
  as the reference's; without h5py a ValueError naming it.  A VRT
  drill (an expression over the data and a mask granule, reduced on
  the host in both packages) equal to the reference's.
"""

import ast
import datetime as dt
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsky_tpu.geo import geometry as jgeom
from gsky_tpu.geo.crs import EPSG4326 as JEPSG4326
from gsky_tpu.index.client import MASClient as JMASClient
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.index.store import MASStore as JMASStore
from gsky_tpu.io.netcdf import NetCDF as JNetCDF
from gsky_tpu.io.netcdf import write_netcdf3 as jwrite_netcdf3
from gsky_tpu.ops import drill as jD
from gsky_tpu.ops import expr as jexpr
from gsky_tpu.ops import pallas_tpu as jpt
from gsky_tpu.pipeline import drill as jdrill
from gsky_tpu.pipeline import drill_cache as jDC
from gsky_tpu.pipeline.types import GeoDrillRequest as JRequest

from gsky_tpu_torch.carry import drill_stack_from_numpy
from gsky_tpu_torch.geo import geometry as tgeom
from gsky_tpu_torch.geo.crs import EPSG4326
from gsky_tpu_torch.geo.transform import GeoTransform
from gsky_tpu_torch.index.client import MASClient
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.index.store import MASStore
from gsky_tpu_torch.io.netcdf import NetCDF, write_netcdf3
from gsky_tpu_torch.ops import drill as tD
from gsky_tpu_torch.ops import expr as texpr
from gsky_tpu_torch.ops import stats as tstats
from gsky_tpu_torch.pipeline import drill as tdrill
from gsky_tpu_torch.pipeline import drill_cache as tDC
from gsky_tpu_torch.pipeline.types import GeoDrillRequest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W = 48, 64, 64
RES = 0.01
T0 = dt.datetime(2019, 1, 1, tzinfo=dt.timezone.utc).timestamp()
TIMES = T0 + 16 * 86400.0 * np.arange(T)
POLY = ("POLYGON((140.10 -30.08,140.93 -30.14,140.80 -30.57,"
        "140.16 -30.49,140.10 -30.08))")


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch, tmp_path):
    """The JAX reference per call, B3 in interpret mode, stacks uploaded
    on the first request; a hermetic race ledger."""
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_WAVES", "0")
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")
    monkeypatch.setenv("GSKY_KERNEL_LEDGER", str(tmp_path / "ledger.jsonl"))
    yield
    jDC.default_drill_cache.clear()


def _grid(x0, y0, w=W, h=H):
    x = x0 + RES * (np.arange(w) + 0.5)
    y = y0 - RES * (np.arange(h) + 0.5)
    return x, y


def _write_archive(root):
    """Two float32 files side by side (vars a, b; nodata -9999 block,
    NaN specks) and one int16 file (vars c, d; nodata -1), all 48
    steps of 64 x 64 at 0.01 degrees."""
    rng = np.random.default_rng(7)
    paths = []
    for i, x0 in enumerate((140.0, 140.64)):
        x, y = _grid(x0, -30.0)
        a = rng.uniform(0, 100, (T, H, W)).astype(np.float32)
        b = rng.normal(50, 30, (T, H, W)).astype(np.float32)
        a[:, 20:30, 12:20] = -9999.0
        a[rng.uniform(size=a.shape) < 0.01] = np.nan
        b[5:9] = -9999.0                    # whole timesteps of nodata
        p = os.path.join(root, f"drill_f32_{i}.nc")
        write_netcdf3(p, {"a": a, "b": b}, x, y, EPSG4326, times=TIMES,
                      nodata=-9999.0)
        paths.append(p)
    x, y = _grid(140.0, -30.0)
    c = rng.integers(0, 100, (T, H, W)).astype(np.int16)
    d = rng.integers(-50, 50, (T, H, W)).astype(np.int16)
    c[:, 40:, 40:] = -1
    d[:, :5] = -1
    p = os.path.join(root, "drill_i16.nc")
    write_netcdf3(p, {"c": c, "d": d}, x, y, EPSG4326, times=TIMES,
                  nodata=-1)
    paths.append(p)
    return paths


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drill_archive"))
    paths = _write_archive(root)
    jstore, tstore = JMASStore(), MASStore()
    for p in paths:
        jrec = jextract(p, approx_stats=True)
        trec = extract(p, approx_stats=True)
        assert not jrec.get("error") and not trec.get("error")
        jstore.ingest(jrec)
        tstore.ingest(trec)
    return {"root": root, "paths": paths, "jstore": jstore,
            "tstore": tstore}


def _pipelines(archive, cache=None):
    return (jdrill.DrillPipeline(JMASClient(archive["jstore"])),
            tdrill.DrillPipeline(MASClient(archive["tstore"]),
                                 device="cpu", cache=cache))


def _requests(archive, **kw):
    base = dict(collection=archive["root"], geometry_wkt=POLY,
                approx=False)
    base.update(kw)
    return JRequest(**base), GeoDrillRequest(**base)


def _assert_same(jres, tres, exact=False):
    assert tres.dates == jres.dates
    assert set(tres.values) == set(jres.values)
    assert tres.raw_namespaces == jres.raw_namespaces
    for k in jres.values:
        assert [int(c) for c in tres.counts[k]] == \
            [int(c) for c in jres.counts[k]], k
        a = np.asarray(jres.values[k], np.float64)
        b = np.asarray(tres.values[k], np.float64)
        if exact or "_d" in k:
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, equal_nan=True,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# ops/drill
# ---------------------------------------------------------------------------

def _stats_inputs(seed, B=6, N=900):
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 100, (B, N)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.3
    valid[0] = False                          # no valid pixel
    valid[1, 3:] = False                      # fewer than D+1 pixels
    valid[2, :] = True
    valid[2, 10 * 99:] = False if N > 990 else valid[2, 10 * 99:]
    data[3, ::5] = 0.0
    data[3, 1::5] = -0.0
    data[~valid & (rng.uniform(size=(B, N)) < 0.2)] = np.nan
    return data, valid


class TestDrillOps:
    @pytest.mark.parametrize("pixel_count", [False, True])
    @pytest.mark.parametrize("clip", [(-3.0e38, 3.0e38), (-40.0, 75.5)])
    def test_masked_mean_torch_vs_jax(self, pixel_count, clip):
        data, valid = _stats_inputs(1)
        vj, cj = jD.masked_mean(jnp.asarray(data), jnp.asarray(valid),
                                *clip, pixel_count=pixel_count)
        vt, ct = tD.masked_mean(torch.from_numpy(data),
                                torch.from_numpy(valid), *clip,
                                pixel_count=pixel_count)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        if pixel_count:                       # a ratio of exact counts
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        else:
            np.testing.assert_allclose(vt.numpy(), np.asarray(vj),
                                       rtol=1e-5)

    @pytest.mark.parametrize("pixel_count", [False, True])
    def test_masked_mean_numpy_bit_exact(self, pixel_count):
        data, valid = _stats_inputs(2)
        vj, cj = jD.masked_mean_impl(data, valid, -40.0, 75.5, pixel_count,
                                     np)
        vt, ct = tD.masked_mean_impl(data, valid, -40.0, 75.5, pixel_count)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ct, cj)

    @pytest.mark.parametrize("n_deciles", [1, 3, 9])
    @pytest.mark.parametrize("N", [7, 900, 1000])
    def test_deciles_torch_and_numpy_vs_jax(self, n_deciles, N):
        data, valid = _stats_inputs(3, N=N)
        dj = np.asarray(jD.deciles(jnp.asarray(data), jnp.asarray(valid),
                                   n_deciles))
        dt_ = tD.deciles(torch.from_numpy(data), torch.from_numpy(valid),
                         n_deciles).numpy()
        dn = tD.deciles_impl(data, valid, n_deciles)
        assert dt_.dtype == np.float32
        assert (dt_ == dj).all() and (dn == dj).all()

    @pytest.mark.parametrize("dtype,nodata", [
        (np.float32, -9999.0), (np.float32, float("nan")),
        (np.int16, -1.0), (np.uint16, -1.0), (np.uint16, 65535.0),
        (np.int8, 300.0)])
    def test_window_gather_vs_jax(self, dtype, nodata):
        rng = np.random.default_rng(4)
        st = rng.integers(0, 100, (10, 40, 50)).astype(dtype)
        if np.dtype(dtype).kind == "f":
            st[:, 5:9, 5:9] = np.nan
            st[:, 0, :] = np.inf
        st[:, 20:25, 30:] = np.asarray(nodata).astype(dtype) \
            if not np.isnan(nodata) else st[:, 20:25, 30:]
        tsel = np.array([0, 3, 3, 9], np.int64)
        mask = rng.uniform(size=(32, 32)) > 0.4
        nd = np.asarray(nodata)
        if np.isnan(nodata):
            nd_native, use_nd = 0, False
        else:
            cast = nd.astype(dtype)
            nd_native, use_nd = cast.item(), bool(float(cast) == nodata)
        dj, vj = jD.window_gather(
            jnp.asarray(st), jnp.asarray(tsel.astype(np.int32)),
            np.int32(6), np.int32(17), jnp.asarray(mask),
            np.asarray(nd_native, dtype), np.bool_(use_nd), (32, 32))
        tst = drill_stack_from_numpy(st, nodata, device="cpu")
        dt_, vt = tD.window_gather(tst.dev, torch.from_numpy(tsel), 6, 17,
                                   torch.from_numpy(mask), nd_native,
                                   use_nd, (32, 32))
        np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))

    def test_interp_strided_identical(self):
        rng = np.random.default_rng(5)
        pos = np.array([0, 2, 5, 6, 11])
        v = rng.normal(size=(5, 4)).astype(np.float32)
        c = rng.integers(0, 1000, (5, 4)).astype(np.int32)
        a = jD.interp_strided(v, c, pos, 12)
        b = tD.interp_strided(v, c, pos, 12)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# NetCDF, crawler, store
# ---------------------------------------------------------------------------

def _nc_arrays(dtype):
    rng = np.random.default_rng(6)
    if np.dtype(dtype).kind == "f":
        v = rng.normal(size=(3, 5, 7)).astype(dtype)
    else:
        v = rng.integers(0, 120, (3, 5, 7)).astype(dtype)
    return {"v": v, "w": v[::-1].copy()}


@pytest.mark.parametrize("dtype,nodata", [(np.float32, -9999.0),
                                          (np.int16, -1), (np.uint16, 7),
                                          (np.float64, None)])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_netcdf_round_trip(tmp_path, dtype, nodata, direction):
    arrays = _nc_arrays(dtype)
    x, y = _grid(150.0, -20.0, w=7, h=5)
    times = TIMES[:3]
    p = str(tmp_path / "rt.nc")
    if direction == "jax_to_port":
        jwrite_netcdf3(p, arrays, x, y, JEPSG4326, times=times,
                       nodata=nodata)
        reader = NetCDF
    else:
        write_netcdf3(p, arrays, x, y, EPSG4326, times=times, nodata=nodata)
        reader = JNetCDF
    with reader(p) as nc, JNetCDF(p) as ref:
        for name, arr in arrays.items():
            got = np.asarray(nc.variables[name][:])
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got, arr)
            assert nc.variables[name].nodata == (
                None if nodata is None else float(nodata))
            np.testing.assert_array_equal(
                nc.read_slice(name, 2, (1, 2, 4, 3)), arr[2, 2:5, 1:5])
        np.testing.assert_array_equal(nc.timestamps(), times)
        assert nc.crs().to_proj4() == ref.crs().to_proj4()
        assert nc.geotransform().to_gdal() == ref.geotransform().to_gdal()


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint16])
def test_netcdf_writers_emit_identical_bytes(tmp_path, dtype):
    arrays = _nc_arrays(dtype)
    x, y = _grid(150.0, -20.0, w=7, h=5)
    pj, pt = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jwrite_netcdf3(pj, arrays, x, y, JEPSG4326, times=TIMES[:3], nodata=3)
    write_netcdf3(pt, arrays, x, y, EPSG4326, times=TIMES[:3], nodata=3)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def _write_netcdf4(path, arrays, x, y, times, nodata):
    """A CF NetCDF-4 (HDF5) file written with h5py: dimension scales
    x, y, time, a ``crs`` grid-mapping variable, (time, y, x) data."""
    import h5py
    with h5py.File(path, "w") as f:
        for name, vals, std in (("x", x, "longitude"), ("y", y, "latitude"),
                                ("time", times, "time")):
            d = f.create_dataset(name, data=np.asarray(vals, np.float64))
            d.attrs["standard_name"] = std
            d.make_scale(name)
        f["time"].attrs["units"] = "seconds since 1970-01-01 00:00:00"
        f.create_dataset("crs", data=np.int32(0)).attrs["spatial_ref"] = \
            EPSG4326.to_wkt()
        for name, arr in arrays.items():
            d = f.create_dataset(name, data=arr, chunks=(1, 16, 16),
                                 compression="gzip")
            d.attrs["grid_mapping"] = "crs"
            d.attrs["_FillValue"] = np.asarray(nodata, arr.dtype)
            for i, dim in enumerate(("time", "y", "x")):
                d.dims[i].attach_scale(f[dim])


def test_netcdf4_raises_not_ported(tmp_path, monkeypatch):
    """NetCDF-4 (HDF5) through h5py: the reader, the crawler record and
    a drill equal the reference's.  With h5py unimportable the port
    raises ValueError naming it (the crawler's error record), where the
    reference's own fallback is a plain 'not a NetCDF file'."""
    arrays = {k: v[:6] for k, v in _nc_arrays(np.float32).items()}
    arrays = {k: np.repeat(np.repeat(v, 4, 1), 3, 2)
              for k, v in arrays.items()}            # (3, 20, 21)
    x, y = _grid(140.0, -30.0, w=21, h=20)
    p = str(tmp_path / "nc4_stack.nc")
    _write_netcdf4(p, arrays, x, y, TIMES[:3], -9999.0)
    with NetCDF(p) as nc, JNetCDF(p) as ref:
        assert sorted(nc.variables) == sorted(ref.variables)
        for name in arrays:
            tv, jv = nc.variables[name], ref.variables[name]
            assert (tv.dims, tv.shape, tv.dtype, tv.nodata) == \
                (jv.dims, jv.shape, jv.dtype, jv.nodata)
            np.testing.assert_array_equal(
                nc.read_slice(name, 1, (2, 3, 9, 7)),
                ref.read_slice(name, 1, (2, 3, 9, 7)))
            np.testing.assert_array_equal(nc.read_slice(name, 2, step=2),
                                          ref.read_slice(name, 2, step=2))
            assert nc.chunk_map(name) == ref.chunk_map(name)
        assert [v.name for v in nc.raster_vars()] == \
            [v.name for v in ref.raster_vars()]
        assert nc.geotransform().to_gdal() == ref.geotransform().to_gdal()
        assert nc.crs().to_proj4() == ref.crs().to_proj4()
        np.testing.assert_array_equal(nc.timestamps(), ref.timestamps())
    rec = extract(p, approx_stats=True)
    assert not rec.get("error") and rec == jextract(p, approx_stats=True)
    jstore, tstore = JMASStore(), MASStore()
    jstore.ingest(jextract(p))
    tstore.ingest(rec)
    arch = {"root": str(tmp_path), "jstore": jstore, "tstore": tstore}
    jp, tp = _pipelines(arch)
    jreq, treq = _requests(arch, bands=["v", "w"])
    _assert_same(jp.process(jreq), tp.process(treq))

    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ValueError, match="h5py"):
        NetCDF(p)
    bad = extract(p)
    assert "h5py" in bad["error"] and bad["geo_metadata"] == []


@pytest.mark.parametrize("approx_stats", [False, True])
def test_crawler_record_equals_reference(archive, approx_stats):
    for p in archive["paths"]:
        assert extract(p, approx_stats=approx_stats) == \
            jextract(p, approx_stats=approx_stats)


def test_store_returns_crawler_stats(archive):
    kw = dict(srs="EPSG:4326", wkt=POLY, namespaces="a,c")
    j = JMASClient(archive["jstore"]).intersects(archive["root"], **kw)
    t = MASClient(archive["tstore"]).intersects(archive["root"], **kw)
    key = lambda d: (d.file_path, d.namespace)        # noqa: E731
    assert len(t) == len(j) == 3
    for dj, dt_ in zip(sorted(j, key=key), sorted(t, key=key)):
        assert (dt_.file_path, dt_.namespace, dt_.timestamps) == \
            (dj.file_path, dj.namespace, dj.timestamps)
        assert dt_.means == dj.means and len(dt_.means) == T
        assert dt_.sample_counts == dj.sample_counts
        assert dt_.nodata == dj.nodata


# ---------------------------------------------------------------------------
# geometry, expressions
# ---------------------------------------------------------------------------

GEOMS = {
    "polygon": POLY,
    "hole": ("POLYGON((140.1 -30.1,140.5 -30.1,140.5 -30.5,140.1 -30.5,"
             "140.1 -30.1),(140.2 -30.2,140.4 -30.22,140.35 -30.4,"
             "140.2 -30.2))"),
    "multipolygon": ("MULTIPOLYGON(((140.05 -30.05,140.2 -30.05,"
                     "140.12 -30.3,140.05 -30.05)),((140.3 -30.3,"
                     "140.55 -30.31,140.5 -30.6,140.3 -30.3)))"),
    "point": "POINT(140.333 -30.222)",
    "line": "LINESTRING(140.01 -30.01,140.3 -30.44,140.61 -30.2)",
}


@pytest.mark.parametrize("kind", sorted(GEOMS))
def test_rasterize_all_touched_identical(kind):
    gt = GeoTransform(140.0, RES, 0.0, -30.0, 0.0, -RES)
    wgt = gt.window(3, 2)
    to_px = lambda x, y: wgt.geo_to_pixel(x, y)       # noqa: E731
    mj = jgeom.rasterize(jgeom.from_wkt(GEOMS[kind]), 61, 62, to_px,
                         all_touched=True)
    mt = tgeom.rasterize(tgeom.from_wkt(GEOMS[kind]), 61, 62, to_px,
                         all_touched=True)
    assert mt.dtype == np.uint8 and mt.any()
    np.testing.assert_array_equal(mt, mj)


@pytest.mark.parametrize("kind", ["polygon", "hole", "multipolygon",
                                  "point"])
@pytest.mark.parametrize("steps", [(0.15, 0.1), (0.25, 0.0), (0.0, 0.0)])
def test_tiled_geometries_identical(kind, steps):
    assert tdrill.tiled_geometries(GEOMS[kind], *steps) == \
        jdrill.tiled_geometries(GEOMS[kind], *steps)


EXPRS = ["a + b", "(a - b) / (a + b)", "a > 50 ? a : -b", "a % 7 - b % -3",
         "sqrt(abs(b)) + log10(a + 1) * exp(-a / 100)",
         "max(a, b) - min(a, 2) + pow(a, 0.5)", "!(a > b) || a == b",
         "a ** 2 / 3 && b", "floor(a / 3) + ceil(b) + sin(a) * cos(b)",
         "-a / 0"]


# calls the port evaluates with numpy's float64 libm and the reference
# with XLA's float64 kernels: equal within 2 ulp, not always to the bit
_TRANSCENDENTAL = ("sqrt", "log", "exp", "sin", "cos", "pow", "**")


@pytest.mark.parametrize("src", EXPRS)
def test_expression_evaluation_identical(src):
    rng = np.random.default_rng(8)
    arrs = {"a": rng.uniform(0, 120, 64), "b": rng.uniform(-5, 120, 64)}
    scalars = [{k: np.float64(v[i]) for k, v in arrs.items()}
               for i in range(8)]
    with np.errstate(all="ignore"):
        got = [np.asarray(texpr.compile_expr(src)(env))
               for env in scalars + [arrs]]
        want = [np.asarray(jexpr.compile_expr(src)(env, xp=np))
                for env in scalars + [arrs]]
    for g, w in zip(got, want):
        if any(f in src for f in _TRANSCENDENTAL):
            np.testing.assert_array_almost_equal_nulp(g, w, nulp=2)
        else:
            np.testing.assert_array_equal(g, w)


def test_expression_over_torch_is_not_ported():
    # evaluation over torch tensors is ported (tests/test_torch_mosaic.py
    # holds it against JAX); an array module other than numpy or torch
    # is refused
    got = texpr.compile_expr("a + 1")({"a": torch.ones(2)}, xp=torch)
    assert torch.equal(got, torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="array module"):
        texpr.compile_expr("a + 1")({"a": np.ones(2)}, xp=jnp)


# ---------------------------------------------------------------------------
# the drill as a whole
# ---------------------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Counts the JAX run's B3 (Pallas) calls and the port's B3 calls."""
    calls = {"pallas": 0, "plain": 0}
    pallas, plain = jpt.masked_stats_pallas, tstats.masked_stats_plain

    def jspy(*a, **k):
        calls["pallas"] += 1
        return pallas(*a, **k)

    def tspy(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(jpt, "masked_stats_pallas", jspy)
    monkeypatch.setattr(tstats, "masked_stats_plain", tspy)
    return calls


CASES = {
    "exact": dict(bands=["a"]),
    "two_files_two_vars": dict(bands=["a", "b"]),
    "clip": dict(bands=["a", "b"], clip_lower=20.0, clip_upper=61.5),
    "pixel_count": dict(bands=["a"], clip_lower=30.0, clip_upper=70.0,
                        pixel_count=True),
    "deciles": dict(bands=["a"], deciles=9),
    "band_strides": dict(bands=["a", "b"], band_strides=3, deciles=3),
    "expression": dict(bands=["ratio = a / (a + b) * 100", "b"]),
    "tiling": dict(bands=["a"], index_tile_x_size=0.3,
                   index_tile_y_size=0.25),
    "time_window": dict(bands=["b"], start_time=T0 + 100 * 86400.0,
                        end_time=T0 + 400 * 86400.0),
    "int16_clip": dict(bands=["c", "d"], clip_lower=0.0, clip_upper=60.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_drill_matches_reference(archive, spies, case):
    jp, tp = _pipelines(archive)
    jreq, treq = _requests(archive, **CASES[case])
    jres, tres = jp.process(jreq), tp.process(treq)
    assert jres.dates
    _assert_same(jres, tres)
    if CASES[case].get("pixel_count"):
        assert spies["pallas"] == 0 and spies["plain"] == 0
    else:
        # both ran the resident-stack path through B3
        assert spies["pallas"] >= 1 and spies["plain"] >= 1


def test_process_split_matches_reference(archive, spies):
    jp, tp = _pipelines(archive)
    jreq, treq = _requests(archive, bands=["a"], start_time=T0,
                           end_time=T0 + 700 * 86400.0)
    jres = jp.process_split(jreq, year_step=1)
    tres = tp.process_split(treq, year_step=1)
    _assert_same(jres, tres)
    assert len(tres.dates) == 44 and spies["plain"] >= 2


def test_approx_fast_path_matches_reference(archive, spies):
    jp, tp = _pipelines(archive)
    jreq, treq = _requests(archive, bands=["a", "c"], approx=True)
    _assert_same(jp.process(jreq), tp.process(treq), exact=True)
    assert spies["plain"] == 0 and spies["pallas"] == 0


@pytest.mark.parametrize("cache_mode", ["0", "sync"])
def test_integer_drill_exact_and_csv_identical(archive, monkeypatch,
                                               cache_mode):
    monkeypatch.setenv("GSKY_DRILL_CACHE", cache_mode)
    jp, tp = _pipelines(archive)
    jreq, treq = _requests(archive, bands=["c", "d", "s = c + d"])
    jres, tres = jp.process(jreq), tp.process(treq)
    _assert_same(jres, tres, exact=True)
    assert tdrill.drill_csv(tres) == jdrill.drill_csv(jres)
    assert tdrill.drill_csv(tres, ["s", "c"]) == \
        jdrill.drill_csv(jres, ["s", "c"])


def test_cold_host_path_bit_exact(archive, monkeypatch):
    monkeypatch.setenv("GSKY_DRILL_CACHE", "0")
    jp, tp = _pipelines(archive)
    jreq, treq = _requests(archive, bands=["a", "b"], deciles=9,
                           clip_lower=10.0)
    _assert_same(jp.process(jreq), tp.process(treq), exact=True)


def test_async_cold_then_warm(archive, spies, monkeypatch):
    """Default mode: the first request reads from the host while the
    stack uploads; after wait_idle the same request runs through B3 and
    agrees with the cold answer."""
    monkeypatch.delenv("GSKY_DRILL_CACHE")
    cache = tDC.DrillStackCache(device="cpu")
    _, tp = _pipelines(archive, cache)
    _, treq = _requests(archive, bands=["a"])
    cold = tp.process(treq)
    assert spies["plain"] == 0
    assert cache.wait_idle(60)
    warm = tp.process(treq)
    assert spies["plain"] == 2 and cache.hits == 2
    _assert_same(cold, warm)
    assert tp.spans["host"] > 0 and tp.spans["gather"] > 0


def test_drill_device_on_carried_reference_stack(archive):
    """The reference's resident stack carried into the port: both
    `_drill_device`s over one stack, mask and timestep selection."""
    path = archive["paths"][2]
    jst = jDC.DrillStackCache().get(path, True, "c", 1, -1.0)
    tst = drill_stack_from_numpy(np.asarray(jst.dev), jst.nodata, "cpu")
    assert tst.dev.dtype == torch.int16 and tst.shape == jst.shape
    mask = tgeom.rasterize(tgeom.from_wkt(GEOMS["hole"]), 40, 40,
                           lambda x, y: GeoTransform(
                               140.05, RES, 0, -30.03, 0, -RES)
                           .geo_to_pixel(x, y))
    sel, read_idx = list(range(0, 48, 2)), list(range(24))
    jreq, treq = _requests(archive, bands=["c"], deciles=3,
                           clip_upper=80.0)
    win = (5, 3, 45, 43)
    vj, cj, dj = jdrill._drill_device(jst, sel, read_idx, mask, win, jreq)
    vt, ct, dt_ = tdrill._drill_device(tst, sel, read_idx, mask, win, treq)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(vt, vj)      # integer sums below 2**24
    assert (dt_ == dj).all()


class TestDrillStackCache:
    def test_reuse_eviction_and_caps(self, archive):
        nc = archive["paths"][0]
        cache = tDC.DrillStackCache(device="cpu")
        s1 = cache.get(nc, True, "a", 1, None)
        assert s1.shape == (T, H, W) and s1.dev.dtype == torch.float32
        assert cache.get(nc, True, "a", 1, None).serial == s1.serial
        tiny = tDC.DrillStackCache(device="cpu", max_item_bytes=16)
        assert tiny.get(nc, True, "a", 1, None) is None
        assert tiny.get(nc, True, "a", 1, None) is None
        assert tiny.hits == 1 and tiny.misses == 1
        small = tDC.DrillStackCache(device="cpu", max_bytes=s1.nbytes + 1)
        a = small.get(nc, True, "a", 1, None)
        assert small.get(nc, True, "b", 1, None) is not None
        assert small.get(nc, True, "a", 1, None).serial != a.serial

    def test_64bit_refused_and_uint16_widened(self, tmp_path):
        x, y = _grid(150.0, -20.0, w=7, h=5)
        p = str(tmp_path / "types.nc")
        write_netcdf3(p, {"f8": np.ones((2, 5, 7)),
                          "u2": np.full((2, 5, 7), 65000, np.uint16)},
                      x, y, EPSG4326, times=TIMES[:2])
        cache = tDC.DrillStackCache(device="cpu")
        assert cache.get(p, True, "f8", 1, None) is None
        st = cache.get(p, True, "u2", 1, None)
        assert st.dev.dtype == torch.int32 and st.np_dtype == np.uint16
        assert int(st.dev.max()) == 65000

    def test_async_miss_then_hit(self, archive):
        nc = archive["paths"][1]
        cache = tDC.DrillStackCache(device="cpu")
        assert cache.get_async(nc, True, "b", 1, None) is None
        assert cache.wait_idle(30)
        assert cache.get_async(nc, True, "b", 1, None) is not None
        assert cache.hits == 1 and cache.misses == 1
        cache.clear()
        assert cache.get_async(nc, True, "b", 1, None) is None
        assert cache.wait_idle(30)

    def test_background_failure_raises_not_falls_back(self, archive,
                                                      monkeypatch):
        cache = tDC.DrillStackCache(device="cpu")

        def boom(*a):
            raise MemoryError("device full")

        monkeypatch.setattr(cache, "_load", boom)
        assert cache.get_async(archive["paths"][0], True, "a", 1,
                               None) is None
        with pytest.raises(RuntimeError, match="upload failed"):
            cache.wait_idle(30)
        with pytest.raises(MemoryError):
            cache.get(archive["paths"][0], True, "a", 1, None)

    def test_one_cache_per_device(self):
        assert tDC.for_device("cpu") is tDC.for_device(torch.device("cpu"))


def test_times_match_identical(archive):
    kw = dict(srs="EPSG:4326", wkt=POLY)
    key = lambda d: (d.file_path, d.namespace)        # noqa: E731
    j = sorted(JMASClient(archive["jstore"]).intersects(archive["root"],
                                                        **kw), key=key)
    t = sorted(MASClient(archive["tstore"]).intersects(archive["root"],
                                                       **kw), key=key)
    assert [key(d) for d in j] == [key(d) for d in t]
    j[1].timestamps, t[1].timestamps = j[1].timestamps[:3], \
        t[1].timestamps[:3]
    j[2].timestamps, t[2].timestamps = [1.0], [1.0]
    for a in range(3):
        for b in range(3):
            assert tdrill._times_match(t[a], t[b]) == \
                jdrill._times_match(j[a], j[b])


def test_unported_branches_raise(archive, monkeypatch):
    # GSKY_SPMD=1 with one mesh member (GSKY_CPU_DEVICES unset) serves
    # the drill single-device, as the reference's does on a one-device
    # host: its one-device path is its GSKY_SPMD=0 path
    jp, tp = _pipelines(archive)
    jreq, treq = _requests(archive, bands=["a", "b"])
    monkeypatch.delenv("GSKY_CPU_DEVICES", raising=False)
    monkeypatch.delenv("GSKY_MESH_DEVICES", raising=False)
    monkeypatch.setenv("GSKY_SPMD", "1")
    tres = tp.process(treq)
    monkeypatch.delenv("GSKY_SPMD")
    _assert_same(jp.process(jreq), tres)
    # a VRT drill is served: an expression over the data granule and
    # its co-registered mask granule (``a``, of the float32 file on the
    # same tile), reduced on the host in both packages
    vrt = ('<VRTDataset><VRTRasterBand band="1" dataType="Float32">'
           '<PixelFunctionType>e</PixelFunctionType>'
           '<PixelFunctionLanguage>expression</PixelFunctionLanguage>'
           '<PixelFunctionCode>b1 * 2 + b2</PixelFunctionCode>'
           '<SimpleSource metadata-template="1">'
           '<SourceFilename>{{ .Data.Path }}</SourceFilename>'
           '</SimpleSource>{{ range g := .Masks }}<SimpleSource>'
           '<SourceFilename>{{ g.Path }}</SourceFilename></SimpleSource>'
           '{{ end }}</VRTRasterBand></VRTDataset>')
    jp, tp = _pipelines(archive)
    jreq, treq = _requests(archive, bands=["c"], vrt_xml=vrt,
                           mask_namespaces=["a"])
    jres, tres = jp.process(jreq), tp.process(treq)
    _assert_same(jres, tres, exact=True)
    assert len(tres.dates) == T and max(tres.counts["c"]) > 0


def test_drill_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdrill.DrillPipeline(MASClient(MASStore()))
    with pytest.raises(RuntimeError, match="CUDA"):
        tDC.DrillStackCache()


def test_drill_modules_and_smoke_import_no_jax():
    """Every module of the port and chip_smoke.py import nothing of JAX
    or of the JAX package, nor aiohttp, which the card machine does not
    have, and PIL only inside a function (the adapter tier opens an
    image with it, so a host without it imports every module; static
    check of their import statements)."""
    files = ["chip_smoke.py"] + sorted(
        os.path.relpath(os.path.join(d, f), REPO)
        for d, _, fs in os.walk(os.path.join(REPO, "gsky_tpu_torch"))
        for f in fs if f.endswith(".py"))
    assert len(files) > 40
    for f in files:
        tree = ast.parse(open(os.path.join(REPO, f)).read())
        in_function = {id(n) for fn in ast.walk(tree)
                       if isinstance(fn, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                       for n in ast.walk(fn)}
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "gsky_tpu",
                                    "aiohttp"), (f, n)
                assert root != "PIL" or id(node) in in_function, (f, n)
