"""Port parity, formats tier: the GMT and HDF4 readers and writers, the
format registry (its native tier and its adapter tier: images with ESRI
world files through PIL), the VRT reader and the crawler records of the
archive families the port serves (GMT, HDF4 / HDF-EOS, Albers GeoTIFF,
CF geostationary and Lambert NetCDF, curvilinear swaths, JP2 and PNG),
against the JAX package on the same seeded inputs; a GetMap over a JP2
through both packages.

Both packages' writers emit the same bytes; both readers return the
same arrays, georeferencing and nodata (exact); the crawler records are
equal dicts.  Every corrupt-file case of the reference's
`tests/test_formats.py::TestHDF4Corrupt` raises, or terminates, alike in
both packages.  The port imports ``h5py`` only where it opens an HDF5
file: no module does it at import time."""

import ast
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from gsky_tpu.geo.crs import CRS_SINU_MODIS as JSINU
from gsky_tpu.geo.crs import EPSG4326 as J4326
from gsky_tpu.geo.transform import GeoTransform as JGT
from gsky_tpu.index import rulesets as jrulesets
from gsky_tpu.index.crawler import extract as jextract
from gsky_tpu.io import gmt as jgmt
from gsky_tpu.io import hdf4 as jhdf4
from gsky_tpu.io import registry as jregistry
from gsky_tpu.io import vrt as jvrt
from gsky_tpu.io.geotiff import write_geotiff as jwrite_geotiff

from gsky_tpu_torch.geo.crs import CRS_SINU_MODIS, EPSG4326
from gsky_tpu_torch.geo.transform import GeoTransform
from gsky_tpu_torch.index.crawler import extract
from gsky_tpu_torch.io import gmt as tgmt
from gsky_tpu_torch.io import hdf4 as thdf4
from gsky_tpu_torch.io import registry as tregistry
from gsky_tpu_torch.io import vrt as tvrt
from gsky_tpu_torch.io.geotiff import write_geotiff
from gsky_tpu_torch.io.netcdf import write_netcdf3_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_builtin_rule(path):
    """Fixture names match no built-in product rule: a matching rule
    would rewrite the record's timestamps, namespaces or SRS, and these
    tests hold each format's own extractor against the reference's."""
    rule, _ = jrulesets.match_rule(path, None)
    assert rule is None or rule.collection == "default", (path, rule)


# ---------------------------------------------------------------------------
# GMT
# ---------------------------------------------------------------------------

def _gmt_data(seed=3, H=48, W=64, dtype=np.float32):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 10.0, (H, W)).astype(dtype)
    if data.dtype.kind == "f":
        data[0, 0] = np.nan                      # a GMT hole
        data[7, 9:14] = np.nan
    return data


@pytest.mark.parametrize("node_offset", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_gmt_writers_identical_and_readers_equal(tmp_path, node_offset,
                                                 dtype):
    data = _gmt_data(dtype=dtype)
    pj, pt = str(tmp_path / "j.grd"), str(tmp_path / "t.grd")
    jgmt.write_gmt(pj, data, (148.0, 148.64), (-35.48, -35.0),
                   node_offset=node_offset)
    tgmt.write_gmt(pt, data, (148.0, 148.64), (-35.48, -35.0),
                   node_offset=node_offset)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert tgmt.is_gmt(pt) and jgmt.is_gmt(pt)
    with tgmt.GMTGrid(pt) as t, jgmt.GMTGrid(pt) as j:
        assert (t.width, t.height) == (j.width, j.height) == (64, 48)
        assert t.gt.to_gdal() == j.gt.to_gdal()
        assert t.dtype == j.dtype
        assert (t.nodata is None) == (j.nodata is None)
        assert t.overviews == ()
        for win in (None, (0, 0, 64, 48), (8, 4, 16, 12), (0, 10, 64, 5),
                    (63, 47, 1, 1)):
            a, b = t.read(1, win), j.read(1, win)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.read(1), data)


def test_gmt_rejects_what_the_reference_rejects(tmp_path):
    p = str(tmp_path / "plain.nc")
    write_netcdf3_raw(p, [("n", 4)], [("v", ("n",), {},
                                       np.arange(4, dtype=np.float32))], {})
    assert not tgmt.is_gmt(p) and not jgmt.is_gmt(p)
    for mod in (tgmt, jgmt):
        with pytest.raises(ValueError, match="not a GMT grid"):
            mod.GMTGrid(p)
    bad = str(tmp_path / "bad.grd")
    write_netcdf3_raw(bad, [("side", 2), ("xysize", 4)], [
        ("dimension", ("side",), {}, np.asarray([9, 9], np.int32)),
        ("z", ("xysize",), {}, np.zeros(4, np.float32))], {})
    for mod in (tgmt, jgmt):
        with pytest.raises(ValueError, match="too small"):
            mod.GMTGrid(bad)


# ---------------------------------------------------------------------------
# HDF4
# ---------------------------------------------------------------------------

def _modis_arrays(seed=9, H=96, W=80):
    rng = np.random.default_rng(seed)
    ndvi = rng.uniform(-2000, 10000, (H, W)).astype(np.int16)
    ndvi[:8, :8] = -3000                      # fill region
    evi = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    qa = rng.integers(0, 65535, (H, W)).astype(np.uint16)
    return {"250m NDVI": ndvi, "250m EVI": evi, "250m QA": qa}


def _write_modis(mod, path, compress, sinu=True):
    arrays = _modis_arrays()
    if sinu:
        crs = JSINU if mod is jhdf4 else CRS_SINU_MODIS
        x0, y0 = crs.from_lonlat(148.0, -35.0)
        GT = JGT if mod is jhdf4 else GeoTransform
        gt = GT(float(x0), 463.3127165, 0.0, float(y0), 0.0, -463.3127165)
    else:
        crs = None
        GT = JGT if mod is jhdf4 else GeoTransform
        gt = GT(148.0, 0.25, 0.0, -35.0, 0.0, -0.5)
    mod.write_hdf4(path, arrays, gt=gt, crs=crs,
                   fills={"250m NDVI": -3000.0}, compress=compress)
    return arrays


@pytest.mark.parametrize("sinu", [True, False], ids=["snsoid", "geo"])
@pytest.mark.parametrize("compress", [None, "deflate"])
def test_hdf4_writers_identical_and_readers_equal(tmp_path, compress, sinu):
    pj, pt = str(tmp_path / "j.hdf"), str(tmp_path / "t.hdf")
    _write_modis(jhdf4, pj, compress, sinu)
    arrays = _write_modis(thdf4, pt, compress, sinu)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert thdf4.is_hdf4(pt)
    with thdf4.HDF4(pt) as t, jhdf4.HDF4(pt) as j:
        assert [s.name for s in t.sds] == [s.name for s in j.sds] \
            == list(arrays)
        assert [s.dims for s in t.sds] == [s.dims for s in j.sds]
        assert [s.fill for s in t.sds] == [s.fill for s in j.sds]
        assert (t.width, t.height, t.nodata, t.bands) == \
            (j.width, j.height, j.nodata, j.bands)
        assert t.gt.to_gdal() == j.gt.to_gdal()
        assert t.crs.to_proj4() == j.crs.to_proj4()
        assert t.global_attrs.keys() == j.global_attrs.keys()
        assert t.global_attrs["StructMetadata.0"] == \
            j.global_attrs["StructMetadata.0"]
        for b, (name, arr) in enumerate(arrays.items(), start=1):
            assert t.nodata_for(b) == j.nodata_for(b)
            for win in (None, (10, 20, 30, 40), (79, 95, 1, 1)):
                a, r = t.read(b, win), j.read(b, win)
                assert a.dtype == r.dtype
                np.testing.assert_array_equal(a, r)
            np.testing.assert_array_equal(t.read(b), arr)


def test_hdf4_struct_metadata_parse_equal():
    texts = [
        "XDim=2400\nYDim=2400\nUpperLeftPointMtrs=(13343406.236,"
        "-3335851.559)\nLowerRightMtrs=(14455356.755,-4447802.079)\n"
        "Projection=GCTP_SNSOID\n",
        "XDim=4\nYDim=3\nUpperLeftPointMtrs=(148000000.000,-35000000.000)"
        "\nLowerRightMtrs=(149000000.000,-36030000.000)\n"
        "Projection=GCTP_GEO\n",
        "XDim=4\nYDim=3\nUpperLeftPointMtrs=(1,2)\nLowerRightMtrs=(3,4)\n"
        "Projection=GCTP_UTM\n",
        "no grid here",
    ]
    for text in texts:
        t = thdf4.parse_struct_metadata(text)
        j = jhdf4.parse_struct_metadata(text)
        assert (t is None) == (j is None)
        if t is not None:
            assert t[0].to_gdal() == j[0].to_gdal()
            assert t[1].to_proj4() == j[1].to_proj4()
            assert t[2] == j[2]


def _corrupt_cycle(path, mod):
    with open(path, "r+b") as fp:
        fp.seek(4 + 2)
        fp.write(struct.pack(">I", 4))        # next-block -> itself
    with mod.HDF4(path) as h:                 # terminates, no hang
        return h.bands


def _corrupt_truncated(path, mod):
    raw = open(path, "rb").read()
    with open(path, "wb") as fp:
        fp.write(raw[:40])
    h = mod.HDF4(path)                        # opens; elements bounded
    assert all(o + ln <= 40 for _, _, o, ln in h._raw.dds)
    n = h.bands
    h.close()
    return n


def _corrupt_oversize_dims(path, mod):
    h = mod.HDF4(path)
    off = next(o for t, r, o, ln in h._raw.dds if t == mod.DFTAG_SDD)
    h.close()
    with open(path, "r+b") as fp:
        fp.seek(off + 2)
        fp.write(struct.pack(">i", 1 << 30))
    with mod.HDF4(path) as h2:
        assert h2.bands == 1
        h2.read(1)                            # dims exceed the element


def _corrupt_zero_length(path, mod):
    h = mod.HDF4(path)
    off = next(o for t, r, o, ln in h._raw.dds if t & 0x4000 and ln >= 14)
    h.close()
    with open(path, "r+b") as fp:
        fp.seek(off)
        (code,) = struct.unpack(">H", fp.read(2))
        assert code == mod.SPECIAL_COMP
        fp.seek(off + 4)
        fp.write(struct.pack(">I", 0))
    with mod.HDF4(path) as h2:
        h2.read(1)                            # 0 bytes can't fill 64x64


def _corrupt_truncated_deflate(path, mod):
    h = mod.HDF4(path)
    off, ln = next((o, ln) for t, r, o, ln in h._raw.dds
                   if t == mod.DFTAG_COMPRESSED)
    h.close()
    with open(path, "r+b") as fp:             # zero the payload's tail
        fp.seek(off + ln // 2)
        fp.write(b"\x00" * (ln - ln // 2))
    with mod.HDF4(path) as h2:
        h2.read(1)


def _corrupt_not_hdf4(path, mod):
    with open(path, "wb") as fp:
        fp.write(b"not an hdf file at all")
    assert not mod.is_hdf4(path)
    mod.HDF4(path)


def _corrupt_unsupported_special(path, mod):
    h = mod.HDF4(path)
    off = next(o for t, r, o, ln in h._raw.dds if t & 0x4000 and ln >= 14)
    h.close()
    with open(path, "r+b") as fp:             # SPECIAL_LINKED
        fp.seek(off)
        fp.write(struct.pack(">H", mod.SPECIAL_LINKED))
    with mod.HDF4(path) as h2:
        h2.read(1)


def _corrupt_unsupported_codec(path, mod):
    h = mod.HDF4(path)
    off = next(o for t, r, o, ln in h._raw.dds if t & 0x4000 and ln >= 14)
    h.close()
    with open(path, "r+b") as fp:             # comp_type 1 (RLE)
        fp.seek(off + 12)
        fp.write(struct.pack(">H", 1))
    with mod.HDF4(path) as h2:
        h2.read(1)


# (case, deflate-compressed base file, expected: "ok" or the ValueError
# message pattern)
CORRUPT = [
    (_corrupt_cycle, False, "ok"),
    (_corrupt_truncated, False, "ok"),
    (_corrupt_oversize_dims, False, "exceed"),
    (_corrupt_zero_length, True, "exceed its 0-byte"),
    (_corrupt_truncated_deflate, True, "deflate|compressed element"),
    (_corrupt_not_hdf4, False, "not an HDF4 file"),
    (_corrupt_unsupported_special, True, "special element"),
    (_corrupt_unsupported_codec, True, "compression"),
]


@pytest.mark.parametrize("case,deflate,expect", CORRUPT,
                         ids=[c[0].__name__[9:] for c in CORRUPT])
def test_hdf4_corrupt_files_alike(tmp_path, case, deflate, expect):
    """Each corrupt file fails fast, or degrades, the same way in both
    packages: the reference's TestHDF4Corrupt cases plus the
    unsupported-storage errors."""
    out = {}
    for name, mod in (("jax", jhdf4), ("port", thdf4)):
        p = str(tmp_path / f"{name}.hdf")
        mod.write_hdf4(p, {"v": np.arange(4096, dtype=np.float32)
                           .reshape(64, 64)},
                       compress="deflate" if deflate else None)
        if expect == "ok":
            out[name] = case(p, mod)
        else:
            with pytest.raises(ValueError, match=expect):
                case(p, mod)
    if expect == "ok":
        assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_dispatch_equal(tmp_path):
    data = _gmt_data()
    pg = str(tmp_path / "relief.grd")
    tgmt.write_gmt(pg, data, (148.0, 148.64), (-35.48, -35.0))
    ph = str(tmp_path / "swath.hdf")
    _write_modis(thdf4, ph, "deflate")
    pt = str(tmp_path / "albers.tif")
    write_geotiff(pt, data, GeoTransform(1.5e6, 25.0, 0, -3.9e6, 0, -25.0),
                  EPSG4326, nodata=-1.0)
    for p, cls in ((pg, tgmt.GMTGrid), (ph, thdf4.HDF4)):
        h, r = tregistry.open_raster(p), jregistry.open_raster(p)
        assert isinstance(h, cls)
        assert type(r).__name__ == cls.__name__
        assert (h.width, h.height, h.nodata) == (r.width, r.height, r.nodata) \
            or np.isnan(h.nodata) and np.isnan(r.nodata)
        np.testing.assert_array_equal(h.read(1, (3, 2, 20, 11)),
                                      r.read(1, (3, 2, 20, 11)))
        h.close()
        r.close()
    h = tregistry.open_raster(pt)
    assert type(h).__name__ == "GeoTIFF"
    h.close()
    assert tregistry.formats() == ["geotiff", "gmt", "hdf4", "pil-image"]
    assert tregistry.formats() == jregistry.formats()


def test_registry_unknown_magic_and_custom_format(tmp_path):
    p = str(tmp_path / "mystery.bin")
    with open(p, "wb") as fp:
        fp.write(b"FAKE\x00\x01\x02\x03 not a raster")
    for reg in (tregistry, jregistry):
        with pytest.raises(ValueError, match="no registered reader"):
            reg.open_raster(p)
    with pytest.raises(ValueError, match="cannot read"):
        tregistry.open_raster(str(tmp_path / "missing.tif"))

    class Fake:
        width = height = 1
        nodata = None
        overviews = ()

        def read(self, band=1, window=None):
            return np.zeros((1, 1), np.float32)

        def close(self):
            pass

    tregistry.register("fake-fmt", lambda path, magic: magic[:4] == b"FAKE",
                       lambda path: Fake())
    try:
        assert isinstance(tregistry.open_raster(p), Fake)
        tregistry.register("first", lambda path, magic: True,
                           lambda path: "first", prepend=True)
        assert tregistry.open_raster(p) == "first"
    finally:
        tregistry._formats[:] = [e for e in tregistry._formats
                                 if e[0] not in ("fake-fmt", "first")]
    assert tregistry.formats() == jregistry.formats()


# ---------------------------------------------------------------------------
# crawler records of the new families
# ---------------------------------------------------------------------------

def _cf_geos_nc(path, H=60, W=80):
    """A Himawari-shaped full-disk fragment: CF ``geostationary`` grid
    mapping, x/y in metres, f32 with a fill value."""
    rng = np.random.default_rng(5)
    x = -5.0e5 + 2000.0 * (np.arange(W) + 0.5)
    y = -3.0e6 - 2000.0 * (np.arange(H) + 0.5)
    band = rng.uniform(200, 320, (H, W)).astype(np.float32)
    band[:3] = -999.0
    write_netcdf3_raw(path, [("y", H), ("x", W)], [
        ("x", ("x",), {"standard_name": "projection_x_coordinate"}, x),
        ("y", ("y",), {"standard_name": "projection_y_coordinate"}, y),
        ("geostationary", (), {
            "grid_mapping_name": "geostationary",
            "perspective_point_height": 35785863.0,
            "longitude_of_projection_origin": 140.7,
            "sweep_angle_axis": "y", "semi_major_axis": 6378137.0,
            "inverse_flattening": 298.257223563},
         np.zeros((), np.int32)),
        ("tbb_13", ("y", "x"), {"grid_mapping": "geostationary",
                                "_FillValue": np.float32(-999.0)}, band),
    ], {"Conventions": "CF-1.6"})


def _cf_lcc_nc(path, H=40, W=50):
    rng = np.random.default_rng(6)
    x = 1.0e6 + 5000.0 * (np.arange(W) + 0.5)
    y = 2.0e6 - 5000.0 * (np.arange(H) + 0.5)
    write_netcdf3_raw(path, [("y", H), ("x", W)], [
        ("x", ("x",), {"standard_name": "projection_x_coordinate"}, x),
        ("y", ("y",), {"standard_name": "projection_y_coordinate"}, y),
        ("lambert", (), {
            "grid_mapping_name": "lambert_conformal_conic",
            "standard_parallel": np.array([-30.0, -20.0]),
            "longitude_of_central_meridian": 135.0,
            "latitude_of_projection_origin": -25.0,
            "false_easting": 1.0e6, "false_northing": 2.0e6},
         np.zeros((), np.int32)),
        ("temp", ("y", "x"), {"grid_mapping": "lambert"},
         rng.normal(290, 5, (H, W)).astype(np.float32)),
    ], {})


def _swath_nc(path, H=50, W=40):
    ii, jj = np.mgrid[0:H, 0:W].astype(np.float64)
    lon = 147.0 + 0.004 * jj + 0.0012 * ii
    lat = -34.0 - 0.003 * ii + 0.0004 * jj
    write_netcdf3_raw(path, [("y", H), ("x", W)], [
        ("lon", ("y", "x"), {"standard_name": "longitude"}, lon),
        ("lat", ("y", "x"), {"standard_name": "latitude"}, lat),
        ("bt", ("y", "x"), {"_FillValue": np.float32(-9999.0)},
         (ii * 3 + jj).astype(np.float32)),
    ], {})


def _archive_files(root):
    """One file of every family; names carry a date and match no
    built-in crawler ruleset."""
    files = {}
    p = os.path.join(root, "relief_20200110.grd")
    tgmt.write_gmt(p, _gmt_data(), (148.0, 148.64), (-35.48, -35.0))
    files["gmt"] = p
    p = os.path.join(root, "gmt_gridline_20200111.nc")
    tgmt.write_gmt(p, _gmt_data(seed=4), (148.0, 148.64), (-35.48, -35.0),
                   node_offset=0)
    files["gmt_nc"] = p
    p = os.path.join(root, "vi_tile.A2020017.h29v12.hdf")
    _write_modis(thdf4, p, "deflate")
    files["hdf4_sinu"] = p
    p = os.path.join(root, "vi_geo_20200112.hdf")
    _write_modis(thdf4, p, None, sinu=False)
    files["hdf4_geo"] = p
    p = os.path.join(root, "dea_albers_20200113.tif")
    write_geotiff(p, _gmt_data(dtype=np.int16),
                  GeoTransform(1.5e6, 25.0, 0.0, -3.9e6, 0.0, -25.0),
                  __import__("gsky_tpu_torch.geo.crs", fromlist=["x"])
                  .EPSG3577, nodata=-999.0)
    files["albers"] = p
    p = os.path.join(root, "ahi_fd_20200114.nc")
    _cf_geos_nc(p)
    files["geos"] = p
    p = os.path.join(root, "lcc_20200115.nc")
    _cf_lcc_nc(p)
    files["lcc"] = p
    p = os.path.join(root, "swath_20200116.nc")
    _swath_nc(p)
    files["swath"] = p
    p = os.path.join(root, "unknown_20200117.bin")
    with open(p, "wb") as fp:
        fp.write(b"\x00\x01\x02\x03" * 8)
    files["unknown"] = p
    return files


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _archive_files(str(tmp_path_factory.mktemp("formats")))


@pytest.mark.parametrize("approx_stats", [False, True])
@pytest.mark.parametrize("family", ["gmt", "gmt_nc", "hdf4_sinu",
                                    "hdf4_geo", "albers", "geos", "lcc",
                                    "swath", "unknown"])
def test_crawler_record_equals_reference(files, family, approx_stats):
    p = files[family]
    _no_builtin_rule(p)
    t = extract(p, approx_stats=approx_stats)
    j = jextract(p, approx_stats=approx_stats)
    if family == "unknown":
        # the error lists the registered formats, the adapter tier's too
        assert t == j and t["geo_metadata"] == []
        assert "'pil-image']" in t["error"]
        return
    assert t == j
    assert not t.get("error"), t
    kind = {"gmt": "GMT", "gmt_nc": "GMT", "hdf4_sinu": "HDF4",
            "hdf4_geo": "HDF4", "albers": "GeoTIFF"}.get(family, "NetCDF")
    assert t["file_type"] == kind
    md = t["geo_metadata"]
    if family == "hdf4_sinu":
        assert [d["namespace"] for d in md] == ["250m_NDVI", "250m_EVI",
                                                "250m_QA"]
        assert "+proj=sinu" in md[0]["proj4"]
    if family == "albers":
        assert "+proj=aea" in md[0]["proj4"]
    if family == "geos":
        assert "+proj=geos" in md[0]["proj4"]
    if family == "swath":
        assert md[0]["geo_loc"]["x_var"] == "lon"


# ---------------------------------------------------------------------------
# VRT
# ---------------------------------------------------------------------------

VRT_TEMPLATE = """<VRTDataset rasterXSize="{{ .RasterXSize }}" \
rasterYSize="{{ .RasterYSize }}">
    <VRTRasterBand band="1" subClass="VRTDerivedRasterBand">
        <PixelFunctionType>apply_masks</PixelFunctionType>
        <PixelFunctionLanguage>python</PixelFunctionLanguage>
        <PixelFunctionCode><![CDATA[
def apply_masks(in_ar, out_ar, xoff, yoff, xsize, ysize, raster_xsize,
    raster_ysize, buf_radius, gt, **kwargs):
  masks = (in_ar[1] == 1) & (in_ar[2] == 1)
  in_ar[0][~masks] = -999
  out_ar[:] = in_ar[0]
        ]]>
        </PixelFunctionCode>
        <SimpleSource  metadata-template="1">
            <SourceFilename>{{ .Data.Path }}</SourceFilename>
        </SimpleSource>
        {{ range g := .Masks }}
        <SimpleSource>
            <SourceFilename>{{ g.Path }}</SourceFilename>
        </SimpleSource>
        {{ end }}
    </VRTRasterBand>
</VRTDataset>"""


def vrt_archive(root):
    """Data and two mask granules on a shared EPSG:4326 grid (known
    values): the reference's `tests/test_worker.py` VRT fixture."""
    os.makedirs(root, exist_ok=True)
    gt = JGT(148.0, 0.01, 0.0, -35.0, 0.0, -0.01)
    data = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    m1 = np.zeros((64, 64), np.int16)
    m1[:, :32] = 1                      # left half passes mask 1
    m2 = np.zeros((64, 64), np.int16)
    m2[:32, :] = 1                      # top half passes mask 2
    paths = {}
    for name, arr, nd in (("veg_data", data, -999.0),
                          ("qmask1", m1, None), ("qmask2", m2, None)):
        p = os.path.join(root, f"{name}.tif")
        jwrite_geotiff(p, arr, gt, J4326, nodata=nd)
        paths[name] = p
    return paths, data, m1, m2


def _expr_vrt(paths, size=""):
    return (f'<VRTDataset{size}>'
            f'<VRTRasterBand band="1" dataType="Float32">'
            f'<PixelFunctionType>expr</PixelFunctionType>'
            f'<PixelFunctionLanguage>expression</PixelFunctionLanguage>'
            f'<PixelFunctionCode>b1 * b2 + b3 / 2</PixelFunctionCode>'
            f'<SimpleSource metadata-template="1">'
            f'<SourceFilename>{paths["veg_data"]}</SourceFilename>'
            f'</SimpleSource>'
            f'<SimpleSource><SourceFilename>{paths["qmask1"]}'
            f'</SourceFilename></SimpleSource>'
            f'<SimpleSource><SourceFilename>{paths["qmask2"]}'
            f'</SourceFilename></SimpleSource>'
            f'</VRTRasterBand></VRTDataset>')


@pytest.mark.parametrize("kind", ["python", "expression",
                                  "expression_half_size"])
def test_vrt_reads_equal(tmp_path, kind):
    paths, data, m1, m2 = vrt_archive(str(tmp_path))
    if kind == "python":
        args = (VRT_TEMPLATE, paths["veg_data"],
                [paths["qmask1"], paths["qmask2"]])
        xml = tvrt.render_vrt(*args)
        assert xml == jvrt.render_vrt(*args)
    else:
        xml = _expr_vrt(paths, ' rasterXSize="0.5" rasterYSize="0.5"'
                        if kind.endswith("half_size") else "")
    t, j = tvrt.VRTRaster(xml), jvrt.VRTRaster(xml)
    assert (t.width, t.height) == (j.width, j.height)
    assert t.gt.to_gdal() == j.gt.to_gdal()
    assert t.crs.to_proj4() == j.crs.to_proj4()
    assert t.nodata == j.nodata and t.dtype == j.dtype
    assert t.ds == j.ds or t.ds.__dict__.keys() == j.ds.__dict__.keys()
    for win in (None, (8, 4, 16, 12), (0, 20, t.width, 3)):
        a, b = t.read(1, win), j.read(1, win)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if kind == "python":
        want = data.copy()
        want[~((m1 == 1) & (m2 == 1))] = -999
        np.testing.assert_array_equal(t.read(1), want)


def test_vrt_render_masks_and_sizes():
    tpl = ('<a x="{{ .RasterXSize }}" y="{{ .RasterYSize }}">'
           '{{ .Data.Path }}{{ range g := .Masks }}<m>{{ g.Path }}</m>'
           '{{ end }}{{ .Other }}</a>')
    for sizes in ((0.0, 0.0), (0.5, 128.0), (64.0, 0.25)):
        args = (tpl, "/d/data.tif", ["/d/m1.tif", "/d/m2.tif"]) + sizes
        assert tvrt.render_vrt(*args) == jvrt.render_vrt(*args)


def test_vrt_errors_alike(tmp_path, monkeypatch):
    paths, *_ = vrt_archive(str(tmp_path))
    bad = ["<NotVRT/>", "<VRTDataset/>",
           '<VRTDataset><VRTRasterBand band="1"/></VRTDataset>',
           _expr_vrt(paths).replace("expression", "javascript")]
    for xml in bad:
        for mod in (tvrt, jvrt):
            with pytest.raises(ValueError):
                mod.VRTRaster(xml).read(1)
    monkeypatch.setenv("GSKY_VRT_ENABLE_PYTHON", "NO")
    xml = tvrt.render_vrt(VRT_TEMPLATE, paths["veg_data"],
                          [paths["qmask1"], paths["qmask2"]])
    for mod in (tvrt, jvrt):
        with pytest.raises(ValueError, match="disabled"):
            mod.VRTRaster(xml).read(1)


# ---------------------------------------------------------------------------
# h5py stays optional
# ---------------------------------------------------------------------------

def test_no_module_imports_h5py_at_import_time():
    """No module of the port imports h5py at module level, guarded or
    not: NetCDF-4 support imports it when an HDF5 file is opened."""
    for d, _, fs in os.walk(os.path.join(REPO, "gsky_tpu_torch")):
        for f in fs:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if not isinstance(node, ast.Module):
                    continue
                for stmt in ast.walk(node):
                    if isinstance(stmt, ast.Import):
                        names = [a.name for a in stmt.names]
                    elif isinstance(stmt, ast.ImportFrom):
                        names = [stmt.module or ""]
                    else:
                        continue
                    if any(n.split(".")[0] == "h5py" for n in names):
                        # only inside a function body
                        assert _in_function(tree, stmt), (f, stmt.lineno)


def _in_function(tree, target):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(n is target for n in ast.walk(node)):
                return True
    return False


def test_port_imports_without_h5py(tmp_path):
    """With h5py unimportable every module of the port imports, the
    crawler records a NetCDF-4 file as an error naming h5py, and
    NetCDF-3 still opens."""
    p = tmp_path / "nc4.nc"
    p.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    code = f"""
import sys, pkgutil, importlib
sys.modules["h5py"] = None
import gsky_tpu_torch
for m in pkgutil.walk_packages(gsky_tpu_torch.__path__, "gsky_tpu_torch."):
    importlib.import_module(m.name)
from gsky_tpu_torch.index.crawler import extract
rec = extract({str(p)!r})
assert "h5py" in rec["error"] and rec["geo_metadata"] == [], rec
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


# ---------------------------------------------------------------------------
# the adapter tier: images with ESRI world files
# ---------------------------------------------------------------------------

# 0.01-degree pixels, the top-left pixel's centre at (148.005, -35.005)
_WORLD = "0.01\n0.0\n0.0\n-0.01\n148.005\n-35.005\n"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """One seeded 64 x 64 uint8 raster as a lossless JP2 beside a .j2w
    and as a PNG beside a .PGW (upper case), and a JP2 whose world file
    is malformed."""
    from PIL import Image
    root = tmp_path_factory.mktemp("adapter")
    rng = np.random.default_rng(9)
    data = rng.integers(1, 255, (64, 64), dtype=np.uint8)
    out = {"root": str(root), "data": data}
    for name, fmt, world in (("S2_B04_20200110.jp2", "JPEG2000", ".j2w"),
                             ("S2_B03_20200110.png", "PNG", ".PGW"),
                             ("bad_world_20200110.jp2", "JPEG2000",
                              ".j2w")):
        p = os.path.join(str(root), name)
        Image.fromarray(data, "L").save(p, fmt)
        with open(os.path.splitext(p)[0] + world, "w") as fp:
            fp.write("0.01\nnot a number\n" if name.startswith("bad")
                     else _WORLD)
        out[name.split("_")[1] if name.startswith("S2") else "bad"] = p
    return out


def test_adapter_formats_registered_in_the_reference_order():
    from gsky_tpu.io import adapter as jadapter
    from gsky_tpu_torch.io import adapter as tadapter
    assert tregistry.formats() == jregistry.formats()
    assert tregistry.formats()[-1] == "pil-image"
    for magic in (b"\x00\x00\x00\x0cjP  \r\n", b"\xff\x4f\xff\x51",
                  b"\x89PNG\r\n\x1a\n", b"\xff\xd8\xff\xe0", b"BM\x00",
                  b"II*\x00", b"CDF\x01"):
        assert tadapter.sniff_image("x", magic) == \
            jadapter.sniff_image("x", magic)


@pytest.mark.parametrize("band", ["B04", "B03", "bad", "missing"])
def test_read_world_file_equals_reference(images, band, tmp_path):
    from gsky_tpu.io.adapter import read_world_file as jread
    from gsky_tpu_torch.io.adapter import read_world_file as tread
    p = images.get(band, str(tmp_path / "no_world.jp2"))
    t, j = tread(p), jread(p)
    if band in ("bad", "missing"):
        assert t is None and j is None
        return
    assert t.to_gdal() == j.to_gdal()
    assert t.to_gdal() == pytest.approx((148.0, 0.01, 0.0, -35.0, 0.0,
                                         -0.01))


@pytest.mark.parametrize("band", ["B04", "B03"])
@pytest.mark.parametrize("window", [None, (8, 4, 16, 12), (60, 50, 10, 20)])
def test_image_window_equals_reference(images, band, window):
    t = tregistry.open_raster(images[band])
    j = jregistry.open_raster(images[band])
    try:
        assert type(t).__name__ == type(j).__name__ == "ImageRaster"
        assert (t.width, t.height, t.bands, t.nodata, t.overviews,
                t.crs) == (j.width, j.height, j.bands, j.nodata,
                           j.overviews, j.crs) == (64, 64, 1, None, (),
                                                   None)
        assert t.gt.to_gdal() == j.gt.to_gdal()
        got = t.read(1, window)
        np.testing.assert_array_equal(got, j.read(1, window))
        c0, r0, w, h = window or (0, 0, 64, 64)
        np.testing.assert_array_equal(
            got, images["data"][r0:r0 + h, c0:c0 + w])
    finally:
        t.close()
        j.close()
    t.close()                               # a second close frees nothing


@pytest.mark.parametrize("band", ["B04", "B03", "bad"])
def test_image_crawler_record_equals_reference(images, band):
    p = images[band]
    t, j = extract(p), jextract(p)
    assert t == j
    assert not t.get("error") and t["file_type"] == "Raster"
    assert t["geo_metadata"][0]["x_size"] == 64


def test_image_without_pil_records_the_import_error(images, tmp_path):
    """On a host without PIL the adapter's open raises the ImportError,
    which the crawler records; nothing decodes the image another way."""
    code = ("import sys; sys.modules['PIL'] = None\n"
            "from gsky_tpu_torch.index.crawler import extract\n"
            f"print(extract({images['B04']!r})['error'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "import of PIL halted; None in sys.modules"


@pytest.mark.parametrize("method", ["near", "bilinear"])
def test_getmap_over_an_image_equals_reference(images, method,
                                               monkeypatch):
    """crawl -> MAS -> GetMap over the Sentinel-2-style JP2 through both
    packages (the reference's Pallas kernels in interpret mode): the
    same granule, equal data and validity, equal tile bytes."""
    from gsky_tpu.geo.crs import EPSG3857 as J3857
    from gsky_tpu.geo.transform import BBox as JBBox
    from gsky_tpu.geo.transform import transform_bbox as jtransform
    from gsky_tpu.index.client import MASClient as JMASClient
    from gsky_tpu.index.store import MASStore as JMASStore
    from gsky_tpu.pipeline import pages as jpages
    from gsky_tpu.pipeline.executor import WarpExecutor as JWarpExecutor
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    from gsky_tpu.pipeline.types import GeoTileRequest as JRequest
    from gsky_tpu_torch.geo.crs import EPSG3857
    from gsky_tpu_torch.geo.transform import BBox, transform_bbox
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.index.store import MASStore
    from gsky_tpu_torch.pipeline.tile import TilePipeline
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    monkeypatch.setenv("GSKY_PALLAS", "interpret")
    monkeypatch.setenv("GSKY_WAVES", "0")
    monkeypatch.setenv("GSKY_RENDER_BATCH", "0")
    p, ns = images["B04"], "S2_B04_20200110"
    jstore, tstore = JMASStore(), MASStore()
    jstore.ingest(jextract(p))
    tstore.ingest(extract(p))
    box = (148.1, -35.5, 148.5, -35.1)
    jbox = jtransform(JBBox(*box), J4326, J3857)
    tbox = transform_bbox(BBox(*box), EPSG4326, EPSG3857)
    assert tbox == BBox(jbox.xmin, jbox.ymin, jbox.xmax, jbox.ymax)
    jpages.reset_default_pool()
    try:
        jpipe = JTilePipeline(JMASClient(jstore), executor=JWarpExecutor())
        jreq = JRequest(collection=images["root"], bands=[ns], bbox=jbox,
                        crs=J3857, width=64, height=64, resample=method)
        jres = jpipe.process(jreq)
        jtile = np.asarray(jpipe.render_composite_byte(jreq))
    finally:
        jpages.reset_default_pool()
    tpipe = TilePipeline(MASClient(tstore), device="cpu")
    treq = GeoTileRequest(collection=images["root"], bands=[ns], bbox=tbox,
                          crs=EPSG3857, width=64, height=64,
                          resample=method)
    tres = tpipe.process(treq)
    ttile = tpipe.render_composite_byte(treq).numpy()
    ok = np.asarray(tres.valid[ns])
    np.testing.assert_array_equal(ok, np.asarray(jres.valid[ns]))
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(tres.data[ns])[ok],
                                  np.asarray(jres.data[ns])[ok])
    np.testing.assert_array_equal(ttile, jtile)
