"""Port parity, CRS tier: the Albers, Lambert conformal conic, sinusoidal
and geostationary projections and the CF grid mappings, against the JAX
package on the same seeded points.

The port projects on the host in float64 numpy with the reference's
formulas and op order, so its forward and inverse transforms equal the
reference's numpy path bit for bit (NaN where the reference gives NaN:
the far side of the earth for ``geos``).  Against the reference's
jitted path (``xp=jax.numpy``, float64; XLA may contract multiply-adds
and pick other libm kernels) the bounds are 1e-8 m forward, a few ulp
of the 1e7 m intermediates (the cone radius, the sinusoidal and
geostationary planes; one ulp there is 1.9e-9 m), and 1e-9 degree
inverse (the geostationary inverse near the limb loses most)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gsky_tpu.geo import crs as jcrs
from gsky_tpu.io.netcdf import crs_from_cf as jcrs_from_cf

from gsky_tpu_torch.geo import crs as tcrs
from gsky_tpu_torch.io.netcdf import crs_from_cf

CRSS = {
    "epsg3577": "EPSG:3577",
    "epsg102008": "EPSG:102008",
    "modis_sinu": "+proj=sinu +R=6371007.181 +lon_0=0 +x_0=0 +y_0=0",
    "lcc": ("+proj=lcc +lat_1=-30 +lat_2=-20 +lat_0=-25 +lon_0=135 "
            "+x_0=1000000 +y_0=2000000 +ellps=GRS80"),
    "lcc_1sp": "+proj=lcc +lat_1=45 +lat_0=45 +lon_0=-100 +ellps=WGS84",
    "himawari": "+proj=geos +h=35785863 +lon_0=140.7 +ellps=WGS84",
}


def _points(name, n=2000):
    rng = np.random.default_rng(17)
    if name in ("epsg102008", "lcc_1sp"):
        return rng.uniform(-125, -70, n), rng.uniform(25, 60, n)
    if name == "himawari":
        # the whole sphere: the far side projects to NaN in both
        return rng.uniform(-180, 180, n), rng.uniform(-89, 89, n)
    return rng.uniform(110, 155, n), rng.uniform(-44, -10, n)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(CRSS))
def test_parse_and_descriptions_equal(name):
    t, j = tcrs.parse_crs(CRSS[name]), jcrs.parse_crs(CRSS[name])
    assert t.to_proj4() == j.to_proj4()
    assert t.to_wkt() == j.to_wkt()
    assert t.name() == j.name()
    # both parsers read the other's WKT and proj4 back to one CRS
    for s in (t.to_wkt(), t.to_proj4()):
        assert tcrs.parse_crs(s).to_proj4() == jcrs.parse_crs(s).to_proj4()


@pytest.mark.parametrize("name", sorted(CRSS))
def test_forward_and_inverse_bit_exact(name):
    t, j = tcrs.parse_crs(CRSS[name]), jcrs.parse_crs(CRSS[name])
    lon, lat = _points(name)
    tx, ty = t.from_lonlat(lon, lat)
    jx, jy = j.from_lonlat(lon, lat)
    _same(tx, jx)
    _same(ty, jy)
    tl = t.to_lonlat(tx, ty)
    jl = j.to_lonlat(jx, jy)
    _same(tl[0], jl[0])
    _same(tl[1], jl[1])
    ok = np.isfinite(tx)
    assert ok.sum() > len(lon) // 3
    if name == "himawari":
        assert (~ok).sum() > len(lon) // 10      # the far side
    # the inverse answers longitudes east of lon0 past 180 unwrapped
    dlon = (tl[0][ok] - lon[ok] + 180.0) % 360.0 - 180.0
    np.testing.assert_allclose(dlon, 0.0, atol=1e-7)
    np.testing.assert_allclose(tl[1][ok], lat[ok], atol=1e-7)


@pytest.mark.parametrize("name", sorted(CRSS))
def test_against_jitted_reference(name):
    t, j = tcrs.parse_crs(CRSS[name]), jcrs.parse_crs(CRSS[name])
    lon, lat = _points(name, 500)
    fwd = jax.jit(lambda a, b: j.from_lonlat(a, b, jnp))
    jx, jy = (np.asarray(v) for v in fwd(lon, lat))
    tx, ty = t.from_lonlat(lon, lat)
    np.testing.assert_array_equal(np.isnan(tx), np.isnan(jx))
    ok = np.isfinite(tx)
    assert np.max(np.abs(tx[ok] - jx[ok])) <= 1e-8
    assert np.max(np.abs(ty[ok] - jy[ok])) <= 1e-8
    inv = jax.jit(lambda a, b: j.to_lonlat(a, b, jnp))
    jl = [np.asarray(v) for v in inv(tx[ok], ty[ok])]
    tl = t.to_lonlat(tx[ok], ty[ok])
    assert np.max(np.abs(tl[0] - jl[0])) <= 1e-9
    assert np.max(np.abs(tl[1] - jl[1])) <= 1e-9


def test_transform_between_new_crss_bit_exact():
    lon, lat = _points("epsg3577", 800)
    pairs = [("EPSG:3577", "EPSG:3857"), ("EPSG:3857", CRSS["modis_sinu"]),
             (CRSS["himawari"], "EPSG:3577"), (CRSS["lcc"], "EPSG:32755")]
    for a, b in pairs:
        x, y = jcrs.EPSG4326.transform_to(jcrs.parse_crs(a), lon, lat)
        jx, jy = jcrs.parse_crs(a).transform_to(jcrs.parse_crs(b), x, y)
        tx, ty = tcrs.parse_crs(a).transform_to(tcrs.parse_crs(b), x, y)
        _same(tx, jx)
        _same(ty, jy)


def test_static_epsg_entries():
    for code in (3577, 102008, 6974):
        assert tcrs.parse_crs(code).to_proj4() == \
            jcrs.parse_crs(code).to_proj4()
    assert tcrs.EPSG3577 == tcrs.parse_crs("EPSG:3577")
    assert tcrs.CRS_SINU_MODIS.to_proj4() == jcrs.CRS_SINU_MODIS.to_proj4()
    assert tcrs.CRS_HIMAWARI.to_proj4() == jcrs.CRS_HIMAWARI.to_proj4()


GRS = {"semi_major_axis": 6378137.0, "inverse_flattening": 298.257222101}
CF_MAPPINGS = {
    "albers": {"grid_mapping_name": "albers_conical_equal_area",
               "standard_parallel": np.array([-18.0, -36.0]),
               "longitude_of_central_meridian": 132.0,
               "latitude_of_projection_origin": 0.0,
               "false_easting": 0.0, "false_northing": 0.0, **GRS},
    "lcc": {"grid_mapping_name": "lambert_conformal_conic",
            "standard_parallel": np.array([-30.0, -20.0]),
            "longitude_of_central_meridian": 135.0,
            "latitude_of_projection_origin": -25.0,
            "false_easting": 1e6, "false_northing": 2e6,
            "semi_major_axis": 6378137.0,
            "semi_minor_axis": 6356752.314245},
    "lcc_1sp": {"grid_mapping_name": "lambert_conformal_conic",
                "standard_parallel": 45.0,
                "longitude_of_central_meridian": -100.0,
                "latitude_of_projection_origin": 45.0},
    "sinusoidal": {"grid_mapping_name": "sinusoidal",
                   "longitude_of_projection_origin": 0.0,
                   "semi_major_axis": 6371007.181,
                   "false_easting": 0.0, "false_northing": 0.0},
    "geostationary": {"grid_mapping_name": "geostationary",
                      "perspective_point_height": 35785863.0,
                      "longitude_of_projection_origin": 140.7,
                      "sweep_angle_axis": "y",
                      "semi_major_axis": 6378137.0,
                      "inverse_flattening": 298.257223563},
    "transverse": {"grid_mapping_name": "transverse_mercator",
                   "longitude_of_central_meridian": 147.0,
                   "scale_factor_at_central_meridian": 0.9996,
                   "false_easting": 500000.0,
                   "false_northing": 10000000.0},
    "mercator": {"grid_mapping_name": "mercator",
                 "longitude_of_projection_origin": 100.0},
    "latlon": {"grid_mapping_name": "latitude_longitude"},
    "bytes_name": {"grid_mapping_name": b"geostationary",
                   "perspective_point_height": np.array([35785863.0]),
                   "longitude_of_projection_origin": np.array([140.7])},
    "wkt": {"spatial_ref": tcrs.EPSG3577.to_wkt()},
}


@pytest.mark.parametrize("name", sorted(CF_MAPPINGS))
def test_cf_grid_mappings(name):
    t = crs_from_cf(CF_MAPPINGS[name])
    j = jcrs_from_cf(CF_MAPPINGS[name])
    assert t.to_proj4() == j.to_proj4()
    assert (t.proj, t.lon0, t.lat0, t.lat1, t.lat2, t.h, t.k0) == \
        (j.proj, j.lon0, j.lat0, j.lat1, j.lat2, j.h, j.k0)
    assert (t.ellps.a, t.ellps.f) == (j.ellps.a, j.ellps.f)


def test_unknown_grid_mapping_raises_value_error():
    attrs = {"grid_mapping_name": "polar_stereographic"}
    with pytest.raises(ValueError):
        jcrs_from_cf(attrs)
    with pytest.raises(ValueError, match="polar_stereographic"):
        crs_from_cf(attrs)
