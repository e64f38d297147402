"""Port parity, GetFeatureInfo, GetLegendGraphic and DescribeLayer: the
port's `OWSServer` against the JAX package's on `test_torch_server`'s
archive and config, and `pipeline.feature_info.get_feature_info` against
the reference's on the same request.

GetFeatureInfo renders through the modular route: a plain layer through
the fused warp (B1 natively, B2 a source-CRS group), a masked layer's
mosaic through B4, a fusion layer each input, a layer with
``feature_info_bands`` those bands.  Bounds: status and content type
equal; nearest values equal; bilinear and cubic within 2 ulp of
float32; "n/a" at the same pixels; ``available_dates`` equal; error
codes equal.  Legends: the decoded RGBA identical; DescribeLayer: the
bodies equal."""

import json

import numpy as np
import pytest

from gsky_tpu.io.png import decode_png as jdecode_png
from gsky_tpu_torch.io.png import decode_png

from test_torch_server import HOST, MASKED, METHODS, MULTI, NATIVE, \
    CORNER, FAR, MERC, T_ALL, T_DATA, T_MASK, T_MULTI, _bbox, _both, \
    _code, env, wrappers  # noqa: F401 (fixtures)

SIZE = (96, 80)     # height, width
# clicked pixels (i, j): the corner, the centre, the far edge, and one
# inside the data granule's nodata corner
POINTS = ((0, 0), (40, 48), (79, 95), (5, 3))


def _info(layer, box, i, j, *, style="", time=None, version="1.3.0",
          crs=MERC, size=SIZE, ns=""):
    h, w = size
    ij = f"i={i}&j={j}" if version == "1.3.0" else f"x={i}&y={j}"
    q = (f"service=WMS&request=GetFeatureInfo&version={version}"
         f"&layers={layer}&query_layers={layer}&styles={style}"
         f"&{'crs' if version == '1.3.0' else 'srs'}={crs}"
         f"&bbox={_bbox(box)}&width={w}&height={h}&{ij}"
         f"&info_format=application/json")
    if time:
        q += f"&time={time}"
    return f"/ows{'/' + ns if ns else ''}?{q}"


def _props(resp):
    status, ctype, body = resp
    assert (status, ctype) == (200, "application/json"), body[:300]
    doc = json.loads(body)
    assert doc["type"] == "FeatureCollection"
    (feat,) = doc["features"]
    assert feat["type"] == "Feature" and feat["geometry"] is None
    return feat["properties"]


def _ulps(a, b):
    ia = np.array([a], np.float32).view(np.int32).astype(np.int64)[0]
    ib = np.array([b], np.float32).view(np.int32).astype(np.int64)[0]
    return abs(int(ia) - int(ib))


def _same_props(ref, got, exact, what=""):
    pr, pg = _props(ref), _props(got)
    assert sorted(pr) == sorted(pg), (what, pr, pg)
    for k, v in pr.items():
        w = pg[k]
        if k == "available_dates" or v == "n/a" or exact:
            assert w == v, (what, k, v, w)
        else:
            assert w != "n/a" and _ulps(v, w) <= 2, (what, k, v, w)
    return pr


def _valued(props):
    return [k for k, v in props.items()
            if k != "available_dates" and v != "n/a"]


@pytest.mark.parametrize("method", METHODS)
def test_fused_layer(env, wrappers, method):
    """The plain layer's modular render: one B1 launch a click; its
    values equal the reference's, the contributing dates too."""
    seen = 0
    for box in (NATIVE[0], CORNER):
        for i, j in POINTS:
            ref, got = _both(env, _info("plain", box, i, j, style=method,
                                        time=T_DATA))
            props = _same_props(ref, got, method == "near", (box, i, j))
            seen += len(_valued(props))
            assert props["available_dates"] == [
                "2020-01-10T00:00:00.000Z", "2020-01-11T00:00:00.000Z"]
    assert seen >= 6
    assert wrappers == {"B1": 2 * len(POINTS), "B2": 0, "B4": 0}


def test_two_crs_layer(env, wrappers):
    """Granules in two source CRSs: one B2 launch a group."""
    for i, j in POINTS[:2]:
        ref, got = _both(env, _info("multi", MULTI[0], i, j, style="near",
                                    time=T_MULTI))
        assert _valued(_same_props(ref, got, True))
    assert wrappers == {"B1": 0, "B2": 4, "B4": 0}


def test_wms_111_x_y(env):
    ll = (148.10, -35.22, 148.14, -35.19)
    ref, got = _both(env, _info("plain", ll, 30, 20, style="near",
                                time=T_DATA, version="1.1.1",
                                crs="EPSG:4326"))
    assert _valued(_same_props(ref, got, True))


@pytest.mark.parametrize("layer", ["masked", "ndvi"])
def test_masked_layer(env, wrappers, layer):
    """A mask band: the mosaic per namespace through B4 in both."""
    calls = env["b4_calls"]
    n0 = len(calls)
    valued = 0
    for i, j in POINTS:
        ref, got = _both(env, _info(layer, MASKED[0], i, j, time=T_MASK))
        valued += len(_valued(_same_props(ref, got, False, (i, j))))
    assert valued >= 2
    per = 1 if layer == "masked" else 2
    assert len(calls) - n0 == wrappers["B4"] == per * len(POINTS)
    assert wrappers["B1"] == wrappers["B2"] == 0


def test_feature_info_bands(env, wrappers):
    """``feature_info_bands`` replace the layer's NDVI expression; the
    two newest of the contributing dates are listed."""
    for i, j in POINTS:
        ref, got = _both(env, _info("info", MASKED[0], i, j, time=T_MASK))
        props = _same_props(ref, got, False, (i, j))
        assert set(props) == {"LC08_B4", "LC08_B5", "available_dates"}
        assert len(props["available_dates"]) == 2
    assert wrappers["B1"] == len(POINTS)


def test_fusion_layer(env, wrappers):
    for box, t in ((NATIVE[0], T_ALL), (MULTI[0], T_ALL)):
        ref, got = _both(env, _info("fusion", box, 40, 48, time=t))
        _same_props(ref, got, True, box)


def test_no_data_is_na(env):
    ref, got = _both(env, _info("plain", FAR, 10, 10, style="near",
                                time=T_DATA))
    props = _same_props(ref, got, True)
    assert props == {"B4": "n/a", "available_dates": []}


def test_get_feature_info_against_the_reference(env):
    """`get_feature_info` itself: values, files and dates."""
    from gsky_tpu.pipeline.feature_info import get_feature_info as jgfi
    from gsky_tpu.pipeline.tile import TilePipeline as JTilePipeline
    from gsky_tpu.pipeline.types import GeoTileRequest as JRequest
    from gsky_tpu.geo.crs import parse_crs as jparse_crs
    from gsky_tpu.geo.transform import BBox as JBBox
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.index.store import parse_time
    from gsky_tpu_torch.pipeline.feature_info import get_feature_info
    from gsky_tpu_torch.pipeline.tile import TilePipeline
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    t0, t1 = (parse_time(t) for t in T_DATA.split(","))
    kw = dict(collection=f"{env['root']}/data", bands=["B4"], width=80,
              height=96, start_time=t0, end_time=t1, resample="near")
    jreq = JRequest(bbox=JBBox(*NATIVE[0]), crs=jparse_crs(MERC), **kw)
    treq = GeoTileRequest(bbox=BBox(*NATIVE[0]), crs=parse_crs(MERC), **kw)
    jmas = env["jax_mas"]
    pipe = TilePipeline(env["tmas"], device="cpu")
    for x, y in POINTS:
        a = jgfi(JTilePipeline(jmas), jreq, x, y)
        b = get_feature_info(pipe, treq, x, y)
        assert (b.values, b.files, b.dates) == (a.values, a.files, a.dates)
    with pytest.raises(ValueError):
        get_feature_info(pipe, treq, 80, 0)


ERRORS = {
    "outside": _info("plain", NATIVE[0], 80, 0, time=T_DATA),
    "negative": _info("plain", NATIVE[0], 3, -1, time=T_DATA),
    "no i/j": (f"/ows?service=WMS&request=GetFeatureInfo&version=1.3.0"
               f"&layers=plain&crs={MERC}&bbox={_bbox(NATIVE[0])}"
               f"&width=80&height=96"),
    "no bbox": "/ows?service=WMS&request=GetFeatureInfo&layers=plain"
               "&i=1&j=1",
    "no layers": (f"/ows?service=WMS&request=GetFeatureInfo&crs={MERC}"
                  f"&bbox={_bbox(NATIVE[0])}&i=1&j=1"),
    "unknown layer": _info("nope", NATIVE[0], 1, 1),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors(env, case):
    ref, got = _both(env, ERRORS[case])
    assert got[:2] == ref[:2], (got, ref)
    assert ref[1] == "application/vnd.ogc.se_xml"
    assert _code(got[2]) == _code(ref[2])
    if case in ("outside", "negative"):
        assert _code(got[2]) == "InvalidPoint"
    if case in ("no i/j", "no bbox"):
        assert _code(got[2]) == "MissingParameterValue"


# ---------------------------------------------------------------------------
# GetLegendGraphic and DescribeLayer
# ---------------------------------------------------------------------------

def _legend(layer, key="layer", style=""):
    return (f"/ows?service=WMS&request=GetLegendGraphic&{key}={layer}"
            f"&style={style}&format=image/png")


@pytest.mark.parametrize("case", ["file", "palette", "palette layers="])
def test_legend(env, case):
    layer = "legend_file" if case == "file" else "palette"
    key = "layers" if case.endswith("layers=") else "layer"
    ref, got = _both(env, _legend(layer, key))
    assert got[:2] == ref[:2] == (200, "image/png")
    a, b = jdecode_png(ref[2]), decode_png(got[2])
    assert np.array_equal(a, b)
    if case == "file":
        with open(f"{env['root']}/legend.png", "rb") as fp:
            assert got[2] == ref[2] == fp.read()
    else:
        # the palette's ramp at the default legend size: a row a byte
        # value, 254 at the top
        assert a.shape == (320, 160, 4)
        assert (a[:, 0] == a[:, -1]).all()
        assert not np.array_equal(a[0], a[-1])


@pytest.mark.parametrize("layer", ["plain", "nope"])
def test_legend_errors(env, layer):
    ref, got = _both(env, _legend(layer))
    assert got[:2] == ref[:2]
    assert got[0] == (404 if layer == "plain" else 400)
    assert _code(got[2]) == _code(ref[2])


@pytest.mark.parametrize("layers", ["plain", "plain,masked,truecolour",
                                    "plain,nope"])
def test_describe_layer(env, layers):
    for ns in ("", "sub"):
        url = (f"/ows{'/' + ns if ns else ''}?service=WMS"
               f"&request=DescribeLayer&version=1.1.1&layers={layers}")
        ref, got = _both(env, url)
        assert got[:2] == ref[:2]
        if "nope" in layers:
            assert _code(got[2]) == _code(ref[2]) == "LayerNotDefined"
            continue
        assert got[:2] == (200, "text/xml")
        assert got[2] == ref[2]
        assert f"owsURL=\"http://{HOST}/ows".encode() in got[2]
        assert got[2].count(b"<LayerDescription") == layers.count(",") + 1
