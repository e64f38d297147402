"""Port parity, WPS: the port's WPS GetCapabilities, DescribeProcess and
Execute (`server/ows.py` over `pipeline/drill.py`), `parse_wps` with
its XML POST bodies, and `geometry.from_geojson` / `Geometry.area`,
against the JAX package's.

The servers are `test_torch_wcs`'s (fixture ``wenv``); the drills run
over its NetCDF fractional-cover stack (three dates), the reference's
with ``GSKY_DRILL_CACHE=sync``.  Bounds: equal dates and counts in the
CSVs, values within rtol 1e-5; documents equal; errors with the same
status and exception code; a process over a VRT answers 501 naming
ROADMAP A.8.
"""

import json
import re
import urllib.request
from urllib.parse import quote
from xml.etree import ElementTree

import numpy as np
import pytest

from gsky_tpu.geo import geometry as jgeom
from gsky_tpu.server.params import parse_wps as jparse_wps

from gsky_tpu_torch.geo import geometry as geom
from gsky_tpu_torch.server.params import OWSError, parse_wps

from test_torch_wcs import TIMEOUT, _code, both, port_get, \
    wenv  # noqa: F401  (the module fixture)

POLY = {"type": "Polygon", "coordinates": [[
    [148.0, -35.4], [148.4, -35.4], [148.4, -35.1], [148.0, -35.1],
    [148.0, -35.4]]]}
HOLED = {"type": "Polygon", "coordinates": [
    [[147.8, -35.6], [148.6, -35.6], [148.6, -35.0], [147.8, -35.0],
     [147.8, -35.6]],
    [[148.1, -35.4], [148.3, -35.4], [148.3, -35.2], [148.1, -35.2],
     [148.1, -35.4]]]}
MULTI = {"type": "MultiPolygon", "coordinates": [
    POLY["coordinates"],
    [[[148.6, -35.9], [148.9, -35.9], [148.9, -35.7], [148.6, -35.9]]]]}
POINT = {"type": "Point", "coordinates": [148.2, -35.25]}
LINE = {"type": "LineString", "coordinates": [[148.0, -35.0],
                                               [148.5, -35.5]]}
BIG = {"type": "Polygon", "coordinates": [[
    [140.0, -40.0], [150.0, -40.0], [150.0, -30.0], [140.0, -40.0]]]}
GEOMS = [POLY, HOLED, MULTI, POINT, LINE,
         {"type": "Feature", "geometry": POLY, "properties": {}},
         {"type": "FeatureCollection",
          "features": [{"type": "Feature", "geometry": MULTI}]}]


def _geom_fields(g):
    return (g.kind, g.area(), g.bbox(),
            [[r.tolist() for r in p] for p in g.polys],
            None if g.points is None else g.points.tolist(), g.to_wkt())


@pytest.mark.parametrize("i", range(len(GEOMS)))
def test_from_geojson(i):
    got = geom.from_geojson(json.dumps(GEOMS[i]))
    want = jgeom.from_geojson(GEOMS[i])
    a, b = _geom_fields(got), _geom_fields(want)
    assert a[0] == b[0] and a[1] == b[1] and a[3:] == b[3:]
    assert (a[2].xmin, a[2].ymin, a[2].xmax, a[2].ymax) == \
        (b[2].xmin, b[2].ymin, b[2].xmax, b[2].ymax)


@pytest.mark.parametrize("bad", ['{"type": "FeatureCollection", '
                                 '"features": []}',
                                 '{"type": "Circle", "coordinates": [1]}'])
def test_from_geojson_rejects(bad):
    with pytest.raises(ValueError) as want:
        jgeom.from_geojson(bad)
    with pytest.raises(ValueError) as got:
        geom.from_geojson(bad)
    assert str(got.value) == str(want.value)


def _execute_xml(identifier, geometry, start=None, end=None, literal=False):
    inputs = [("geometry", json.dumps(geometry), "ComplexData")]
    if start:
        inputs.append(("start_datetime", start,
                       "LiteralData" if literal else "ComplexData"))
    if end:
        inputs.append(("end_datetime", end, "LiteralData"))
    body = "".join(
        f"<wps:Input><ows:Identifier>{k}</ows:Identifier><wps:Data>"
        f"<wps:{kind}>{v}</wps:{kind}></wps:Data></wps:Input>"
        for k, v, kind in inputs)
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<wps:Execute service="WPS" version="1.0.0" '
        'xmlns:wps="http://www.opengis.net/wps/1.0.0" '
        'xmlns:ows="http://www.opengis.net/ows/1.1">'
        f"<ows:Identifier>{identifier}</ows:Identifier>"
        f"<wps:DataInputs>{body}</wps:DataInputs></wps:Execute>").encode()


WPS_PARAMS = [
    ({"request": "Execute", "identifier": "fc_drill",
      "datainputs": f"geometry={json.dumps(POLY)};start_datetime="
                    "2020-01-10T00:00:00.000Z;end_datetime="
                    '{"type":"string","value":"2020-01-12T00:00:00.000Z"}'},
     None),
    ({"request": "GetCapabilities", "version": ""}, None),
    ({}, _execute_xml("fc_drill", POLY, "2020-01-10T00:00:00.000Z",
                      "2020-01-11T00:00:00.000Z")),
    ({"identifier": "other"}, _execute_xml("fc_drill", POINT,
                                           '"2020-01-10T00:00:00.000Z"',
                                           literal=True)),
    ({"request": "Execute"}, b"<not xml"),
    ({"request": "Execute", "datainputs": "start_datetime=yesterday"},
     None),
]


def _wps_fields(p):
    return (p.request, p.version, p.identifier, p.geometry_json,
            p.start_time, p.end_time, p.inputs)


@pytest.mark.parametrize("i", range(len(WPS_PARAMS)))
def test_parse_wps(i):
    q, body = WPS_PARAMS[i]
    try:
        want = ("ok", _wps_fields(jparse_wps(dict(q), body)))
    except Exception as e:           # the reference's OWSError
        want = ("error", type(e).__name__)
    try:
        got = ("ok", _wps_fields(parse_wps(dict(q), body)))
    except OWSError as e:
        got = ("error", "OWSError")
    except ValueError:
        got = ("error", "ValueError")
    assert got == want


@pytest.mark.parametrize("req", ["GetCapabilities",
                                 "DescribeProcess&identifier=fc_drill",
                                 "DescribeProcess&identifier=fc_deciles"])
def test_wps_documents(wenv, req):
    ref, got = both(wenv, f"/ows?service=WPS&request={req}")
    assert got == ref


def _csv_blocks(body):
    root = ElementTree.fromstring(body)
    ns = {"wps": "http://www.opengis.net/wps/1.0.0"}
    return [el.text or "" for el in root.iterfind(".//wps:ComplexData", ns)]


def _rows(block):
    out = []
    for line in block.splitlines():
        date, *vals = line.split(",")
        out.append((date, [float(v) if v else float("nan") for v in vals]))
    return out


def _same_csv(ref, got):
    assert got[:2] == ref[:2] == (200, "text/xml"), got[2][:400]
    a, b = _csv_blocks(ref[2]), _csv_blocks(got[2])
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        rx, ry = _rows(x), _rows(y)
        assert [d for d, _ in rx] == [d for d, _ in ry] and rx
        np.testing.assert_allclose(np.array([v for _, v in ry]),
                                   np.array([v for _, v in rx]),
                                   rtol=1e-5)
    return b


@pytest.fixture
def drill_env(monkeypatch):
    monkeypatch.setenv("GSKY_DRILL_CACHE", "sync")


def _kvp(identifier, geometry, start="2020-01-10T00:00:00.000Z",
         end="2020-01-13T00:00:00.000Z"):
    di = f"geometry={json.dumps(geometry)}"
    if start:
        di += f";start_datetime={start}"
    if end:
        di += f";end_datetime={end}"
    return (f"/ows?service=WPS&request=Execute&identifier={identifier}"
            f"&datainputs={quote(di)}")


@pytest.mark.parametrize("geometry", [POLY, HOLED, MULTI, POINT],
                         ids=["polygon", "holed", "multipolygon", "point"])
def test_execute_get(wenv, drill_env, geometry):
    blocks = _same_csv(*both(wenv, _kvp("fc_drill", geometry)))
    if geometry is not POINT:
        assert len(_rows(blocks[0])) == 3


def test_execute_deciles_year_split(wenv, drill_env):
    """Deciles over a year-stepped split; no TIME inputs."""
    blocks = _same_csv(*both(wenv, _kvp("fc_deciles", POLY, None, None)))
    assert len(_rows(blocks[0])[0][1]) == 10


def test_execute_post(wenv, drill_env):
    body = _execute_xml("fc_drill", POLY, "2020-01-11T00:00:00.000Z",
                        "2020-01-13T00:00:00.000Z")
    blocks = _same_csv(*both(wenv, "/ows?service=WPS", body))
    assert [d for d, _ in _rows(blocks[0])] == ["2020-01-11", "2020-01-12"]


def test_execute_post_over_a_socket(wenv, drill_env):
    """The POST body reaches the handler (the XML Execute document)."""
    httpd = wenv["port"].serve("127.0.0.1", 0)
    try:
        body = _execute_xml("fc_drill", POLY, "2020-01-10T00:00:00.000Z")
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/ows?service=WPS",
            data=body, headers={"Content-Type": "text/xml"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            got = (r.status, r.headers["Content-Type"], r.read())
        _same_csv(wenv["jax"].request("/ows?service=WPS", body), got)
    finally:
        httpd.shutdown()
        httpd.server_close()


WPS_ERRORS = {
    "unknown process": _kvp("nope", POLY),
    "no geometry": "/ows?service=WPS&request=Execute&identifier=fc_drill",
    "bad geojson": "/ows?service=WPS&request=Execute&identifier=fc_drill"
                   "&datainputs=geometry%3D%7Bnot",
    "line": _kvp("fc_drill", LINE),
    "area": _kvp("fc_drill", BIG),
    "describe unknown": "/ows?service=WPS&request=DescribeProcess"
                        "&identifier=nope",
    "bad request": "/ows?service=WPS&request=Dance",
    "bad xml": ("/ows?service=WPS&request=Execute", b"<oops"),
}


@pytest.mark.parametrize("case", sorted(WPS_ERRORS))
def test_wps_errors(wenv, case):
    url = WPS_ERRORS[case]
    body = None
    if isinstance(url, tuple):
        url, body = url
    ref, got = both(wenv, url, body)
    assert got[:2] == ref[:2], (got, ref)
    assert _code(got[2]) == _code(ref[2])


def test_vrt_process_answers_501(wenv):
    status, ctype, body = port_get(wenv, _kvp("vrt_drill", POLY))
    assert (status, ctype) == (501, "application/vnd.ogc.se_xml")
    assert _code(body) == "OperationNotSupported"
    assert b"ROADMAP A.8" in body
    assert re.search(rb"VRT", body)
