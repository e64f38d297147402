"""OGC request parameter parsing for WMS, WCS and WPS.

Counterpart of `gsky_tpu/server/params.py`: case-insensitive keys, the
service inferred from ``request`` when ``service`` is missing, WMS
1.3.0 vs 1.1.1 axis order, time lists, WCS ``subset=`` clauses, and WPS
Execute inputs from the ``datainputs`` KVP or an XML POST body.
"""

from __future__ import annotations

import json
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..geo.crs import CRS, parse_crs
from ..geo.transform import BBox
from ..index.store import parse_time


class OWSError(Exception):
    """Maps to an OGC ServiceException response."""

    def __init__(self, message: str, code: str = "", status: int = 400):
        super().__init__(message)
        self.code = code
        self.status = status


# requests that identify a service when `service=` is missing
_REQUEST_TO_SERVICE = {
    "getmap": "WMS",
    "getfeatureinfo": "WMS",
    "describelayer": "WMS",
    "getlegendgraphic": "WMS",
    "getcoverage": "WCS",
    "describecoverage": "WCS",
    "describeprocess": "WPS",
    "execute": "WPS",
}


def normalise_query(query) -> Dict[str, str]:
    """Lower-case keys, first value wins, except ``subset``, whose
    values are all kept, joined by ';'.  ``query`` maps a key to one
    value, or to a list of values (`urllib.parse.parse_qs`)."""
    out: Dict[str, str] = {}
    for k in query:
        v = query.getall(k) if hasattr(query, "getall") else query[k]
        if isinstance(v, str):
            v = [v]
        kl = k.lower()
        if kl == "subset":
            vals = out.get(kl, "").split(";") if kl in out else []
            out[kl] = ";".join(dict.fromkeys(vals + list(v)))
        elif kl not in out:
            out[kl] = v[0]
    return out


def infer_service(q: Dict[str, str]) -> str:
    svc = q.get("service", "").upper()
    if svc in ("WMS", "WCS", "WPS"):
        return svc
    req = q.get("request", "").lower()
    if req in _REQUEST_TO_SERVICE:
        return _REQUEST_TO_SERVICE[req]
    if req == "getcapabilities":
        return "WMS"
    raise OWSError("Not a valid OGC WMS/WCS/WPS request", status=400)


def parse_times(value: str) -> List[float]:
    """`time=` may be a comma list of ISO 8601 entries; duplicates are
    dropped and the result sorted."""
    out = []
    seen = set()
    for tok in value.split(","):
        tok = tok.strip()
        if not tok or tok.lower() in ("current", "now"):
            continue
        try:
            t = parse_time(tok)
        except ValueError:
            raise OWSError(f"invalid time format: {tok!r}")
        if t not in seen:
            seen.add(t)
            out.append(t)
    out.sort()
    return out


def _parse_bbox(value: str, crs: CRS, version: str) -> BBox:
    parts = value.split(",")
    if len(parts) < 4:
        raise OWSError(f"invalid bbox: {value!r}")
    try:
        a, b, c, d = (float(p) for p in parts[:4])
    except ValueError:
        raise OWSError(f"invalid bbox: {value!r}")
    # WMS 1.3.0 + geographic CRS: axis order is lat,lon
    if version >= "1.3.0" and crs.is_geographic:
        a, b, c, d = b, a, d, c
    if a >= c or b >= d:
        raise OWSError(f"degenerate bbox: {value!r}")
    return BBox(a, b, c, d)


@dataclass
class WMSParams:
    request: str = ""
    version: str = "1.3.0"
    layers: List[str] = field(default_factory=list)
    styles: List[str] = field(default_factory=list)
    crs: Optional[CRS] = None
    bbox: Optional[BBox] = None
    width: int = 0
    height: int = 0
    format: str = "image/png"
    times: List[float] = field(default_factory=list)
    x: Optional[int] = None     # GetFeatureInfo i/j
    y: Optional[int] = None
    info_format: str = "application/json"
    axes: Dict[str, str] = field(default_factory=dict)  # dim_* params


def parse_wms(q: Dict[str, str]) -> WMSParams:
    p = WMSParams()
    p.request = q.get("request", "")
    p.version = q.get("version", "1.3.0") or "1.3.0"
    if p.version not in ("1.1.1", "1.3.0"):
        raise OWSError(f"WMS version {p.version} not supported",
                       "InvalidParameterValue")
    layers = q.get("layers") or q.get("layer", "")
    p.layers = [l for l in layers.split(",") if l]
    p.styles = [s for s in q.get("styles", "").split(",")]
    crs_val = q.get("crs") or q.get("srs", "")
    if crs_val:
        try:
            p.crs = parse_crs(crs_val)
        except ValueError:
            raise OWSError(f"CRS {crs_val!r} not supported",
                           "InvalidCRS")
    if q.get("bbox"):
        if p.crs is None:
            raise OWSError("bbox given without crs", "InvalidCRS")
        p.bbox = _parse_bbox(q["bbox"], p.crs, p.version)
    for key in ("width", "height"):
        if q.get(key):
            try:
                setattr(p, key, int(float(q[key])))
            except (ValueError, OverflowError):
                raise OWSError(f"invalid {key}: {q[key]!r}")
    if q.get("format"):
        p.format = q["format"]
    if q.get("time"):
        p.times = parse_times(q["time"])
    for attr, keys in (("x", ("x", "i")), ("y", ("y", "j"))):
        for key in keys:
            if q.get(key):
                try:
                    setattr(p, attr, int(float(q[key])))
                except (ValueError, OverflowError):
                    raise OWSError(f"invalid {key}: {q[key]!r}")
    if q.get("info_format"):
        p.info_format = q["info_format"]
    for k, v in q.items():
        if k.startswith("dim_"):
            p.axes[k[4:]] = v
    return p


@dataclass
class WCSParams:
    request: str = ""
    version: str = "1.0.0"
    coverages: List[str] = field(default_factory=list)
    crs: Optional[CRS] = None
    bbox: Optional[BBox] = None
    width: int = 0
    height: int = 0
    format: str = "GeoTIFF"
    times: List[float] = field(default_factory=list)
    styles: List[str] = field(default_factory=list)
    # subset=axis(lo,hi) clauses and DAP4 value filters: name -> (lo, hi)
    axes: Dict[str, Tuple[Optional[float], Optional[float]]] = \
        field(default_factory=dict)
    # DAP4 index selection: name -> [(start, end, step, is_range,
    # is_all), ...]
    axis_idx: Dict[str, List[Tuple]] = field(default_factory=dict)
    # DAP4: the variables a constraint names replace the layer's bands
    bands_override: List[str] = field(default_factory=list)


def parse_wcs(q: Dict[str, str]) -> WCSParams:
    p = WCSParams()
    p.request = q.get("request", "")
    p.version = q.get("version", "1.0.0") or "1.0.0"
    cov = q.get("coverage") or q.get("coverageid") or q.get("identifier", "")
    p.coverages = [c for c in cov.split(",") if c]
    p.styles = [s for s in q.get("styles", "").split(",") if s]
    crs_val = q.get("crs") or q.get("srs", "")
    if crs_val:
        try:
            p.crs = parse_crs(crs_val)
        except ValueError:
            raise OWSError(f"CRS {crs_val!r} not supported", "InvalidCRS")
    if q.get("bbox"):
        if p.crs is None:
            raise OWSError("bbox given without crs", "InvalidCRS")
        p.bbox = _parse_bbox(q["bbox"], p.crs, "1.0.0")
    for key in ("width", "height"):
        if q.get(key):
            try:
                setattr(p, key, int(float(q[key])))
            except (ValueError, OverflowError):
                raise OWSError(f"invalid {key}: {q[key]!r}")
    if q.get("format"):
        p.format = q["format"]
    if q.get("time"):
        p.times = parse_times(q["time"])
    # subset=axis(lo,hi), repeatable (normalise_query joins them by ';')
    for clause in (q.get("subset", "") or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        m = re.match(r"(\w+)\(([^,\)]*)(?:,([^\)]*))?\)", clause)
        if not m:
            raise OWSError(f"invalid subset clause {clause!r}")
        try:
            lo = float(m.group(2)) if m.group(2) else None
            hi = float(m.group(3)) if m.group(3) else lo
        except ValueError:
            raise OWSError(f"invalid subset clause {clause!r}")
        p.axes[m.group(1)] = (lo, hi)
    return p


@dataclass
class WPSParams:
    request: str = ""
    version: str = "1.0.0"
    identifier: str = ""
    geometry_json: str = ""
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    inputs: Dict[str, str] = field(default_factory=dict)


def parse_wps(q: Dict[str, str],
              post_body: Optional[bytes] = None) -> WPSParams:
    """WPS parameters from the query and, for a POST, the XML Execute
    document; the KVP ``datainputs`` (``geometry=...;start_datetime=
    ...``) overrides inputs the body gave."""
    p = WPSParams()
    p.request = q.get("request", "")
    p.version = q.get("version", "1.0.0") or "1.0.0"
    p.identifier = q.get("identifier", "")
    if post_body:
        _parse_wps_post(p, post_body)
    if q.get("datainputs"):
        for part in re.split(r"[;&]", q["datainputs"]):
            if "=" in part:
                k, _, v = part.partition("=")
                p.inputs[k.strip().lower()] = v.strip()
    _extract_known_inputs(p)
    return p


_WPS_NS = {"wps": "http://www.opengis.net/wps/1.0.0",
           "ows": "http://www.opengis.net/ows/1.1"}


def _parse_wps_post(p: WPSParams, body: bytes) -> None:
    """An XML Execute document: the request from its root element, the
    process identifier, and every input's literal or complex data."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise OWSError(f"invalid WPS XML payload: {e}")
    if p.request == "":
        p.request = root.tag.split("}")[-1]
    ident = root.find(".//ows:Identifier", _WPS_NS)
    if ident is not None and ident.text and not p.identifier:
        p.identifier = ident.text.strip()
    for inp in root.findall(".//wps:Input", _WPS_NS):
        key_el = inp.find("ows:Identifier", _WPS_NS)
        if key_el is None or not key_el.text:
            continue
        key = key_el.text.strip().lower()
        lit = inp.find(".//wps:LiteralData", _WPS_NS)
        if lit is not None and lit.text:
            p.inputs[key] = lit.text.strip()
            continue
        comp = inp.find(".//wps:ComplexData", _WPS_NS)
        if comp is not None:
            text = comp.text or ""
            if not text.strip() and len(comp):
                text = "".join(ET.tostring(c, encoding="unicode")
                               for c in comp)
            p.inputs[key] = text.strip()


def _extract_known_inputs(p: WPSParams) -> None:
    g = p.inputs.get("geometry", "")
    if g:
        p.geometry_json = g
    s = _strip_json_wrapper(p.inputs.get("start_datetime", ""))
    if s:
        p.start_time = parse_time(s)
    e = _strip_json_wrapper(p.inputs.get("end_datetime", ""))
    if e:
        p.end_time = parse_time(e)


def _strip_json_wrapper(v: str) -> str:
    """An input is a bare ISO string or a {"type": "string", "value":
    ...} JSON fragment."""
    v = v.strip()
    if v.startswith("{"):
        try:
            return str(json.loads(v).get("value", "")).strip()
        except ValueError:
            return ""
    return v.strip('"')
