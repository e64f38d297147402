"""OGC request parameter parsing for WMS.

Counterpart of the WMS half of `gsky_tpu/server/params.py`:
case-insensitive keys, the service inferred from ``request`` when
``service`` is missing, WMS 1.3.0 vs 1.1.1 axis order, time lists.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
