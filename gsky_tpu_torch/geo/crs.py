"""Coordinate reference systems: host (numpy, float64) projection math.

Counterpart of `gsky_tpu/geo/crs.py`, trimmed to the projections the
single-band GetMap slice serves — geographic (EPSG:4326), web mercator
(EPSG:3857), ellipsoidal mercator and transverse mercator / UTM
(EPSG:326xx, 327xx, GDA94 MGA 283xx) — and to the numpy path only: the
port projects control points on the host and never traces projection
math on the device.  Formulas, constants and op order are the reference
module's, so both packages project the same points to the same bits.

Formulas follow Snyder, *Map Projections — A Working Manual* (USGS PP 1395).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
GRS80_F = 1.0 / 298.257222101


@dataclass(frozen=True)
class Ellipsoid:
    a: float = WGS84_A
    f: float = WGS84_F

    @property
    def b(self) -> float:
        return self.a * (1.0 - self.f)

    @property
    def e2(self) -> float:
        return self.f * (2.0 - self.f)

    @property
    def e(self) -> float:
        return math.sqrt(self.e2)

    @property
    def ep2(self) -> float:  # second eccentricity squared
        e2 = self.e2
        return e2 / (1.0 - e2)


WGS84 = Ellipsoid(WGS84_A, WGS84_F)
GRS80 = Ellipsoid(WGS84_A, GRS80_F)

_ELLIPSOIDS = {
    "WGS84": WGS84,
    "GRS80": GRS80,
    "GRS67": Ellipsoid(6378160.0, 1 / 298.247167427),
    "WGS72": Ellipsoid(6378135.0, 1 / 298.26),
    "bessel": Ellipsoid(6377397.155, 1 / 299.1528128),
    "clrk66": Ellipsoid(6378206.4, 1 / 294.9786982),
    "clrk80": Ellipsoid(6378249.145, 1 / 293.465),
    "intl": Ellipsoid(6378388.0, 1 / 297.0),
    "krass": Ellipsoid(6378245.0, 1 / 298.3),
    "aust_SA": Ellipsoid(6378160.0, 1 / 298.25),
    "sphere": Ellipsoid(6370997.0, 0.0),
}


def _rad(deg):
    return deg * (math.pi / 180.0)


def _deg(rad):
    return rad * (180.0 / math.pi)


# -- mercator (ellipsoidal, Snyder 7-7..7-10) -------------------------------

def _merc_fwd(lon, lat, p):
    a, e = p.ellps.a, p.ellps.e
    lat = np.clip(lat, -89.5, 89.5)
    phi = _rad(lat)
    x = a * p.k0 * _rad(lon - p.lon0)
    esin = e * np.sin(phi)
    y = a * p.k0 * np.log(np.tan(math.pi / 4 + phi / 2)
                          * ((1 - esin) / (1 + esin)) ** (e / 2))
    return x + p.x0, y + p.y0


def _merc_inv(x, y, p):
    a, e = p.ellps.a, p.ellps.e
    lon = p.lon0 + _deg((x - p.x0) / (a * p.k0))
    t = np.exp(-(y - p.y0) / (a * p.k0))
    phi = math.pi / 2 - 2 * np.arctan(t)
    for _ in range(6):
        esin = e * np.sin(phi)
        phi = math.pi / 2 - 2 * np.arctan(
            t * ((1 - esin) / (1 + esin)) ** (e / 2))
    return lon, _deg(phi)


# -- web mercator (spherical formulas on the WGS84 semi-major axis) ---------

def _webmerc_fwd(lon, lat, p):
    a = p.ellps.a
    x = a * _rad(lon - p.lon0) + p.x0
    lat = np.clip(lat, -85.06, 85.06)
    y = a * np.log(np.tan(math.pi / 4.0 + _rad(lat) / 2.0)) + p.y0
    return x, y


def _webmerc_inv(x, y, p):
    a = p.ellps.a
    lon = p.lon0 + _deg((x - p.x0) / a)
    lat = _deg(2.0 * np.arctan(np.exp((y - p.y0) / a)) - math.pi / 2.0)
    return lon, lat


# -- transverse mercator (ellipsoidal, Snyder 8-12..8-17 / 8-18..8-25) ------

def _tm_M(phi, e2, a):
    e4 = e2 * e2
    e6 = e4 * e2
    return a * (
        (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
        - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * phi)
        + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * phi)
        - (35 * e6 / 3072) * np.sin(6 * phi)
    )


def _tmerc_fwd(lon, lat, p):
    a, e2 = p.ellps.a, p.ellps.e2
    ep2 = p.ellps.ep2
    k0, lon0, lat0 = p.k0, p.lon0, p.lat0
    phi = _rad(lat)
    lam = _rad(lon - lon0)
    sphi, cphi = np.sin(phi), np.cos(phi)
    N = a / np.sqrt(1 - e2 * sphi * sphi)
    T = (sphi / cphi) ** 2
    C = ep2 * cphi * cphi
    A = lam * cphi
    M = _tm_M(phi, e2, a)
    M0 = _tm_M(math.radians(lat0), e2, a)
    A2, A3 = A * A, A * A * A
    x = k0 * N * (A + (1 - T + C) * A3 / 6
                  + (5 - 18 * T + T * T + 72 * C - 58 * ep2) * A2 * A3 / 120)
    y = k0 * (M - M0 + N * (sphi / cphi) * (
        A2 / 2 + (5 - T + 9 * C + 4 * C * C) * A2 * A2 / 24
        + (61 - 58 * T + T * T + 600 * C - 330 * ep2) * A3 * A3 / 720))
    return x + p.x0, y + p.y0


def _tmerc_inv(x, y, p):
    a, e2 = p.ellps.a, p.ellps.e2
    ep2 = p.ellps.ep2
    k0, lon0, lat0 = p.k0, p.lon0, p.lat0
    x = x - p.x0
    y = y - p.y0
    M0 = _tm_M(math.radians(lat0), e2, a)
    M = M0 + y / k0
    e4, e6 = e2 * e2, e2 * e2 * e2
    mu = M / (a * (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256))
    e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
    phi1 = mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu) \
        + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu) \
        + (151 * e1 ** 3 / 96) * np.sin(6 * mu) \
        + (1097 * e1 ** 4 / 512) * np.sin(8 * mu)
    sphi, cphi = np.sin(phi1), np.cos(phi1)
    C1 = ep2 * cphi * cphi
    T1 = (sphi / cphi) ** 2
    N1 = a / np.sqrt(1 - e2 * sphi * sphi)
    R1 = a * (1 - e2) / (1 - e2 * sphi * sphi) ** 1.5
    D = x / (N1 * k0)
    D2 = D * D
    phi = phi1 - (N1 * sphi / cphi / R1) * (
        D2 / 2 - (5 + 3 * T1 + 10 * C1 - 4 * C1 * C1 - 9 * ep2) * D2 * D2 / 24
        + (61 + 90 * T1 + 298 * C1 + 45 * T1 * T1 - 252 * ep2 - 3 * C1 * C1)
        * D2 * D2 * D2 / 720)
    lam = (D - (1 + 2 * T1 + C1) * D * D2 / 6
           + (5 - 2 * C1 + 28 * T1 - 3 * C1 * C1 + 8 * ep2 + 24 * T1 * T1)
           * D * D2 * D2 / 120) / cphi
    return lon0 + _deg(lam), _deg(phi)


_KERNELS = {
    "longlat": (None, None),
    "merc": (_merc_fwd, _merc_inv),
    "webmerc": (_webmerc_fwd, _webmerc_inv),
    "tmerc": (_tmerc_fwd, _tmerc_inv),
}


@dataclass(frozen=True)
class CRS:
    """A coordinate reference system; hashable, so it keys the host
    coordinate caches.  ``proj`` selects the projection kernel;
    parameters mirror proj4 names."""

    proj: str  # longlat | merc | webmerc | tmerc
    ellps: Ellipsoid = WGS84
    lon0: float = 0.0
    lat0: float = 0.0
    lat1: float = 0.0
    lat2: float = 0.0
    k0: float = 1.0
    x0: float = 0.0
    y0: float = 0.0
    h: float = 0.0
    epsg: Optional[int] = None

    @property
    def is_geographic(self) -> bool:
        return self.proj == "longlat"

    def to_lonlat(self, x, y):
        """Projected coords (m) -> lon/lat degrees."""
        if self.proj == "longlat":
            return x, y
        return _KERNELS[self.proj][1](x, y, self)

    def from_lonlat(self, lon, lat):
        """lon/lat degrees -> projected coords (m)."""
        if self.proj == "longlat":
            return lon, lat
        return _KERNELS[self.proj][0](lon, lat, self)

    def transform_to(self, other: "CRS", x, y):
        """Coordinates in this CRS -> coordinates in ``other``."""
        if self == other:
            return x, y
        lon, lat = self.to_lonlat(x, y)
        return other.from_lonlat(lon, lat)

    def name(self) -> str:
        if self.epsg is not None:
            return f"EPSG:{self.epsg}"
        return f"+proj={self.proj}"

    def to_wkt(self) -> str:
        """Minimal well-known-text (the reference module's emitter)."""
        if self.proj == "longlat":
            return (
                'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",'
                f'{self.ellps.a},{1.0 / self.ellps.f if self.ellps.f else 0}]],'
                'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433],'
                f'AUTHORITY["EPSG","{self.epsg or 4326}"]]'
            )
        inv_f = 1.0 / self.ellps.f if self.ellps.f else 0.0
        proj_names = {
            "merc": "Mercator_1SP",
            "webmerc": "Mercator_1SP",
            "tmerc": "Transverse_Mercator",
        }
        params = [
            ("central_meridian", self.lon0),
            ("latitude_of_origin", self.lat0),
            ("standard_parallel_1", self.lat1),
            ("standard_parallel_2", self.lat2),
            ("scale_factor", self.k0),
            ("false_easting", self.x0),
            ("false_northing", self.y0),
        ]
        pstr = ",".join(f'PARAMETER["{k}",{v}]' for k, v in params)
        auth = f',AUTHORITY["EPSG","{self.epsg}"]' if self.epsg else ""
        return (
            f'PROJCS["{self.name()}",GEOGCS["WGS 84",DATUM["WGS_1984",'
            f'SPHEROID["WGS 84",{self.ellps.a},{inv_f}]],'
            'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
            f'PROJECTION["{proj_names[self.proj]}"],{pstr},'
            f'UNIT["metre",1]{auth}]'
        )

    def to_proj4(self) -> str:
        e = self.ellps
        if e.f == 0.0:
            ell = f"+R={e.a}"
        else:
            name = next((n for n, el in _ELLIPSOIDS.items() if el == e), None)
            ell = f"+ellps={name}" if name else f"+a={e.a} +rf={1.0 / e.f}"
        base = {
            "longlat": f"+proj=longlat {ell}",
            "merc": (f"+proj=merc +lon_0={self.lon0} +k={self.k0} "
                     f"+x_0={self.x0} +y_0={self.y0} {ell}"),
            "webmerc": (f"+proj=merc +a={e.a} +b={e.a} +lon_0={self.lon0} "
                        f"+x_0={self.x0} +y_0={self.y0}"),
            "tmerc": (f"+proj=tmerc +lat_0={self.lat0} +lon_0={self.lon0} "
                      f"+k={self.k0} +x_0={self.x0} +y_0={self.y0} {ell}"),
        }[self.proj]
        return base + " +units=m +no_defs" if self.proj != "longlat" \
            else base + " +no_defs"


EPSG4326 = CRS("longlat", WGS84, epsg=4326)
EPSG3857 = CRS("webmerc", WGS84, epsg=3857)

_STATIC_EPSG = {
    4326: EPSG4326,
    4283: CRS("longlat", GRS80, epsg=4283),  # GDA94 geographic
    3857: EPSG3857,
    900913: CRS("webmerc", WGS84, epsg=900913),
}


def _epsg_lookup(code: int) -> CRS:
    if code in _STATIC_EPSG:
        return _STATIC_EPSG[code]
    # UTM WGS84: 326xx north / 327xx south
    if 32601 <= code <= 32660:
        zone = code - 32600
        return CRS("tmerc", WGS84, lon0=zone * 6 - 183, lat0=0.0, k0=0.9996,
                   x0=500000.0, y0=0.0, epsg=code)
    if 32701 <= code <= 32760:
        zone = code - 32700
        return CRS("tmerc", WGS84, lon0=zone * 6 - 183, lat0=0.0, k0=0.9996,
                   x0=500000.0, y0=10000000.0, epsg=code)
    # GDA94 MGA zones 49-56 (EPSG:28349-28356)
    if 28348 <= code <= 28358:
        zone = code - 28300
        return CRS("tmerc", GRS80, lon0=zone * 6 - 183, lat0=0.0, k0=0.9996,
                   x0=500000.0, y0=10000000.0, epsg=code)
    raise ValueError(f"unsupported EPSG code {code}")


_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def _parse_proj4(s: str) -> CRS:
    kv = {}
    for tok in s.split():
        tok = tok.lstrip("+")
        if "=" in tok:
            k, v = tok.split("=", 1)
            kv[k] = v
        else:
            kv[tok] = True
    proj = kv.get("proj", "longlat")
    if kv.get("R"):
        ellps = Ellipsoid(float(kv["R"]), 0.0)
    elif kv.get("a") and kv.get("b"):
        a, b = float(kv["a"]), float(kv["b"])
        ellps = Ellipsoid(a, (a - b) / a)
    elif kv.get("ellps"):
        name = str(kv["ellps"])
        if name not in _ELLIPSOIDS:
            raise ValueError(f"unsupported ellipsoid {name!r}")
        ellps = _ELLIPSOIDS[name]
    else:
        ellps = WGS84

    def f(name, default=0.0):
        return float(kv.get(name, default))
    if proj == "longlat":
        return CRS("longlat", ellps)
    if proj == "merc":
        if ellps.f == 0.0 or (kv.get("a") is not None
                              and kv.get("a") == kv.get("b")):
            return CRS("webmerc", Ellipsoid(ellps.a, 0.0), lon0=f("lon_0"),
                       x0=f("x_0"), y0=f("y_0"))
        return CRS("merc", ellps, lon0=f("lon_0"), k0=f("k", f("k_0", 1.0)),
                   x0=f("x_0"), y0=f("y_0"))
    if proj in ("tmerc", "utm"):
        if proj == "utm":
            zone = int(kv["zone"])
            south = "south" in kv
            return CRS("tmerc", ellps, lon0=zone * 6 - 183, k0=0.9996,
                       x0=500000.0, y0=10000000.0 if south else 0.0)
        return CRS("tmerc", ellps, lon0=f("lon_0"), lat0=f("lat_0"),
                   k0=f("k", f("k_0", 1.0)), x0=f("x_0"), y0=f("y_0"))
    raise ValueError(f"unsupported proj4 projection {proj!r}")


def _wkt_param(wkt: str, name: str, default: float = 0.0) -> float:
    m = re.search(rf'PARAMETER\["{name}",\s*({_NUM})\]', wkt, re.I)
    return float(m.group(1)) if m else default


def _parse_wkt(wkt: str) -> CRS:
    m = re.search(r'AUTHORITY\["EPSG","(\d+)"\]\s*\]\s*$', wkt)
    if m:
        try:
            return _epsg_lookup(int(m.group(1)))
        except ValueError:
            pass
    sp = re.search(rf'SPHEROID\["[^"]*",\s*({_NUM}),\s*({_NUM})', wkt, re.I)
    if sp:
        a = float(sp.group(1))
        inv_f = float(sp.group(2))
        ellps = Ellipsoid(a, 1.0 / inv_f if inv_f else 0.0)
    else:
        ellps = WGS84
    if not re.search(r"PROJCS", wkt, re.I):
        return CRS("longlat", ellps)
    pm = re.search(r'PROJECTION\["([^"]+)"\]', wkt, re.I)
    pname = (pm.group(1) if pm else "").lower()
    lon0 = _wkt_param(wkt, "central_meridian",
                      _wkt_param(wkt, "longitude_of_center"))
    lat0 = _wkt_param(wkt, "latitude_of_origin",
                      _wkt_param(wkt, "latitude_of_center"))
    k0 = _wkt_param(wkt, "scale_factor", 1.0)
    x0 = _wkt_param(wkt, "false_easting")
    y0 = _wkt_param(wkt, "false_northing")
    if "transverse_mercator" in pname:
        return CRS("tmerc", ellps, lon0=lon0, lat0=lat0, k0=k0, x0=x0, y0=y0)
    if "mercator" in pname:
        if ellps.f == 0.0 or "pseudo-mercator" in wkt.lower() \
                or "popular visualisation" in wkt.lower():
            return CRS("webmerc", Ellipsoid(ellps.a, 0.0), lon0=lon0,
                       x0=x0, y0=y0)
        return CRS("merc", ellps, lon0=lon0, k0=k0, x0=x0, y0=y0)
    raise ValueError(f"unsupported WKT projection {pname!r}")


def parse_crs(s) -> CRS:
    """Parse an EPSG code ('EPSG:3857', 'epsg:4326', 3857), a proj4 string,
    or a WKT string into a CRS."""
    if isinstance(s, CRS):
        return s
    if isinstance(s, int):
        return _epsg_lookup(s)
    s = s.strip()
    m = re.match(r"^(?:urn:ogc:def:crs:)?EPSG:{1,2}(\d+)$", s, re.I)
    if m:
        return _epsg_lookup(int(m.group(1)))
    if s.upper() in ("CRS:84", "WGS84", "WGS:84"):
        return EPSG4326
    if s.startswith("+"):
        return _parse_proj4(s)
    if s.upper().startswith(("GEOGCS", "PROJCS", "GEOGCRS", "PROJCRS")):
        return _parse_wkt(s)
    raise ValueError(f"cannot parse CRS {s!r}")
