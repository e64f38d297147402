"""MAS — the metadata index, sqlite-backed.

Counterpart of `gsky_tpu/index/store.py`, trimmed to what the GetMap
and drill paths ask of it: ingest of crawler records, the
``?intersects&metadata=gdal`` query (bbox R*Tree prefilter in EPSG:4326,
then an exact polygon test), with the same JSON record shape, including
the crawler's per-timestep means and sample counts (the drill's fast
path) and geolocation records, and the ``?timestamps`` query with its
cache token (a layer's dates).
"""

from __future__ import annotations

import datetime as dt
import hashlib
import json
import math
import re
import sqlite3
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..geo import geometry as geom
from ..geo.crs import EPSG4326, parse_crs

ISO = "%Y-%m-%dT%H:%M:%S.000Z"


def parse_time(s: str) -> float:
    """RFC3339-ish -> unix seconds (the formats Go emits/accepts)."""
    s = s.strip()
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ",
                "%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            d = dt.datetime.strptime(s, fmt)
            if d.tzinfo is None:
                d = d.replace(tzinfo=dt.timezone.utc)
            return d.timestamp()
        except ValueError:
            continue
    raise ValueError(f"cannot parse time {s!r}")


def timestamps_token(result) -> str:
    """The ?timestamps cache token: a digest of the answer's list."""
    return hashlib.md5(json.dumps(list(result)).encode()).hexdigest()


def fmt_time(t: float) -> str:
    return dt.datetime.fromtimestamp(t, dt.timezone.utc).strftime(ISO)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS files(
    path TEXT PRIMARY KEY,
    file_type TEXT,
    meta TEXT
);
CREATE TABLE IF NOT EXISTS datasets(
    id INTEGER PRIMARY KEY,
    path TEXT NOT NULL,
    ds_name TEXT,
    namespace TEXT,
    array_type TEXT,
    srs TEXT,
    geo_transform TEXT,
    polygon TEXT,          -- WKT in the file's SRS
    nodata REAL,
    xmin REAL, ymin REAL, xmax REAL, ymax REAL,   -- EPSG:4326 bbox
    min_stamp REAL, max_stamp REAL,               -- unix seconds
    timestamps TEXT,       -- JSON array of RFC3339
    axes TEXT,
    means TEXT,
    sample_counts TEXT,
    geo_loc TEXT,
    overviews TEXT
);
CREATE INDEX IF NOT EXISTS idx_ds_path ON datasets(path);
CREATE VIRTUAL TABLE IF NOT EXISTS datasets_rtree
    USING rtree(id, xmin, xmax, ymin, ymax);
CREATE TRIGGER IF NOT EXISTS ds_rtree_ins AFTER INSERT ON datasets
WHEN new.xmin IS NOT NULL BEGIN
    INSERT INTO datasets_rtree VALUES
        (new.id, new.xmin, new.xmax, new.ymin, new.ymax);
END;
CREATE TRIGGER IF NOT EXISTS ds_rtree_del AFTER DELETE ON datasets
BEGIN
    DELETE FROM datasets_rtree WHERE id = old.id;
END;
"""


class MASStore:
    """The index.  Thread-safe: one shared connection for ``:memory:``
    (every statement under a lock), one connection per thread for a
    file database."""

    _QUERY_CACHE_MAX = 1024

    def __init__(self, db_path: str = ":memory:"):
        self._db_path = db_path
        self._query_cache: "OrderedDict" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._generation = 0
        self._local = threading.local()
        self._memory_conn: Optional[sqlite3.Connection] = None
        self._lock = threading.Lock()
        if db_path == ":memory:":
            self._memory_conn = sqlite3.connect(":memory:",
                                                check_same_thread=False)
        with self._maybe_lock():
            self._conn().executescript(_SCHEMA)
            self._conn().commit()
        self._columns = [d[0] for d in self._conn().execute(
            "SELECT * FROM datasets LIMIT 0").description]

    def _maybe_lock(self):
        import contextlib
        return self._lock if self._memory_conn is not None \
            else contextlib.nullcontext()

    def _conn(self) -> sqlite3.Connection:
        if self._memory_conn is not None:
            return self._memory_conn
        c = getattr(self._local, "conn", None)
        if c is None:
            c = sqlite3.connect(self._db_path)
            self._local.conn = c
        return c

    def ingest(self, record: Dict) -> int:
        """Ingest one crawler record {"filename", "file_type",
        "geo_metadata": [...]}.  Returns the number of datasets indexed."""
        return self.ingest_many([record])

    def ingest_many(self, records) -> int:
        """Batch ingest under one transaction."""
        n = 0
        with self._maybe_lock():
            conn = self._conn()
            try:
                for record in records:
                    path = record.get("filename") \
                        or record.get("file_path")
                    if not path:
                        raise ValueError("record missing filename")
                    n += self._ingest_locked(conn, record, path)
                conn.commit()
            except BaseException:
                conn.rollback()
                raise
        with self._cache_lock:
            self._generation += 1
            self._query_cache.clear()
        return n

    def _ingest_locked(self, conn, record: Dict, path: str) -> int:
        conn.execute("INSERT OR REPLACE INTO files(path, file_type, meta) "
                     "VALUES (?,?,?)",
                     (path, record.get("file_type", ""), json.dumps(record)))
        conn.execute("DELETE FROM datasets WHERE path = ?", (path,))
        n = 0
        for ds in record.get("geo_metadata", []):
            srs = ds.get("proj_wkt") or ds.get("proj4") or ds.get("srs") \
                or ""
            poly_wkt = ds.get("polygon", "")
            bbox4326 = (None, None, None, None)
            if poly_wkt:
                try:
                    g = geom.from_wkt(poly_wkt)
                    if srs:
                        crs = parse_crs(srs)
                        if crs != EPSG4326:
                            g = g.transform(
                                lambda x, y: crs.transform_to(
                                    EPSG4326, x, y))
                    b = g.split_dateline().bbox()
                    bbox4326 = (b.xmin, b.ymin, b.xmax, b.ymax)
                except (ValueError, KeyError):
                    pass
            stamps = ds.get("timestamps") or []
            unix = sorted(parse_time(s) for s in stamps) if stamps else []
            conn.execute(
                "INSERT INTO datasets(path, ds_name, namespace, array_type,"
                " srs, geo_transform, polygon, nodata, xmin, ymin, xmax,"
                " ymax, min_stamp, max_stamp, timestamps, axes, means,"
                " sample_counts, geo_loc, overviews)"
                " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (path,
                 ds.get("ds_name", path),
                 sanitize_namespace(ds.get("namespace", "")),
                 ds.get("array_type", "Float32"),
                 srs,
                 json.dumps(ds.get("geotransform")
                            or ds.get("geo_transform")),
                 poly_wkt,
                 _float_or_none(ds.get("nodata")),
                 *bbox4326,
                 unix[0] if unix else None,
                 unix[-1] if unix else None,
                 json.dumps([fmt_time(t) for t in unix]),
                 json.dumps(ds.get("axes")) if ds.get("axes") else None,
                 json.dumps(ds.get("means")) if ds.get("means") else None,
                 json.dumps(ds.get("sample_counts"))
                 if ds.get("sample_counts") else None,
                 json.dumps(ds.get("geo_loc")) if ds.get("geo_loc") else None,
                 json.dumps(ds.get("overviews"))
                 if ds.get("overviews") else None))
            n += 1
        return n

    def intersects(self, gpath: str, srs: str = "", wkt: str = "",
                   nseg: int = 2, time: str = "", until: str = "",
                   namespaces: Optional[Sequence[str]] = None,
                   metadata: str = "", limit: int = 0) -> Dict:
        """`mas_intersects`: {"files": [...]}, or {"gdal": [...]} when
        metadata == "gdal".  Answers cache per (args, generation)."""
        with self._cache_lock:
            ckey = (gpath, srs, wkt, nseg, time, until,
                    tuple(namespaces) if namespaces else None, metadata,
                    limit, self._generation)
            hit = self._query_cache.get(ckey)
            if hit is not None:
                self._query_cache.move_to_end(ckey)
        if hit is not None:
            if "gdal" in hit:
                return {"gdal": [dict(r) for r in hit["gdal"]]}
            return {"files": list(hit["files"])}
        q_geom = None
        if wkt:
            g = geom.from_wkt(wkt)
            if srs:
                crs = parse_crs(srs)
                if crs != EPSG4326:
                    if nseg and nseg > 1:
                        b = g.bbox()
                        seg = max((b.width + b.height) / (2 * nseg), 1e-9)
                        g = g.segmentize(seg)
                    g = g.transform(
                        lambda x, y: crs.transform_to(EPSG4326, x, y))
            q_geom = g.split_dateline()

        t_a = parse_time(time) if time else None
        t_b = parse_time(until) if until else None

        if q_geom is not None:
            qb = q_geom.bbox()
            sql = ("SELECT datasets.* FROM datasets"
                   " JOIN datasets_rtree AS rt ON datasets.id = rt.id"
                   " WHERE datasets.path LIKE ? ESCAPE '\\'"
                   " AND rt.xmax >= ? AND rt.xmin <= ?"
                   " AND rt.ymax >= ? AND rt.ymin <= ?")
            args: List = [_like_prefix(gpath),
                          qb.xmin, qb.xmax, qb.ymin, qb.ymax]
        else:
            sql = "SELECT * FROM datasets WHERE path LIKE ? ESCAPE '\\'"
            args = [_like_prefix(gpath)]
        if t_a is not None and t_b is None:
            sql += " AND min_stamp <= ? AND max_stamp >= ?"
            args += [t_a, t_a]
        elif t_a is not None and t_b is not None:
            # postgres OVERLAPS with the reference's 1s slack
            sql += " AND ? < max_stamp + 1 AND min_stamp - 1 < ?"
            args += [t_a, t_b]
        if namespaces:
            sql += " AND namespace IN (%s)" % ",".join("?" * len(namespaces))
            args += list(namespaces)
        with self._maybe_lock():
            rows = self._conn().execute(sql, args).fetchall()
        cols = self._columns

        out_rows = []
        for row in rows:
            r = dict(zip(cols, row))
            if q_geom is not None and r["polygon"]:
                try:
                    p = geom.from_wkt(r["polygon"])
                    if r["srs"]:
                        crs = parse_crs(r["srs"])
                        if crs != EPSG4326:
                            p = p.transform(lambda x, y: crs.transform_to(
                                EPSG4326, x, y))
                    p = p.split_dateline()
                    if not _geoms_intersect(p, q_geom):
                        continue
                except (ValueError, KeyError):
                    pass
            out_rows.append(r)
            if limit and len(out_rows) >= limit:
                break

        if metadata != "gdal":
            value = {"files": sorted({r["path"] for r in out_rows})}
        else:
            value = {"gdal": [{
                "file_path": r["path"],
                "ds_name": r["ds_name"],
                "namespace": r["namespace"],
                "array_type": r["array_type"],
                "srs": r["srs"],
                "geo_transform": json.loads(r["geo_transform"] or "null"),
                "timestamps": json.loads(r["timestamps"] or "[]"),
                "polygon": r["polygon"],
                "overviews": json.loads(r["overviews"])
                if r["overviews"] else None,
                "nodata": r["nodata"] if r["nodata"] is not None else 0.0,
                "axes": json.loads(r["axes"]) if r["axes"] else None,
                "means": json.loads(r["means"]) if r["means"] else None,
                "sample_counts": json.loads(r["sample_counts"])
                if r["sample_counts"] else None,
                "geo_loc": json.loads(r["geo_loc"]) if r["geo_loc"] else None,
            } for r in out_rows]}
        # callers annotate the records they get, so the cache keeps its
        # own per-record copies
        kept = {"gdal": [dict(r) for r in value["gdal"]]} \
            if "gdal" in value else {"files": list(value["files"])}
        with self._cache_lock:
            self._query_cache[ckey] = kept
            while len(self._query_cache) > self._QUERY_CACHE_MAX:
                self._query_cache.popitem(last=False)
        return value


    def timestamps(self, gpath: str, time: str = "", until: str = "",
                   namespaces: Optional[Sequence[str]] = None,
                   token: str = "") -> Dict:
        """`mas_timestamps`: the distinct sorted timestamps under
        ``gpath`` within [time, until] (until defaults to now), with the
        cache-token protocol: a matching token short-circuits to an
        empty list (the caller keeps its cache)."""
        t_a = parse_time(time) if time else None
        t_b = parse_time(until) if until else dt.datetime.now(
            dt.timezone.utc).timestamp()
        sql = ("SELECT timestamps FROM datasets WHERE path LIKE ? "
               "ESCAPE '\\'")
        args: List = [_like_prefix(gpath)]
        if namespaces:
            sql += " AND namespace IN (%s)" % ",".join("?" * len(namespaces))
            args += list(namespaces)
        with self._maybe_lock():
            rows = self._conn().execute(sql, args).fetchall()
        stamps = set()
        for (ts_json,) in rows:
            for s in json.loads(ts_json or "[]"):
                t = parse_time(s)
                if (t_a is None or t >= t_a) and t <= t_b:
                    stamps.add(t)
        result = [fmt_time(t) for t in sorted(stamps)]
        query_token = timestamps_token(result)
        if token and token == query_token:
            return {"timestamps": [], "token": token}
        return {"timestamps": result, "token": query_token}

def sanitize_namespace(ns: str) -> str:
    """`regexp_replace(trim(ns), '[^a-zA-Z0-9_]', '_')` — the namespace
    character rule, shared with the crawler."""
    return re.sub(r"[^a-zA-Z0-9_]", "_", ns.strip())


def _float_or_none(v) -> Optional[float]:
    if v is None:
        return None
    try:
        f = float(v)
        return None if math.isnan(f) else f
    except (TypeError, ValueError):
        return None


def _like_prefix(gpath: str) -> str:
    esc = gpath.replace("\\", "\\\\").replace("%", r"\%").replace("_", r"\_")
    return esc + "%"


def _geoms_intersect(a: geom.Geometry, b: geom.Geometry) -> bool:
    """Polygon/polygon (or point) intersection test."""
    if not a.bbox().intersects(b.bbox()):
        return False
    if b.kind in ("Point", "MultiPoint"):
        return any(a.contains_point(p[0], p[1]) for p in b.points)
    if a.kind in ("Point", "MultiPoint"):
        return any(b.contains_point(p[0], p[1]) for p in a.points)
    for poly in a.polys:
        for p in poly[0][:: max(1, len(poly[0]) // 64)]:
            if b.contains_point(p[0], p[1]):
                return True
    for poly in b.polys:
        for p in poly[0][:: max(1, len(poly[0]) // 64)]:
            if a.contains_point(p[0], p[1]):
                return True
    for pa in a.polys:
        for pb in b.polys:
            if _rings_cross(pa[0], pb[0]):
                return True
    return False


def _rings_cross(r1: np.ndarray, r2: np.ndarray) -> bool:
    """Any segment of r1 crosses any segment of r2 (vectorised)."""
    def closed(r):
        if r[0][0] != r[-1][0] or r[0][1] != r[-1][1]:
            return np.vstack([r, r[:1]])
        return r
    r1 = closed(r1)
    r2 = closed(r2)
    p = r1[:-1][:, None, :]
    pr = r1[1:][:, None, :] - p
    q = r2[:-1][None, :, :]
    qs = r2[1:][None, :, :] - q
    d = q - p
    rxs = np.cross(pr, qs)
    t = np.cross(d, qs)
    u = np.cross(d, pr)
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = t / rxs
        uu = u / rxs
    hit = (rxs != 0) & (tt >= 0) & (tt <= 1) & (uu >= 0) & (uu <= 1)
    return bool(hit.any())
