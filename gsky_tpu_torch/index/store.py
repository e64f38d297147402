"""MAS — the metadata index, sqlite-backed.

Counterpart of `gsky_tpu/index/store.py`.  The reference's MAS is
Postgres+PostGIS (`mas/db/schema.sql`); its HTTP contract
(`mas/api/api.go:58-124`) is kept here over sqlite:

- ``?intersects``: files (or their `gdal` metadata records) whose
  footprint intersects a query geometry and time range: an R*Tree bbox
  prefilter in EPSG:4326, then an exact polygon test;
- ``?timestamps``: distinct sorted timestamps with a cache token;
- ``?extents``: EPSG:3857 envelope + stamp range + variables.

Ingest takes the crawler's ``{"filename", "file_type", "geo_metadata":
[...]}`` records.  Every ingest bumps a generation persisted in the
database, so an ingest from another process against the same file
invalidates cached answers here too.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import json
import math
import sqlite3
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geo import geometry as geom
from ..geo.crs import EPSG3857, EPSG4326, parse_crs
from ..geo.transform import BBox, transform_bbox

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
    """The ?timestamps cache token (`mas/api/mas.sql:549-598`): one
    definition shared by the single store and the sharded router so the
    protocols cannot drift."""
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
CREATE INDEX IF NOT EXISTS idx_ds_bbox ON datasets(xmin, xmax, ymin, ymax);
CREATE INDEX IF NOT EXISTS idx_ds_ns ON datasets(namespace);
CREATE TABLE IF NOT EXISTS gsky_meta(k TEXT PRIMARY KEY, v INTEGER);
INSERT OR IGNORE INTO gsky_meta(k, v) VALUES ('generation', 0);
-- R*Tree over footprint bboxes: the role of the reference's partial
-- GIST indexes (mas.sql:363-425) — intersects queries walk the tree
-- instead of scanning the table (measured: 100k granules, p50 21.5 ms
-- scan -> 1-2 ms tree).  Triggers keep it in lockstep with datasets.
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

_RTREE_BACKFILL = """
INSERT INTO datasets_rtree
    SELECT id, xmin, xmax, ymin, ymax FROM datasets
    WHERE xmin IS NOT NULL
      AND id NOT IN (SELECT id FROM datasets_rtree)
"""


class MASStore:
    """The index.  Thread-safe for concurrent reads."""

    _QUERY_CACHE_MAX = 1024
    # process-wide totals across store instances, reachable by the
    # metrics layer without a handle on the per-server store; guarded by
    # a CLASS-level lock — per-instance locks don't serialise increments
    # across the many MASStore instances a sharded store fans out to
    total_query_hits = 0
    total_query_misses = 0
    _totals_lock = threading.Lock()

    def __init__(self, db_path: str = ":memory:"):
        self._db_path = db_path
        from collections import OrderedDict
        self._query_cache: "OrderedDict" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.query_hits = 0
        self.query_misses = 0
        self._local = threading.local()
        self._memory_conn: Optional[sqlite3.Connection] = None
        # a single :memory: connection is shared across threads, so every
        # statement must serialise through _lock; file databases get one
        # connection per thread instead and need no lock
        self._lock = threading.Lock()
        if db_path == ":memory:":
            self._memory_conn = sqlite3.connect(":memory:",
                                                check_same_thread=False)
        with self._maybe_lock():
            self._conn().executescript(_SCHEMA)
            # pre-R*Tree databases: index their existing rows once
            self._conn().execute(_RTREE_BACKFILL)
            self._conn().commit()
        self._columns = [d[0] for d in self._conn().execute(
            "SELECT * FROM datasets LIMIT 0").description]
        # bumped on every ingest; response caches key on it so cached
        # answers die with the data they were computed from.  Persisted
        # in sqlite (gsky_meta) so an ingest from ANOTHER process against
        # the same file DB (e.g. the crawler CLI) also invalidates this
        # server's cache.

    @property
    def generation(self) -> int:
        with self._maybe_lock():
            row = self._conn().execute(
                "SELECT v FROM gsky_meta WHERE k = 'generation'").fetchone()
        return int(row[0]) if row else 0

    def _maybe_lock(self):
        import contextlib
        return self._lock if self._memory_conn is not None \
            else contextlib.nullcontext()

    def _fetchall(self, sql: str, args=()) -> List[tuple]:
        with self._maybe_lock():
            return self._conn().execute(sql, args).fetchall()

    def _conn(self) -> sqlite3.Connection:
        if self._memory_conn is not None:
            return self._memory_conn
        c = getattr(self._local, "conn", None)
        if c is None:
            c = sqlite3.connect(self._db_path)
            self._local.conn = c
        return c

    # -- ingest --------------------------------------------------------------

    def ingest(self, record: Dict) -> int:
        """Ingest one crawler record: {"filename", "file_type",
        "geo_metadata": [...]}.  Returns number of datasets indexed.
        (The bash ingest pipeline `mas/db/shard_ingest.sh` analogue is a
        loop over these.)"""
        path = record.get("filename") or record.get("file_path")
        if not path:
            raise ValueError("record missing filename")
        with self._maybe_lock():
            try:
                self._conn().execute(
                    "UPDATE gsky_meta SET v = v + 1 WHERE k = 'generation'")
                return self._ingest_locked(record, path)
            except BaseException:
                # a half-ingested record must not linger in the open
                # implicit transaction, where the next successful ingest
                # would commit it
                self._conn().rollback()
                raise

    def ingest_many(self, records) -> int:
        """Batch ingest under ONE transaction + one generation bump —
        the crawl pipeline's bulk path (`mas/db/shard_ingest.sh` feeds
        psql a stream the same way).  ~50x faster than per-record
        ingest for catalog-scale loads."""
        n = 0
        with self._maybe_lock():
            conn = self._conn()
            try:
                conn.execute(
                    "UPDATE gsky_meta SET v = v + 1 WHERE k = 'generation'")
                for record in records:
                    path = record.get("filename") or record.get("file_path")
                    if not path:
                        raise ValueError("record missing filename")
                    n += self._ingest_locked(record, path, commit=False)
                conn.commit()
            except BaseException:
                conn.rollback()
                raise
        return n

    def _ingest_locked(self, record: Dict, path: str,
                       commit: bool = True) -> int:
        conn = self._conn()
        conn.execute("INSERT OR REPLACE INTO files(path, file_type, meta) "
                     "VALUES (?,?,?)",
                     (path, record.get("file_type", ""), json.dumps(record)))
        conn.execute("DELETE FROM datasets WHERE path = ?", (path,))
        n = 0
        for ds in record.get("geo_metadata", []):
            srs = ds.get("proj_wkt") or ds.get("proj4") or ds.get("srs") or ""
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
                    # dateline-crossing footprints index under the bbox
                    # of their SPLIT parts (reaching +/-180 on each
                    # side), so the prefilter admits queries near the
                    # antimeridian on either side
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
                 _sanitize_ns(ds.get("namespace", "")),
                 ds.get("array_type", "Float32"),
                 srs,
                 json.dumps(ds.get("geotransform") or ds.get("geo_transform")),
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
        if commit:
            conn.commit()
        return n

    # -- queries -------------------------------------------------------------

    def intersects(self, gpath: str, srs: str = "", wkt: str = "",
                   nseg: int = 2, time: str = "", until: str = "",
                   namespaces: Optional[Sequence[str]] = None,
                   metadata: str = "", limit: int = 0) -> Dict:
        """`mas_intersects` (`mas/api/mas.sql:363-547`).  Returns
        {"files": [...]} or {"gdal": [...]} when metadata == "gdal".

        Results cache per (args, generation) — the in-process stand-in
        for the reference's memcached tier in front of MAS
        (`mas/api/api.go:43-52`): a tile server asks the same question
        for every zoom-level repeat, and the polygon refinement below is
        ~3 ms a call.  Any ingest bumps the generation (even from
        another process against the same file DB), so cached answers
        die with the data they were computed from."""
        ckey = (gpath, srs, wkt, nseg, time, until,
                tuple(namespaces) if namespaces else None, metadata,
                limit, self.generation)
        with self._cache_lock:
            hit = self._query_cache.get(ckey)
            if hit is not None:
                self.query_hits += 1
                with MASStore._totals_lock:
                    MASStore.total_query_hits += 1
                self._query_cache.move_to_end(ckey)
            else:
                self.query_misses += 1
                with MASStore._totals_lock:
                    MASStore.total_query_misses += 1
        if hit is not None:
            # shallow-per-record copy on hit: callers sort the files
            # list and annotate top-level record dicts, so those copy;
            # inner lists (timestamps, axes) are treated read-only by
            # every consumer — a deepcopy here would cost as much as
            # the query it saves for deep time-series responses
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
            # antimeridian-crossing queries split into hemisphere parts
            # (ST_SplitDatelineWGS84, mas.sql:13-84)
            q_geom = g.split_dateline()

        t_a = parse_time(time) if time else None
        t_b = parse_time(until) if until else None

        if q_geom is not None:
            # R*Tree walk instead of a table scan (GIST-index role);
            # NULL-bbox rows are absent from the tree, matching the old
            # prefilter's `xmin IS NULL` exclusion
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
        rows = self._fetchall(sql, args)
        cols = self._columns

        # refine: exact polygon intersection in 4326
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
                    # zone-60/zone-1 footprints: split before testing
                    p = p.split_dateline()
                    if not _geoms_intersect(p, q_geom):
                        continue
                except (ValueError, KeyError):
                    pass
            out_rows.append(r)
            if limit and len(out_rows) >= limit:
                break

        if metadata != "gdal":
            return self._cache_put(
                ckey, {"files": sorted({r["path"] for r in out_rows})})
        gdal = []
        for r in out_rows:
            gdal.append({
                "file_path": r["path"],
                "ds_name": r["ds_name"],
                "namespace": r["namespace"],
                "array_type": r["array_type"],
                "srs": r["srs"],
                "geo_transform": json.loads(r["geo_transform"] or "null"),
                "timestamps": json.loads(r["timestamps"] or "[]"),
                "polygon": r["polygon"],
                "overviews": json.loads(r["overviews"]) if r["overviews"] else None,
                "means": json.loads(r["means"]) if r["means"] else None,
                "sample_counts": json.loads(r["sample_counts"])
                if r["sample_counts"] else None,
                "nodata": r["nodata"] if r["nodata"] is not None else 0.0,
                "axes": json.loads(r["axes"]) if r["axes"] else None,
                "geo_loc": json.loads(r["geo_loc"]) if r["geo_loc"] else None,
            })
        return self._cache_put(ckey, {"gdal": gdal})

    def _cache_put(self, ckey, value: Dict) -> Dict:
        # NOTE: this, api.MasQueryCache and executor's geo cache are
        # three small LRUs with different value lifetimes (raw query
        # dicts / HTTP byte bodies / numpy+device arrays); kept separate
        # deliberately — a shared helper would couple their eviction
        # policies for ~10 lines of savings each
        if "gdal" in value:
            kept = {"gdal": [dict(r) for r in value["gdal"]]}
        else:
            kept = {"files": list(value["files"])}
        with self._cache_lock:
            self._query_cache[ckey] = kept
            while len(self._query_cache) > self._QUERY_CACHE_MAX:
                self._query_cache.popitem(last=False)
        return value

    def timestamps(self, gpath: str, time: str = "", until: str = "",
                   namespaces: Optional[Sequence[str]] = None,
                   token: str = "") -> Dict:
        """`mas_timestamps` with the cache-token protocol
        (`mas/api/mas.sql:549-598`): a matching token short-circuits to an
        empty list (caller keeps its cache)."""
        t_a = parse_time(time) if time else None
        t_b = parse_time(until) if until else dt.datetime.now(
            dt.timezone.utc).timestamp()
        sql = ("SELECT timestamps FROM datasets WHERE path LIKE ? "
               "ESCAPE '\\'")
        args: List = [_like_prefix(gpath)]
        if namespaces:
            sql += " AND namespace IN (%s)" % ",".join("?" * len(namespaces))
            args += list(namespaces)
        stamps = set()
        for (ts_json,) in self._fetchall(sql, args):
            for s in json.loads(ts_json or "[]"):
                t = parse_time(s)
                if (t_a is None or t >= t_a) and t <= t_b:
                    stamps.add(t)
        result = [fmt_time(t) for t in sorted(stamps)]
        query_token = timestamps_token(result)
        if token and token == query_token:
            return {"timestamps": [], "token": token}
        return {"timestamps": result, "token": query_token}

    def extents(self, gpath: str,
                namespaces: Optional[Sequence[str]] = None) -> Dict:
        """`mas_spatial_temporal_extents` (`mas/api/mas.sql:640-709`):
        EPSG:3857 envelope + stamp range + variable list."""
        sql = ("SELECT namespace, xmin, ymin, xmax, ymax, min_stamp,"
               " max_stamp FROM datasets WHERE path LIKE ? ESCAPE '\\'")
        args: List = [_like_prefix(gpath)]
        if namespaces:
            sql += " AND namespace IN (%s)" % ",".join("?" * len(namespaces))
            args += list(namespaces)
        rows = self._fetchall(sql, args)
        if not rows:
            return {}
        nss = sorted({r[0] for r in rows if r[0]})
        xs0 = [r[1] for r in rows if r[1] is not None]
        ys0 = [r[2] for r in rows if r[2] is not None]
        xs1 = [r[3] for r in rows if r[3] is not None]
        ys1 = [r[4] for r in rows if r[4] is not None]
        stamps_min = [r[5] for r in rows if r[5] is not None]
        stamps_max = [r[6] for r in rows if r[6] is not None]
        out: Dict = {"variables": nss}
        if xs0:
            b = transform_bbox(BBox(min(xs0), min(ys0), max(xs1), max(ys1)),
                               EPSG4326, EPSG3857)
            out.update({"xmin": b.xmin, "ymin": b.ymin,
                        "xmax": b.xmax, "ymax": b.ymax})
        if stamps_min:
            out["min_stamp"] = fmt_time(min(stamps_min))
            out["max_stamp"] = fmt_time(max(stamps_max))
        return out

    def list_files(self) -> List[str]:
        return [r[0] for r in self._fetchall(
            "SELECT path FROM files ORDER BY path")]


def sanitize_namespace(ns: str) -> str:
    """`regexp_replace(trim(ns), '[^a-zA-Z0-9_]', '_')` (mas.sql:495) —
    the single source of the namespace character rule, shared with the
    crawler."""
    import re
    return re.sub(r"[^a-zA-Z0-9_]", "_", ns.strip())


_sanitize_ns = sanitize_namespace


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
    # vertex containment either way
    for poly in a.polys:
        for p in poly[0][:: max(1, len(poly[0]) // 64)]:
            if b.contains_point(p[0], p[1]):
                return True
    for poly in b.polys:
        for p in poly[0][:: max(1, len(poly[0]) // 64)]:
            if a.contains_point(p[0], p[1]):
                return True
    # edge crossings
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
    p = r1[:-1][:, None, :]   # (N,1,2)
    pr = r1[1:][:, None, :] - p
    q = r2[:-1][None, :, :]   # (1,M,2)
    qs = r2[1:][None, :, :] - q
    d = q - p                 # (N,M,2)
    rxs = np.cross(pr, qs)    # (N,M)
    t = np.cross(d, qs)
    u = np.cross(d, pr)
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = t / rxs
        uu = u / rxs
    hit = (rxs != 0) & (tt >= 0) & (tt <= 1) & (uu >= 0) & (uu <= 1)
    return bool(hit.any())
