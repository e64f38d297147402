"""Sharded MAS store: one sqlite shard per top-level directory.

Counterpart of `gsky_tpu/index/sharded.py`, the schema-per-shard scale
path of the reference (`mas/MAS_Design.md:11-17`,
`mas/db/shard_ingest.sh`).  Each top-level directory under the data
root is a shard with its own sqlite file under ``<root>/.gsky_mas``;
ingest routes by file path, queries route by gpath: one shard when the
gpath names it, a concurrent fan-out and a merge (files path-sorted,
records by (file_path, ds_name)) when the gpath spans the root.  Shards
can be built by independent crawler runs, re-ingested or dropped
without touching each other; a shard file that appears later joins the
next root-spanning query.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
from typing import Dict, List, Optional, Sequence

from .store import MASStore


class MASShardedStore:
    """gpath-routing composite over per-directory `MASStore` shards."""

    def __init__(self, root: str, db_dir: Optional[str] = None):
        self.root = os.path.abspath(root)
        self.db_dir = db_dir or os.path.join(self.root, ".gsky_mas")
        os.makedirs(self.db_dir, exist_ok=True)
        self._shards: Dict[str, MASStore] = {}
        self._lock = threading.Lock()
        self._pool = cf.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="gsky-mas-shard")
        # adopt shard DBs left by previous runs / other ingesters
        for fn in sorted(os.listdir(self.db_dir)):
            if fn.endswith(".sqlite"):
                self._shard(fn[:-len(".sqlite")])

    def _shard_key(self, path: str) -> str:
        """Shard = first path component under the root ('' when the
        path IS the root or lies outside it — those land in a catch-all
        shard, like the reference's public schema)."""
        p = os.path.abspath(path)
        if p == self.root or not p.startswith(self.root + os.sep):
            return "_root"
        rel = p[len(self.root) + 1:]
        return rel.split(os.sep, 1)[0] or "_root"

    def _shard(self, key: str,
               create: bool = True) -> Optional[MASStore]:
        """The shard for ``key``.  Reads pass create=False: a query for
        a collection that was never ingested must NOT materialise an
        empty .sqlite on disk (arbitrary HTTP GETs would otherwise grow
        unbounded junk shards that join every future fan-out)."""
        with self._lock:
            s = self._shards.get(key)
            if s is not None:
                return s
            db = os.path.join(self.db_dir, f"{key}.sqlite")
            if not create and not os.path.exists(db):
                return None
            s = MASStore(db)
            self._shards[key] = s
            return s

    def _adopt_new(self) -> None:
        """Register shard DBs that appeared in db_dir after startup —
        the rsync-a-shard-in workflow must be visible to root-spanning
        queries without a restart."""
        try:
            names = os.listdir(self.db_dir)
        except OSError:
            return
        for fn in names:
            if fn.endswith(".sqlite"):
                key = fn[:-len(".sqlite")]
                with self._lock:
                    known = key in self._shards
                if not known:
                    self._shard(key)

    def _route(self, gpath: str) -> List[MASStore]:
        key = self._shard_key(gpath)
        if key != "_root":
            s = self._shard(key, create=False)
            return [s] if s is not None else []
        self._adopt_new()
        with self._lock:
            return list(self._shards.values())

    # -- MASStore API ---------------------------------------------------

    def ingest(self, record: Dict) -> int:
        path = record.get("filename") or record.get("file_path") or ""
        return self._shard(self._shard_key(path)).ingest(record)

    def ingest_many(self, records) -> int:
        """Batch ingest, one transaction per shard."""
        from collections import defaultdict
        by: Dict[str, list] = defaultdict(list)
        for r in records:
            path = r.get("filename") or r.get("file_path") or ""
            by[self._shard_key(path)].append(r)
        return sum(self._shard(k).ingest_many(rs)
                   for k, rs in by.items())

    @property
    def generation(self) -> int:
        with self._lock:
            shards = list(self._shards.values())
        return sum(s.generation for s in shards)

    def intersects(self, gpath: str, **kw) -> Dict:
        shards = self._route(gpath)
        key = "gdal" if kw.get("metadata") == "gdal" else "files"
        if not shards:
            return {key: []}
        if len(shards) == 1:
            return shards[0].intersects(gpath, **kw)
        parts = list(self._pool.map(
            lambda s: s.intersects(gpath, **kw), shards))
        out = [d for part in parts for d in (part.get(key) or [])]
        # single-store contract: files come back path-sorted; keep the
        # fan-out deterministic (and limit truncation order-stable)
        out = sorted(out) if key == "files" else \
            sorted(out, key=lambda d: (d.get("file_path", ""),
                                       d.get("ds_name", "")))
        limit = int(kw.get("limit") or 0)
        if limit > 0:
            out = out[:limit]
        return {key: out}

    def timestamps(self, gpath: str, time: str = "", until: str = "",
                   namespaces: Optional[Sequence[str]] = None,
                   token: str = "") -> Dict:
        from .store import timestamps_token
        shards = self._route(gpath)
        if not shards:
            result: List[str] = []
            return {"timestamps": result,
                    "token": timestamps_token(result)}
        if len(shards) == 1:
            return shards[0].timestamps(gpath, time, until, namespaces,
                                        token)
        stamps = set()
        for part in self._pool.map(
                lambda s: s.timestamps(gpath, time, until, namespaces),
                shards):
            stamps.update(part.get("timestamps") or [])
        result = sorted(stamps)
        query_token = timestamps_token(result)
        if token and token == query_token:
            return {"timestamps": [], "token": token}
        return {"timestamps": result, "token": query_token}

    def extents(self, gpath: str,
                namespaces: Optional[Sequence[str]] = None) -> Dict:
        shards = self._route(gpath)
        if not shards:
            return {}
        if len(shards) == 1:
            return shards[0].extents(gpath, namespaces)
        merged: Dict = {}
        for part in self._pool.map(
                lambda s: s.extents(gpath, namespaces), shards):
            if not part:
                continue
            if not merged:
                merged = dict(part)
                continue
            merged["variables"] = sorted(
                set(merged.get("variables", []))
                | set(part.get("variables", [])))
            for k, fn in (("xmin", min), ("ymin", min),
                          ("xmax", max), ("ymax", max),
                          ("min_stamp", min), ("max_stamp", max)):
                if k in part:
                    merged[k] = fn(merged[k], part[k]) \
                        if k in merged else part[k]
        return merged
