"""masapi: the HTTP face of the metadata index.

Counterpart of `gsky_tpu/index/api.py` (`mas/api/api.go`), served by
the standard library's threaded HTTP server, as the port's OWS server
is.  Every GET or POST path is a collection path; the operation is a
bare query key (``?intersects``, ``?timestamps``, ``?extents``); a
parameter comes from the query string, else from a POSTed urlencoded
form (big drill polygons POST their wkt), else its default, with
Python ``or`` semantics (an empty value falls through).  A body is
``json.dumps`` of the store's answer, byte for byte the reference's,
under ``application/json; charset=utf-8``; an error is
``{"error": ...}`` with status 400, an unknown operation included.
Answers are cached in `MasQueryCache` (keyed on the store generation,
path, query and form, so an ingest invalidates them) and, with
``GSKY_MAS_SHARED_CACHE`` naming a sqlite file, in a
`SharedResponseCache` that several processes share.

    python -m gsky_tpu_torch.index.api -port 8888 -ingest crawl.tsv
        [-database FILE | -shard-root DIR] [-shared-cache FILE]

`ingest_file` loads crawler output (JSON lines or TSV) into a store.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import logging
import os
import sqlite3
import sys
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from .store import MASStore

log = logging.getLogger("gsky.masapi")

MAX_BODY = 64 * 1024 * 1024          # the reference app's client_max_size
CONTENT_TYPE = "application/json; charset=utf-8"
UNKNOWN_OP = ("unknown operation; currently supported: "
              "?intersects, ?timestamps, ?extents")
_BATCH = 10_000       # records per ingest transaction


class MasQueryCache:
    """LRU of response bodies keyed on the canonical query, carrying the
    store generation (the memcached tier of `mas/api/api.go:43-52`)."""

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, str]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> Optional[str]:
        with self._lock:
            body = self._entries.get(key)
            if body is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return body

    def put(self, key: tuple, body: str):
        with self._lock:
            self._entries[key] = body
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)


class SharedResponseCache:
    """Cross-process response cache in a sqlite file, behind the
    in-process LRU: masapi processes on one host share answers.  Keys
    carry the store generation; eviction is by insert time, trimmed
    every `_TRIM_EVERY` puts."""

    _TRIM_EVERY = 64

    def __init__(self, path: str, max_entries: int = 8192):
        self.path = path
        self.max_entries = max_entries
        self._local = threading.local()
        self.hits = 0
        self.misses = 0
        self._puts = 0
        c = self._conn()
        c.execute("CREATE TABLE IF NOT EXISTS cache("
                  " k TEXT PRIMARY KEY, body TEXT, ts REAL)")
        c.execute("CREATE INDEX IF NOT EXISTS idx_cache_ts"
                  " ON cache(ts)")
        c.commit()

    def _conn(self) -> sqlite3.Connection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = sqlite3.connect(self.path, timeout=5.0)
            self._local.conn = c
        return c

    @staticmethod
    def _k(key: tuple) -> str:
        return hashlib.sha256(repr(key).encode()).hexdigest()

    def get(self, key: tuple) -> Optional[str]:
        try:
            row = self._conn().execute(
                "SELECT body FROM cache WHERE k = ?",
                (self._k(key),)).fetchone()
        except sqlite3.Error:
            return None         # a broken shared cache is a miss
        if row is None:
            self.misses += 1
            return None
        self.hits += 1
        return row[0]

    def put(self, key: tuple, body: str):
        try:
            c = self._conn()
            c.execute("INSERT OR REPLACE INTO cache(k, body, ts)"
                      " VALUES (?,?,?)", (self._k(key), body, time.time()))
            self._puts += 1
            if self._puts % self._TRIM_EVERY == 0:
                c.execute(
                    "DELETE FROM cache WHERE k IN ("
                    " SELECT k FROM cache ORDER BY ts DESC"
                    " LIMIT -1 OFFSET ?)",
                    (self.max_entries + self._TRIM_EVERY,))
            c.commit()
        except sqlite3.Error:
            pass        # a locked shared cache must not fail the answer


def _ns(v: str):
    return v.split(",") if v else None


class MasAPI:
    """The masapi handler over one store (a `MASStore` or a
    `MASShardedStore`); `serve` puts it behind HTTP."""

    def __init__(self, store, cache: Optional[MasQueryCache] = None,
                 shared_cache: Optional[SharedResponseCache] = None):
        self.store = store
        self.cache = cache if cache is not None else MasQueryCache()
        if shared_cache is None:
            sp = os.environ.get("GSKY_MAS_SHARED_CACHE", "")
            if sp:
                shared_cache = SharedResponseCache(sp)
        self.shared_cache = shared_cache

    def handle(self, gpath: str, query: List[Tuple[str, str]],
               form: List[Tuple[str, str]]) -> Tuple[int, str]:
        """(status, JSON body) for one request: ``gpath`` the decoded
        URL path, ``query`` and ``form`` the (key, value) pairs of the
        query string and of a POSTed form."""
        q: Dict[str, str] = {}
        for k, v in query:
            q.setdefault(k, v)
        f: Dict[str, str] = {}
        for k, v in form:
            f.setdefault(k, v)

        def val(key: str, default: str = "") -> str:
            return q.get(key) or f.get(key) or default

        key = (self.store.generation, gpath, tuple(sorted(query)),
               tuple(sorted(form)))
        hit = self.cache.get(key)
        if hit is not None:
            return 200, hit
        if self.shared_cache is not None:
            hit = self.shared_cache.get(key)
            if hit is not None:
                self.cache.put(key, hit)      # promote into the LRU
                return 200, hit
        try:
            if "intersects" in q:
                result = self.store.intersects(
                    gpath, srs=val("srs"), wkt=val("wkt"),
                    nseg=int(val("nseg") or 2), time=val("time"),
                    until=val("until"), namespaces=_ns(val("namespace")),
                    metadata=val("metadata"),
                    limit=int(val("limit") or 0))
            elif "timestamps" in q:
                result = self.store.timestamps(
                    gpath, time=val("time"), until=val("until"),
                    namespaces=_ns(val("namespace")), token=val("token"))
            elif "extents" in q:
                result = self.store.extents(
                    gpath, namespaces=_ns(val("namespace")))
            else:
                return 400, json.dumps({"error": UNKNOWN_OP})
        except ValueError as e:
            return 400, json.dumps({"error": str(e)})
        body = json.dumps(result)
        self.cache.put(key, body)
        if self.shared_cache is not None:
            self.shared_cache.put(key, body)
        return 200, body

    def serve(self, host: str = "127.0.0.1",
              port: int = 8888) -> "_HTTPServer":
        """Bind ``host``:``port`` (0 = an ephemeral port) and serve in a
        daemon thread, one thread a connection.  Its address is
        ``server_address``; stop it with ``shutdown()`` and
        ``server_close()``."""
        httpd = _HTTPServer((host, port), self)
        httpd.thread.start()
        return httpd


def build_app(store, cache: Optional[MasQueryCache] = None,
              shared_cache: Optional[SharedResponseCache] = None) -> MasAPI:
    return MasAPI(store, cache, shared_cache)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, api: MasAPI):
        super().__init__(address, _Handler)
        self.api = api
        self.thread = threading.Thread(target=self.serve_forever,
                                       name="gsky-masapi-http", daemon=True)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _answer(self, status: int, body: str) -> None:
        data = body.encode()
        self.send_response(status)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self, form: Optional[List[Tuple[str, str]]] = None):
        url = urlsplit(self.path)
        try:
            status, body = self.server.api.handle(
                unquote(url.path) or "/",
                parse_qsl(url.query, keep_blank_values=True), form or [])
        except Exception as e:
            # a store failure that is not a bad request: the client
            # retries a 5xx
            log.exception("masapi: %s failed", self.path)
            status, body = 500, json.dumps({"error": str(e)})
        self._answer(status, body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        if n > MAX_BODY:
            self.close_connection = True
            self._answer(413, json.dumps(
                {"error": f"request body of {n} bytes exceeds {MAX_BODY}"}))
            return
        raw = self.rfile.read(n) if n else b""
        ctype = self.headers.get("Content-Type", "").split(";")[0].strip()
        form = parse_qsl(raw.decode("utf-8"), keep_blank_values=True) \
            if ctype == "application/x-www-form-urlencoded" else []
        self.do_GET(form)

    def log_message(self, fmt, *args):
        pass


def ingest_file(store, path: str) -> int:
    """Ingest a crawler output file, JSON lines or TSV
    (``path\\tgdal\\tjson``), gzipped when its name ends in ``.gz``.
    Returns the number of datasets indexed."""
    opener = gzip.open if path.endswith(".gz") else open
    n = 0
    batch = []
    with opener(path, "rt") as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            if "\t" in line:
                parts = line.split("\t")
                rec = json.loads(parts[-1])
                rec.setdefault("filename", parts[0])
            else:
                rec = json.loads(line)
            batch.append(rec)
            if len(batch) >= _BATCH:
                n += store.ingest_many(batch)
                batch = []
    if batch:
        n += store.ingest_many(batch)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gsky-mas-torch",
                                 description="GSKY metadata index API")
    ap.add_argument("-database", default=":memory:",
                    help="sqlite database path")
    ap.add_argument("-port", type=int, default=8888)
    ap.add_argument("-host", default="0.0.0.0")
    ap.add_argument("-ingest", nargs="*", default=[],
                    help="crawler TSV/JSON files to ingest at startup")
    ap.add_argument("-shard-root", default="",
                    help="serve a sharded index: one sqlite shard per "
                         "top-level directory under this root")
    ap.add_argument("-shared-cache", default="",
                    help="sqlite file for a response cache shared by "
                         "every masapi on this host (also "
                         "GSKY_MAS_SHARED_CACHE)")
    args = ap.parse_args(argv)

    if args.shard_root:
        from .sharded import MASShardedStore
        store = MASShardedStore(args.shard_root)
    else:
        store = MASStore(args.database)
    for path in args.ingest:
        ingest_file(store, path)
    shared = SharedResponseCache(args.shared_cache) \
        if args.shared_cache else None
    httpd = MasAPI(store, shared_cache=shared).serve(args.host, args.port)
    print(f"masapi listening on {args.host}:{httpd.server_address[1]}",
          flush=True)
    try:
        httpd.thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
