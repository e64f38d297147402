"""Byte-range sources: the object-store client under ranged decode.

Counterpart of `gsky_tpu/ingest/source.py`.  A `ByteSource` answers
exact byte-range requests for one granule:

* `LocalFileSource` — ``os.pread`` on a descriptor kept open; pread
  carries its own offset, so threads read ranges of one file at once;
* `HTTPRangeSource` — HTTP/1.1 ``Range: bytes=a-b`` requests over a
  small keep-alive connection pool, retried through
  `resilience.retry` (transport errors and 5xx; a 4xx, such as 416,
  is not); a 200 (the server ignored the Range) is sliced;
* `S3RangeSource` — ``s3://bucket/key`` through the same pool, signed
  with SigV4 from the ``AWS_*`` environment, re-signed on each retry.

`fetch_ranges` is the funnel every ranged read goes through: it merges
ranges whose gap is at most ``GSKY_RANGE_COALESCE_KB`` (default 64)
into one request, slices each range back out and records the requests
and bytes in `stats`.  `source_for` caches a source per path under the
``GSKY_INGEST_SOURCES`` allowlist (default ``local,http``); a scheme
outside it gives None, and the caller reads through its handle.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qsl, quote, urlsplit

from ..resilience.retry import RetryPolicy, call_with_retry
from . import stats


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def coalesce_kb() -> int:
    """Gap (KiB) under which neighbouring ranges merge into one request
    — re-read per call so the knob is live-tunable."""
    return max(0, _env_int("GSKY_RANGE_COALESCE_KB", 64))


class ByteSource:
    """Abstract ranged reader for one granule."""

    def read_range(self, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def size(self) -> Optional[int]:
        return None

    def close(self) -> None:
        pass


class LocalFileSource(ByteSource):
    """pread-based local source: lock-free concurrent range reads."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self._size = os.fstat(self._fd).st_size
        self._closed = False

    def read_range(self, offset: int, length: int) -> bytes:
        if offset < 0 or length < 0 or offset + length > self._size:
            raise ValueError(
                f"range [{offset}, {offset + length}) beyond "
                f"{self.path} size {self._size}")
        out = b""
        while len(out) < length:
            chunk = os.pread(self._fd, length - len(out), offset + len(out))
            if not chunk:
                raise IOError(
                    f"short pread at {offset + len(out)} in {self.path}")
            out += chunk
        return out

    def size(self) -> Optional[int]:
        return self._size

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                os.close(self._fd)
            except OSError:
                pass


class _RangeHTTPError(Exception):
    """Non-2xx answer to a Range request; ``retryable`` follows the
    resilience convention (5xx retries, 4xx doesn't)."""

    def __init__(self, status: int, url: str):
        super().__init__(f"HTTP {status} for ranged GET {url}")
        self.status = status
        self.retryable = status >= 500


class HTTPRangeSource(ByteSource):
    """Ranged GETs against one URL with keep-alive connection pooling.

    The pool holds up to ``pool_size`` idle connections; concurrent
    readers beyond that open transient connections (closed on release)
    so a burst never blocks on the pool.  Retries ride
    `resilience.retry.call_with_retry` — jittered backoff, transport
    errors and 5xx only."""

    def __init__(self, url: str, pool_size: int = 4, timeout: float = 10.0):
        self.url = url
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"not an http(s) url: {url}")
        self._scheme = parts.scheme
        self._host = parts.hostname or ""
        self._port = parts.port
        self._path = (parts.path or "/") + \
            (("?" + parts.query) if parts.query else "")
        self._pool_size = max(1, int(pool_size))
        self._timeout = timeout
        self._idle: List[object] = []
        self._lock = threading.Lock()
        self._size: Optional[int] = None
        self._closed = False
        self.requests = 0

    # -- connection pool ------------------------------------------------

    def _connect(self):
        cls = http.client.HTTPSConnection if self._scheme == "https" \
            else http.client.HTTPConnection
        return cls(self._host, self._port, timeout=self._timeout)

    def _acquire(self):
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return self._connect()

    def _release(self, conn, broken: bool = False) -> None:
        if broken:
            try:
                conn.close()
            except Exception:  # broken conn - close is best-effort
                pass
            return
        with self._lock:
            if not self._closed and len(self._idle) < self._pool_size:
                self._idle.append(conn)
                return
        try:
            conn.close()
        except Exception:  # pool full or closed - drop the conn, close errors are moot
            pass

    # -- requests -------------------------------------------------------

    def _request_headers(self, method: str,
                         headers: Dict[str, str]) -> Dict[str, str]:
        """Per-request header hook; subclasses (S3RangeSource) add
        authentication here.  Must return the headers to send —
        including the ones passed in."""
        return headers

    def _once(self, offset: int, length: int) -> bytes:
        conn = self._acquire()
        try:
            conn.request("GET", self._path, headers=self._request_headers(
                "GET", {
                    "Range": f"bytes={offset}-{offset + length - 1}",
                    "Connection": "keep-alive"}))
            resp = conn.getresponse()
            body = resp.read()
            self.requests += 1
            if resp.status == 206:
                cr = resp.getheader("Content-Range", "")
                if self._size is None and "/" in cr:
                    try:
                        self._size = int(cr.rsplit("/", 1)[1])
                    except ValueError:
                        pass
                if len(body) != length:
                    raise IOError(
                        f"short ranged body {len(body)} != {length} "
                        f"from {self.url}")
                self._release(conn)
                return body
            if resp.status == 200:
                # server ignored Range: serve the slice, don't pool the
                # full-body connection state assumptions any further
                self._size = len(body)
                self._release(conn)
                return body[offset:offset + length]
            self._release(conn, broken=resp.status >= 500)
            raise _RangeHTTPError(resp.status, self.url)
        except _RangeHTTPError:
            raise
        except Exception:
            self._release(conn, broken=True)
            raise

    def read_range(self, offset: int, length: int) -> bytes:
        return call_with_retry(
            lambda: self._once(offset, length),
            RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=0.5),
            site=f"ingest:{self._host}")

    def size(self) -> Optional[int]:
        if self._size is None:
            # HEAD once to learn the length (needed for chunk-map
            # bounds checks before the first ranged GET answers)
            conn = self._acquire()
            try:
                conn.request("HEAD", self._path,
                             headers=self._request_headers("HEAD", {}))
                resp = conn.getresponse()
                resp.read()
                cl = resp.getheader("Content-Length")
                if cl is not None:
                    self._size = int(cl)
                self._release(conn)
            except Exception:
                self._release(conn, broken=True)
        return self._size

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for c in idle:
            try:
                c.close()
            except Exception:  # teardown - close errors on idle conns are moot
                pass


# ---------------------------------------------------------------------------
# s3:// — SigV4-signed ranged reads
# ---------------------------------------------------------------------------

# sha256 of an empty payload: ranged GET/HEAD bodies are empty
EMPTY_PAYLOAD_SHA256 = ("e3b0c44298fc1c149afbf4c8996fb9242"
                        "7ae41e4649b934ca495991b7852b855")


def aws_credentials() -> Optional[Tuple[str, str, Optional[str]]]:
    """The env credential chain: (access_key, secret_key, session
    token or None), or None when unconfigured (anonymous requests —
    public buckets still work unsigned)."""
    ak = os.environ.get("AWS_ACCESS_KEY_ID", "")
    sk = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    if not ak or not sk:
        return None
    return ak, sk, os.environ.get("AWS_SESSION_TOKEN") or None


def sigv4_headers(method: str, host: str, path: str, query: str = "",
                  region: str = "us-east-1", access_key: str = "",
                  secret_key: str = "",
                  session_token: Optional[str] = None,
                  amzdate: Optional[str] = None,
                  payload_hash: str = EMPTY_PAYLOAD_SHA256,
                  headers: Optional[Dict[str, str]] = None,
                  service: str = "s3") -> Dict[str, str]:
    """AWS Signature Version 4, header-auth flavour.

    Pure function of its inputs — ``amzdate`` (``YYYYMMDDTHHMMSSZ``)
    is injectable so tests can pin the canned AWS vector instead of
    the clock.  ``headers`` are extra headers to SIGN (e.g. Range);
    every signed header must then be sent byte-identical.  Returns the
    headers to attach: the signed extras, ``x-amz-*``, and
    ``Authorization`` (``host`` is omitted — http.client sends it)."""
    if amzdate is None:
        amzdate = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    datestamp = amzdate[:8]
    hdrs = {"host": host, "x-amz-content-sha256": payload_hash,
            "x-amz-date": amzdate}
    for k, v in (headers or {}).items():
        hdrs[k.lower()] = str(v)
    if session_token:
        hdrs["x-amz-security-token"] = session_token
    names = sorted(hdrs)
    signed_names = ";".join(names)
    canonical_headers = "".join(
        f"{k}:{hdrs[k].strip()}\n" for k in names)
    q = ""
    if query:
        q = "&".join(
            f"{quote(k, safe='-_.~')}={quote(v, safe='-_.~')}"
            for k, v in sorted(parse_qsl(query,
                                         keep_blank_values=True)))
    creq = "\n".join([method, path or "/", q, canonical_headers,
                      signed_names, payload_hash])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_sign = _hmac(_hmac(_hmac(_hmac(("AWS4" + secret_key).encode(),
                                     datestamp), region), service),
                   "aws4_request")
    sig = hmac.new(k_sign, to_sign.encode(), hashlib.sha256).hexdigest()
    out = {k: hdrs[k] for k in names if k != "host"}
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={sig}")
    return out


class S3RangeSource(HTTPRangeSource):
    """``s3://bucket/key`` through the same ranged-GET pool, with
    SigV4 header signing from the env credential chain
    (``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY`` /
    ``AWS_SESSION_TOKEN``); unsigned when no credentials are set.
    Region from ``AWS_REGION`` / ``AWS_DEFAULT_REGION`` (default
    us-east-1); a custom endpoint (``AWS_ENDPOINT_URL_S3`` /
    ``AWS_ENDPOINT_URL`` — minio, localstack) switches to path-style
    addressing.  Every retry is re-signed: `_request_headers` runs per
    attempt, so a request never goes out with a stale date."""

    def __init__(self, url: str, pool_size: int = 4,
                 timeout: float = 10.0):
        parts = urlsplit(url)
        if parts.scheme != "s3" or not parts.netloc or \
                not parts.path.lstrip("/"):
            raise ValueError(f"not an s3://bucket/key url: {url}")
        self.bucket = parts.netloc
        self.key = parts.path.lstrip("/")
        self.region = (os.environ.get("AWS_REGION")
                       or os.environ.get("AWS_DEFAULT_REGION")
                       or "us-east-1")
        endpoint = (os.environ.get("AWS_ENDPOINT_URL_S3")
                    or os.environ.get("AWS_ENDPOINT_URL") or "")
        if endpoint:
            http_url = (endpoint.rstrip("/")
                        + f"/{self.bucket}/{self.key}")
        else:
            host = (f"{self.bucket}.s3.amazonaws.com"
                    if self.region == "us-east-1" else
                    f"{self.bucket}.s3.{self.region}.amazonaws.com")
            http_url = f"https://{host}/{self.key}"
        super().__init__(http_url, pool_size=pool_size, timeout=timeout)
        self.s3_url = url

    def _signing_host(self) -> str:
        if self._port and self._port not in (80, 443):
            return f"{self._host}:{self._port}"
        return self._host

    def _request_headers(self, method: str,
                         headers: Dict[str, str]) -> Dict[str, str]:
        creds = aws_credentials()
        if creds is None:
            return headers
        access_key, secret_key, token = creds
        path, _, query = self._path.partition("?")
        sign = {k: v for k, v in headers.items()
                if k.lower() != "connection"}   # hop-by-hop: unsigned
        out = dict(headers)
        out.update(sigv4_headers(
            method, self._signing_host(), path, query=query,
            region=self.region, access_key=access_key,
            secret_key=secret_key, session_token=token, headers=sign))
        return out


# ---------------------------------------------------------------------------
# Range coalescing + the fetch funnel
# ---------------------------------------------------------------------------

def coalesce_ranges(ranges: Sequence[Tuple[int, int]], max_gap: int
                    ) -> List[Tuple[int, int, List[int]]]:
    """Merge byte ranges whose gap is ≤ ``max_gap`` into request groups.

    Returns [(start, length, member_indices)] covering every input
    range; members keep their original indices so callers can slice
    each chunk back out of the group blob.  Overlapping and unsorted
    inputs are handled (COG tile offsets are usually monotonic, but
    nothing guarantees it)."""
    if not ranges:
        return []
    order = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
    groups: List[Tuple[int, int, List[int]]] = []
    start, end, members = None, None, []
    for i in order:
        o, n = ranges[i]
        if n < 0 or o < 0:
            raise ValueError(f"negative range ({o}, {n})")
        if start is None:
            start, end, members = o, o + n, [i]
        elif o <= end + max_gap:
            end = max(end, o + n)
            members.append(i)
        else:
            groups.append((start, end - start, members))
            start, end, members = o, o + n, [i]
    if start is not None:
        groups.append((start, end - start, members))
    return groups


def fetch_ranges(source: ByteSource, ranges: Sequence[Tuple[int, int]]
                 ) -> List[bytes]:
    """Fetch every (offset, nbytes) range through ``source``, coalesced
    per ``GSKY_RANGE_COALESCE_KB``; returns the per-range byte strings
    in input order and records the request/byte/overlap accounting."""
    if not ranges:
        return []
    gap = coalesce_kb() * 1024
    groups = coalesce_ranges(ranges, gap)
    out: List[Optional[bytes]] = [None] * len(ranges)
    t0 = time.perf_counter()
    total = 0
    for start, length, members in groups:
        blob = source.read_range(start, length)
        total += length
        for i in members:
            o, n = ranges[i]
            out[i] = blob[o - start:o - start + n]
    stats.record_ranged(len(groups), total, time.perf_counter() - t0)
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Per-path source cache
# ---------------------------------------------------------------------------

_sources: Dict[str, ByteSource] = {}
_sources_order: List[str] = []
_sources_lock = threading.Lock()
_MAX_SOURCES = 64


def allowed_kinds() -> Tuple[str, ...]:
    raw = os.environ.get("GSKY_INGEST_SOURCES", "local,http")
    return tuple(k.strip() for k in raw.split(",") if k.strip())


def open_source(path: str) -> Optional[ByteSource]:
    """A fresh source for ``path`` (no cache), or None when its scheme
    is outside the ``GSKY_INGEST_SOURCES`` allowlist."""
    kinds = allowed_kinds()
    if path.startswith(("http://", "https://")):
        return HTTPRangeSource(path) if "http" in kinds else None
    if path.startswith("s3://"):
        # opt-in: add "s3" to GSKY_INGEST_SOURCES (credentials ride
        # the standard AWS_* env chain; unsigned without them)
        return S3RangeSource(path) if "s3" in kinds else None
    return LocalFileSource(path) if "local" in kinds else None


def source_for(path: str) -> Optional[ByteSource]:
    """Cached source for ``path`` — the ranged analogue of the decode
    handle cache, bounded FIFO like it."""
    with _sources_lock:
        s = _sources.get(path)
        if s is not None:
            return s
    s = open_source(path)
    if s is None:
        return None
    with _sources_lock:
        cur = _sources.get(path)
        if cur is not None:
            close_later = s
            s = cur
        else:
            close_later = None
            _sources[path] = s
            _sources_order.append(path)
            while len(_sources_order) > _MAX_SOURCES:
                old = _sources_order.pop(0)
                try:
                    _sources.pop(old).close()
                except Exception:  # evicted source may already be closed
                    pass
    if close_later is not None:
        close_later.close()
    return s


def reset_sources() -> None:
    """Close + drop every cached source (tests; soak leg boundaries)."""
    with _sources_lock:
        srcs = list(_sources.values())
        _sources.clear()
        _sources_order.clear()
    for s in srcs:
        try:
            s.close()
        except Exception:  # teardown - close errors are moot
            pass
