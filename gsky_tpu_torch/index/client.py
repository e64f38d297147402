"""MAS client used by the pipelines.

Counterpart of `gsky_tpu/index/client.py`.  The tile indexer asks
``?intersects&metadata=gdal`` and parses `Dataset` records
(`processor/tile_indexer.go:42-86`); a layer's dates come from
``?timestamps``.  Two transports: HTTP to a masapi at ``host:port``
(`index.api`, or the reference's), with bounded retries of transport
errors and 5xx answers under a per-address circuit breaker, and
in-process over any store object with an ``intersects`` method (a
`MASStore` or a `MASShardedStore`).  A masapi error body surfaces as
``MAS error: ...``.  Both transports run under the retry policy and
the breaker, behind the ``mas`` fault site (`resilience.faults`), so
an in-process store takes the recovery path a remote masapi does.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..resilience import (RetryPolicy, call_with_retry, clamp_timeout,
                          faults, get_breaker)
from .store import parse_time

DEFAULT_MAS_TIMEOUT = 60.0


@dataclass
class DatasetAxis:
    """Extra (non-time) axis on a dataset."""

    name: str
    params: List[float] = field(default_factory=list)
    strides: List[int] = field(default_factory=list)
    shape: List[int] = field(default_factory=list)
    grid: str = ""

    @classmethod
    def from_json(cls, j: Dict) -> "DatasetAxis":
        return cls(name=j.get("name", ""),
                   params=list(j.get("params") or []),
                   strides=list(j.get("strides") or []),
                   shape=list(j.get("shape") or []),
                   grid=j.get("grid") or "")


@dataclass
class Dataset:
    """One `GDALDataset` record from MAS."""

    file_path: str
    ds_name: str
    namespace: str
    array_type: str
    srs: str
    geo_transform: Optional[List[float]]
    timestamps: List[float]          # unix seconds
    timestamps_iso: List[str]
    polygon: str
    nodata: float
    axes: List[DatasetAxis] = field(default_factory=list)
    means: Optional[List[float]] = None
    sample_counts: Optional[List[int]] = None
    geo_loc: Optional[Dict] = None
    overviews: Optional[List[Dict]] = None

    @classmethod
    def from_json(cls, j: Dict) -> "Dataset":
        iso = list(j.get("timestamps") or [])
        return cls(
            file_path=j.get("file_path", ""),
            ds_name=j.get("ds_name", ""),
            namespace=j.get("namespace", ""),
            array_type=j.get("array_type", "Float32"),
            srs=j.get("srs", ""),
            geo_transform=j.get("geo_transform"),
            timestamps=[parse_time(s) for s in iso],
            timestamps_iso=iso,
            polygon=j.get("polygon", ""),
            nodata=float(j.get("nodata") or 0.0),
            axes=[DatasetAxis.from_json(a) for a in (j.get("axes") or [])],
            means=j.get("means"),
            sample_counts=j.get("sample_counts"),
            geo_loc=j.get("geo_loc"),
            overviews=j.get("overviews"),
        )


class MASClient:
    """``address``: ``'host:port'`` of a masapi, or a store object for
    the in-process transport.  ``requests`` counts the HTTP requests
    sent (every attempt)."""

    def __init__(self, address, timeout: float = DEFAULT_MAS_TIMEOUT):
        if hasattr(address, "intersects"):
            self._store = address
            self.address = "<in-process>"
        else:
            self._store = None
            self.address = address
        self.timeout = float(timeout or DEFAULT_MAS_TIMEOUT)
        self._breaker = get_breaker(f"mas:{self.address}")
        self._retry = RetryPolicy(max_attempts=3, base_delay=0.1,
                                  max_delay=2.0)
        self._lock = threading.Lock()
        self.requests = 0

    def _get(self, gpath: str, params: Dict[str, str], op: str) -> Dict:
        return call_with_retry(
            lambda: self._get_once(gpath, params, op),
            self._retry, site="mas", breaker=self._breaker)

    def _get_once(self, gpath: str, params: Dict[str, str],
                  op: str) -> Dict:
        faults.inject("mas")
        if self._store is not None:
            return self._call_store(gpath, params, op)
        return self._get_http(gpath, params, op)

    def _call_store(self, gpath: str, params: Dict[str, str],
                    op: str) -> Dict:
        ns = params.get("namespace", "")
        namespaces = ns.split(",") if ns else None
        if op == "intersects":
            return self._store.intersects(
                gpath, srs=params.get("srs", ""),
                wkt=params.get("wkt", ""),
                nseg=int(params.get("nseg") or 2),
                time=params.get("time", ""),
                until=params.get("until", ""),
                metadata=params.get("metadata", ""),
                limit=int(params.get("limit") or 0),
                namespaces=namespaces)
        if op == "timestamps":
            return self._store.timestamps(
                gpath, time=params.get("time", ""),
                until=params.get("until", ""),
                token=params.get("token", ""), namespaces=namespaces)
        if op == "extents":
            return self._store.extents(gpath, namespaces=namespaces)
        raise ValueError(op)

    def _get_http(self, gpath: str, params: Dict[str, str],
                  op: str) -> Dict:
        qs = urllib.parse.urlencode({op: "", **params})
        url = f"http://{self.address}{urllib.parse.quote(gpath)}?{qs}"
        with self._lock:
            self.requests += 1
        try:
            with urllib.request.urlopen(
                    url, timeout=clamp_timeout(self.timeout)) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # surface masapi's JSON error body: a 5xx is the server
            # failing (retryable), a 4xx an answer no retry changes
            try:
                body = json.loads(e.read())
            except ValueError:
                err = RuntimeError(f"MAS HTTP {e.code}")
            else:
                err = RuntimeError(
                    f"MAS error: {body.get('error', e.code)}")
            err.retryable = e.code >= 500
            raise err from e

    def intersects(self, gpath: str, *, srs: str = "", wkt: str = "",
                   time: str = "", until: str = "", namespaces: str = "",
                   nseg: int = 2, limit: int = 0,
                   metadata: str = "gdal") -> List[Dataset]:
        params = {"metadata": metadata, "srs": srs, "wkt": wkt,
                  "time": time, "until": until, "namespace": namespaces,
                  "nseg": str(nseg)}
        if limit:
            params["limit"] = str(limit)
        resp = self._get(gpath, params, "intersects")
        if resp.get("error") and resp["error"] not in ("", "OK"):
            raise RuntimeError(f"MAS error: {resp['error']}")
        return [Dataset.from_json(j) for j in resp.get("gdal") or []]

    def file_list(self, gpath: str, **kw) -> List[str]:
        params = {k: str(v) for k, v in kw.items() if v}
        resp = self._get(gpath, params, "intersects")
        return resp.get("files") or []

    def timestamps(self, gpath: str, *, time: str = "", until: str = "",
                   namespaces: str = "", token: str = "") -> Dict:
        return self._get(gpath, {"time": time, "until": until,
                                 "namespace": namespaces, "token": token},
                         "timestamps")

    def extents(self, gpath: str, namespaces: str = "") -> Dict:
        return self._get(gpath, {"namespace": namespaces}, "extents")
