"""MAS client used by the tile pipeline.

Counterpart of `gsky_tpu/index/client.py`, in-process transport only:
`MASClient(store)` answers ``?intersects&metadata=gdal`` from a
`MASStore` and parses the records into `Dataset`s, and ``?timestamps``
(a layer's dates).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .store import parse_time


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
    """In-process client over a `MASStore`."""

    def __init__(self, store):
        self._store = store

    def intersects(self, gpath: str, *, srs: str = "", wkt: str = "",
                   time: str = "", until: str = "", namespaces: str = "",
                   nseg: int = 2, limit: int = 0) -> List[Dataset]:
        resp = self._store.intersects(
            gpath, srs=srs, wkt=wkt, nseg=nseg, time=time, until=until,
            namespaces=namespaces.split(",") if namespaces else None,
            metadata="gdal", limit=limit)
        return [Dataset.from_json(j) for j in resp.get("gdal") or []]

    def timestamps(self, gpath: str, *, time: str = "", until: str = "",
                   namespaces: str = "", token: str = "") -> Dict:
        return self._store.timestamps(
            gpath, time=time, until=until,
            namespaces=namespaces.split(",") if namespaces else None,
            token=token)
