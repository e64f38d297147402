"""Granule/raster <-> RPC message conversion for the worker boundary.

Counterpart of `gsky_tpu/worker/serialize.py`, over the port's codec
(`gskyrpc`)."""

from __future__ import annotations

import json
import math
from typing import Optional, Tuple

import numpy as np

from ..pipeline.types import Granule
from . import gskyrpc as pb


def granule_to_pb(g: Granule) -> pb.Granule:
    m = pb.Granule(
        path=g.path, ds_name=g.ds_name, var_name=g.var_name,
        band=int(g.band),
        time_index=-1 if g.time_index is None else int(g.time_index),
        timestamp=float(g.timestamp), srs=g.srs,
        array_type=g.array_type, is_netcdf=bool(g.is_netcdf),
        namespace=g.namespace, base_namespace=g.base_namespace)
    m.geo_transform.extend(float(v) for v in (g.geo_transform or []))
    if g.nodata is not None and not (isinstance(g.nodata, float)
                                     and math.isnan(g.nodata)):
        m.nodata = float(g.nodata)
        m.has_nodata = True
    if g.geo_loc:
        m.geo_loc_json = json.dumps(g.geo_loc)
    if g.polygon:
        m.polygon = g.polygon
    return m


def granule_from_pb(m: pb.Granule) -> Granule:
    return Granule(
        path=m.path, ds_name=m.ds_name, namespace=m.namespace,
        base_namespace=m.base_namespace, band=m.band,
        time_index=None if m.time_index < 0 else m.time_index,
        timestamp=m.timestamp, srs=m.srs,
        geo_transform=list(m.geo_transform),
        nodata=m.nodata if m.has_nodata else None,
        array_type=m.array_type or "Float32",
        is_netcdf=m.is_netcdf, var_name=m.var_name,
        geo_loc=json.loads(m.geo_loc_json) if m.geo_loc_json else None,
        polygon=m.polygon)


def pack_raster(result: pb.Result, data: np.ndarray,
                valid: np.ndarray) -> None:
    """float32 raster + packed-bit validity into a Result in place."""
    h, w = data.shape
    result.raster = np.ascontiguousarray(data, np.float32).tobytes()
    result.valid = np.packbits(
        np.ascontiguousarray(valid, bool), axis=None).tobytes()
    del result.shape[:]
    result.shape.extend([h, w])


def unpack_raster(result: pb.Result
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    if len(result.shape) != 2 or not result.raster:
        return None
    h, w = result.shape
    data = np.frombuffer(result.raster, np.float32).reshape(h, w)
    bits = np.unpackbits(np.frombuffer(result.valid, np.uint8),
                         count=h * w)
    return data.copy(), bits.astype(bool).reshape(h, w)
