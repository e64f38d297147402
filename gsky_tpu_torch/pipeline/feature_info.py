"""GetFeatureInfo: the value under a clicked pixel, per namespace, with
the contributing files and dates.

Counterpart of `gsky_tpu/pipeline/feature_info.py`: the request renders
through the modular route (`TilePipeline.index`, then `render`: the
fused warp through B1 or B2, or with a mask band the mosaic through B4)
on the pipeline's device, and pixel (x, y) is read back.
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .tile import TilePipeline
from .types import GeoTileRequest


@dataclass
class FeatureInfo:
    values: Dict[str, Optional[float]]
    files: List[str] = field(default_factory=list)
    dates: List[str] = field(default_factory=list)


def get_feature_info(pipe: TilePipeline, req: GeoTileRequest,
                     x: int, y: int) -> FeatureInfo:
    """Render ``req`` and read pixel (x, y), 0-based from the top left
    (WMS 1.3.0 i/j): a namespace's value, or None where it is not
    valid."""
    if not (0 <= x < req.width and 0 <= y < req.height):
        raise ValueError(f"i/j ({x},{y}) outside {req.width}x{req.height}")
    granules = pipe.index(req)
    res = pipe.render(req, granules)
    values: Dict[str, Optional[float]] = {}
    for ns in res.namespaces:
        if ns in res.data and bool(res.valid[ns][y, x]):
            values[ns] = float(res.data[ns][y, x])
        else:
            values[ns] = None
    files = sorted({g.path for g in granules})
    dates = sorted({
        dt.datetime.fromtimestamp(g.timestamp, dt.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.000Z")
        for g in granules if g.timestamp})
    return FeatureInfo(values, files, dates)
