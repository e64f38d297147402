"""Request, granule and result types for the tile and drill pipelines.

Counterpart of `gsky_tpu/pipeline/types.py`, trimmed to the fields the
GetMap paths and the WPS drill read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from ..geo.crs import CRS, EPSG3857
from ..geo.transform import BBox, GeoTransform
from ..ops.expr import BandExpressions, parse_band_expressions


@dataclass
class MaskSpec:
    """A quality/cloud mask band."""

    id: str
    value: str = ""
    bit_tests: List[str] = field(default_factory=list)
    data_source: str = ""
    inclusive: bool = False


@dataclass
class AxisSelector:
    """Selection on a non-spatial axis: a value range or explicit
    indices."""

    name: str
    start: Optional[float] = None
    end: Optional[float] = None
    in_values: Optional[List[float]] = None
    idx_start: Optional[int] = None
    idx_end: Optional[int] = None
    idx_step: int = 1
    order: int = 0
    aggregate: int = 1


@dataclass
class GeoTileRequest:
    """One tile render request (GetMap tile)."""

    collection: str                       # MAS gpath
    bands: Sequence[str]                  # rgb_products entries
    bbox: BBox
    crs: CRS = EPSG3857
    width: int = 256
    height: int = 256
    start_time: Optional[float] = None    # unix seconds
    end_time: Optional[float] = None
    axes: List[AxisSelector] = field(default_factory=list)
    mask: Optional[MaskSpec] = None
    resample: str = "near"                # near | bilinear | cubic
    query_limit: int = 0
    polygon_segments: int = 2
    # the layer's known extent in EPSG:4326 (xmin, ymin, xmax, ymax) and
    # the index subdivision it enables (`TilePipeline._index_subdivision`):
    # a request coarser than ``index_res_limit`` degrees a pixel over a
    # 256-px virtual grid is queried in index tiles of
    # 256 * index_tile_{x,y}_size pixels; <= 0 disables
    spatial_extent: Optional[Sequence[float]] = None
    index_tile_x_size: float = 0.0
    index_tile_y_size: float = 0.0
    index_res_limit: float = 0.0

    _exprs: Optional[BandExpressions] = None

    @property
    def band_exprs(self) -> BandExpressions:
        if self._exprs is None:
            object.__setattr__(self, "_exprs",
                               parse_band_expressions(list(self.bands)))
        return self._exprs

    def dst_gt(self) -> GeoTransform:
        return GeoTransform.from_bbox(self.bbox, self.width, self.height)


@dataclass
class Granule:
    """One unit of warp work: (file, band, axis combination)."""

    path: str
    ds_name: str
    namespace: str                        # output namespace (+axis suffix)
    base_namespace: str                   # the MAS namespace it came from
    band: int                             # 1-based band
    time_index: Optional[int]
    timestamp: float
    srs: str
    geo_transform: List[float]
    nodata: float
    array_type: str = "Float32"
    is_netcdf: bool = False
    var_name: str = ""
    geo_loc: Optional[Dict] = None
    polygon: str = ""


@dataclass
class TileResult:
    """Per-namespace float32 canvases + validity masks, as tensors on
    the pipeline's device."""

    data: Dict[str, torch.Tensor]         # namespace -> (H, W) float32
    valid: Dict[str, torch.Tensor]        # namespace -> (H, W) bool
    namespaces: List[str]                 # output order
    granule_count: int = 0
    file_count: int = 0


@dataclass
class GeoDrillRequest:
    """WPS polygon drill request (`drill_types.go`)."""

    collection: str
    bands: Sequence[str]
    geometry_wkt: str                     # in EPSG:4326
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    clip_lower: float = -3.0e38
    clip_upper: float = 3.0e38
    deciles: int = 0
    pixel_count: bool = False
    band_strides: int = 1
    approx: bool = True                   # use the crawler stats fast path
    # VRT granules (`drill_indexer.go:318-346`): not ported yet
    vrt_url: str = ""
    vrt_xml: str = ""
    mask_namespaces: Sequence[str] = ()
    # large-polygon tiling (`drill_indexer.go:115-137`): the polygon
    # splits into index tiles of this size in degrees; 0 disables
    index_tile_x_size: float = 0.0
    index_tile_y_size: float = 0.0

    _exprs: Optional[BandExpressions] = None

    @property
    def band_exprs(self) -> BandExpressions:
        if self._exprs is None:
            object.__setattr__(self, "_exprs",
                               parse_band_expressions(list(self.bands)))
        return self._exprs


@dataclass
class DrillResult:
    """Per-date aggregated statistics: rows indexed by timestamp."""

    dates: List[float]                                  # unix, sorted
    values: Dict[str, List[float]]                      # namespace -> series
    counts: Dict[str, List[int]]
    raw_namespaces: List[str] = field(default_factory=list)
