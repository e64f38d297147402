"""The tile pipeline: index -> fused scene warp + mosaic + byte scale.

Counterpart of the GetMap half of `gsky_tpu/pipeline/tile.py`:
`render_composite_byte` runs one MAS query, expands granules, assigns
namespace slots and newest-first mosaic priorities (`ns_prio`), and
hands the tile to `WarpExecutor.render_byte_scenes`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from ..device import resolve_device
from ..index.client import MASClient
from ..index.store import fmt_time
from ..ops.mosaic import priority_order
from .executor import WarpExecutor
from .granule import expand_granules
from .types import GeoTileRequest, Granule


def ns_prio(gs: Sequence[Granule]):
    """(ns_names, ns_ids, prio) for a granule set: namespace slots in
    first-seen order, mosaic priorities newest-first."""
    ns_names: List[str] = []
    ns_index: Dict[str, int] = {}
    for g in gs:
        if g.namespace not in ns_index:
            ns_index[g.namespace] = len(ns_names)
            ns_names.append(g.namespace)
    ns_ids = [ns_index[g.namespace] for g in gs]
    order = priority_order([g.timestamp for g in gs])
    prio = [0.0] * len(gs)
    for rank, i in enumerate(order):
        prio[i] = float(len(gs) - rank)
    return ns_names, ns_ids, prio


class TilePipeline:
    def __init__(self, mas: MASClient,
                 executor: Optional[WarpExecutor] = None, device="cuda"):
        """``device`` ("cuda" by default) places the scene cache, the
        page pool and the kernels; without CUDA it must be "cpu", which
        runs the kernels' plain PyTorch versions."""
        self.device = resolve_device(device)
        self.mas = mas
        self.executor = executor or WarpExecutor(device=self.device)

    def index(self, req: GeoTileRequest) -> List[Granule]:
        """One MAS query + axis intersection."""
        namespaces = list(req.band_exprs.var_list)
        kw = dict(srs=req.crs.name(), wkt=req.bbox.to_polygon_wkt(),
                  namespaces=",".join(namespaces),
                  nseg=req.polygon_segments, limit=req.query_limit)
        if req.start_time is not None:
            kw["time"] = fmt_time(req.start_time)
        if req.end_time is not None:
            kw["until"] = fmt_time(req.end_time)
        datasets = self.mas.intersects(req.collection, **kw)
        return expand_granules(datasets, req.start_time, req.end_time,
                               req.axes)

    def composite_prep(self, req: GeoTileRequest):
        """ONE index pass for the fused composite path: (granules,
        ns_ids, prio, n_ns), or None when the request has a mask band or
        no granules."""
        if req.mask is not None:
            return None
        if any(ce._ast[0] != "var" for ce in req.band_exprs.expressions):
            raise NotImplementedError(
                "band algebra is not ported yet: "
                f"{req.band_exprs.expr_text}")
        granules = self.index(req)
        if not granules:
            return None
        _, ns_ids, prio = ns_prio(granules)
        return granules, ns_ids, prio, len(set(ns_ids))

    def composite_dispatch(self, req: GeoTileRequest, made,
                           offset: float = 0.0, scale: float = 0.0,
                           clip: float = 0.0, colour_scale: int = 0,
                           auto: bool = True):
        granules, ns_ids, prio, n_ns = made
        return self.executor.render_byte_scenes(
            granules, ns_ids, prio, req.dst_gt(), req.crs,
            req.height, req.width, n_ns, req.resample,
            offset, scale, clip, colour_scale, auto)

    def render_composite_byte(self, req: GeoTileRequest,
                              offset: float = 0.0, scale: float = 0.0,
                              clip: float = 0.0, colour_scale: int = 0,
                              auto: bool = True):
        """One-dispatch GetMap: the PNG-ready uint8 (H, W) tensor on the
        pipeline's device (255 = nodata), or None when the request does
        not qualify (mask band, no granules, uncacheable scenes)."""
        t0 = time.perf_counter()
        made = self.composite_prep(req)
        self.executor.add_span("index", t0)
        if made is None:
            return None
        return self.composite_dispatch(req, made, offset, scale, clip,
                                       colour_scale, auto)
