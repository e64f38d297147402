"""The tile pipeline: index -> warp -> mosaic -> band expressions.

Counterpart of the GetMap half of `gsky_tpu/pipeline/tile.py`, three
routes:

- `render_composite_byte`, the fused single-band route (its halves
  `composite_prep` / `composite_dispatch` are also run apart, by the
  staged GetMap path and per frame of an animation, `animation_prep`
  indexing a whole TIME list at once): one MAS query,
  granule expansion, namespace slots and newest-first mosaic priorities
  (`ns_prio`), then `WarpExecutor.render_byte_scenes` (kernels B1/B2).
  A band expression that is not a bare variable takes `_expr_prep`
  instead (fused band algebra, ``GSKY_EXPR_FUSE``): its variables
  resolved to namespaces, granules of other namespaces dropped, each
  granule mapped to its variable's fingerprint slot, then
  `WarpExecutor.render_expr_byte` (B1 and the expression epilogue);
- the multi-band (RGB) rungs over one index pass (`_bands_prep`):
  `render_rgba_byte` (three granules of one grid to an RGBA tile) and
  `render_bands_byte` (B2, one byte plane per band), both in
  `render_rgb_auto`;
- `process` -> `render`, the modular route the OWS front end falls back
  to.  Without a mask band it is `_render_fused`: the cached scenes
  warped and mosaicked per namespace in one dispatch per source-CRS
  group (`WarpExecutor.warp_mosaic_scenes`, B1 or B2), else the decoded
  windows (`WarpExecutor.warp_mosaic`, B2).  With a mask band (the
  reference's `tile_merger.go` path) every granule's window is decoded
  and warped per resampling method (the mask band always nearest;
  curvilinear granules instead through one `warp_mosaic_scenes` over
  their cached scenes, a namespace slot each), the mask band becomes
  per-timestamp exclusions and each namespace is mosaicked newest-first
  (kernel B4).  Band expressions are evaluated
  last; everything after decode stays on the device.

The index queries the MAS once, or, for a coarse request over a layer
with a known extent and ``index_res_limit``, in index tiles
(`_index_subdivision`).  Not ported here: remote workers.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geo.crs import EPSG4326
from ..geo.transform import BBox, transform_bbox
from ..index.client import MASClient
from ..index.store import fmt_time
from ..ops import mosaic as M
from ..ops.expr import BandExpressions, expr_fuse_enabled, fingerprint
from ..ops.paged import note_expr_fused
from ..ops.raster import DTYPE_NP
from ..resilience import check_partial
from .decode import decode_all
from .executor import WarpExecutor
from .granule import expand_granules
from .types import GeoTileRequest, Granule, TileResult

log = logging.getLogger("gsky.tile")

_DECODE_WORKERS = 8       # threads reading one tile's granule windows


def ns_prio(gs: Sequence[Granule]):
    """(ns_names, ns_ids, prio) for a granule set: namespace slots in
    first-seen order, mosaic priorities newest-first."""
    ns_names: List[str] = []
    ns_index: Dict[str, int] = {}
    for g in gs:
        if g.namespace not in ns_index:
            ns_index[g.namespace] = len(ns_names)
            ns_names.append(g.namespace)
    return ns_names, [ns_index[g.namespace] for g in gs], newest_first(gs)


def newest_first(gs: Sequence[Granule]) -> List[float]:
    """Mosaic priorities of a granule set, the newest highest."""
    order = M.priority_order([g.timestamp for g in gs])
    prio = [0.0] * len(gs)
    for rank, i in enumerate(order):
        prio[i] = float(len(gs) - rank)
    return prio


class TilePipeline:
    def __init__(self, mas: MASClient,
                 executor: Optional[WarpExecutor] = None, device="cuda"):
        """``device`` ("cuda" by default) places the scene cache, the
        page pool, decoded windows and the kernels; without CUDA it must
        be "cpu", which runs the kernels' plain PyTorch versions."""
        self.device = resolve_device(device)
        self.mas = mas
        self.executor = executor or WarpExecutor(device=self.device)

    def index(self, req: GeoTileRequest) -> List[Granule]:
        """MAS query + axis intersection, plus the mask band: in the
        data collection's query when it has no ``data_source``, else by
        a second query of that collection."""
        namespaces = list(req.band_exprs.var_list)
        if req.mask is not None and req.mask.id \
                and not req.mask.data_source:
            if req.mask.id not in namespaces:
                namespaces.append(req.mask.id)
        kw = dict(srs=req.crs.name(), wkt=req.bbox.to_polygon_wkt(),
                  namespaces=",".join(namespaces),
                  nseg=req.polygon_segments, limit=req.query_limit)
        if req.start_time is not None:
            kw["time"] = fmt_time(req.start_time)
        if req.end_time is not None:
            kw["until"] = fmt_time(req.end_time)
        datasets = self._index_query(req, kw, req.collection)
        granules = expand_granules(datasets, req.start_time, req.end_time,
                                   req.axes)
        if req.mask is not None and req.mask.data_source:
            mkw = dict(kw, namespaces=req.mask.id)
            mds = self._index_query(req, mkw, req.mask.data_source)
            granules += expand_granules(mds, req.start_time, req.end_time,
                                        req.axes)
        return granules

    def _index_query(self, req: GeoTileRequest, kw: Dict,
                     collection: str):
        """One MAS ?intersects, or one per index tile of
        `_index_subdivision`, deduplicated by (file, dataset, namespace)
        in first-seen order.  The reference queries the index tiles
        from a thread pool over HTTP; the port's MAS is in-process (an
        in-memory store answers one query at a time), so they run one
        after another, in the same order."""
        sub = self._index_subdivision(req)
        if sub is None:
            return self.mas.intersects(collection, **kw)
        seen = set()
        out = []
        for wkt4326 in sub:
            part = self.mas.intersects(collection,
                                       **dict(kw, srs="EPSG:4326",
                                              wkt=wkt4326))
            for ds in part:
                k = (ds.file_path, ds.ds_name, ds.namespace)
                if k not in seen:
                    seen.add(k)
                    out.append(ds)
        return out

    @staticmethod
    def _index_subdivision(req: GeoTileRequest):
        """None to query as one; [] when the request misses the layer's
        extent; else the index tiles' EPSG:4326 polygons: the request's
        bbox clipped to ``spatial_extent``, on a 256-px virtual grid, in
        tiles of 256 * index_tile_{x,y}_size pixels, when that grid is
        coarser than ``index_res_limit`` degrees a pixel."""
        if req.index_res_limit <= 0 or req.query_limit > 0 \
                or not req.spatial_extent:
            return None
        try:
            ll = transform_bbox(req.bbox, req.crs, EPSG4326)
        except ValueError:
            return None
        ext = req.spatial_extent
        xmin = max(ll.xmin, ext[0])
        ymin = max(ll.ymin, ext[1])
        xmax = min(ll.xmax, ext[2])
        ymax = min(ll.ymax, ext[3])
        if xmax < xmin or ymax < ymin:
            return []
        res_w = res_h = 256
        xres = (xmax - xmin) / res_w
        yres = (ymax - ymin) / res_h
        if max(xres, yres) <= req.index_res_limit:
            return None
        mx = int(res_w * req.index_tile_x_size)
        my = int(res_h * req.index_tile_y_size)
        mx = mx if mx > 0 else res_w
        my = my if my > 0 else res_h
        if mx >= res_w and my >= res_h:
            return None
        return [BBox(xmin + x * xres, ymin + y * yres,
                     min(xmin + (x + mx) * xres, xmax),
                     min(ymin + (y + my) * yres, ymax)).to_polygon_wkt()
                for y in range(0, res_h, my) for x in range(0, res_w, mx)]

    # -- the fused single-band route -----------------------------------

    def composite_prep(self, req: GeoTileRequest,
                       stats: Optional[Dict[str, int]] = None,
                       spans: Optional[Dict[str, float]] = None):
        """ONE index pass for the fused composite path: (granules,
        ns_ids, prio, n_ns), or None when the request has a mask band or
        no granules.  ``stats`` gets the granule and file counts,
        ``spans["index_s"]`` the index query's seconds.  A request with
        band algebra gets `_expr_prep`'s 5-tuple instead (granules
        still first)."""
        if req.mask is not None:
            return None
        exprs = req.band_exprs
        if any(ce._ast[0] != "var" for ce in exprs.expressions):
            return self._expr_prep(req, exprs, stats, spans)
        granules = self._timed_index(req, spans)
        if not granules:
            return None
        _note_counts(stats, granules)
        _, ns_ids, prio = ns_prio(granules)
        return granules, ns_ids, prio, len(set(ns_ids))

    def _expr_prep(self, req: GeoTileRequest, exprs: BandExpressions,
                   stats: Optional[Dict[str, int]] = None,
                   spans: Optional[Dict[str, float]] = None):
        """Fused band-algebra qualification: ONE index pass, variables
        resolved to namespaces as `evaluate_expressions` resolves them
        (exact name, else the unique ``var#axis`` candidate), granules
        mapped to fingerprint slot ids.  (granules, ns_ids, prio,
        n_slots, fp), or None: several expressions, no variable, no
        granule of a referenced namespace, or ``GSKY_EXPR_FUSE=0``
        (counted "unfused"); the modular route then runs."""
        if len(exprs.expressions) != 1:
            return None
        ce = exprs.expressions[0]
        if ce._ast[0] == "var" or not ce.variables:
            return None
        if not expr_fuse_enabled():
            note_expr_fused("unfused")
            return None
        granules = self._timed_index(req, spans)
        if not granules:
            return None
        _note_counts(stats, granules)
        fp = fingerprint(ce)
        names = {g.namespace for g in granules}
        slot_of: Dict[str, int] = {}
        for i, var in enumerate(fp.slots):
            if var in names:
                slot_of[var] = i
                continue
            cands = [k for k in names if k.split("#")[0] == var]
            if len(cands) == 1:
                slot_of[cands[0]] = i
            # an unresolved slot gets no granule: it stays all-invalid,
            # as the modular route's missing band does
        # granules of unreferenced namespaces are dropped: the output
        # does not depend on them, and ranking the kept subset keeps
        # each namespace's priority order
        kept = [g for g in granules if g.namespace in slot_of]
        if not kept:
            return None
        return (kept, [slot_of[g.namespace] for g in kept],
                newest_first(kept), len(fp.slots), fp)

    def _timed_index(self, req: GeoTileRequest,
                     spans: Optional[Dict[str, float]]):
        t0 = time.perf_counter()
        granules = self.index(req)
        if spans is not None:
            spans["index_s"] = spans.get("index_s", 0.0) \
                + time.perf_counter() - t0
        return granules

    def animation_prep(self, req: GeoTileRequest, times: Sequence[float],
                       stats: Optional[Dict[str, int]] = None,
                       spans: Optional[Dict[str, float]] = None):
        """ONE index pass for a TIME animation: a single MAS query over
        [min(times), max(times)], partitioned per frame as a lone GetMap
        at that time selects (|timestamp - t| < 1 s, untimed granules in
        every frame); a frame with no exact match takes the nearest
        timestep (WMS-T nearest value), so frames between two source
        dates share one granule set.  A list aligned with ``times`` of
        `composite_prep`-form tuples (None for a frame with no granule),
        or None when the fused composite route does not serve the
        request (a mask band, band algebra, no granules): each frame
        then renders on its own."""
        if req.mask is not None or any(
                ce._ast[0] != "var" for ce in req.band_exprs.expressions):
            return None
        span_req = dataclasses.replace(req, start_time=min(times),
                                       end_time=max(times) + 1.0)
        granules = self._timed_index(span_req, spans)
        if not granules:
            return None
        _note_counts(stats, granules)
        untimed = [g for g in granules if g.timestamp == 0.0]
        timed = [g for g in granules if g.timestamp != 0.0]
        frames = []
        for t in times:
            fg = [g for g in timed if abs(g.timestamp - t) < 1.0]
            if not fg and timed:
                best = min(abs(g.timestamp - t) for g in timed)
                fg = [g for g in timed if abs(g.timestamp - t) == best]
            fg = fg + untimed
            if not fg:
                frames.append(None)
                continue
            ns_names, ns_ids, prio = ns_prio(fg)
            frames.append((fg, ns_ids, prio, len(ns_names)))
        return frames

    def composite_dispatch(self, req: GeoTileRequest, made,
                           offset: float = 0.0, scale: float = 0.0,
                           clip: float = 0.0, colour_scale: int = 0,
                           auto: bool = True):
        if len(made) == 5:      # `_expr_prep`'s form: band algebra
            granules, ns_ids, prio, n_slots, fp = made
            out = self.executor.render_expr_byte(
                granules, ns_ids, prio, req.dst_gt(), req.crs,
                req.height, req.width, n_slots, fp, req.resample,
                offset, scale, clip, colour_scale, auto)
            if out is None:
                note_expr_fused("unfused")
            return out
        granules, ns_ids, prio, n_ns = made
        return self.executor.render_byte_scenes(
            granules, ns_ids, prio, req.dst_gt(), req.crs,
            req.height, req.width, n_ns, req.resample,
            offset, scale, clip, colour_scale, auto)

    def render_composite_byte(self, req: GeoTileRequest,
                              offset: float = 0.0, scale: float = 0.0,
                              clip: float = 0.0, colour_scale: int = 0,
                              auto: bool = True):
        """One-dispatch GetMap: the PNG-ready uint8 (H, W) (255 =
        nodata), a host array when a wave rendered it, else a tensor on
        the pipeline's device; or None when the request does not qualify
        (mask band, no granules, uncacheable scenes)."""
        t0 = time.perf_counter()
        made = self.composite_prep(req)
        self.executor.add_span("index", t0)
        if made is None:
            return None
        return self.composite_dispatch(req, made, offset, scale, clip,
                                       colour_scale, auto)

    # -- the multi-band (RGB) rungs ------------------------------------

    def _bands_prep(self, req: GeoTileRequest, n_bands: int = 0,
                    stats: Optional[Dict[str, int]] = None,
                    spans: Optional[Dict[str, float]] = None):
        """ONE index pass for both RGB rungs: (granules, ns_index,
        out_sel), or None (a mask band, band algebra, ``n_bands`` given
        and not the style's band count, no granules, a band without a
        unique namespace)."""
        if req.mask is not None:
            return None
        exprs = req.band_exprs
        if not exprs.expressions or \
                (n_bands and len(exprs.expressions) != n_bands) or \
                any(ce._ast[0] != "var" for ce in exprs.expressions):
            return None
        granules = self._timed_index(req, spans)
        if not granules:
            return None
        _note_counts(stats, granules)
        ns_index: Dict[str, int] = {}
        for g in granules:
            if g.namespace not in ns_index:
                ns_index[g.namespace] = len(ns_index)
        out_sel = []
        for ce in exprs.expressions:
            var = ce.variables[0]
            if var in ns_index:
                out_sel.append(ns_index[var])
                continue
            cands = [k for k in ns_index if k.split("#")[0] == var]
            if len(cands) != 1:
                return None
            out_sel.append(ns_index[cands[0]])
        return granules, ns_index, out_sel

    def _bands_dispatch(self, req: GeoTileRequest, granules, ns_index,
                        out_sel, offset, scale, clip, colour_scale, auto):
        return self.executor.render_bands_byte(
            granules, [ns_index[g.namespace] for g in granules],
            newest_first(granules), req.dst_gt(), req.crs, req.height,
            req.width, len(ns_index), out_sel, req.resample, offset, scale,
            clip, colour_scale, auto)

    def render_bands_byte(self, req: GeoTileRequest, offset: float = 0.0,
                          scale: float = 0.0, clip: float = 0.0,
                          colour_scale: int = 0, auto: bool = True,
                          stats: Optional[Dict[str, int]] = None):
        """The planes rung: uint8 (n_bands, H, W) in the style's band
        order, or None when the request does not qualify."""
        made = self._bands_prep(req, stats=stats)
        if made is None:
            return None
        return self._bands_dispatch(req, *made, offset, scale, clip,
                                    colour_scale, auto)

    def _rgba_try(self, req: GeoTileRequest, granules, ns_index, out_sel,
                  offset, scale, clip, colour_scale, auto):
        """The RGBA rung over an already indexed granule set, or None
        when the set is not one granule per band."""
        if len(granules) != 3 or len(ns_index) != 3 \
                or sorted(out_sel) != [0, 1, 2]:
            return None
        return self.executor.render_rgba_byte(
            granules, out_sel, req.dst_gt(), req.crs, req.height,
            req.width, req.resample, offset, scale, clip, colour_scale,
            auto)

    def render_rgba_byte(self, req: GeoTileRequest, offset: float = 0.0,
                         scale: float = 0.0, clip: float = 0.0,
                         colour_scale: int = 0, auto: bool = True,
                         stats: Optional[Dict[str, int]] = None):
        """The RGBA rung alone: uint8 (H, W, 4), or None."""
        made = self._bands_prep(req, n_bands=3, stats=stats)
        if made is None:
            return None
        return self._rgba_try(req, *made, offset, scale, clip,
                              colour_scale, auto)

    def render_rgb_auto(self, req: GeoTileRequest, offset: float = 0.0,
                        scale: float = 0.0, clip: float = 0.0,
                        colour_scale: int = 0, auto: bool = True,
                        stats: Optional[Dict[str, int]] = None):
        """The RGB ladder over ONE index pass: ("rgba", (H, W, 4)) when
        the granule set fits the RGBA rung, else ("planes", (3, H, W)),
        else None."""
        made = self._bands_prep(req, n_bands=3, stats=stats)
        if made is None:
            return None
        out = self._rgba_try(req, *made, offset, scale, clip, colour_scale,
                             auto)
        if out is not None:
            return ("rgba", out)
        out = self._bands_dispatch(req, *made, offset, scale, clip,
                                   colour_scale, auto)
        return None if out is None else ("planes", out)

    # -- the modular route ---------------------------------------------

    def process(self, req: GeoTileRequest) -> TileResult:
        t0 = time.perf_counter()
        granules = self.index(req)
        self.executor.add_span("index", t0)
        return self.render(req, granules)

    def render(self, req: GeoTileRequest,
               granules: List[Granule]) -> TileResult:
        exprs = req.band_exprs
        H, W = req.height, req.width
        dev = self.device
        if not granules:
            return _empty_result(exprs, H, W, dev)
        mask_id = req.mask.id if req.mask is not None else None
        if mask_id is None:
            return self._render_fused(req, granules)
        ex = self.executor
        # mask bands always resample nearest: interpolating bitfields is
        # meaningless
        is_mask = [g.base_namespace == mask_id for g in granules]
        warped: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = \
            [None] * len(granules)
        for method, idxs in (
                (req.resample, [i for i, m in enumerate(is_mask) if not m]),
                ("near", [i for i, m in enumerate(is_mask) if m])):
            if not idxs:
                continue
            # curvilinear granules have no affine window: they warp from
            # the scene cache through the geolocation control grid
            reg = [i for i in idxs if not granules[i].geo_loc]
            gl = [i for i in idxs if granules[i].geo_loc]
            t = time.perf_counter()
            if reg:
                errs: List[Exception] = []
                ws = decode_all([granules[i] for i in reg], req.bbox,
                                req.crs, method, _DECODE_WORKERS,
                                dst_hw=(H, W), errors=errs, device=dev)
                check_partial(len(errs), len(reg), "decode")
                t = ex.add_span("decode", t)
                wr = ex.warp_all(ws, req.dst_gt(), req.crs, H, W, method)
                for k, i in enumerate(reg):
                    warped[i] = wr[k]
            if gl:
                # one batched dispatch, each granule its own namespace
                # slot so per-granule rasters come back for the mask
                # machinery; when it cannot be served, one granule at a
                # time, so a single uncacheable file degrades alone
                sc = ex.warp_mosaic_scenes(
                    [granules[i] for i in gl], list(range(len(gl))),
                    [1.0] * len(gl), req.dst_gt(), req.crs, H, W,
                    len(gl), method)
                if sc is not None:
                    canv, vals = sc
                    for k, i in enumerate(gl):
                        warped[i] = (canv[k], vals[k])
                else:
                    for i in gl:
                        one = ex.warp_mosaic_scenes(
                            [granules[i]], [0], [1.0], req.dst_gt(),
                            req.crs, H, W, 1, method)
                        if one is None:
                            log.warning(
                                "curvilinear granule %s uncacheable; "
                                "rendered empty", granules[i].path)
                            continue
                        warped[i] = (one[0][0], one[1][0])
            ex.add_span("warp", t)

        # group warped granules by namespace; the mask band becomes
        # per-timestamp exclusions
        t = time.perf_counter()
        by_ns: Dict[str, List[Tuple[Granule, torch.Tensor,
                                    torch.Tensor]]] = {}
        mask_by_stamp: Dict[float, torch.Tensor] = {}
        for g, wr in zip(granules, warped):
            if wr is None:
                continue
            data, ok = wr
            if g.base_namespace == mask_id:
                band, storage = _restore_int(data, g.array_type)
                excl = M.compute_bit_mask(band, req.mask.value or None,
                                          req.mask.bit_tests, storage)
                excl = excl & ok
                if req.mask.inclusive:
                    excl = ~excl & ok
                prev = mask_by_stamp.get(g.timestamp)
                mask_by_stamp[g.timestamp] = \
                    excl if prev is None else (prev | excl)
                if mask_id not in exprs.var_list:
                    continue
            by_ns.setdefault(g.namespace, []).append((g, data, ok))
        t = ex.add_span("bitmask", t)

        # mosaic per namespace (newest wins, older fills holes)
        data_env: Dict[str, torch.Tensor] = {}
        valid_env: Dict[str, torch.Tensor] = {}
        for ns, items in by_ns.items():
            rasters = [d for _, d, _ in items]
            valids = []
            for g, _, ok in items:
                excl = mask_by_stamp.get(g.timestamp)
                valids.append(ok & ~excl if excl is not None else ok)
            stamps = [g.timestamp for g, _, _ in items]
            data_env[ns], valid_env[ns] = M.mosaic_stack(rasters, valids,
                                                         stamps)
        t = ex.add_span("mosaic", t)
        out = evaluate_expressions(exprs, data_env, valid_env, H, W, dev,
                                   granule_count=len(granules),
                                   file_count=len({g.path
                                                   for g in granules}))
        ex.add_span("expr", t)
        return out

    def _render_fused(self, req: GeoTileRequest,
                      granules: List[Granule]) -> TileResult:
        """A request without a mask band: the cached scenes warped and
        mosaicked per namespace in one dispatch per source-CRS group;
        when a scene is uncacheable, the decoded windows instead; then
        the band expressions."""
        exprs = req.band_exprs
        H, W = req.height, req.width
        dev = self.device
        ex = self.executor
        t = time.perf_counter()
        ns_names, ns_ids, prio = ns_prio(granules)
        sc = ex.warp_mosaic_scenes(granules, ns_ids, prio, req.dst_gt(),
                                   req.crs, H, W, len(ns_names),
                                   req.resample)
        if sc is None:
            errs: List[Exception] = []
            ws = decode_all(granules, req.bbox, req.crs, req.resample,
                            _DECODE_WORKERS, dst_hw=(H, W), errors=errs,
                            device=dev)
            check_partial(len(errs), len(granules), "decode")
            t = ex.add_span("decode", t)
            live = [(g, w) for g, w in zip(granules, ws) if w is not None]
            if not live:
                return _empty_result(exprs, H, W, dev)
            ns_names, ns_ids, prio = ns_prio([g for g, _ in live])
            sc = ex.warp_mosaic([w for _, w in live], ns_ids, prio,
                                req.dst_gt(), req.crs, H, W, len(ns_names),
                                req.resample)
        canv, vals = sc
        t = ex.add_span("warp", t)
        data_env = {n: canv[i] for i, n in enumerate(ns_names)}
        valid_env = {n: vals[i] for i, n in enumerate(ns_names)}
        out = evaluate_expressions(exprs, data_env, valid_env, H, W, dev,
                                   granule_count=len(granules),
                                   file_count=len({g.path
                                                   for g in granules}))
        ex.add_span("expr", t)
        return out


def _note_counts(stats: Optional[Dict[str, int]], granules) -> None:
    if stats is not None:
        stats["granules"] = len(granules)
        stats["files"] = len({g.path for g in granules})


def evaluate_expressions(exprs: BandExpressions,
                         data_env: Dict[str, torch.Tensor],
                         valid_env: Dict[str, torch.Tensor],
                         H: int, W: int, device="cuda",
                         granule_count: int = 0,
                         file_count: int = 0) -> TileResult:
    """Band-expression evaluation over the mosaic canvases.  Variables
    the index produced with axis suffixes (``var#axis=value``) are
    matched to the plain variable when unambiguous; a missing variable
    gives an all-invalid zero plane on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    out_data: Dict[str, torch.Tensor] = {}
    out_valid: Dict[str, torch.Tensor] = {}
    names: List[str] = []

    def lookup(var: str) -> Optional[str]:
        if var in data_env:
            return var
        cands = [k for k in data_env if k.split("#")[0] == var]
        return cands[0] if len(cands) == 1 else None

    for ce, name in zip(exprs.expressions, exprs.expr_names):
        keys = [lookup(var) for var in ce.variables]
        if any(k is None for k in keys):
            out_data[name] = torch.zeros((H, W), dtype=torch.float32,
                                         device=device)
            out_valid[name] = torch.zeros((H, W), dtype=torch.bool,
                                          device=device)
        elif ce._ast[0] == "var":
            out_data[name] = data_env[keys[0]].to(torch.float32)
            out_valid[name] = valid_env[keys[0]]
        else:
            env = {v: data_env[k] for v, k in zip(ce.variables, keys)}
            venv = {v: valid_env[k] for v, k in zip(ce.variables, keys)}
            o, ok = ce.eval_masked(env, venv, device=device)
            out_data[name] = o.to(torch.float32)
            out_valid[name] = ok
        names.append(name)

    # axis-expanded outputs with no expression pass through as extra
    # namespaces
    for k in data_env:
        if "#" in k and k not in out_data:
            out_data[k] = data_env[k].to(torch.float32)
        if "#" in k and k not in out_valid:
            out_valid[k] = valid_env[k]
            names.append(k)
    return TileResult(out_data, out_valid, names, granule_count, file_count)


def _restore_int(data: torch.Tensor, array_type: str):
    """Warped mask bands come back float32: (integer tensor, numpy
    storage dtype) for the bitwise tests.  The cast is XLA's — NaN to 0,
    truncation toward zero, saturation at the storage dtype's range —
    and the result is held in the widened dtype `compute_bit_mask`
    tests in (uint16 as int32, uint32 as int64)."""
    dt = np.dtype(DTYPE_NP.get(array_type, np.int32))
    if dt.kind not in "iu":
        dt = np.dtype(np.int32)
    info = np.iinfo(dt)
    x = torch.where(torch.isnan(data), torch.zeros_like(data), data)
    x = x.clamp(-2.0 ** 40, 2.0 ** 40).to(torch.int64)
    x = x.clamp(int(info.min), int(info.max))
    return x.to(M._WIDE[dt]), dt


def _empty_result(exprs: BandExpressions, H: int, W: int,
                  device="cuda") -> TileResult:
    device = resolve_device(device)
    data = {n: torch.zeros((H, W), dtype=torch.float32, device=device)
            for n in exprs.expr_names}
    valid = {n: torch.zeros((H, W), dtype=torch.bool, device=device)
             for n in exprs.expr_names}
    return TileResult(data, valid, list(exprs.expr_names), 0, 0)
