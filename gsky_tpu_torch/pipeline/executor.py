"""The warp executor: cached scenes -> one fused warp-render dispatch,
and decoded windows -> batched gather warps.

Counterpart of `gsky_tpu/pipeline/executor.py` on the GetMap paths.
`render_byte_scenes` groups a tile's granules by (source CRS, bucket
shape, dtype), builds the sparse control grid once per (dst grid, src
CRS) on the host in float64, and dispatches:

- the paged leg (kernel B1) when the page pool can stage every
  granule's footprint pages (`_paged_from_group`);
- the bucketed leg (kernel B2) otherwise — page budget exceeded, the
  reference's VMEM gate (`ops.paged.paged_vmem_ok`) refused the page
  list, or every pool slot pinned.  B2 reads each granule from its
  cached scene through a per-granule base pointer: no dense copy of the
  group's scenes is made.

`warp_mosaic_scenes` is the same dispatch for the modular route without
a mask band (`TilePipeline._render_fused`), stopping at the scored
per-namespace canvases (over more than `MAX_NS` namespaces, `MAX_NS`
at a time): one group goes through B1 or B2 as above;
several source-CRS groups go each through B2 and are combined by
priority (`ops.warp.combine_scored`).  `warp_mosaic` is its decoded-
window leg, taken when a scene is uncacheable: per source CRS, the
windows (validity NaN-encoded) go through B2 with the group's own
control grid, then the same combine.

With waves on (``GSKY_WAVES``, default on) a tile the paged leg serves
is not launched here: it becomes a lane of the device's wave
(`pipeline.waves`), which renders every concurrent lane in one B1
launch and returns host arrays.  Declined tiles, the decoded-window leg
and multi-CRS mosaics stay per call.

`render_expr_byte` is the fused band-algebra tile (an expression over
several bands, no mask band): every referenced band's granules in one
B1 launch, mosaic slot i the expression's variable i, the page windows
of a tile's granules widened to their union, then the expression
epilogue and byte scale (`ops.paged.render_expr_paged`); with waves on,
a lane of the device's wave.  It declines (None: the caller runs the
modular route) where the reference does: granules in several source
CRSs, an uncacheable scene, the page budget or the VMEM gate, and
where its pow2 slot count exceeds `MAX_NS`, the kernels' most.

The multi-band (RGB) rungs: `render_rgba_byte`, three granules of one
grid (one per band) to an RGBA tile in plain torch ops, the tap indices
computed once for the three cached scenes (`ops.warp.render_rgba_ctrl`);
`render_bands_byte`, one B2 launch over a group's cached scenes, then a
byte plane per selected namespace (`ops.warp_render.
render_scenes_bands`).

`warp_all` serves the masked route: every decoded window is
projected per dst pixel on the host (float64, cached per dst grid and
source CRS), padded into source-shape buckets and warped by one
`warp_gather_batch` per bucket; results stay on the device.
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geo.crs import CRS, parse_crs
from ..geo.transform import GeoTransform
from ..ops.paged import PARAMS_W, note_expr_fused, page_slots, \
    paged_vmem_ok, render_byte_paged, render_expr_paged, warp_scored_paged
from ..ops.warp import combine_scored, render_rgba_ctrl, warp_gather_batch
from ..ops.warp_render import MAX_NS, render_scenes, render_scenes_bands, \
    warp_scenes_scored
from .autoplan import union_lane_spans
from .decode import DecodedWindow
from .pages import PagePool
from .scene_cache import DeviceScene, SceneCache
from .waves import BucketedLane, default_waves, waves_enabled

_WIN_MARGIN = 2  # covers cubic's +2 tap and f32-vs-f64 coord rounding
# host-clock stages of one fused tile: "index" is recorded by the tile
# pipeline, the rest by `render_byte_scenes` ("dispatch" is the host
# side of the kernel launch and epilogue; the device runs asynchronously)
SPANS = ("index", "groups", "tables", "dispatch")
# the modular (mask-band) path's stages, all recorded by
# `TilePipeline.render`; they appear in `spans` once that path runs
MODULAR_SPANS = ("index", "decode", "warp", "bitmask", "mosaic", "expr")
# padded source-window shape buckets (H and W independently bucketed)
_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def _bucket_in(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / 4096) * 4096)


def _bucket(n: int) -> int:
    return _bucket_in(n, _BUCKETS)


def _bucket_pow2(n: int, lo: int = 1) -> int:
    """Next power of two >= n (granule- and namespace-count padding)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _granule_bounds(p: np.ndarray, cx: np.ndarray, cy: np.ndarray):
    """Raw gather-footprint bounds (r_lo, r_hi, c_lo, c_hi) of ONE
    granule's param row, or None when it has no finite coords.  The
    affine commutes with the bilinear upsample, so the dense extremes
    are bounded by the affine at the control points (f64 here)."""
    # clamp to the kernel's oob thresholds: coords past the true extent
    # are NaN-poisoned on device and never gathered
    cols = np.clip(p[0] + p[1] * cx + p[2] * cy - 0.5, -1.0, p[7])
    rows = np.clip(p[3] + p[4] * cx + p[5] * cy - 0.5, -1.0, p[6])
    ok = np.isfinite(rows) & np.isfinite(cols)
    if not ok.any():
        return None
    r_lo = math.floor(float(rows[ok].min())) - _WIN_MARGIN
    c_lo = math.floor(float(cols[ok].min())) - _WIN_MARGIN
    # one extra pixel on the high edge: the device recomputes coords in
    # f32, which can land just past the f64 bound and bump floor() by one
    r_hi = math.floor(float(rows[ok].max())) + _WIN_MARGIN + 2
    c_hi = math.floor(float(cols[ok].max())) + _WIN_MARGIN + 2
    return r_lo, r_hi, c_lo, c_hi


def _inv_gt_params(gt: GeoTransform, ox: float, oy: float):
    """Origin-folded inverse geotransform (src-CRS coords relative to
    (ox, oy) -> granule pixel): params[:6] of every scene kernel —
    col = p0 + p1*sx + p2*sy, row = p3 + p4*sx + p5*sy."""
    det = gt.dx * gt.dy - gt.rx * gt.ry
    inv = (gt.dy / det, -gt.rx / det, -gt.ry / det, gt.dx / det)
    a0 = inv[0] * (ox - gt.x0) + inv[1] * (oy - gt.y0)
    a3 = inv[2] * (ox - gt.x0) + inv[3] * (oy - gt.y0)
    return (a0, inv[0], inv[1], a3, inv[2], inv[3])


def _by_ns_chunks(render, items, ns_ids, prios, n_ns: int):
    """A mosaic over more namespaces than the kernels take (`MAX_NS`),
    rendered `MAX_NS` namespaces at a time: ``render(items, ns_ids,
    prios, n)`` for each slice of namespaces, their canvases and valids
    stacked.  A namespace's mosaic depends on its own granules only, so
    the result is one launch's over all of them.  None when a slice's
    render is None."""
    canvs, valids = [], []
    for lo in range(0, n_ns, MAX_NS):
        hi = min(n_ns, lo + MAX_NS)
        idx = [i for i, n in enumerate(ns_ids) if lo <= n < hi]
        made = render([items[i] for i in idx], [ns_ids[i] - lo for i in idx],
                      [prios[i] for i in idx], hi - lo)
        if made is None:
            return None
        canvs.append(made[0][:hi - lo])
        valids.append(made[1][:hi - lo])
    return torch.cat(canvs), torch.cat(valids)


@dataclass
class SceneGroup:
    """Device inputs of one (source CRS, bucket, dtype) granule group."""

    scenes: List[DeviceScene]
    ctrl: np.ndarray            # (2, gh, gw) f32 origin-relative coords
    ctrl_dev: torch.Tensor      # the same on the device
    params: np.ndarray          # (B, 11) f64, B = pow2(len(scenes))
    step: int


def _serials(group: SceneGroup):
    """A wave lane's scene identity: its scenes' serials and the padded
    granule count (the reference's stack key)."""
    return tuple(s.serial for s in group.scenes) + (len(group.params),)


def _bucketed_lane(group: SceneGroup) -> BucketedLane:
    n = len(group.scenes)
    return BucketedLane([s.dev for s in group.scenes],
                        group.params[:n].astype(np.float32), group.ctrl_dev,
                        (len(group.params),) + tuple(group.scenes[0].bucket))


class WarpExecutor:
    """Dispatches cached-scene tiles to the fused warp-render kernels."""

    _GEO_CACHE_MAX = 256
    _STRIDE_CACHE_MAX = 8192

    def __init__(self, device="cuda", cache: Optional[SceneCache] = None,
                 pool: Optional[PagePool] = None):
        self.device = resolve_device(device)
        self.cache = cache or SceneCache(device=self.device)
        self.pool = pool or PagePool(device=self.device)
        self._geo_cache: OrderedDict = OrderedDict()
        self._stride_cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        # dispatch counts by leg — "where do renders actually go";
        # `paged_gated` counts the declines the VMEM gate alone made,
        # `ns_declined` the fused renders declined because their pow2
        # namespace count exceeds what the kernels are built for
        self.paged_engaged = 0
        self.paged_declined = 0
        self.paged_gated = 0
        self.ns_declined = 0
        # seconds per stage, summed over calls (SPANS, MODULAR_SPANS)
        self.spans = dict.fromkeys(SPANS, 0.0)
        # window-batch dispatches of `warp_all` by (bh, bw, B)
        self.bucket_stats: Dict[tuple, int] = {}

    def add_span(self, name: str, t0: float) -> float:
        """Add the time since ``t0`` to stage ``name``; returns now."""
        now = time.perf_counter()
        with self._lock:
            self.spans[name] = self.spans.get(name, 0.0) + now - t0
        return now

    def warm_scene(self, g, dst_gt: GeoTransform, dst_crs: CRS,
                   height: int, width: int):
        """Load one granule's scene into the device cache at the
        overview level this destination grid needs (the level
        `_scene_groups` picks); the `DeviceScene`, or None when it is
        uncacheable."""
        return self.cache.get(g, self._granule_stride(g, dst_gt, dst_crs,
                                                      height, width))

    def _geo_cache_get(self, key):
        with self._lock:
            hit = self._geo_cache.get(key)
            if hit is not None:
                self._geo_cache.move_to_end(key)
            return hit

    def _geo_cache_put(self, key, value):
        with self._lock:
            self._geo_cache[key] = value
            self._geo_cache.move_to_end(key)
            while len(self._geo_cache) > self._GEO_CACHE_MAX:
                self._geo_cache.popitem(last=False)

    def _dst_geo_coords(self, dst_gt: GeoTransform, dst_crs: CRS,
                        height: int, width: int,
                        src_crs: CRS) -> Tuple[np.ndarray, np.ndarray]:
        """(sx, sy): every dst pixel centre projected into src CRS (f64,
        host), cached — shared by every granule in that CRS."""
        key = (dst_gt.to_gdal(), dst_crs, height, width, src_crs)
        hit = self._geo_cache_get(key)
        if hit is not None:
            return hit
        c = np.arange(width, dtype=np.float64) + 0.5
        r = np.arange(height, dtype=np.float64) + 0.5
        C, R = np.meshgrid(c, r)
        x, y = dst_gt.pixel_to_geo(C, R)
        sx, sy = dst_crs.transform_to(src_crs, x, y)
        sx = np.asarray(sx, np.float64)
        sy = np.asarray(sy, np.float64)
        self._geo_cache_put(key, (sx, sy))
        return sx, sy

    def warp_all(self, windows: Sequence[Optional[DecodedWindow]],
                 dst_gt: GeoTransform, dst_crs: CRS, height: int,
                 width: int, method: str = "near"):
        """Warp every decoded window onto the dst grid.  Returns, per
        input, (data (H, W) f32, ok (H, W) bool) tensors on the device,
        or None for a None window.  Windows are padded into (bucket(h),
        bucket(w)) source shapes and the granule count of each bucket to
        a power of two, with padding rows that gather nothing."""
        jobs = []
        for i, wdw in enumerate(windows):
            if wdw is None:
                continue
            sx, sy = self._dst_geo_coords(dst_gt, dst_crs, height, width,
                                          wdw.src_crs)
            col, row = wdw.window_gt.geo_to_pixel(sx, sy)
            jobs.append((i, wdw, (row - 0.5).astype(np.float32),
                         (col - 0.5).astype(np.float32)))
        results: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = \
            [None] * len(windows)
        buckets: Dict[Tuple[int, int], list] = {}
        for job in jobs:
            h, w = job[1].data.shape
            buckets.setdefault((_bucket(h), _bucket(w)), []).append(job)
        dev = self.device
        for (bh, bw), batch in buckets.items():
            B = _bucket_pow2(len(batch))
            with self._lock:
                key = (bh, bw, B)
                self.bucket_stats[key] = self.bucket_stats.get(key, 0) + 1
            src = torch.zeros((B, bh, bw), dtype=torch.float32, device=dev)
            valid = torch.zeros((B, bh, bw), dtype=torch.bool, device=dev)
            rows = np.full((B, height, width), -1e6, np.float32)
            cols = np.full((B, height, width), -1e6, np.float32)
            for k, (_, wdw, r, c) in enumerate(batch):
                rows[k] = r
                cols[k] = c
                h, w = wdw.data.shape
                src[k, :h, :w] = wdw.data
                valid[k, :h, :w] = wdw.valid
            out, ok = warp_gather_batch(
                src, valid, torch.from_numpy(rows).to(dev),
                torch.from_numpy(cols).to(dev), method)
            for k, (i, _, _, _) in enumerate(batch):
                results[i] = (out[k], ok[k])
        return results

    def _ctrl_geo_coords(self, dst_gt: GeoTransform, dst_crs: CRS,
                         height: int, width: int, src_crs: CRS,
                         step: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Sparse control-point grid: dst pixel centres at every
        ``step``-th row/col projected into src CRS (f64, host).  The step
        halves until the bilinear reconstruction error at cell midpoints
        is within 0.125 px (GDAL's approx-transformer bound).  Returns
        (sx, sy, actual_step)."""
        key = ("ctrl", dst_gt.to_gdal(), dst_crs, height, width, src_crs,
               step)
        hit = self._geo_cache_get(key)
        if hit is not None:
            return hit
        while True:
            gh = (height - 1 + step - 1) // step + 1
            gw = (width - 1 + step - 1) // step + 1
            c = np.arange(gw, dtype=np.float64) * step + 0.5
            r = np.arange(gh, dtype=np.float64) * step + 0.5
            C, R = np.meshgrid(c, r)
            x, y = dst_gt.pixel_to_geo(C, R)
            sx, sy = dst_crs.transform_to(src_crs, x, y)
            sx = np.asarray(sx, np.float64)
            sy = np.asarray(sy, np.float64)
            if step <= 2 or self._ctrl_err_px(
                    sx, sy, dst_gt, dst_crs, src_crs, step) <= 0.125:
                break
            step //= 2
        self._geo_cache_put(key, (sx, sy, step))
        return sx, sy, step

    @staticmethod
    def _ctrl_err_px(sx: np.ndarray, sy: np.ndarray, dst_gt: GeoTransform,
                     dst_crs: CRS, src_crs: CRS, step: int) -> float:
        """Max bilinear-interpolation error of the ctrl grid at cell
        midpoints, in units of local source-coords-per-dst-pixel."""
        gh, gw = sx.shape
        if gh < 2 or gw < 2:
            return 0.0
        c = (np.arange(gw - 1, dtype=np.float64) + 0.5) * step + 0.5
        r = (np.arange(gh - 1, dtype=np.float64) + 0.5) * step + 0.5
        C, R = np.meshgrid(c, r)
        x, y = dst_gt.pixel_to_geo(C, R)
        ex, ey = dst_crs.transform_to(src_crs, x, y)
        ix = 0.25 * (sx[:-1, :-1] + sx[:-1, 1:] + sx[1:, :-1]
                     + sx[1:, 1:])
        iy = 0.25 * (sy[:-1, :-1] + sy[:-1, 1:] + sy[1:, :-1]
                     + sy[1:, 1:])
        du = np.hypot(sx[:-1, 1:] - sx[:-1, :-1],
                      sy[:-1, 1:] - sy[:-1, :-1]) / step
        dv = np.hypot(sx[1:, :-1] - sx[:-1, :-1],
                      sy[1:, :-1] - sy[:-1, :-1]) / step
        scale = np.maximum(np.maximum(du, dv), 1e-12)
        with np.errstate(invalid="ignore"):
            px = np.hypot(np.asarray(ex) - ix, np.asarray(ey) - iy) / scale
        if not px.size or np.all(np.isnan(px)):
            return 0.0
        return float(np.nanmax(px))

    def _granule_stride(self, g, dst_gt: GeoTransform, dst_crs: CRS,
                        height: int, width: int) -> float:
        """Source pixels stepped per dst pixel for a granule under this
        request — drives the scene cache's overview-level choice."""
        key = (dst_gt.to_gdal(), dst_crs, height, width,
               g.srs, tuple(g.geo_transform or ()))
        with self._lock:
            hit = self._stride_cache.get(key)
            if hit is not None:
                self._stride_cache.move_to_end(key)
                return hit
        try:
            src_crs = parse_crs(g.srs) if g.srs else None
        except ValueError:
            src_crs = None
        if src_crs is None:
            return 1.0
        sx, sy, step = self._ctrl_geo_coords(dst_gt, dst_crs, height,
                                             width, src_crs, 16)
        ggt = GeoTransform.from_gdal(g.geo_transform)
        col, row = ggt.geo_to_pixel(sx, sy)
        with np.errstate(invalid="ignore"):
            dr = np.nanmedian(np.abs(np.diff(row, axis=0))) / step
            dc = np.nanmedian(np.abs(np.diff(col, axis=1))) / step
        stride = min(float(dr), float(dc))
        stride = stride if np.isfinite(stride) and stride > 1.0 else 1.0
        with self._lock:
            self._stride_cache[key] = stride
            while len(self._stride_cache) > self._STRIDE_CACHE_MAX:
                self._stride_cache.popitem(last=False)
        return stride

    def _scene_groups(self, granules, ns_ids, prios, dst_gt, dst_crs,
                      height, width) -> Optional[List[SceneGroup]]:
        """Device inputs grouped by (source CRS, bucket shape, dtype);
        None when any scene is uncacheable."""
        scenes = []
        for g in granules:
            stride = self._granule_stride(g, dst_gt, dst_crs, height,
                                          width)
            s = self.cache.get(g, stride)
            if s is None:
                return None
            scenes.append(s)
        by_key: Dict[tuple, List[int]] = {}
        for i, s in enumerate(scenes):
            by_key.setdefault((s.crs.name(), s.bucket, str(s.dtype)),
                              []).append(i)
        groups = []
        for idxs in by_key.values():
            gs = [scenes[i] for i in idxs]
            s0 = gs[0]
            sx, sy, step = self._ctrl_geo_coords(
                dst_gt, dst_crs, height, width, s0.crs, 16)
            ox, oy = s0.gt.x0, s0.gt.y0
            ctrl = np.stack([sx - ox, sy - oy]).astype(np.float32)
            dkey = ("ctrldev", dst_gt.to_gdal(), dst_crs, height, width,
                    s0.crs, ox, oy)
            ctrl_dev = self._geo_cache_get(dkey)
            if ctrl_dev is None:
                ctrl_dev = torch.from_numpy(ctrl).to(self.device)
                self._geo_cache_put(dkey, ctrl_dev)
            B = _bucket_pow2(len(gs))
            params = np.zeros((B, 11), np.float64)
            params[:, 10] = -1.0
            for k, (i, s) in enumerate(zip(idxs, gs)):
                params[k, :6] = _inv_gt_params(s.gt, ox, oy)
                params[k, 6] = s.height
                params[k, 7] = s.width
                params[k, 8] = s.nodata
                params[k, 9] = prios[i]
                params[k, 10] = ns_ids[i]
            groups.append(SceneGroup(gs, ctrl, ctrl_dev, params, step))
        return groups

    def page_spans(self, group: SceneGroup, cap: int):
        """Each granule's page-grid window (i0, i1, j0, j1), None for a
        padding row or one with nothing to gather, and the most pages one
        window needs; None when a window needs more than ``cap`` pages."""
        pr, pc = self.pool.page_rows, self.pool.page_cols
        cx = np.asarray(group.ctrl[0], np.float64)
        cy = np.asarray(group.ctrl[1], np.float64)
        params64 = group.params
        gs = group.scenes
        spans = []
        maxnpg = 1
        for k in range(int(params64.shape[0])):
            p = params64[k]
            if p[10] < 0 or k >= len(gs):
                spans.append(None)      # batch-padding row
                continue
            made = _granule_bounds(p, cx, cy)
            if made is None:
                spans.append(None)      # nothing to gather
                continue
            r_lo, r_hi, c_lo, c_hi = made
            bh, bw = int(gs[k].dev.shape[0]), int(gs[k].dev.shape[1])
            i0 = max(0, r_lo) // pr
            i1 = min(-(-bh // pr) - 1, r_hi // pr)
            j0 = max(0, c_lo) // pc
            j1 = min(-(-bw // pc) - 1, c_hi // pc)
            if i1 < i0 or j1 < j0:
                spans.append(None)      # footprint entirely off-scene
                continue
            npg = (i1 - i0 + 1) * (j1 - j0 + 1)
            if npg > cap:
                return None
            maxnpg = max(maxnpg, npg)
            spans.append((i0, i1, j0, j1))
        return spans, maxnpg

    def _paged_from_group(self, group: SceneGroup, n_pad: int,
                          lane_union: bool = False):
        """Page tables + 16-wide kernel params for one scene group, or
        None when the paged leg cannot serve it: a window over
        `page_slots()` pages, a page list the reference's VMEM gate
        refuses for ``n_pad`` (the pow2-padded namespace count), or the
        pool full of pinned pages.

        Returns (tables (T, S) int32, params16 (T, 16) f32, real_pages).
        Page coverage per granule comes from the same `_granule_bounds`
        margins the bucketed window uses; table slots come back PINNED
        and the caller must `pool.unpin(tables)` once its dispatch is
        enqueued.  ``lane_union`` (expression lanes) widens every
        granule's window to their union (`autoplan.union_lane_spans`):
        taps outside a granule's true extent are rejected before the
        window rebase, so a wider window changes no tap."""
        pool = self.pool
        pr, pc = pool.page_rows, pool.page_cols
        cap = page_slots()
        made = self.page_spans(group, cap)
        if made is None:
            return None
        spans, maxnpg = made
        if lane_union:
            spans, maxnpg = union_lane_spans(spans, cap, maxnpg)
        S = _bucket_pow2(maxnpg)
        if not paged_vmem_ok(S, n_pad, pr, pc):
            with self._lock:
                self.paged_gated += 1
            return None
        params64 = group.params
        gs = group.scenes
        T = int(params64.shape[0])
        tables = np.zeros((T, S), np.int32)
        params16 = np.zeros((T, PARAMS_W), np.float32)
        params16[:, :11] = params64[:, :11].astype(np.float32)
        pinned = []
        real_pages = 0
        for k, span in enumerate(spans):
            if span is None:
                # zero-extent row (slots 13/14 stay 0): every tap is
                # out of window, exactly a bucketed all-masked granule
                continue
            i0, i1, j0, j1 = span
            s = gs[k]
            slots = pool.table_for(s.dev, s.serial, i0, i1, j0, j1)
            if slots is None:
                for t in pinned:
                    pool.unpin(t)
                return None
            pinned.append(slots)
            tables[k, :slots.size] = slots
            real_pages += int(slots.size)
            params16[k, 11] = i0 * pr
            params16[k, 12] = j0 * pc
            params16[k, 13] = (i1 - i0 + 1) * pr
            params16[k, 14] = (j1 - j0 + 1) * pc
            params16[k, 15] = j1 - j0 + 1
        return tables, params16, real_pages

    def _group_scored(self, group: SceneGroup, method: str, n_pad: int,
                      height: int, width: int):
        """Kernel B2 over one scene group (padding rows dropped): the
        scored (canvases, best) (n_pad, H, W)."""
        n = len(group.scenes)
        params = torch.from_numpy(group.params[:n].astype(np.float32)) \
            .to(self.device)
        return warp_scenes_scored([s.dev for s in group.scenes],
                                  group.ctrl_dev, params, method, n_pad,
                                  (height, width), group.step)

    def warp_mosaic_scenes(self, granules, ns_ids: Sequence[int],
                           prios: Sequence[float], dst_gt: GeoTransform,
                           dst_crs: CRS, height: int, width: int,
                           n_ns: int, method: str = "near",
                           host: bool = False):
        """Fused warp + per-namespace mosaic from the cached scenes:
        (canvases (n_pad, H, W) f32, valids bool) on the device, or None
        when a scene is uncacheable.  One group: B1 when the page pool
        serves it (same gate and declines as `render_byte_scenes`),
        else B2.  Several groups (granules across source CRSs): B2 per
        group, then a per-pixel priority combine.  ``host`` lets a
        wave lane's result come back as the host arrays it arrives as
        (a caller that reads it on the host: the WCS export), instead of
        being uploaded again."""
        if _bucket_pow2(n_ns) > MAX_NS:
            return _by_ns_chunks(
                lambda gs, ids, pr, n: self.warp_mosaic_scenes(
                    gs, ids, pr, dst_gt, dst_crs, height, width, n, method),
                granules, ns_ids, prios, n_ns)
        groups = self._scene_groups(granules, ns_ids, prios, dst_gt,
                                    dst_crs, height, width)
        if groups is None:
            return None
        n_pad = _bucket_pow2(n_ns)
        if len(groups) > 1:
            parts = [self._group_scored(g, method, n_pad, height, width)
                     for g in groups]
            return combine_scored(torch.stack([c for c, _ in parts]),
                                  torch.stack([b for _, b in parts]))
        group = groups[0]
        made = self._paged_from_group(group, n_pad)
        if made is None:
            with self._lock:
                self.paged_declined += 1
            canv, best = self._group_scored(group, method, n_pad, height,
                                            width)
            return canv, best > float("-inf")
        tables, params16, _ = made
        with self._lock:
            self.paged_engaged += 1
        dev = self.device
        if waves_enabled():
            c, v = default_waves(dev).warp_scored(
                self.pool, tables, params16, group.ctrl,
                (method, n_pad, (height, width), group.step),
                _bucketed_lane(group), _serials(group))
            if host:
                return c, v
            return torch.from_numpy(c).to(dev), torch.from_numpy(v).to(dev)
        try:
            with self.pool.locked_pool() as pool:
                canv, best = warp_scored_paged(
                    pool, torch.from_numpy(tables[None]).to(dev),
                    torch.from_numpy(params16).to(dev),
                    group.ctrl_dev[None], method, n_pad, (height, width),
                    group.step)
        finally:
            self.pool.unpin(tables)
        return canv[0], best[0] > float("-inf")

    def warp_mosaic(self, windows: Sequence[DecodedWindow],
                    ns_ids: Sequence[int], prios: Sequence[float],
                    dst_gt: GeoTransform, dst_crs: CRS, height: int,
                    width: int, n_ns: int, method: str = "near"):
        """Fused warp + per-namespace mosaic of decoded windows, one B2
        launch per source CRS with that CRS's control grid: (canvases
        (n_pad, H, W) f32, valids bool).  B2 takes scenes of one shape,
        so a group's windows are padded on the device into one NaN
        stack of the largest window's shape; validity is NaN-encoded
        (params[8] = NaN: a tap is valid when finite) and each window's
        true extent rejects the padding."""
        if _bucket_pow2(n_ns) > MAX_NS:
            return _by_ns_chunks(
                lambda ws, ids, pr, n: self.warp_mosaic(
                    ws, ids, pr, dst_gt, dst_crs, height, width, n, method),
                windows, ns_ids, prios, n_ns)
        by_crs: Dict[CRS, List[int]] = {}
        for i, wdw in enumerate(windows):
            by_crs.setdefault(wdw.src_crs, []).append(i)
        n_pad = _bucket_pow2(n_ns)
        dev = self.device
        parts = []
        for crs, idxs in by_crs.items():
            sx, sy, step = self._ctrl_geo_coords(dst_gt, dst_crs, height,
                                                 width, crs, 16)
            gs = [windows[i] for i in idxs]
            bh = max(g.data.shape[0] for g in gs)
            bw = max(g.data.shape[1] for g in gs)
            src = torch.full((len(gs), bh, bw), float("nan"),
                             dtype=torch.float32, device=dev)
            params = np.zeros((len(gs), 11), np.float64)
            ox, oy = gs[0].window_gt.x0, gs[0].window_gt.y0
            ctrl = np.stack([sx - ox, sy - oy]).astype(np.float32)
            for k, (i, wdw) in enumerate(zip(idxs, gs)):
                h0, w0 = wdw.data.shape
                src[k, :h0, :w0] = torch.where(wdw.valid, wdw.data,
                                               float("nan"))
                params[k, :6] = _inv_gt_params(wdw.window_gt, ox, oy)
                params[k, 6] = h0
                params[k, 7] = w0
                params[k, 8] = np.nan
                params[k, 9] = prios[i]
                params[k, 10] = ns_ids[i]
            parts.append(warp_scenes_scored(
                src, torch.from_numpy(ctrl).to(dev),
                torch.from_numpy(params.astype(np.float32)).to(dev),
                method, n_pad, (height, width), step))
        if len(parts) == 1:
            canv, best = parts[0]
            return canv, best > float("-inf")
        return combine_scored(torch.stack([c for c, _ in parts]),
                              torch.stack([b for _, b in parts]))

    def _note_ns_declined(self) -> None:
        with self._lock:
            self.ns_declined += 1

    def render_expr_byte(self, granules, ns_ids: Sequence[int],
                         prios: Sequence[float], dst_gt: GeoTransform,
                         dst_crs: CRS, height: int, width: int,
                         n_slots: int, fp, method: str = "near",
                         offset: float = 0.0, scale: float = 0.0,
                         clip: float = 0.0, colour_scale: int = 0,
                         auto: bool = True):
        """The fused band-algebra tile: ``ns_ids`` are fingerprint slot
        indices, ``fp`` the `ops.expr.ExprFingerprint`.  PNG-ready uint8
        (H, W): a host array from a wave, else a tensor on the device;
        or None when the fused route declines (the caller then runs the
        modular route and counts the request "unfused")."""
        t = time.perf_counter()
        groups = self._scene_groups(granules, ns_ids, prios, dst_gt,
                                    dst_crs, height, width)
        t = self.add_span("groups", t)
        if groups is None or len(groups) != 1:
            return None
        group = groups[0]
        n_pad = _bucket_pow2(n_slots)
        if n_pad > MAX_NS:
            self._note_ns_declined()
            return None
        made = self._paged_from_group(group, n_pad, lane_union=True)
        t = self.add_span("tables", t)
        if made is None:
            with self._lock:
                self.paged_declined += 1
            return None
        tables, params16, _ = made
        with self._lock:
            self.paged_engaged += 1
        sp = np.array([offset, scale, clip], np.float32)
        consts = fp.const_array()
        statics = (method, n_pad, (height, width), group.step, auto,
                   colour_scale, fp.key)
        dev = self.device
        if waves_enabled():
            note_expr_fused("wave")
            out = default_waves(dev).render_expr(
                self.pool, tables, params16, group.ctrl, sp, consts,
                statics, _bucketed_lane(group), _serials(group))
            self.add_span("dispatch", t)
            return out
        note_expr_fused("percall")
        try:
            with self.pool.locked_pool() as pool:
                out = render_expr_paged(
                    pool, torch.from_numpy(tables[None]).to(dev),
                    torch.from_numpy(params16).to(dev),
                    group.ctrl_dev[None], sp[None],
                    torch.from_numpy(consts[None]).to(dev), method, n_pad,
                    (height, width), group.step, auto, colour_scale,
                    fp.key, fp.hash)
        finally:
            self.pool.unpin(tables)
        self.add_span("dispatch", t)
        return out[0]

    def render_bands_byte(self, granules, ns_ids: Sequence[int],
                          prios: Sequence[float], dst_gt: GeoTransform,
                          dst_crs: CRS, height: int, width: int,
                          n_ns: int, out_sel: Sequence[int],
                          method: str = "near", offset: float = 0.0,
                          scale: float = 0.0, clip: float = 0.0,
                          colour_scale: int = 0, auto: bool = True):
        """The multi-band planes rung: one B2 launch over the group's
        cached scenes, one byte plane per ``out_sel`` namespace: uint8
        (n_out, H, W) on the device, or None (several source-CRS
        groups, an uncacheable scene, more namespaces than `MAX_NS`)."""
        groups = self._scene_groups(granules, ns_ids, prios, dst_gt,
                                    dst_crs, height, width)
        if groups is None or len(groups) != 1:
            return None
        group = groups[0]
        n_pad = _bucket_pow2(n_ns)
        if n_pad > MAX_NS:
            self._note_ns_declined()
            return None
        n = len(group.scenes)
        params = torch.from_numpy(group.params[:n].astype(np.float32)) \
            .to(self.device)
        sp = np.array([offset, scale, clip], np.float32)
        return render_scenes_bands([s.dev for s in group.scenes],
                                   group.ctrl_dev, params, sp, out_sel,
                                   method, n_pad, (height, width),
                                   group.step, auto, colour_scale)

    def render_rgba_byte(self, granules, out_sel: Sequence[int],
                         dst_gt: GeoTransform, dst_crs: CRS, height: int,
                         width: int, method: str = "near",
                         offset: float = 0.0, scale: float = 0.0,
                         clip: float = 0.0, colour_scale: int = 0,
                         auto: bool = True):
        """The single-scene RGB rung: three granules, one per band, of
        one grid (srs, geotransform; scenes of one bucket, dtype, nodata
        and shape) -> the RGBA tile uint8 (H, W, 4) on the device, or
        None.  Channel k comes from granule ``out_sel[k]``."""
        if len(granules) != 3 or len(out_sel) != 3 \
                or sorted(out_sel) != [0, 1, 2]:
            return None
        g0 = granules[0]
        if g0.geo_loc:
            return None
        for g in granules[1:]:
            if g.geo_loc or g.srs != g0.srs \
                    or g.geo_transform != g0.geo_transform:
                return None
        try:
            src_crs = parse_crs(g0.srs) if g0.srs else None
        except ValueError:
            return None
        if src_crs is None:
            return None
        stride = self._granule_stride(g0, dst_gt, dst_crs, height, width)
        chans = []
        for ns in out_sel:
            s = self.cache.get(granules[ns], stride)
            if s is None:
                return None
            chans.append(s)
        s0 = chans[0]
        for s in chans[1:]:
            if s.bucket != s0.bucket or s.dtype != s0.dtype \
                    or s.crs != s0.crs \
                    or not (np.isnan(s.nodata) and np.isnan(s0.nodata)
                            or s.nodata == s0.nodata) \
                    or (s.height, s.width) != (s0.height, s0.width):
                return None
        sx, sy, step = self._ctrl_geo_coords(dst_gt, dst_crs, height,
                                             width, s0.crs, 16)
        ox, oy = s0.gt.x0, s0.gt.y0
        dkey = ("ctrldev", dst_gt.to_gdal(), dst_crs, height, width,
                s0.crs, ox, oy)
        ctrl_dev = self._geo_cache_get(dkey)
        if ctrl_dev is None:
            ctrl_dev = torch.from_numpy(
                np.stack([sx - ox, sy - oy]).astype(np.float32)) \
                .to(self.device)
            self._geo_cache_put(dkey, ctrl_dev)
        param = np.array(_inv_gt_params(s0.gt, ox, oy)
                         + (s0.height, s0.width, s0.nodata, 0.0, 0.0),
                         np.float32)
        sp = np.array([offset, scale, clip], np.float32)
        return render_rgba_ctrl([s.dev for s in chans], ctrl_dev,
                                torch.from_numpy(param).to(self.device),
                                sp, method, (height, width), step, auto,
                                colour_scale)

    def render_byte_scenes(self, granules, ns_ids: Sequence[int],
                           prios: Sequence[float], dst_gt: GeoTransform,
                           dst_crs: CRS, height: int, width: int,
                           n_ns: int, method: str = "near",
                           offset: float = 0.0, scale: float = 0.0,
                           clip: float = 0.0, colour_scale: int = 0,
                           auto: bool = True):
        """Whole-tile fast path: cached scenes -> PNG-ready uint8 (H, W)
        (255 = nodata), or None when the granule set is not one uniform
        group or a scene is uncacheable.  A tile the paged leg serves
        comes back from its wave as a host array when waves are on; else
        the result is a tensor on the executor's device."""
        t = time.perf_counter()
        groups = self._scene_groups(granules, ns_ids, prios, dst_gt,
                                    dst_crs, height, width)
        t = self.add_span("groups", t)
        if groups is None or len(groups) != 1:
            return None
        group = groups[0]
        sp = np.array([offset, scale, clip], np.float32)
        n_pad = _bucket_pow2(n_ns)
        statics = (method, n_pad, (height, width), group.step, auto,
                   colour_scale)
        made = self._paged_from_group(group, n_pad)
        t = self.add_span("tables", t)
        if made is not None:
            tables, params16, _ = made
            with self._lock:
                self.paged_engaged += 1
            dev = self.device
            if waves_enabled():
                out = default_waves(dev).render_byte(
                    self.pool, tables, params16, group.ctrl, sp, statics,
                    _bucketed_lane(group), _serials(group))
                self.add_span("dispatch", t)
                return out
            try:
                with self.pool.locked_pool() as pool:
                    out = render_byte_paged(
                        pool, torch.from_numpy(tables[None]).to(dev),
                        torch.from_numpy(params16).to(dev),
                        group.ctrl_dev[None], torch.from_numpy(sp[None]),
                        *statics)
            finally:
                self.pool.unpin(tables)
            self.add_span("dispatch", t)
            return out[0]
        with self._lock:
            self.paged_declined += 1
        # B2 reads the cached scenes where they are; the group's padding
        # rows (ns -1, after the real granules) never win the mosaic, so
        # they are dropped here
        n = len(group.scenes)
        params = torch.from_numpy(group.params[:n].astype(np.float32)) \
            .to(self.device)
        out = render_scenes([s.dev for s in group.scenes], group.ctrl_dev,
                            params, torch.from_numpy(sp), *statics)
        self.add_span("dispatch", t)
        return out
