#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. card facts and the kernel build (nvcc, from gsky_tpu_torch/csrc);
2. kernels B1 (paged) and B2 (bucketed) against their plain PyTorch
   versions on the card: near/bilinear/cubic, 1 and 2 namespaces, page
   crossings, padding rows (ns -1) and null-page tables;
3. end to end at real size: four overlapping Landsat-8-size granules
   (7681 x 7821 int16, 30 m, EPSG:32755, nodata -999) written with the
   port's GeoTIFF writer, crawled into the port's MAS store, and 32
   GetMap tiles of 256 x 256 EPSG:3857 per resampling method rendered
   through `TilePipeline(device="cuda").render_composite_byte` — every
   tile through kernel B1;
4. the decline leg: tiles with GSKY_PAGE_SLOTS=1, served by kernel B2;
5. card vs CPU: tiles again with ``device="cpu"`` (the plain versions);
6. kernel B3 (the drill's masked stats) against its plain version on
   the card: B in {1, 7, 129, 1000, 1024} x N in {1, 2047, 2049, 16384,
   262144}, with an all-invalid row, values on the clip bounds and
   NaN / +-inf where valid is False; counts and sums bit-exact;
7. the WPS drill end to end at real size: a 1000-timestep float32 stack
   of 512 x 512 at 0.004 degrees (EPSG:4326, MODIS-500 m-like, nodata
   -9999 block) written with the port's NetCDF writer and crawled into
   the port's MAS store; one cold request (host reads while the stack
   uploads), then warm requests through
   `DrillPipeline(device="cuda").process`, each through kernel B3 on a
   (1024, 262144) input, plus one with deciles=9; warm results equal the
   cold (host numpy) result;
8. card vs CPU: the drill over the first 100 timesteps through
   ``device="cpu"`` (exact and deciles) equals the card's.

Then each kernel's device time (torch.profiler) is taken at the main
path's shapes beside its plain version and its memory bound: for B1/B2
the bytes of the source pixels their taps need, read once, plus their
other inputs and outputs; for B3 its inputs read once and outputs
written once.  The last line of standard output is the
JSON result the harness reads; the line before it gives the card's name
and power limit, and a "kernels" JSON line precedes them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
N_TILES = 32
METHODS = ("near", "bilinear", "cubic")
NS = "LC08_B4"
SCENE_H, SCENE_W = 7681, 7821
# the drill (BASELINE config 5): 1000 timesteps, 512 x 512 at 0.004 deg
DRILL_T, DRILL_HW, DRILL_RES = 1000, 512, 0.004
DRILL_X0, DRILL_Y0 = 130.0, -20.0
# non-rectangular, its window ~390 x 400 px: bucket 512, B3 input
# (1024, 262144)
DRILL_POLY = ("POLYGON((130.20 -20.22,131.76 -20.30,131.80 -21.78,"
              "130.95 -21.82,130.22 -21.40,130.20 -20.22))")
N_WARM = 10
B3_SHAPES_B = (1, 7, 129, 1000, 1024)
B3_SHAPES_N = (1, 2047, 2049, 16384, 262144)


def log(*a):
    print(*a, flush=True)


def card_facts() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, reps=20):
    """Wall time of ``fn`` on the card's clock (CUDA events around
    back-to-back calls, host work between launches included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, kernel, reps=50):
    """Device time of one launch of ``kernel`` (a __global__ name) per
    call of ``fn``: torch.profiler's CUDA kernel records, so host work
    between launches is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if kernel in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in evs)
    # the tracer may drop a record at the edge of the window, so the
    # mean is over the launches it saw, which must be most of them
    if not reps // 2 <= count <= reps:
        raise AssertionError(f"profiler saw {count} {kernel} launches "
                             f"of {reps}")
    return sum(e.self_device_time_total for e in evs) / count / 1e3


def ulp_diff(a, b):
    import torch
    a = a.double()
    b = b.double()
    sp = torch.from_numpy(np.spacing(np.abs(a.cpu().numpy()).astype(
        np.float32)).astype(np.float64)).to(a.device)
    d = (a - b).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float((d / sp.clamp_min(1e-45)).max())


def check_pair(method, ck, bk, cp, bp, what):
    """Kernel vs plain: best exact, canv exact for near, <= 2 ulp for
    the interpolated methods.  Returns max |canv difference|."""
    import torch
    if not torch.equal(bk, bp):
        raise AssertionError(f"{what}: best differs")
    if method == "near":
        if not torch.equal(ck, cp):
            raise AssertionError(f"{what}: near canvas not bit-exact")
    else:
        u = ulp_diff(ck, cp)
        if u > 2:
            raise AssertionError(f"{what}: {u} ulp > 2")
    return float((ck - cp).abs().max())


def phase_kernels():
    """B1 and B2 against their plain versions on synthetic inputs that
    hit every edge case; returns the number of comparisons."""
    import torch
    from gsky_tpu_torch.ops import paged, warp_render
    from gsky_tpu_torch.ops.warp import _bilerp_grid, params16
    from gsky_tpu_torch.pipeline.pages import PagePool
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    S_px, h, w, step = 700, 256, 256, 16
    B = 4
    stack = rng.uniform(-500, 4000, (B, S_px, S_px)).astype(np.float32)
    stack[0, 100:140, 100:180] = np.nan
    stack[1, :, :300] = -999.0
    gh = gw = (h - 1 + step - 1) // step + 1
    ctrl = np.stack([
        np.linspace(20, 560, gw, dtype=np.float32)[None, :].repeat(gh, 0),
        np.linspace(30, 600, gh, dtype=np.float32)[:, None].repeat(gw, 1)])
    n = 0
    for n_ns in (1, 2):
        params = np.zeros((B, 11), np.float32)
        for k in range(B):
            params[k] = [0.4 * k - 0.2, 1.01, 0.02, 0.3 * k, -0.01, 0.99,
                         S_px, S_px, -999.0, 100.0 - k, k % n_ns]
        params[B - 1, 10] = -1.0              # a padding row
        stack_d = torch.from_numpy(stack).to(dev)
        ctrl_d = torch.from_numpy(ctrl).to(dev)
        p16 = params16(torch.from_numpy(params).to(dev))
        sx = _bilerp_grid(ctrl_d[0], h, w, step).contiguous()
        sy = _bilerp_grid(ctrl_d[1], h, w, step).contiguous()
        # B1: stage each granule's whole scene as pages (every tile
        # crosses page rows and columns); granule 2 gets a null table
        pool = PagePool(capacity=128, page_rows=128, page_cols=512,
                        device=dev)
        T, Sl = B, 16
        tables = np.zeros((T, Sl), np.int32)
        p16b = p16.clone()
        ni, nj = -(-S_px // 128), -(-S_px // 512)
        for k in range(B - 1):
            if k == 2:
                p16b[k, 13] = ni * 128
                p16b[k, 14] = nj * 512
                p16b[k, 15] = nj
                continue                      # null table: all invalid
            t = pool.table_for(stack_d[k], 1000 + k, 0, ni - 1, 0, nj - 1)
            tables[k, :t.size] = t
            p16b[k, 13] = ni * 128
            p16b[k, 14] = nj * 512
            p16b[k, 15] = nj
        tab_d = torch.from_numpy(tables[None]).to(dev)
        for method in METHODS:
            with pool.locked_pool() as parr:
                ck, bk = paged.paged_render_scored(
                    parr, tab_d, p16b.contiguous(), sx[None].contiguous(),
                    sy[None].contiguous(), method, n_ns)
                cp, bp = paged.paged_render_scored_plain(
                    parr, tab_d, p16b, sx[None], sy[None], method, n_ns)
            check_pair(method, ck, bk, cp, bp, f"B1 {method} n_ns={n_ns}")
            ck, bk = warp_render.warp_render_scored(stack_d, sx, sy, p16,
                                                    method, n_ns)
            cp, bp = warp_render.warp_render_scored_plain(
                stack_d, sx, sy, p16, method, n_ns)
            check_pair(method, ck, bk, cp, bp, f"B2 {method} n_ns={n_ns}")
            n += 2
    torch.cuda.synchronize()
    return n


def write_archive(root, shape=(SCENE_H, SCENE_W)):
    """Four overlapping Landsat-8-size granules, 2020-01-10..13."""
    h, w = shape
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.geotiff import write_geotiff
    utm = parse_crs("EPSG:32755")
    rng = np.random.default_rng(8)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    paths = []
    for i in range(4):
        gt = GeoTransform(500000.0 + i * 3000.0, 30.0, 0.0,
                          6200000.0 - i * 3000.0, 0.0, -30.0)
        field = 3000.0 + 1500.0 * np.sin(xx / (90.0 + 11 * i)) \
            * np.cos(yy / (130.0 - 9 * i))
        data = (field + rng.normal(0, 120, (h, w))
                .astype(np.float32)).astype(np.int16)
        data[(xx + yy) < 1500] = -999         # nodata collar corner
        p = os.path.join(root, f"LC08_202001{10 + i:02d}_T1.tif")
        write_geotiff(p, data, gt, utm, nodata=-999, compress=False)
        paths.append(p)
    return paths


def tile_boxes():
    """32 native-resolution 256-px EPSG:3857 tiles (8 x 4) over the
    overlap, starting at the newest scene's nodata corner."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox, transform_bbox
    utm = parse_crs("EPSG:32755")
    merc = parse_crs("EPSG:3857")
    x0, y0 = 500000.0 + 9000.0 + 12000.0, 6200000.0 - 9000.0 - 12000.0
    c = transform_bbox(BBox(x0, y0, x0 + 1, y0 + 1), utm, merc)
    lat = np.degrees(np.arctan(np.sinh(c.ymin / 6378137.0)))
    res = 30.0 / np.cos(np.radians(lat))     # ~30 m on the ground
    size = 256 * res
    return [(c.xmin + i * size, c.ymin - (j + 1) * size,
             c.xmin + (i + 1) * size, c.ymin - j * size)
            for j in range(4) for i in range(8)]


def render(pipe, root, boxes, method):
    """Render tiles; returns (host uint8 tiles, per-tile seconds)."""
    import torch
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    merc = parse_crs("EPSG:3857")
    tiles, secs = [], []
    for box in boxes:
        req = GeoTileRequest(collection=root, bands=[NS],
                             bbox=BBox(*box), crs=merc, width=256,
                             height=256, resample=method)
        t0 = time.perf_counter()
        out = pipe.render_composite_byte(req)
        if out is None:
            raise AssertionError(f"tile {box} not rendered")
        if out.is_cuda:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        tile = out.cpu().numpy()
        if tile.dtype != np.uint8 or tile.shape != (256, 256):
            raise AssertionError(f"bad tile {tile.dtype} {tile.shape}")
        if (tile == 255).all():
            raise AssertionError(f"tile {box} is all nodata")
        tiles.append(tile)
    return tiles, secs


def stage_breakdown(pipe, root, boxes, method):
    """Per-stage host clock of warm GetMap tiles, read from the spans
    `TilePipeline.render_composite_byte` and `render_byte_scenes` record,
    plus the readback; then, on a second pass under torch.profiler, the
    device time per tile (all kernels, and B1's alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    ex = pipe.executor
    merc = parse_crs("EPSG:3857")
    reqs = [GeoTileRequest(collection=root, bands=[NS], bbox=BBox(*box),
                           crs=merc, resample=method) for box in boxes]
    clock = time.perf_counter

    def run():
        readback = 0.0
        for req in reqs:
            out = pipe.render_composite_byte(req)
            t0 = clock()
            out.cpu()
            readback += clock() - t0
        return readback

    for k in ex.spans:
        ex.spans[k] = 0.0
    t_all = clock()
    readback = run()
    wall = clock() - t_all
    spans = dict(ex.spans, readback=readback)
    # the profiler's host overhead would skew the spans, so the device
    # time is taken on a second pass over the same tiles
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    avgs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in avgs)
    b1_us = sum(e.self_device_time_total for e in avgs
                if "paged_render" in e.key)
    n = len(boxes)
    return ({k: v / n * 1e3 for k, v in spans.items()}, wall / n * 1e3,
            dev_us / n / 1e3, b1_us / n / 1e3)


class PlainCalls:
    """Counts calls of the kernels' plain versions while installed."""

    def __init__(self):
        from gsky_tpu_torch.ops import paged, stats, warp_render
        self.calls = 0
        self._mods = [(paged, "paged_render_scored_plain"),
                      (warp_render, "warp_render_scored_plain"),
                      (stats, "masked_stats_plain")]
        self._orig = [getattr(m, n) for m, n in self._mods]
        for (m, n), f in zip(self._mods, self._orig):
            setattr(m, n, self._counted(f))

    def _counted(self, f):
        def wrapped(*a, **k):
            self.calls += 1
            return f(*a, **k)
        return wrapped

    def remove(self):
        for (m, n), f in zip(self._mods, self._orig):
            setattr(m, n, f)


def make_pipeline(store, device):
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.pipeline.tile import TilePipeline
    return TilePipeline(MASClient(store), device=device)


def compare_tiles(method, ref, got, what):
    for a, b in zip(ref, got):
        diff = int(np.count_nonzero(a != b))
        if method == "near" and diff:
            raise AssertionError(f"{what} near: {diff} bytes differ")
        if diff > a.size // 1000:
            raise AssertionError(f"{what} {method}: {diff} bytes differ")


def tap_footprint_px(sx, sy, params, method):
    """Distinct source pixels one call's taps need: per granule, every
    tap of a finite, in-extent coordinate that lands inside the scene,
    counted once (what the kernels must read; nodata pixels included,
    padding outside the true extent not).  sx/sy (h, w), params (B, 16)
    with the window origin in slots 11/12."""
    import torch
    from gsky_tpu_torch.ops.warp import NEAR, fma
    offs = (0,) if method in NEAR else \
        ((0, 1) if method == "bilinear" else (-1, 0, 1, 2))
    total = 0
    for p in params:
        if float(p[10]) < 0:
            continue                          # padding row
        H, W = int(p[6]), int(p[7])
        cols = fma(p[2], sy, fma(p[1], sx, p[0])) - 0.5
        rows = fma(p[5], sy, fma(p[4], sx, p[3])) - 0.5
        ok = torch.isfinite(rows) & torch.isfinite(cols) \
            & (rows >= -0.5) & (rows <= H - 0.5) \
            & (cols >= -0.5) & (cols <= W - 0.5)
        shift = 0.5 if method in NEAR else 0.0
        r0 = torch.floor(torch.where(ok, rows, 0.0) + shift).long()
        c0 = torch.floor(torch.where(ok, cols, 0.0) + shift).long()
        seen = torch.zeros(H * W, dtype=torch.bool, device=sx.device)
        for dr in offs:
            for dc in offs:
                ri, ci = r0 + dr, c0 + dc
                m = ok & (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
                seen[(ri * W + ci)[m]] = True
        total += int(seen.sum())
    return total


def bound_bytes(sx, sy, params, method, n_ns, extra=0):
    """Least bytes one call moves: the taps' source pixels read once,
    sx/sy and params read, canv/best written, plus ``extra`` (B1's
    page tables)."""
    h, w = sx.shape[-2:]
    px = tap_footprint_px(sx.reshape(h, w), sy.reshape(h, w), params,
                          method)
    return px * 4 + 2 * h * w * 4 + 2 * n_ns * h * w * 4 \
        + params.numel() * 4 + extra


def b3_edge_inputs(B, N, seed):
    """B3 inputs made on the card: normal data x 100, valid 70%; row 0
    all invalid; the last row (when there are two or more) holds values
    on the clip bounds (valid); NaN and +-inf where valid is False."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    data = torch.randn((B, N), generator=g, device="cuda") * 100.0
    valid = torch.rand((B, N), generator=g, device="cuda") > 0.3
    valid[0] = False
    if B > 1:
        data[-1, ::7] = -80.0
        data[-1, 3::7] = 120.0
        valid[-1, ::7] = True
        valid[-1, 3::7] = True
    r = torch.rand((B, N), generator=g, device="cuda")
    bad = ~valid
    data[bad & (r < 0.2)] = float("nan")
    data[bad & (r > 0.9)] = float("inf")
    data[bad & (r > 0.8) & (r <= 0.9)] = float("-inf")
    return data.contiguous(), valid.contiguous()


def phase_b3_kernel():
    """B3 against its plain version on the card at every (B, N) of the
    phase's grid: counts and sums bit-exact (both sum each of 2048 lanes
    in chunk order, then one fixed lane tree).  Returns (comparisons,
    max |sum difference|)."""
    import torch
    from gsky_tpu_torch.ops import stats
    n, err = 0, 0.0
    saved = stats.masked_stats_kernel.launches
    for B in B3_SHAPES_B:
        for N in B3_SHAPES_N:
            data, valid = b3_edge_inputs(B, N, seed=B * 7 + N)
            s, c = stats.masked_stats(data, valid, -80.0, 120.0)
            sp, cp = stats.masked_stats_plain(data, valid, -80.0, 120.0)
            torch.cuda.synchronize()
            if not torch.equal(c, cp):
                raise AssertionError(f"B3 ({B}, {N}): counts differ")
            if not torch.equal(s, sp):
                d = float((s - sp).abs().max())
                raise AssertionError(f"B3 ({B}, {N}): sums not bit-exact "
                                     f"(max |diff| {d})")
            if c[0] != 0 or s[0] != 0:
                raise AssertionError(f"B3 ({B}, {N}): invalid row counted")
            err = max(err, float((s - sp).abs().max()))
            n += 1
            del data, valid
    stats.masked_stats_kernel.launches = saved
    return n, err


def write_drill_stack(path):
    """A 1000-step NDVI-like float32 stack (8-day steps from 2000-01-01:
    a smooth field, a seasonal cycle and noise; a -9999 nodata block
    inside the polygon), written with the port's NetCDF-3 writer."""
    from gsky_tpu_torch.geo.crs import EPSG4326
    from gsky_tpu_torch.io.netcdf import write_netcdf3
    T, hw = DRILL_T, DRILL_HW
    rng = np.random.default_rng(5)
    x = DRILL_X0 + DRILL_RES * (np.arange(hw) + 0.5)
    y = DRILL_Y0 - DRILL_RES * (np.arange(hw) + 0.5)
    times = 946684800.0 + 8 * 86400.0 * np.arange(T)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    base = 0.3 + 0.2 * np.sin(xx / 37.0) * np.cos(yy / 53.0)
    season = 0.15 * np.sin(2 * np.pi * np.arange(T) * 8 / 365.25)
    data = np.empty((T, hw, hw), np.float32)
    for t in range(T):
        data[t] = base + np.float32(season[t]) \
            + 0.05 * rng.standard_normal((hw, hw), dtype=np.float32)
    data[:, 100:160, 300:380] = -9999.0
    write_netcdf3(path, {"ndvi": data}, x, y, EPSG4326, times=times,
                  nodata=-9999.0)
    return times


def same_drill(ref, got, what, rtol=1e-5):
    """Dates and counts equal, values within ``rtol``, over the
    namespaces of ``ref``; returns the largest relative difference."""
    if got.dates != ref.dates or not set(ref.values) <= set(got.values):
        raise AssertionError(f"{what}: dates or namespaces differ")
    worst = 0.0
    for k in ref.values:
        if list(map(int, got.counts[k])) != list(map(int, ref.counts[k])):
            raise AssertionError(f"{what}: counts of {k} differ")
        a = np.asarray(ref.values[k], np.float64)
        b = np.asarray(got.values[k], np.float64)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{what}: NaN rows of {k} differ")
        ok = ~np.isnan(a)
        rel = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(a[ok]), 1e-30)
        if rel.size:
            worst = max(worst, float(rel.max()))
        if worst > rtol:
            raise AssertionError(f"{what}: {k} differs by {worst} > {rtol}")
    return worst


def phase_drill(root, card):
    """Phases 7 and 8.  Returns (B3 launches of the warm run, the
    arguments B3 got on the main path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    from gsky_tpu_torch.ops import paged, stats, warp_render
    from gsky_tpu_torch.pipeline import drill as tdrill
    from gsky_tpu_torch.pipeline.types import GeoDrillRequest
    t0 = time.perf_counter()
    path = os.path.join(root, "modis_ndvi_stack.nc")
    times = write_drill_stack(path)
    store = MASStore()
    rec = extract(path)
    if rec.get("error"):
        raise AssertionError(rec["error"])
    store.ingest(rec)
    log(f"phase 7: {DRILL_T} x {DRILL_HW} x {DRILL_HW} f32 stack "
        f"({os.path.getsize(path) / 1e9:.3f} GB) written + crawled in "
        f"{time.perf_counter() - t0:.1f} s")
    os.environ.pop("GSKY_DRILL_CACHE", None)   # default: async upload
    pipe = tdrill.DrillPipeline(MASClient(store), device="cuda")
    req = GeoDrillRequest(collection=root, bands=["ndvi"],
                          geometry_wkt=DRILL_POLY, approx=False)
    stats.masked_stats_kernel.launches = 0
    t0 = time.perf_counter()
    cold = pipe.process(req)
    cold_s = time.perf_counter() - t0
    if stats.masked_stats_kernel.launches or len(cold.dates) != DRILL_T:
        raise AssertionError("cold request did not take the host path")
    t0 = time.perf_counter()
    if not pipe.cache.wait_idle(600):
        raise AssertionError("stack upload did not finish")
    log(f"phase 7: cold drill {cold_s * 1e3:.1f} ms (host reads + numpy); "
        f"stack resident after {time.perf_counter() - t0:.1f} s more")

    # the main path: warm drills, counts from 0
    captured = []
    b3_call = tdrill.masked_stats

    def capture(*a):
        if not captured:
            captured.append(a)
        return b3_call(*a)

    tdrill.masked_stats = capture
    plain = PlainCalls()
    for k in (paged.paged_render_kernel, warp_render.warp_render_kernel,
              stats.masked_stats_kernel):
        k.launches = 0
    for k in pipe.spans:
        pipe.spans[k] = 0.0
    lat, warm = [], []
    try:
        for _ in range(N_WARM):
            t0 = time.perf_counter()
            warm.append(pipe.process(req))
            lat.append(time.perf_counter() - t0)
        spans = {k: v / N_WARM * 1e3 for k, v in pipe.spans.items()}
        t0 = time.perf_counter()
        dec = pipe.process(dataclasses.replace(req, deciles=9))
        dec_s = time.perf_counter() - t0
    finally:
        tdrill.masked_stats = b3_call
        plain.remove()
    b3_launches = stats.masked_stats_kernel.launches
    if b3_launches < N_WARM + 1 or plain.calls \
            or paged.paged_render_kernel.launches \
            or warp_render.warp_render_kernel.launches:
        raise AssertionError(f"warm drills: B3 {b3_launches} (want >= "
                             f"{N_WARM + 1}), plain calls {plain.calls}")
    d, v = captured[0][:2]
    want = (1 << (DRILL_T - 1).bit_length(), min(512, DRILL_HW) ** 2)
    if tuple(d.shape) != want:
        raise AssertionError(f"B3 main-path shape {tuple(d.shape)}, "
                             f"want {want}")
    worst = max(same_drill(cold, w, "warm vs cold") for w in warm)
    worst = max(worst, same_drill(cold, dec, "deciles run vs cold"))
    if len([k for k in dec.values if "_d" in k]) != 9:
        raise AssertionError("deciles missing")
    if not all(np.isfinite(dec.values[f"ndvi_d{i}"]).all()
               for i in range(1, 10)):
        raise AssertionError("non-finite deciles")
    wall = sum(lat)
    log(f"phase 7: {N_WARM} warm drills, {N_WARM / wall:.2f} drills/s, "
        f"p50 {np.median(lat) * 1e3:.2f} ms, p90 "
        f"{np.percentile(lat, 90) * 1e3:.2f} ms, "
        f"{DRILL_T * N_WARM / wall:.0f} timesteps/s; deciles=9 drill "
        f"{dec_s * 1e3:.1f} ms; B3 launches {b3_launches}, plain calls 0; "
        f"warm = cold within rel {worst:.3g} ({card})")
    log("phase 7 breakdown, ms per warm drill (host clock): " + ", ".join(
        f"{k} {val:.4f}" for k, val in spans.items()))
    # device time per drill, on a second pass under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pipe.process(req)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in avgs)
    b3_us = sum(e.self_device_time_total for e in avgs
                if "masked_stats_kernel" in e.key)
    top = sorted(((e.self_device_time_total, e.key) for e in avgs
                  if e.self_device_time_total > 0), reverse=True)[:6]
    stats.masked_stats_kernel.launches = b3_launches
    log(f"phase 7 device: busy {dev_us / 3 / 1e3:.4f} ms per drill, of "
        f"which B3 {b3_us / 3 / 1e3:.4f} ms; top: " + "; ".join(
            f"{k[:60]} {us / 3 / 1e3:.4f}" for us, k in top))

    # -- phase 8: card vs CPU over the first 100 timesteps ------------
    os.environ["GSKY_DRILL_CACHE"] = "sync"
    try:
        cpu = tdrill.DrillPipeline(MASClient(store), device="cpu")
        t0 = time.perf_counter()
        for kw in ({}, {"deciles": 9}):
            r = dataclasses.replace(req, start_time=float(times[0]),
                                    end_time=float(times[99]), **kw)
            on_card = pipe.process(r)
            on_cpu = cpu.process(r)
            if len(on_card.dates) != 100:
                raise AssertionError("phase 8 window is not 100 steps")
            w8 = same_drill(on_cpu, on_card, f"card vs cpu {kw}")
            for k in on_cpu.values:
                if "_d" in k and on_cpu.values[k] != on_card.values[k]:
                    raise AssertionError(f"card vs cpu: {k} not equal")
        cpu.cache.clear()
    finally:
        os.environ.pop("GSKY_DRILL_CACHE", None)
    log(f"phase 8: CPU drills over 100 steps match the card (rel "
        f"{w8:.3g}, deciles equal) in {time.perf_counter() - t0:.1f} s")
    pipe.cache.clear()
    return b3_launches, captured[0]


def time_b3(args, card):
    """B3's device time at the main path's (1024, 262144) inputs beside
    its bound (inputs read once, outputs written once, over the memory
    rate), its plain version and the same function composed from
    PyTorch's own reductions.  Returns (ms, plain ms, bound ms, library
    ms, max |kernel - plain|)."""
    import torch
    from gsky_tpu_torch.ops import stats
    d, v, lo, hi = args
    v8 = v.view(torch.uint8)

    def b3():
        return stats.masked_stats(d, v, lo, hi)

    def b3p():
        return stats.masked_stats_plain(d, v, lo, hi)

    flo, fhi = stats.clip_f32(lo, hi)

    def library():
        inclip = (v8 != 0) & (d >= flo) & (d <= fhi)
        return torch.where(inclip, d, 0.0).sum(-1), \
            inclip.sum(-1, dtype=torch.int32)

    saved = stats.masked_stats_kernel.launches
    s, c = b3()
    sp, cp = b3p()
    sl, cl = library()
    torch.cuda.synchronize()
    if not (torch.equal(s, sp) and torch.equal(c, cp) and torch.equal(c, cl)):
        raise AssertionError("B3 main-path inputs: kernel != plain")
    err = float((s - sp).abs().max())
    ms = kernel_device_ms(b3, "masked_stats_kernel")
    call = cuda_time_ms(b3)
    pms = cuda_time_ms(b3p, reps=3)
    lms = cuda_time_ms(library, reps=10)
    stats.masked_stats_kernel.launches = saved
    B, N = d.shape
    nbytes = B * N * 4 + B * N + B * 8
    bd = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing B3 ({B}, {N}): device {ms:.5f} ms (per call with host "
        f"{call:.4f}), bound {bd:.5f} ms ({nbytes} bytes, "
        f"{100 * bd / ms:.1f}% of bound), plain {pms:.3f} ms, library "
        f"(where+sum+count) {lms:.4f} ms, library vs kernel sums max "
        f"|diff| {float((sl - s).abs().max()):.3g} ({card})")
    return ms, pms, bd, lms, err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gsky_tpu_torch.ops import cuda_lib, paged, stats, warp_render
    from gsky_tpu_torch.ops.warp import _bilerp_grid
    t_start = time.perf_counter()
    card = card_facts()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    libs = [warp_render.LIBRARY, stats.LIBRARY]
    built = cuda_lib.build_all(libs)       # one nvcc per source, at once
    for lib in libs:
        lib.load()
    log(f"phase 1: built {', '.join(os.path.relpath(b, ROOT) for b in built)}"
        f" in {time.perf_counter() - t0:.2f} s")

    # -- phase 2: kernels vs plain on the card ------------------------
    n_cmp = phase_kernels()
    if paged.paged_render_kernel.launches == 0 or \
            warp_render.warp_render_kernel.launches == 0:
        raise AssertionError("phase 2 launched no kernel")
    log(f"phase 2: {n_cmp} kernel-vs-plain comparisons passed")

    # -- phase 3: end to end at real size -----------------------------
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    data_root = os.path.join(ROOT, "build", "smoke_archive")
    shutil.rmtree(data_root, ignore_errors=True)
    os.makedirs(data_root)
    try:
        t0 = time.perf_counter()
        paths = write_archive(data_root)
        store = MASStore()
        for p in paths:
            rec = extract(p)
            if rec.get("error"):
                raise AssertionError(rec["error"])
            for ds in rec["geo_metadata"]:
                ds["namespace"] = NS
            store.ingest(rec)
        log(f"phase 3: archive written + crawled in "
            f"{time.perf_counter() - t0:.1f} s")
        boxes = tile_boxes()
        pipe = make_pipeline(store, "cuda")
        # warm the scene cache (decode + upload of the 4 scenes) outside
        # the timed window: it is set-up, not tile latency
        t0 = time.perf_counter()
        render(pipe, data_root, boxes[:1], "near")
        log(f"phase 3: scene cache warm in {time.perf_counter() - t0:.1f} s")
        plain = PlainCalls()
        paged.paged_render_kernel.launches = 0
        warp_render.warp_render_kernel.launches = 0
        stats.masked_stats_kernel.launches = 0
        card_tiles, lat = {}, []
        t0 = time.perf_counter()
        for method in METHODS:
            card_tiles[method], secs = render(pipe, data_root, boxes, method)
            lat += secs
        wall = time.perf_counter() - t0
        b1_launches = paged.paged_render_kernel.launches
        b2_main = warp_render.warp_render_kernel.launches
        plain.remove()
        n_main = N_TILES * len(METHODS)
        if b1_launches != n_main or b2_main != 0 or plain.calls \
                or stats.masked_stats_kernel.launches:
            raise AssertionError(
                f"main path: B1 {b1_launches} (want {n_main}), B2 "
                f"{b2_main}, B3 {stats.masked_stats_kernel.launches}, "
                f"plain calls {plain.calls}")
        p50 = float(np.median(lat)) * 1e3
        log(f"phase 3: {n_main} tiles, {n_main / wall:.1f} tiles/s, p50 "
            f"{p50:.2f} ms, p90 {np.percentile(lat, 90) * 1e3:.2f} ms "
            f"({card}); pool {pipe.executor.pool.stats()}")

        spans, wall_ms, dev_ms, b1_ms = stage_breakdown(
            pipe, data_root, boxes, "bilinear")
        paged.paged_render_kernel.launches = b1_launches
        log("phase 3 breakdown, bilinear, ms per tile: " + ", ".join(
            f"{k} {v:.4f}" for k, v in spans.items()) +
            f"; wall {wall_ms:.4f}; device busy {dev_ms:.5f} "
            f"({100 * dev_ms / wall_ms:.2f}% of wall), of which B1 "
            f"{b1_ms:.5f} ({card})")

        # -- phase 4: the decline leg through B2 ------------------------
        plain = PlainCalls()
        os.environ["GSKY_PAGE_SLOTS"] = "1"
        warp_render.warp_render_kernel.launches = 0
        paged.paged_render_kernel.launches = 0
        decl = {}
        try:
            for method in METHODS:
                decl[method], _ = render(pipe, data_root, boxes[:2], method)
        finally:
            del os.environ["GSKY_PAGE_SLOTS"]
        b2_launches = warp_render.warp_render_kernel.launches
        plain.remove()
        if b2_launches != 2 * len(METHODS) or plain.calls \
                or paged.paged_render_kernel.launches:
            raise AssertionError(f"decline leg: B2 {b2_launches}, plain "
                                 f"{plain.calls}")
        for method in METHODS:
            compare_tiles(method, card_tiles[method][:2], decl[method],
                          "B2 vs B1")
        log(f"phase 4: {b2_launches} tiles through B2, bytes match B1")

        # -- phase 5: card vs CPU ---------------------------------------
        cpu = make_pipeline(store, "cpu")
        t0 = time.perf_counter()
        for method in METHODS:
            got, _ = render(cpu, data_root, boxes[:2], method)
            compare_tiles(method, card_tiles[method][:2], got, "card vs cpu")
        log(f"phase 5: CPU tiles match the card "
            f"({time.perf_counter() - t0:.1f} s)")
        del cpu

        # -- kernel timing at the main path's shapes --------------------
        ex = pipe.executor
        from gsky_tpu_torch.pipeline.tile import ns_prio
        from gsky_tpu_torch.geo.crs import parse_crs
        from gsky_tpu_torch.geo.transform import BBox, GeoTransform
        box = boxes[0]
        dst_gt = GeoTransform.from_bbox(BBox(*box), 256, 256)
        merc = parse_crs("EPSG:3857")
        from gsky_tpu_torch.pipeline.types import GeoTileRequest
        req = GeoTileRequest(collection=data_root, bands=[NS],
                             bbox=BBox(*box), crs=merc)
        granules = pipe.index(req)
        _, ns_ids, prio = ns_prio(granules)
        group = ex._scene_groups(granules, ns_ids, prio, dst_gt, merc,
                                 256, 256)[0]
        tables, p16, _ = ex._paged_from_group(group)
        ex.pool.unpin(tables)
        dev = torch.device("cuda")
        tab_d = torch.from_numpy(tables[None]).to(dev)
        p16_d = torch.from_numpy(p16).to(dev)
        sx = _bilerp_grid(group.ctrl_dev[0], 256, 256, group.step)[None] \
            .contiguous()
        sy = _bilerp_grid(group.ctrl_dev[1], 256, 256, group.step)[None] \
            .contiguous()
        stack = ex._stack(group)
        p16s = torch.zeros_like(p16_d)
        p16s[:, :11] = p16_d[:, :11]
        rows = []
        for method in METHODS:
            with ex.pool.locked_pool() as parr:
                def b1():
                    return paged.paged_render_scored(
                        parr, tab_d, p16_d, sx, sy, method, 1)

                def b1p():
                    return paged.paged_render_scored_plain(
                        parr, tab_d, p16_d, sx, sy, method, 1)
                ck, bk = b1()
                cp, bp = b1p()
                err1 = check_pair(method, ck, bk, cp, bp, f"B1 main {method}")
                saved = paged.paged_render_kernel.launches
                ms1 = kernel_device_ms(b1, "paged_render")
                call1, pms1 = cuda_time_ms(b1), cuda_time_ms(b1p, reps=3)
                paged.paged_render_kernel.launches = saved

            def b2():
                return warp_render.warp_render_scored(stack, sx[0], sy[0],
                                                      p16s, method, 1)

            def b2p():
                return warp_render.warp_render_scored_plain(
                    stack, sx[0], sy[0], p16s, method, 1)
            ck, bk = b2()
            cp, bp = b2p()
            err2 = check_pair(method, ck, bk, cp, bp, f"B2 main {method}")
            saved = warp_render.warp_render_kernel.launches
            ms2 = kernel_device_ms(b2, "warp_render")
            call2, pms2 = cuda_time_ms(b2), cuda_time_ms(b2p, reps=3)
            warp_render.warp_render_kernel.launches = saved
            by2 = bound_bytes(sx, sy, p16s, method, 1)
            by1 = by2 + tables.nbytes
            bd1, bd2 = (by / HBM_BYTES_PER_S * 1e3 for by in (by1, by2))
            rows.append((method, err1, ms1, pms1, bd1, err2, ms2, pms2, bd2))
            log(f"timing {method}: B1 device {ms1:.5f} ms (per call with "
                f"host {call1:.4f}, plain {pms1:.3f}), bound {bd1:.5f} ms; "
                f"B2 device {ms2:.5f} ms (per call with host {call2:.4f}, "
                f"plain {pms2:.3f}), bound {bd2:.5f} ms; bound bytes "
                f"{by1} / {by2} [T={tables.shape[0]} S={tables.shape[1]}] "
                f"({card})")
    finally:
        shutil.rmtree(data_root, ignore_errors=True)

    # -- phases 6-8: the drill and kernel B3 -------------------------
    n_b3, b3_err = phase_b3_kernel()
    log(f"phase 6: {n_b3} B3-vs-plain comparisons bit-exact")
    drill_root = os.path.join(ROOT, "build", "smoke_drill")
    shutil.rmtree(drill_root, ignore_errors=True)
    os.makedirs(drill_root)
    try:
        b3_launches, b3_args = phase_drill(drill_root, card)
        b3_row = time_b3(b3_args, card)
    finally:
        shutil.rmtree(drill_root, ignore_errors=True)

    # the kernels line reports the bilinear row (the GetMap default
    # interpolated method); every method's numbers are logged above
    m, err1, ms1, pms1, bd1, err2, ms2, pms2, bd2 = rows[1]
    b3_ms, b3_pms, b3_bd, b3_lib, b3_main_err = b3_row
    kernels = {"kernels": [
        {"name": "paged_render (B1)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/warp_render.cu",
         "replaces": "gsky_tpu/ops/paged.py:173",
         "launches": b1_launches,
         "max_abs_err": max(r[1] for r in rows),
         "ms": ms1, "plain_ms": pms1, "bound_ms": bd1,
         "bound_by": "bytes", "library_ms": None},
        {"name": "warp_render (B2)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/warp_render.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:456",
         "launches": b2_launches,
         "max_abs_err": max(r[5] for r in rows),
         "ms": ms2, "plain_ms": pms2, "bound_ms": bd2,
         "bound_by": "bytes", "library_ms": None},
        {"name": "masked_stats (B3)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/masked_stats.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:362",
         "launches": b3_launches,
         "max_abs_err": max(b3_err, b3_main_err),
         "ms": b3_ms, "plain_ms": b3_pms, "bound_ms": b3_bd,
         "bound_by": "bytes", "library_ms": b3_lib},
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
