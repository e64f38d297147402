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
5. card vs CPU: tiles again with ``device="cpu"`` (the plain versions).

Then each kernel's device time (torch.profiler) is taken at the main
path's shapes beside its plain version and its memory bound: the bytes
of the source pixels its taps need, read once, plus its other inputs
and outputs.  The last line of standard output is the
JSON result the harness reads; the line before it gives the card's name
and power limit, and a "kernels" JSON line precedes them.
"""

from __future__ import annotations

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
        from gsky_tpu_torch.ops import paged, warp_render
        self.calls = 0
        self._mods = [(paged, "paged_render_scored_plain"),
                      (warp_render, "warp_render_scored_plain")]
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gsky_tpu_torch.ops import paged, warp_render
    from gsky_tpu_torch.ops.warp import _bilerp_grid
    t_start = time.perf_counter()
    card = card_facts()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    lib = warp_render.build_library()
    warp_render._library()
    log(f"phase 1: built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

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
        if b1_launches != n_main or b2_main != 0 or plain.calls:
            raise AssertionError(
                f"main path: B1 {b1_launches} (want {n_main}), B2 "
                f"{b2_main}, plain calls {plain.calls}")
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

    # the kernels line reports the bilinear row (the GetMap default
    # interpolated method); every method's numbers are logged above
    m, err1, ms1, pms1, bd1, err2, ms2, pms2, bd2 = rows[1]
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
