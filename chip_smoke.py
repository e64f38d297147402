#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. card facts and the kernel build (nvcc, from gsky_tpu_torch/csrc);
2. kernels B1 (paged) and B2 (bucketed) against their plain PyTorch
   versions on the card: near/bilinear/cubic, 1 and 2 namespaces, page
   crossings, padding rows (ns -1) and null-page tables, B2 also over 40
   separate scenes (more than its launch carries by value: their
   pointers go in a device table); both at 4 and 8 namespaces with the
   slots filled sparsely, as a fused expression lane fills them
   (bit-exact, every method); then B1 on
   64-slot page windows of 1400 x 1400 scenes: a zoomed-out (3.5 source
   pixels a pixel) tile rotated 30 degrees, whose staged boxes exceed
   the budget in some blocks (the kernel's count of blocks that read the
   pool directly equals `ops.paged.block_boxes`' prediction, > 0), a
   250 x 250 tile whose blocks' boxes cross page rows and columns, and
   a tile at the scene's corner, with boxes clipped at window edges;
3. end to end at real size: four overlapping Landsat-8-size granules
   (7681 x 7821 int16, 30 m, EPSG:32755, nodata -999) written with the
   port's GeoTIFF writer, crawled into the port's MAS store, and 32
   GetMap tiles of 256 x 256 EPSG:3857 per resampling method rendered
   through `TilePipeline(device="cuda").render_composite_byte` — every
   tile through kernel B1, none of its blocks over the staging budget
   (the direct-block count is 0, as `block_boxes` predicts);
4. the decline leg: tiles with GSKY_PAGE_SLOTS=1, served by kernel B2,
   which reads the cached scenes where they lie (the first tile is the
   group's first decline; its latency is logged);
4b. the decline leg as requests reach it: 8 tiles at 2x and 8 at 4x the
   native ground resolution per method at default settings, whose
   windows need more than 8 pages: every one declines to B2 (B2 once a
   tile, B1 never, no plain version); then one tile whose windows need
   17-32 pages, with GSKY_PAGE_SLOTS=32, declined by the reference's
   VMEM gate alone; the device memory peak over phases 4-4b beside
   `torch.stack` of the four scenes, the copy the dense-stack decline
   leg made;
5. card vs CPU: tiles of phases 3 and 4b again with ``device="cpu"``
   (the plain versions);
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
   ``device="cpu"`` (exact and deciles) equals the card's;
9. kernel B4 (the first-valid mosaic) against its plain version on the
   card: T in {1, 2, 3, 8, 9, 13, 128} x (H, W) in {(1, 1), (255, 257),
   (256, 256), (1000, 1000), (2048, 2048)}, valid as bool and as int8,
   with all-invalid pixels, NaN / +-inf / -0.0 in valid layers and
   NaN / inf in invalid ones, and stacks and valid masks viewed at a
   storage offset of one element (views off 16-byte alignment); out
   bit-exact, ok equal;
10. the masked temporal mosaic end to end at Landsat scale: 8
   acquisitions 16 days apart of one path/row (7681 x 7821, EPSG:32755,
   30 m, shifted 0-60 px between dates), each three single-band
   GeoTIFFs (LC08_B4 and LC08_B5 int16 nodata -999, pixel_qa uint16
   nodata 1 with cloud and shadow blobs over 20-40% of each date),
   crawled into the port's MAS store; 32 tiles per request through
   `TilePipeline(device="cuda").process` + `scale_to_byte` with a
   cloud-and-shadow bit-test mask: LC08_B4 near / bilinear / cubic and
   NDVI bilinear, every namespace mosaic through B4 (160 launches at
   T = 8); the masked tiles differ from no-op-mask ones, and the no-op
   nearest tiles agree with the fused `render_composite_byte`;
11. card vs CPU: two tiles per request of phase 10 through
   ``device="cpu"``;
12. the OWS front end over HTTP: the port's `OWSServer(device="cuda")`
   behind the standard library's threaded HTTP server on an ephemeral
   127.0.0.1 port, over a config.json, answering WMS GetMap requests
   (256 x 256 EPSG:3857 image/png) sent with urllib.  12a, over phase
   3's archive: 32 native tiles bilinear, 4 near and 4 cubic (one B1
   launch each), 8 tiles at 4x the native ground resolution (one B2
   each), a palette layer, a tile past the layer's zoom limit (the
   placeholder, no launch), and 8 tiles of a layer over two of phase
   3's granules and two new UTM-56S ones of the same size, which
   `_render_fused` warps as two source-CRS groups (two B2 launches a
   tile); the 32 native tiles again from 4 client threads (the same
   bodies).  12b, over phase 10's archive: the masked LC08_B4 and NDVI
   layers, 8 tiles each through B4.  Every kernel count is set to 0
   before each route and must equal its route's launches after it;
   two tiles per route from a second `OWSServer(device="cpu")` decode
   to the same RGBA (nearest) or within 0.1% of bytes; tiles/s, p50,
   p90 and the share of a request's wall time outside the pipeline
   (parse, encode, socket) are logged per route.
13. wave serving (GSKY_WAVES and the staged path on; phases 3-12 pin
   them off): 13a phase 3's tiles from 16 threads, 13b APNG animations
   over HTTP, 13c concurrent drills (one K-block B3 launch a wave);
14. fused band algebra and the RGB GetMap (BASELINE config 2).  14a, over
   phase 10's archive without a mask band: NDVI and a thresholded
   expression with literals, 32 tiles bilinear each over the two newest
   dates per call, every tile one B1 launch at n_ns 2 or counted as
   declined to the unfused leg; the same tiles with GSKY_EXPR_FUSE=0
   (the modular route) give the same bytes; then from 16 threads in
   waves (bodies equal per call).  14b: two adjacent Sentinel-2
   L2A-shaped MGRS tiles of one UTM zone (B02, B03, B04 each 10980 x
   10980 uint16, nodata 0, 10 m, overlapping by 490 px, with
   overviews) written with the port's writer and crawled; through
   `TilePipeline(device="cuda")`: 16 tiles at 2.5x the ground
   resolution inside one tile (the RGBA rung, no kernel), 16 over the
   overlap (the planes rung, one B2 launch a tile), 8 native tiles (a
   full-size band is over the scene cache's 64 Mpx: the modular route,
   one B2 a tile), bilinear plus 4 near and 4 cubic each, launches
   equal to the prediction.  14c: both over HTTP, with two tiles per
   route from a CPU server (decoded RGBA equal for nearest, <= 0.1%
   otherwise);
15. WCS GetCoverage and DAP4 over HTTP (BASELINE config 4), the port's
   `OWSServer(device="cuda")` with the default serving path (waves on)
   over phase 3's archive: 15a a 4096 x 4096 EPSG:3857 GeoTIFF export
   in 16 tiles of 1024 through the staged export engine, cubic cold
   (the four scenes warmed into a fresh scene cache) and warm, near and
   bilinear, then cubic with GSKY_EXPORT_PIPELINE=0 (tile by tile: the
   decoded body identical); per export the seconds, Mpix/s, the
   engine's stage busy seconds, queue high-water marks, dedup and leg
   counts (every tile paged or declined: a declined tile one B2
   launch); 15b one 1024 x 1024 tile per method at native resolution
   (declined: B2) and at 0.25x (paged: B1), each launch held against
   its plain version on the same inputs; 15c a 1024 x 1024 export in
   256 x 256 tiles per method against a CPU server's (nodata at the
   same pixels, nearest bit-exact, <= 2 ulp otherwise); 15d a 5120 x
   5120 GeoTIFF streamed through `GeoTIFFWriter.write_region` (equal to
   the same request in RAM; no temp file left), a NetCDF body (equal
   to the GeoTIFF's values), a multi-tile DAP4 body streamed chunked
   from the export spool (equal to the in-RAM `encode_dap4` body), an
   auto-sized request (width = height = 0), and, over phase 10's
   archive, a masked layer's export through B4 (the CPU's within rel
   1e-5);
16. WPS Execute (an XML POST) over HTTP on phase 7's resident stack
   (GSKY_WAVES=0, as phase 7): drills/s, p50, B3 launches; the CSV
   equals `drill_csv` of a direct `DrillPipeline.process_split`;
17. the serving gateway and the rest of the WMS surface over HTTP, the
   card server with a private `ServingGateway` (phases 12-16 pass
   ``gateway=None``), GSKY_WAVES=0.  17a over phase 3's archive: 32
   requests for one uncached native tile from 16 threads make one B1
   launch (1 leader, 31 joined or hit; bodies equal the same server's
   without its gateway), a repeat is a hit with no launch, If-None-Match
   a 304; 16 tiles timed as misses (one B1 each) and then as hits (no
   launch); a reload that changes the layer invalidates and the tile
   renders again; JPEG: 16 native tiles through B1 and 8 of a
   three-band style through the planes rung (one B2 each), headers
   parsed (SOF0 size and sampling, the quality-85 DQT), two bodies each
   equal to a CPU server's, and `encode_jpeg` of a 256 x 256 RGB tile
   timed on the host; GetFeatureInfo: 16 clicks through B1, values equal
   the CPU server's (nearest exact, bilinear <= 2 ulp); the legend file,
   a palette legend and DescribeLayer equal the CPU server's.  17b over
   phase 10's archive: 8 clicks on the masked layer, one B4 launch each,
   within 2 ulp of the CPU server's.

Then each kernel's device time (torch.profiler) is taken at the main
path's shapes beside its plain version and its memory bound (B1 and B2
with a warm L2 and again with a 64 MB buffer written before every
launch, as a tile finds its pages cold; B2 at phase 3's native tile and
at a 2x and a 4x tile, the inputs its decline leg gets; an empty
kernel's launch beside them): for B1/B2
the bytes of the source pixels their taps need, read once, plus their
other inputs and outputs (B2 also the 32-byte sectors its taps touch);
for B3 its inputs read once and outputs
written once; for B4 the bytes its early-exit scan needs on those
inputs (the full-read bound is logged beside it), and again at
(128, 2048, 2048) where every pixel scans all layers; B1 again at phase
14a's first NDVI tile (n_ns 2) and B2 at phase 14b's first planes-rung
tile (n_ns 4, six scenes); B1 and B2 at phase 15b's 1024 x 1024 WCS
tile, bilinear and cubic (paged at 0.25x: B1; native, declined: B2),
inside the request at the launch's own inputs.  The last line of
standard output is the JSON result the harness reads; the line before
it gives the card's name and power limit, and a "kernels" JSON line
precedes them.
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
B4_SHAPES_T = (1, 2, 3, 8, 9, 13, 128)
# (T, H, W) at which B4's inputs are also viewed at a storage offset of
# one element
B4_OFFSET_SHAPES = ((8, 256, 256), (13, 255, 257), (9, 1000, 1000))
# phase-2 B1 cases on 64-slot page windows: (name, (h, w), (scale,
# degrees, x0, y0)) of the dst grid over a 1400 x 1400 scene
B1_SCENE = 1400
B1_CASES = (
    ("zoomed-out rotated", (256, 256), (3.5, 30.0, 700.0, 60.0)),
    ("250 x 250 across pages", (250, 250), (1.0, 5.0, 380.0, 60.0)),
    ("scene corner", (256, 256), (1.0, 0.0, -12.0, -6.0)),
)
# B3's K-block form in phase 2: (K, B, N); the last is phase 7's wave
B3_WAVE_K = ((1, 7, 2049), (4, 129, 16384), (16, 3, 262144),
             (64, 2, 4097), (4, 1024, 262144))
L2_FLUSH_BYTES = 64 << 20     # written between launches for a cold L2
# phase 4b: 8 tiles (4 x 2) per method at each of these multiples of the
# native ground resolution; their windows need more than the default 8
# pages, so each declines to B2
ZOOMS = (2.0, 4.0)
# the gate tile (16 < pages <= 32) is the first such among tiles at these
GATE_ZOOMS = (3.0, 3.5)
# B2 is timed at (a) phase 3's first native tile, (b) the first 2x tile
# and (c) the first 4x tile
B2_INPUTS = (("a", None), ("b", 2.0), ("c", 4.0))
# B4 is timed at the first main-path call's inputs and every 16th after
# it: a tile's cloud and nodata set how far its pixels scan
B4_TIMED_EVERY = 16
B4_SHAPES_HW = ((1, 1), (255, 257), (256, 256), (1000, 1000), (2048, 2048))
# the masked temporal mosaic (BASELINE config 3): 8 acquisitions, 16 days
# apart from 2020-01-01, of LC08_B4 / LC08_B5 / pixel_qa
MOSAIC_DATES = 8
MOSAIC_T0 = 1577836800.0                      # 2020-01-01T00:00Z
CLOUD_SHADOW = ["100000", "100000", "1000", "1000"]
NDVI = "ndvi=(LC08_B5-LC08_B4)/(LC08_B5+LC08_B4)"
# (bands, method, scale_to_byte style) per phase-10 request
MOSAIC_REQS = (
    (["LC08_B4"], "near", dict(clip=2000.0)),
    (["LC08_B4"], "bilinear", dict(clip=2000.0)),
    (["LC08_B4"], "cubic", dict(clip=2000.0)),
    ([NDVI], "bilinear", dict(auto=True)),
)


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


def kernel_device_ms(fn, kernel, reps=50, tries=6, between=None):
    """Device time of one launch of ``kernel`` (a __global__ name) per
    call of ``fn``: torch.profiler's CUDA kernel records, so host work
    between launches is not counted.  ``between``, when given, runs
    before every call (its own kernels are filtered out by name).  The
    tracer can drop records (windows saw 9, and 0, of 50 launches), so
    a window that saw fewer than half is taken again, up to ``tries``
    windows; the mean is over the launches of the fullest one.  It
    fails when no window saw a launch or one saw more launches than
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    count, total = 0, 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if kernel in e.key and e.self_device_time_total > 0]
        n = sum(e.count for e in evs)
        if n > reps:
            raise AssertionError(f"profiler saw {n} {kernel} launches "
                                 f"of {reps}")
        if n > count:
            count = n
            total = sum(e.self_device_time_total for e in evs)
        if count >= reps // 2:
            break
        log(f"profiler saw {n} {kernel} launches of {reps}; again")
    if count == 0:
        raise AssertionError(f"profiler saw no {kernel} launch")
    return total / count / 1e3


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


def phase_kernels(dev="cuda"):
    """B1 and B2 against their plain versions on synthetic inputs that
    hit every edge case; returns the number of comparisons."""
    import torch
    from gsky_tpu_torch.ops import paged, warp_render
    from gsky_tpu_torch.ops.warp import _bilerp_grid, params16
    from gsky_tpu_torch.pipeline.pages import PagePool
    dev = torch.device(dev)
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
    # B2 over more scenes than its launch carries by value: separate
    # tensors, their pointers in a device table
    B = warp_render.INLINE_SCENES + 8
    S_px = 300
    scenes = [torch.from_numpy(rng.uniform(-500, 4000, (S_px, S_px))
                               .astype(np.float32)).to(dev) for _ in range(B)]
    for k in range(0, B, 5):
        scenes[k][50 + k:90 + k, 30:200] = float("nan")
    ctrl = np.stack([
        np.linspace(-20, 280, gw, dtype=np.float32)[None, :].repeat(gh, 0),
        np.linspace(-10, 290, gh, dtype=np.float32)[:, None].repeat(gw, 1)])
    params = np.zeros((B, 11), np.float32)
    for k in range(B):
        params[k] = [3.0 * (k % 7) - 9.0, 1.0, 0.0, 2.0 * (k % 5) - 4.0, 0.0,
                     1.0, S_px - k, S_px, -999.0, float(B - k), k % 2]
    p16 = params16(torch.from_numpy(params).to(dev))
    sx, sy = (_bilerp_grid(torch.from_numpy(ctrl).to(dev), h, w, step)
              .contiguous())
    for method in METHODS:
        ck, bk = warp_render.warp_render_scored(scenes, sx, sy, p16, method, 2)
        cp, bp = warp_render.warp_render_scored_plain(scenes, sx, sy, p16,
                                                      method, 2)
        check_pair(method, ck, bk, cp, bp, f"B2 {method} over {B} scenes")
        n += 1
    return n


# phase 2 at the namespace counts fused band algebra and RGB styles
# reach: (n_ns, the slot of each of 8 granules).  An expression lane
# fills one slot per variable, several granules a slot, and leaves its
# pow2 padding empty: 3 variables at n_ns 4, 6 at n_ns 8
WIDE_NS = ((4, (0, 2, 1, 0, 2, 1, 0, 2)),
           (8, (0, 5, 1, 4, 2, 0, 3, 5)))


def check_exact(what, ck, bk, cp, bp):
    """Kernel vs plain, canvases and best bit-exact (every method)."""
    import torch
    if not (torch.equal(bk, bp) and torch.equal(ck, cp)):
        raise AssertionError(f"{what}: not bit-exact")
    return float((ck - cp).abs().max())


def phase_wide_ns(dev="cuda"):
    """B1 and B2 at n_ns 4 and 8 (`WIDE_NS`) against their plain
    versions, bit-exact for every method: 8 granules of 700 x 700 (NaN
    and nodata patches), B1 over their whole-scene page windows; the
    padding slots stay empty.  Returns (comparisons, max |difference|)."""
    import torch
    from gsky_tpu_torch.ops import paged, warp_render
    from gsky_tpu_torch.ops.warp import _bilerp_grid, params16
    from gsky_tpu_torch.pipeline.pages import PagePool
    dev = torch.device(dev)
    rng = np.random.default_rng(2)
    S_px, h, w, step, B = 700, 256, 256, 16, 8
    stack = rng.uniform(-500, 4000, (B, S_px, S_px)).astype(np.float32)
    for k in range(B):
        stack[k, 60 * k:60 * k + 50, 100:300] = np.nan
        stack[k, 400:460, 50 * k:50 * k + 120] = -999.0
    gh = gw = (h - 1 + step - 1) // step + 1
    ctrl = np.stack([
        np.linspace(20, 560, gw, dtype=np.float32)[None, :].repeat(gh, 0),
        np.linspace(30, 600, gh, dtype=np.float32)[:, None].repeat(gw, 1)])
    stack_d = torch.from_numpy(stack).to(dev)
    ctrl_d = torch.from_numpy(ctrl).to(dev)
    sx = _bilerp_grid(ctrl_d[0], h, w, step).contiguous()
    sy = _bilerp_grid(ctrl_d[1], h, w, step).contiguous()
    pr, pc = 128, 512
    ni, nj = -(-S_px // pr), -(-S_px // pc)
    pool = PagePool(capacity=B * ni * nj + 1, page_rows=pr, page_cols=pc,
                    device=dev)
    tables = np.zeros((B, 16), np.int32)
    for k in range(B):
        t = pool.table_for(stack_d[k], 4000 + k, 0, ni - 1, 0, nj - 1)
        tables[k, :t.size] = t
    tab_d = torch.from_numpy(tables[None]).to(dev)
    n, err = 0, 0.0
    for n_ns, slots in WIDE_NS:
        params = np.zeros((B, 11), np.float32)
        for k in range(B):
            params[k] = [0.4 * k - 1.0, 1.01, 0.02, 0.3 * k - 1.0, -0.01,
                         0.99, S_px, S_px, -999.0, 100.0 - k, slots[k]]
        p16 = params16(torch.from_numpy(params).to(dev))
        p16b = p16.clone()
        p16b[:, 13], p16b[:, 14], p16b[:, 15] = ni * pr, nj * pc, nj
        empty = sorted(set(range(n_ns)) - set(slots))
        for method in METHODS:
            with pool.locked_pool() as parr:
                ck, bk = paged.paged_render_scored(
                    parr, tab_d, p16b.contiguous(), sx[None].contiguous(),
                    sy[None].contiguous(), method, n_ns)
                cp, bp = paged.paged_render_scored_plain(
                    parr, tab_d, p16b, sx[None], sy[None], method, n_ns)
            err = max(err, check_exact(f"B1 {method} n_ns={n_ns}", ck, bk,
                                       cp, bp))
            if not bool(torch.isneginf(bk[0, empty]).all()) or not all(
                    bool((bk[0, m] > float("-inf")).any())
                    for m in set(slots)):
                raise AssertionError(f"B1 n_ns={n_ns}: slots filled wrong")
            b1_best = bk[0]
            ck, bk = warp_render.warp_render_scored(stack_d, sx, sy, p16,
                                                    method, n_ns)
            cp, bp = warp_render.warp_render_scored_plain(
                stack_d, sx, sy, p16, method, n_ns)
            err = max(err, check_exact(f"B2 {method} n_ns={n_ns}", ck, bk,
                                       cp, bp))
            if not torch.equal(bk, b1_best):
                raise AssertionError(f"B2 n_ns={n_ns}: its winners differ "
                                     f"from B1's")
            n += 2
    return n, err


def b1_grid(h, w, scale, degrees, x0, y0, dev):
    """sx/sy (1, h, w) f32 on ``dev``: a dst grid rotated by ``degrees``
    and zoomed out by ``scale`` source pixels a pixel, from (x0, y0)."""
    import torch
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) + 0.5
    a = np.radians(degrees)
    sx = x0 + scale * (np.cos(a) * xx - np.sin(a) * yy)
    sy = y0 + scale * (np.sin(a) * xx + np.cos(a) * yy)
    return tuple(torch.from_numpy(v.astype(np.float32)[None]).to(dev)
                 for v in (sx, sy))


def predicted_direct_blocks(sx, sy, params, method):
    """`block_boxes`' count of B1 blocks that read the pool directly,
    over N tiles: sx/sy (N, h, w), params (N*T, 16)."""
    from gsky_tpu_torch.ops.paged import block_boxes
    T = params.shape[0] // sx.shape[0]
    total = 0
    for n in range(sx.shape[0]):
        _, fits = block_boxes(sx[n], sy[n], params[n * T:(n + 1) * T],
                              method)
        total += int((~fits).any(-1).sum())
    return total


def phase_b1_cases(dev="cuda"):
    """B1 against its plain version on 64-slot page windows of three
    1400 x 1400 scenes plus a padding row (`B1_CASES`): granule 0 a
    whole-scene window, granule 1 a window of page rows 2-7 and columns
    1-2 with an offset affine (boxes clip at its edges), granule 2 a
    narrower true extent.  Per call the kernel's direct-block count must
    equal `block_boxes`' prediction.  Returns (comparisons, direct
    blocks counted, direct blocks predicted); the zoomed-out case must
    give a count > 0."""
    import torch
    from gsky_tpu_torch.ops import paged
    from gsky_tpu_torch.pipeline.pages import PagePool
    dev = torch.device(dev)
    rng = np.random.default_rng(11)
    S_px, pr, pc, slots = B1_SCENE, 128, 512, 64
    ni, nj = -(-S_px // pr), -(-S_px // pc)
    pool = PagePool(capacity=3 * ni * nj + 1, page_rows=pr, page_cols=pc,
                    device=dev)
    tables = np.zeros((4, slots), np.int32)
    p16 = np.zeros((4, 16), np.float32)
    windows = ((0, ni - 1, 0, nj - 1), (2, 7, 1, 2), (0, ni - 1, 0, nj - 1))
    for k, (i0, i1, j0, j1) in enumerate(windows):
        scene = rng.uniform(-500, 4000, (S_px, S_px)).astype(np.float32)
        scene[200 + 90 * k:260 + 90 * k, 300:420] = np.nan
        scene[900:1000, 100 + 200 * k:300 + 200 * k] = -999.0
        t = pool.table_for(torch.from_numpy(scene).to(dev), 2000 + k,
                           i0, i1, j0, j1)
        tables[k, :t.size] = t
        p16[k] = [0.0, 1.0, 0.0, 0.0, 0.0, 1.0, S_px, S_px, -999.0,
                  100.0 - k, k % 2, i0 * pr, j0 * pc, (i1 - i0 + 1) * pr,
                  (j1 - j0 + 1) * pc, j1 - j0 + 1]
    p16[1, [0, 3]] = (3.25, -2.5)
    p16[2, [6, 7]] = (1100.0, 900.0)
    p16[3, 10] = -1.0                         # padding row, zero window
    tab_d = torch.from_numpy(tables[None]).to(dev)
    n = counted = predicted = 0
    for name, (h, w), grid in B1_CASES:
        sx, sy = b1_grid(h, w, *grid, dev)
        for n_ns in (1, 2):
            prm = torch.from_numpy(p16).to(dev)
            if n_ns == 1:
                prm[:3, 10] = 0.0
            for method in METHODS:
                want = predicted_direct_blocks(sx, sy, prm, method)
                paged.reset_direct_blocks(dev)
                with pool.locked_pool() as parr:
                    ck, bk = paged.paged_render_scored(
                        parr, tab_d, prm, sx, sy, method, n_ns)
                    cp, bp = paged.paged_render_scored_plain(
                        parr, tab_d, prm, sx, sy, method, n_ns)
                got = paged.direct_blocks(dev)
                check_pair(method, ck, bk, cp, bp,
                           f"B1 {name} {method} n_ns={n_ns}")
                if got != want:
                    raise AssertionError(
                        f"B1 {name} {method}: {got} blocks read the pool "
                        f"directly, block_boxes predicts {want}")
                if name.startswith("zoomed") and not want:
                    raise AssertionError(f"B1 {name}: no box over budget")
                if not bool((bk > float("-inf")).any()):
                    raise AssertionError(f"B1 {name}: nothing rendered")
                counted += got
                predicted += want
                n += 1
    return n, counted, predicted


def phase_wave_kernels(dev="cuda"):
    """The wave forms of B1 and B3 against their plain versions on the
    card.  B1 with ``sb_of``: three 1400 x 1400 scenes behind two
    superblock rows of 64-slot union windows, eight lanes (four per row,
    each its own grid and its params' window set to its row's union, as
    `pipeline.autoplan` writes them); per lane the canvases equal the
    lane rendered alone from its row without ``sb_of``, and the
    direct-block count equals `block_boxes`' prediction.  B3's K-block
    form at K in `B3_WAVE_K`: sums and counts bit-exact against its
    plain version and against one per-call launch per block.  Returns
    (comparisons, max |B3 sum difference|)."""
    import torch
    from gsky_tpu_torch.ops import paged, stats
    from gsky_tpu_torch.pipeline.pages import PagePool
    dev = torch.device(dev)
    rng = np.random.default_rng(13)
    S_px, pr, pc, slots = B1_SCENE, 128, 512, 64
    ni, nj = -(-S_px // pr), -(-S_px // pc)
    pool = PagePool(capacity=3 * ni * nj + 1, page_rows=pr, page_cols=pc,
                    device=dev)
    tabs = []
    for k in range(3):
        scene = rng.uniform(-500, 4000, (S_px, S_px)).astype(np.float32)
        scene[150 + 80 * k:220 + 80 * k, 250:400] = np.nan
        scene[800:900, 100 + 150 * k:260 + 150 * k] = -999.0
        tabs.append(pool.table_for(torch.from_numpy(scene).to(dev),
                                   3000 + k, 0, ni - 1, 0, nj - 1))
    # row 0: granules 0, 1 over their whole grids; row 1: granules 1, 2
    # over page rows 1-8 and columns 0-1, granule 0 a padding row
    rows = (((0, ni - 1, 0, nj - 1), (0, ni - 1, 0, nj - 1), None),
            (None, (1, 8, 0, 1), (1, 8, 0, 1)))
    G, T = 2, 3
    tables = np.zeros((G, T, slots), np.int32)
    lanes = 8
    sb_of = np.array([0, 1] * (lanes // 2), np.int32)
    p16 = np.zeros((lanes, T, 16), np.float32)
    for g, row in enumerate(rows):
        for t, win in enumerate(row):
            if win is None:
                continue
            i0, i1, j0, j1 = win
            full = tabs[t].reshape(ni, nj)
            sub = full[i0:i1 + 1, j0:j1 + 1].reshape(-1)
            tables[g, t, :sub.size] = sub
    for n in range(lanes):
        for t, win in enumerate(rows[sb_of[n]]):
            if win is None:
                p16[n, t, 10] = -1.0
                continue
            i0, i1, j0, j1 = win
            p16[n, t] = [0.25 * n, 1.0, 0.0, -0.5 * n, 0.0, 1.0, S_px,
                         S_px, -999.0, 100.0 - t, t % 2, i0 * pr, j0 * pc,
                         (i1 - i0 + 1) * pr, (j1 - j0 + 1) * pc,
                         j1 - j0 + 1]
    grids = [b1_grid(256, 256, *([1.0, 0.0] if n % 4 else [2.0, 20.0]),
                     200.0 + 37.0 * n, 150.0 + 53.0 * n, dev)
             for n in range(lanes)]
    sx = torch.cat([g[0] for g in grids]).contiguous()
    sy = torch.cat([g[1] for g in grids]).contiguous()
    tab_d = torch.from_numpy(tables).to(dev)
    sb_d = torch.from_numpy(sb_of).to(dev)
    n_cmp = 0
    for n_ns in (1, 2):
        prm = torch.from_numpy(p16.reshape(lanes * T, 16)).to(dev)
        if n_ns == 1:
            prm[:, 10] = torch.where(prm[:, 10] >= 0, 0.0, -1.0)
        for method in METHODS:
            want = predicted_direct_blocks(sx, sy, prm, method)
            paged.reset_direct_blocks(dev)
            with pool.locked_pool() as parr:
                ck, bk = paged.paged_render_scored(
                    parr, tab_d, prm, sx, sy, method, n_ns, sb_d)
                cp, bp = paged.paged_render_scored_plain(
                    parr, tab_d, prm, sx, sy, method, n_ns, sb_d)
                saved = paged.paged_render_kernel.launches
                alone = [paged.paged_render_scored(
                    parr, tab_d[sb_of[n]][None].contiguous(),
                    prm[n * T:(n + 1) * T].contiguous(),
                    sx[n:n + 1].contiguous(), sy[n:n + 1].contiguous(),
                    method, n_ns) for n in range(lanes)]
                paged.paged_render_kernel.launches = saved
            got = paged.direct_blocks(dev)
            check_pair(method, ck, bk, cp, bp,
                       f"B1 sb_of {method} n_ns={n_ns}")
            for n, (ca, ba) in enumerate(alone):
                if not (torch.equal(ca[0], ck[n])
                        and torch.equal(ba[0], bk[n])):
                    raise AssertionError(f"B1 sb_of {method}: lane {n} "
                                         f"differs from its launch alone")
            if got != want:
                raise AssertionError(f"B1 sb_of {method}: {got} direct "
                                     f"blocks, block_boxes predicts {want}")
            if not bool((bk > float("-inf")).any()):
                raise AssertionError("B1 sb_of: nothing rendered")
            n_cmp += 1 + lanes
    del pool
    err = 0.0
    saved = (stats.masked_stats_kernel.launches,
             stats.masked_stats_many_kernel.launches)
    for K, B, N in B3_WAVE_K:
        blocks = [b3_edge_inputs(B, N, seed=1000 * K + k) for k in range(K)]
        datas = [d for d, _ in blocks]
        valids = [v for _, v in blocks]
        s, c = stats.masked_stats_many(datas, valids, -80.0, 120.0)
        if B * N * K <= (1 << 28):
            sp, cp = stats.masked_stats_many_plain(datas, valids, -80.0,
                                                   120.0)
        else:       # the plain version's stack would not fit: per block
            parts = [stats.masked_stats_plain(d, v, -80.0, 120.0)
                     for d, v in blocks]
            sp = torch.stack([a for a, _ in parts])
            cp = torch.stack([b for _, b in parts])
        one = [stats.masked_stats(d, v, -80.0, 120.0) for d, v in blocks]
        torch.cuda.synchronize()
        if not (torch.equal(c, cp) and torch.equal(s, sp)):
            raise AssertionError(f"B3 K-block ({K}, {B}, {N}) differs from "
                                 f"its plain version")
        for k, (s1, c1) in enumerate(one):
            if not (torch.equal(s[k], s1) and torch.equal(c[k], c1)):
                raise AssertionError(f"B3 K-block ({K}, {B}, {N}): block "
                                     f"{k} differs from its own launch")
        err = max(err, float((s - sp).abs().max()))
        n_cmp += 2
        del blocks, datas, valids
    (stats.masked_stats_kernel.launches,
     stats.masked_stats_many_kernel.launches) = saved
    return n_cmp, err


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


def tile_boxes(x0=500000.0 + 9000.0 + 12000.0,
               y0=6200000.0 - 9000.0 - 12000.0, zoom=1.0, nx=8, ny=4):
    """nx x ny 256-px EPSG:3857 tiles (32 by default) at ``zoom`` times
    the native ground resolution from the UTM point (x0, y0) east and
    south; by default native, over the phase-3 overlap, starting at the
    newest scene's nodata corner."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox, transform_bbox
    utm = parse_crs("EPSG:32755")
    merc = parse_crs("EPSG:3857")
    c = transform_bbox(BBox(x0, y0, x0 + 1, y0 + 1), utm, merc)
    lat = np.degrees(np.arctan(np.sinh(c.ymin / 6378137.0)))
    res = 30.0 * zoom / np.cos(np.radians(lat))  # 30 m x zoom on the ground
    size = 256 * res
    return [(c.xmin + i * size, c.ymin - (j + 1) * size,
             c.xmin + (i + 1) * size, c.ymin - j * size)
            for j in range(ny) for i in range(nx)]


def zoom_boxes(zoom):
    """Phase 4b's 8 tiles at ``zoom`` x the native ground resolution."""
    return tile_boxes(zoom=zoom, nx=4, ny=2)


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


def tile_group(pipe, root, box):
    """The scene group the fused route builds for the 256-px tile
    ``box``."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox, GeoTransform
    from gsky_tpu_torch.pipeline.tile import ns_prio
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    dst_gt = GeoTransform.from_bbox(BBox(*box), 256, 256)
    merc = parse_crs("EPSG:3857")
    req = GeoTileRequest(collection=root, bands=[NS], bbox=BBox(*box),
                         crs=merc)
    granules = pipe.index(req)
    _, ns_ids, prio = ns_prio(granules)
    return pipe.executor._scene_groups(granules, ns_ids, prio, dst_gt, merc,
                                       256, 256)[0]


def main_operands(pipe, root, box):
    """B1's operands as the fused route builds them for the tile ``box``
    of phase 3: host page tables, then tables, params, sx and sy (N = 1)
    on the pipeline's device."""
    import torch
    from gsky_tpu_torch.ops.warp import _bilerp_grid
    ex = pipe.executor
    group = tile_group(pipe, root, box)
    tables, p16, _ = ex._paged_from_group(group, 1)
    ex.pool.unpin(tables)
    dev = ex.device
    tab_d = torch.from_numpy(tables[None]).to(dev)
    p16_d = torch.from_numpy(p16).to(dev)
    sx, sy = _bilerp_grid(group.ctrl_dev[:, None], 256, 256, group.step)
    return tables, tab_d, p16_d, sx.contiguous(), sy.contiguous()


def b2_operands(pipe, root, box):
    """B2's operands as the decline leg builds them for the tile ``box``:
    the group's cached scenes (read where they lie), params (B, 16)
    without padding rows, sx and sy (256, 256)."""
    import torch
    from gsky_tpu_torch.ops.warp import _bilerp_grid, params16
    group = tile_group(pipe, root, box)
    n = len(group.scenes)
    p16 = params16(torch.from_numpy(group.params[:n].astype(np.float32))
                   .to(pipe.executor.device))
    sx, sy = _bilerp_grid(group.ctrl_dev, 256, 256, group.step)
    return [s.dev for s in group.scenes], p16, sx.contiguous(), \
        sy.contiguous()


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


class CaptureB1:
    """Keeps every B1 call's (sx, sy, params, method) while installed
    (with ``full``, its whole argument list); the wrapper it calls counts
    launches as always."""

    def __init__(self, full=False):
        from gsky_tpu_torch.ops import paged
        self.mod = paged
        self.orig = paged.paged_render_scored
        self.full = full
        self.args = []
        paged.paged_render_scored = self._call

    def _call(self, pool, tables, params, sx, sy, method, n_ns, sb_of=None):
        self.args.append((pool, tables, params, sx, sy, method, n_ns, sb_of)
                         if self.full else (sx, sy, params, method))
        return self.orig(pool, tables, params, sx, sy, method, n_ns, sb_of)

    def remove(self):
        self.mod.paged_render_scored = self.orig


class PlainCalls:
    """Counts calls of the kernels' plain versions while installed."""

    def __init__(self):
        from gsky_tpu_torch.ops import (first_valid, mosaic, paged, stats,
                                        warp_render)
        self.calls = 0
        self._mods = [(paged, "paged_render_scored_plain"),
                      (warp_render, "warp_render_scored_plain"),
                      (stats, "masked_stats_plain"),
                      (first_valid, "mosaic_first_valid_plain"),
                      (mosaic, "mosaic_first_valid")]
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


def granule_taps(sx, sy, p, method):
    """One granule's taps that a kernel must read: (rows, cols) int64 of
    every tap of a finite, in-extent coordinate that lands inside the
    scene's true (H, W) extent (nodata pixels included, padding not).
    sx/sy (h, w), p a 16-wide params row."""
    import torch
    from gsky_tpu_torch.ops.warp import NEAR, fma
    offs = (0,) if method in NEAR else \
        ((0, 1) if method == "bilinear" else (-1, 0, 1, 2))
    H, W = int(p[6]), int(p[7])
    cols = fma(p[2], sy, fma(p[1], sx, p[0])) - 0.5
    rows = fma(p[5], sy, fma(p[4], sx, p[3])) - 0.5
    ok = torch.isfinite(rows) & torch.isfinite(cols) \
        & (rows >= -0.5) & (rows <= H - 0.5) \
        & (cols >= -0.5) & (cols <= W - 0.5)
    shift = 0.5 if method in NEAR else 0.0
    r0 = torch.floor(torch.where(ok, rows, 0.0) + shift).long()
    c0 = torch.floor(torch.where(ok, cols, 0.0) + shift).long()
    rs, cs = [], []
    for dr in offs:
        for dc in offs:
            ri, ci = r0 + dr, c0 + dc
            m = ok & (ri >= 0) & (ri < H) & (ci >= 0) & (ci < W)
            rs.append(ri[m])
            cs.append(ci[m])
    return torch.cat(rs), torch.cat(cs)


def tap_footprint_px(sx, sy, params, method):
    """Distinct source pixels one call's taps need, over its granules
    (what the kernels must read).  sx/sy (h, w), params (B, 16) with the
    window origin in slots 11/12."""
    total = 0
    for p in params:
        if float(p[10]) < 0:
            continue                          # padding row
        ri, ci = granule_taps(sx, sy, p, method)
        total += int((ri * int(p[7]) + ci).unique().numel())
    return total


def tap_sectors(sx, sy, params, method, scenes):
    """Distinct 32-byte sectors of device memory B2's taps touch, reading
    granule t from ``scenes[t]`` (each (WR, WC) f32 where it lies): at
    zoom-out a warp's taps fall in separate sectors, so this is the floor
    a gather can reach."""
    total = 0
    for p, scene in zip(params, scenes):
        if float(p[10]) < 0:
            continue
        ri, ci = granule_taps(sx, sy, p, method)
        addr = scene.data_ptr() + 4 * (ri * scene.shape[1] + ci)
        total += int((addr // 32).unique().numel())
    return total


def other_bytes(sx, params, n_ns):
    """The bytes of a warp-render call besides its taps: sx/sy and params
    read, canv/best written."""
    h, w = sx.shape[-2:]
    return 2 * h * w * 4 + 2 * n_ns * h * w * 4 + params.numel() * 4


def bound_bytes(sx, sy, params, method, n_ns, extra=0):
    """Least bytes one call moves: the taps' source pixels read once,
    plus the other operands (`other_bytes`) and ``extra`` (B1's page
    tables)."""
    h, w = sx.shape[-2:]
    px = tap_footprint_px(sx.reshape(h, w), sy.reshape(h, w), params,
                          method)
    return px * 4 + other_bytes(sx, params, n_ns) + extra


def phase_zoomed(pipe, root):
    """Phase 4b: `zoom_boxes` at each of `ZOOMS` per method through the
    fused route at default settings.  Every tile declines (its windows
    need more than `page_slots()` pages) and goes to B2: B2 launches once
    a tile, B1 never, no plain version runs, the gate declines none.
    Returns ({(zoom, method): host tiles}, per-tile seconds, B2
    launches)."""
    from gsky_tpu_torch.ops import paged, warp_render
    ex = pipe.executor
    for zoom in ZOOMS:                    # scenes cached, handles open
        render(pipe, root, zoom_boxes(zoom)[:1], "near")
    declined, gated = ex.paged_declined, ex.paged_gated
    plain = PlainCalls()
    warp_render.warp_render_kernel.launches = 0
    paged.paged_render_kernel.launches = 0
    tiles, lat = {}, []
    try:
        for zoom in ZOOMS:
            for method in METHODS:
                tiles[(zoom, method)], secs = render(pipe, root,
                                                     zoom_boxes(zoom), method)
                lat += secs
    finally:
        plain.remove()
    n = len(tiles) * len(zoom_boxes(ZOOMS[0]))
    got = (ex.paged_declined - declined, ex.paged_gated - gated,
           warp_render.warp_render_kernel.launches,
           paged.paged_render_kernel.launches, plain.calls)
    if got != (n, 0, n, 0, 0):
        raise AssertionError(f"phase 4b over {n} tiles: declined, gated, "
                             f"B2, B1, plain calls {got}")
    return tiles, lat, n


def phase_gate(pipe, root):
    """A tile whose windows need 17 to 32 pages, with GSKY_PAGE_SLOTS=32:
    no window exceeds the slots, the page list pads to 32 slots, and the
    reference's VMEM gate (`ops.paged.paged_vmem_ok`) alone declines it
    to B2.  Returns the pages its largest window needs."""
    from gsky_tpu_torch.ops import paged, warp_render
    ex = pipe.executor
    for box in (b for z in GATE_ZOOMS for b in tile_boxes(zoom=z, nx=4,
                                                          ny=2)):
        made = ex.page_spans(tile_group(pipe, root, box), paged.MAX_SLOTS)
        if made is not None and 16 < made[1] <= 32:
            break
    else:
        raise AssertionError("no tile with windows of 17 to 32 pages")
    before = (ex.paged_declined, ex.paged_gated,
              warp_render.warp_render_kernel.launches,
              paged.paged_render_kernel.launches)
    os.environ["GSKY_PAGE_SLOTS"] = "32"
    try:
        render(pipe, root, [box], "bilinear")
    finally:
        del os.environ["GSKY_PAGE_SLOTS"]
    after = (ex.paged_declined, ex.paged_gated,
             warp_render.warp_render_kernel.launches,
             paged.paged_render_kernel.launches)
    if tuple(b - a for a, b in zip(before, after)) != (1, 1, 1, 0):
        raise AssertionError(f"gate tile: declined, gated, B2, B1 went "
                             f"from {before} to {after}")
    return made[1]


def time_b2(pipe, root, native_box, flush, card):
    """B2's device time at `B2_INPUTS`: (a) phase 3's native tile
    ``native_box``, (b) and (c) the first tiles at 2x and 4x the native
    ground resolution, which the decline leg gets at default settings;
    near, bilinear and cubic, warm and cold L2, beside its plain version
    and two bounds: the distinct source pixels its taps need x 4 B, and
    the distinct 32-byte sectors they touch x 32 B, each plus the other
    operands.  Logs the device time of a launch that does nothing first.
    Returns {(input, method): (ms, cold ms, plain ms, pixel bound ms,
    sector bound ms, max |kernel - plain|)}."""
    import torch
    from gsky_tpu_torch.ops import warp_render
    from gsky_tpu_torch.ops.paged import page_slots
    saved = warp_render.warp_render_kernel.launches
    dev = torch.device("cuda")
    empty = kernel_device_ms(lambda: warp_render.empty_kernel(dev),
                             "empty_kernel")
    log(f"timing: a launch of an empty kernel {empty:.5f} ms ({card})")
    rows = {}
    for name, zoom in B2_INPUTS:
        box = native_box if zoom is None else zoom_boxes(zoom)[0]
        if zoom is not None and pipe.executor.page_spans(
                tile_group(pipe, root, box), page_slots()) is not None:
            raise AssertionError(f"B2 input ({name}) fits the paged leg")
        scenes, p16, sx, sy = b2_operands(pipe, root, box)
        for method in METHODS:
            def b2():
                return warp_render.warp_render_scored(scenes, sx, sy, p16,
                                                      method, 1)

            def b2p():
                return warp_render.warp_render_scored_plain(
                    scenes, sx, sy, p16, method, 1)
            ck, bk = b2()
            cp, bp = b2p()
            err = check_pair(method, ck, bk, cp, bp, f"B2 ({name}) {method}")
            ms = kernel_device_ms(b2, "warp_render")
            cold = kernel_device_ms(b2, "warp_render", between=flush.zero_)
            call, pms = cuda_time_ms(b2), cuda_time_ms(b2p, reps=3)
            other = other_bytes(sx, p16, 1)
            px = tap_footprint_px(sx, sy, p16, method)
            sec = tap_sectors(sx, sy, p16, method, scenes)
            bd_px = (4 * px + other) / HBM_BYTES_PER_S * 1e3
            bd_sec = (32 * sec + other) / HBM_BYTES_PER_S * 1e3
            rows[(name, method)] = (ms, cold, pms, bd_px, bd_sec, err)
            log(f"timing B2 ({name}) {method}: device {ms:.5f} ms warm L2, "
                f"{cold:.5f} ms cold L2 (per call with host {call:.4f}, "
                f"plain {pms:.3f}); bounds {bd_px:.5f} ms ({px} pixels) and "
                f"{bd_sec:.5f} ms ({sec} sectors), + {other} bytes of other "
                f"operands; B = {len(scenes)} ({card})")
    warp_render.warp_render_kernel.launches = saved
    return rows


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
    """Phases 7, 16, 13c and 8.  Returns (B3 launches of the warm run,
    the arguments B3 got on the main path, B3's K-block launches in 13c,
    B3 launches of the WPS Execute requests of phase 16)."""
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

    # -- phase 16: WPS Execute over HTTP --------------------------------
    wps_b3 = phase_wps(root, store, card)
    stats.masked_stats_kernel.launches = b3_launches

    # -- phase 13c: concurrent warm drills in one wave -----------------
    kb_launches, kb_args = phase_wave_drills(pipe, req, card)
    stats.masked_stats_kernel.launches = b3_launches
    time_b3_blocks(kb_args, card)
    del kb_args

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
    return b3_launches, captured[0], kb_launches, wps_b3


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


def b4_edge_inputs(T, H, W, seed):
    """B4 inputs made on the card: normal data x 50; valid with a density
    that lets deep stacks reach late layers; an all-invalid column band
    (W >= 7); NaN / +-inf / -0.0 in 20% of valid entries, NaN / inf in
    30% of invalid ones."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    stack = torch.randn((T, H, W), generator=g, device="cuda") * 50.0
    valid = torch.rand((T, H, W), generator=g, device="cuda") \
        < (0.5 if T <= 8 else 0.03)
    if W >= 7:
        valid[:, :, :W // 7] = False
    r = torch.rand((T, H, W), generator=g, device="cuda")
    nan, inf = float("nan"), float("inf")
    for lo, val in ((0.0, nan), (0.05, inf), (0.10, -inf), (0.15, -0.0)):
        stack = torch.where(valid & (r >= lo) & (r < lo + 0.05),
                            torch.full((), val, device="cuda"), stack)
    stack = torch.where(~valid & (r < 0.2), torch.full((), nan, device="cuda"),
                        stack)
    stack = torch.where(~valid & (r >= 0.2) & (r < 0.3),
                        torch.full((), inf, device="cuda"), stack)
    return stack.contiguous(), valid.contiguous()


def b4_same(a, b, what):
    """Kernel vs plain: out bit-exact (as int32), ok equal."""
    import torch
    if not torch.equal(a[1], b[1]):
        raise AssertionError(f"{what}: ok differs")
    if not torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)):
        n = int((a[0].view(torch.int32) != b[0].view(torch.int32)).sum())
        raise AssertionError(f"{what}: {n} values not bit-exact")


def phase_b4_kernel():
    """B4 against its plain version at every (T, H, W) of the phase's
    grid, valid as bool and as int8.  Returns the comparisons made."""
    import torch
    from gsky_tpu_torch.ops import first_valid as fv
    saved = fv.first_valid_kernel.launches
    n = 0
    for T in B4_SHAPES_T:
        for H, W in B4_SHAPES_HW:
            stack, valid = b4_edge_inputs(T, H, W, seed=T * 7919 + H + W)
            want = fv.mosaic_first_valid_plain(stack, valid)
            for v in (valid, valid.to(torch.int8)):
                got = fv.mosaic_first_valid_kernel(stack, v)
                torch.cuda.synchronize()
                b4_same(got, want, f"B4 ({T}, {H}, {W}) {v.dtype}")
                n += 1
            bits = want[0].view(torch.int32)
            if bool((bits[~want[1]] != 0).any()):
                raise AssertionError("B4 fill is not +0.0")
            del stack, valid, want, got
    for T, H, W in B4_OFFSET_SHAPES:
        stack, valid = b4_edge_inputs(T, H, W, seed=T * 31 + H)
        want = fv.mosaic_first_valid_plain(stack, valid)
        for v in (valid, valid.to(torch.int8)):
            for s_in, v_in in ((at_offset(stack), v), (stack, at_offset(v)),
                               (at_offset(stack), at_offset(v))):
                got = fv.mosaic_first_valid_kernel(s_in, v_in)
                torch.cuda.synchronize()
                b4_same(got, want, f"B4 ({T}, {H}, {W}) {v.dtype} at "
                        f"offsets {s_in.storage_offset()}, "
                        f"{v_in.storage_offset()}")
                n += 1
        del stack, valid, want, got
    fv.first_valid_kernel.launches = saved
    return n


def at_offset(x):
    """A contiguous copy of ``x`` viewed one element into its storage,
    off 16-byte alignment."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def mosaic_dates():
    """(YYYYMMDD, unix seconds) of the phase-10 acquisitions."""
    import datetime as dt
    out = []
    for i in range(MOSAIC_DATES):
        t = MOSAIC_T0 + 16 * 86400.0 * i
        out.append((dt.datetime.fromtimestamp(t, dt.timezone.utc)
                    .strftime("%Y%m%d"), t))
    return out


def _blob_mask(rng, shape, frac, cell=32):
    """A blobby mask covering ~``frac`` of ``shape``: a smoothed random
    field on a ``cell``-px grid, thresholded at its quantile, then
    blown up to full size."""
    gh, gw = shape[0] // cell + 2, shape[1] // cell + 2
    f = rng.standard_normal((gh, gw)).astype(np.float32)
    for _ in range(3):                       # three 3x3 box passes
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)) / 3.0
        f = (f + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 3.0
    m = f > np.quantile(f, 1.0 - frac)
    return np.repeat(np.repeat(m, cell, 0), cell, 1)[:shape[0], :shape[1]]


def write_mosaic_archive(root, shape=(SCENE_H, SCENE_W)):
    """8 acquisitions x {LC08_B4, LC08_B5, pixel_qa}, written uncompressed
    and tiled with the port's writer; returns [(path, namespace)].  A
    date's three files share its timestamp (the file name's date)."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.geotiff import write_geotiff
    h, w = shape
    utm = parse_crs("EPSG:32755")
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    collar = (xx + yy) < 1500
    out = []
    for i, (date, _) in enumerate(mosaic_dates()):
        rng = np.random.default_rng(40 + i)
        dx, dy = (int(v) for v in rng.integers(0, 61, 2))
        gt = GeoTransform(500000.0 + 30.0 * dx, 30.0, 0.0,
                          6200000.0 - 30.0 * dy, 0.0, -30.0)
        red = (900.0 + 500.0 * np.sin(xx / (97.0 + 7 * i))
               * np.cos(yy / 131.0)).astype(np.int16)
        red += rng.integers(-60, 61, (h, w), dtype=np.int16)
        nir = (2500.0 + 800.0 * np.cos(xx / 173.0)
               * np.sin(yy / (89.0 + 5 * i))).astype(np.int16)
        nir += rng.integers(-90, 91, (h, w), dtype=np.int16)
        cloud = _blob_mask(rng, shape, rng.uniform(0.15, 0.25))
        shadow = _blob_mask(rng, shape, rng.uniform(0.05, 0.15), 16) & ~cloud
        qa = np.full(shape, 322, np.uint16)   # clear
        qa[cloud] = 352                       # bit 5: cloud
        qa[shadow] = 328                      # bit 3: cloud shadow
        for arr, fill in ((red, -999), (nir, -999), (qa, 1)):
            arr[collar] = fill
        for ns, arr, nd in (("LC08_B4", red, -999), ("LC08_B5", nir, -999),
                            ("pixel_qa", qa, 1)):
            p = os.path.join(root, f"{ns}_{date}_T1.tif")
            write_geotiff(p, arr, gt, utm, nodata=nd, compress=False)
            out.append((p, ns))
        del red, nir, qa, cloud, shadow
    return out


def mosaic_boxes():
    """32 native-resolution tiles inside every acquisition's footprint."""
    return tile_boxes(600000.0, 6100000.0)


def mosaic_request(root, box, bands, method, mask):
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    dates = mosaic_dates()
    return GeoTileRequest(collection=root, bands=list(bands),
                          bbox=BBox(*box), crs=parse_crs("EPSG:3857"),
                          width=256, height=256,
                          start_time=dates[0][1] - 86400.0,
                          end_time=dates[-1][1] + 86400.0, mask=mask,
                          resample=method)


def render_masked(pipe, root, boxes, bands, method, mask, style):
    """GetMap tiles through `process` + `scale_to_byte` + readback.
    Returns (host uint8 tiles, per-tile seconds, scale s, readback s)."""
    import torch
    from gsky_tpu_torch.ops.scale import scale_to_byte
    clock = time.perf_counter
    tiles, secs = [], []
    t_scale = t_read = 0.0
    for box in boxes:
        req = mosaic_request(root, box, bands, method, mask)
        t0 = clock()
        res = pipe.process(req)
        t1 = clock()
        planes = [scale_to_byte(res.data[n], res.valid[n], **style)
                  for n in res.namespaces]
        t2 = clock()
        host = [p.cpu().numpy() for p in planes]
        t3 = clock()
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(clock() - t0)
        t_scale += t2 - t1
        t_read += t3 - t2
        tile = host[0]
        if len(host) != 1 or tile.dtype != np.uint8 \
                or tile.shape != (256, 256):
            raise AssertionError(f"bad tile {bands} {method} {box}")
        if (tile == 255).all():
            raise AssertionError(f"tile {box} is all nodata")
        tiles.append(tile)
    return tiles, secs, t_scale, t_read


class CaptureB4:
    """Keeps every B4 call's (stack, valid) while installed; the
    wrapper it calls counts launches as always."""

    def __init__(self):
        from gsky_tpu_torch.ops import first_valid
        self.mod = first_valid
        self.orig = first_valid.mosaic_first_valid_kernel
        self.args = []
        first_valid.mosaic_first_valid_kernel = self._call

    def _call(self, stack, valid):
        self.args.append((stack, valid))
        return self.orig(stack, valid)

    def remove(self):
        self.mod.mosaic_first_valid_kernel = self.orig


def b4_needed_bytes(valid):
    """Bytes B4's early-exit scan must move on these inputs: per pixel
    the valid bytes up to the first valid layer (all T where none is),
    the 4-byte value it copies, and 5 bytes of output."""
    import torch
    v = valid != 0
    ok = v.any(0)
    first = torch.argmax(v.to(torch.uint8), 0)
    k = torch.where(ok, first + 1, torch.full_like(first, v.shape[0]))
    return int(k.sum()) + 4 * int(ok.sum()) + 5 * ok.numel()


def crawl(paths):
    """A MAS store of the port's crawler records of (path, namespace)."""
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    store = MASStore()
    for p, ns in paths:
        rec = extract(p)
        if rec.get("error"):
            raise AssertionError(rec["error"])
        for ds in rec["geo_metadata"]:
            ds["namespace"] = ns
        store.ingest(rec)
    return store


def mosaic_store(root):
    """Phase 10's archive written under ``root`` and crawled."""
    t0 = time.perf_counter()
    paths = write_mosaic_archive(root)
    store = crawl(paths)
    size = sum(os.path.getsize(p) for p, _ in paths)
    log(f"phase 10: {len(paths)} GeoTIFFs ({size / 1e9:.3f} GB) written + "
        f"crawled in {time.perf_counter() - t0:.1f} s")
    return store


def phase_mosaic(root, store, card):
    """Phases 10 and 11 over phase 10's archive under ``root``, crawled
    into ``store``.  Returns (B4 launches of the main path, the main
    path's B4 arguments: the first call's and every `B4_TIMED_EVERY`-th
    after it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gsky_tpu_torch.ops import first_valid, paged, stats, warp_render
    from gsky_tpu_torch.ops.scale import scale_to_byte
    from gsky_tpu_torch.pipeline.types import MaskSpec
    boxes = mosaic_boxes()
    mask = MaskSpec(id="pixel_qa", bit_tests=list(CLOUD_SHADOW))
    noop = MaskSpec(id="pixel_qa", value="0")
    pipe = make_pipeline(store, "cuda")
    # warm-up (handles, allocator): one tile per request, not counted
    for bands, method, style in MOSAIC_REQS:
        render_masked(pipe, root, boxes[:1], bands, method, mask, style)

    # -- the main path: masked tiles, counts from 0 --------------------
    ex = pipe.executor
    for k in ex.spans:
        ex.spans[k] = 0.0
    cap = CaptureB4()
    plain = PlainCalls()
    for k in (paged.paged_render_kernel, warp_render.warp_render_kernel,
              stats.masked_stats_kernel, first_valid.first_valid_kernel):
        k.launches = 0
    card_tiles, lat = {}, []
    t_scale = t_read = 0.0
    t0 = time.perf_counter()
    try:
        for bands, method, style in MOSAIC_REQS:
            tiles, secs, ts, tr = render_masked(pipe, root, boxes, bands,
                                                method, mask, style)
            card_tiles[(bands[0], method)] = tiles
            lat += secs
            t_scale += ts
            t_read += tr
        wall = time.perf_counter() - t0
    finally:
        cap.remove()
        plain.remove()
    b4_launches = first_valid.first_valid_kernel.launches
    others = (paged.paged_render_kernel.launches,
              warp_render.warp_render_kernel.launches,
              stats.masked_stats_kernel.launches)
    n_tiles = N_TILES * len(MOSAIC_REQS)
    want = N_TILES * (3 + 2)
    shapes = {tuple(s.shape) for s, _ in cap.args}
    if b4_launches != want or plain.calls or any(others) \
            or shapes != {(MOSAIC_DATES, 256, 256)}:
        raise AssertionError(
            f"phase 10 main path: B4 {b4_launches} (want {want}), B1/B2/B3 "
            f"{others}, plain calls {plain.calls}, B4 shapes {shapes}")
    spans = {k: v / n_tiles * 1e3 for k, v in ex.spans.items()
             if k in ("index", "decode", "warp", "bitmask", "mosaic",
                      "expr")}
    spans.update(scale=t_scale / n_tiles * 1e3,
                 readback=t_read / n_tiles * 1e3)
    log(f"phase 10: {n_tiles} masked tiles, {n_tiles / wall:.2f} tiles/s, "
        f"p50 {np.median(lat) * 1e3:.2f} ms, p90 "
        f"{np.percentile(lat, 90) * 1e3:.2f} ms; B4 launches {b4_launches} "
        f"at T = {MOSAIC_DATES}, plain calls 0 ({card})")
    log("phase 10 breakdown, ms per tile (host clock): " + ", ".join(
        f"{k} {v:.4f}" for k, v in spans.items()))
    main_args = cap.args[::B4_TIMED_EVERY]

    # -- checks after the main path ---------------------------------------
    # the same tiles with a no-op mask: what the mask excluded
    cap_noop = CaptureB4()
    noop_tiles = {}
    try:
        for bands, method, style in MOSAIC_REQS:
            noop_tiles[(bands[0], method)], _, _, _ = render_masked(
                pipe, root, boxes, bands, method, noop, style)
    finally:
        cap_noop.remove()
    kept = sum(int(v.sum()) for _, v in cap.args)
    total = sum(int(v.sum()) for _, v in cap_noop.args)
    excluded = 1.0 - kept / total
    differ = {k: int(sum(np.count_nonzero(a != b) for a, b in
                         zip(card_tiles[k], noop_tiles[k])))
              for k in card_tiles}
    if not excluded > 0 or not all(differ.values()):
        raise AssertionError(f"mask excluded {excluded}, differing bytes "
                             f"{differ}")
    del cap, cap_noop
    # nearest no-op tiles against the fused route over the same archive
    style = MOSAIC_REQS[0][2]
    flips = 0
    total_px = 0
    for box, mod in zip(boxes, noop_tiles[("LC08_B4", "near")]):
        req = mosaic_request(root, box, ["LC08_B4"], "near", None)
        fused = pipe.render_composite_byte(req, auto=False, **style)
        if fused is None:
            raise AssertionError(f"fused route declined {box}")
        fused = fused.cpu().numpy()
        if not np.array_equal(fused == 255, mod == 255):
            raise AssertionError(f"fused vs modular: nodata differs {box}")
        ok = mod != 255
        flips += int(np.count_nonzero(fused[ok] != mod[ok]))
        total_px += int(ok.sum())
    if flips > 0.02 * total_px:
        raise AssertionError(f"fused vs modular: {flips} of {total_px} "
                             f"bytes differ")
    log(f"phase 10: mask excluded {100 * excluded:.2f}% of valid "
        f"pixel-layers; masked vs no-op bytes differ {differ}; no-op near "
        f"vs fused route: nodata equal, {flips} of {total_px} bytes "
        f"({100 * flips / total_px:.3f}%) differ")

    # device busy share of a masked tile, on a pass under the profiler
    bands, method, style = MOSAIC_REQS[1]
    clock = time.perf_counter
    t0 = clock()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_masked(pipe, root, boxes[:8], bands, method, mask, style)
        torch.cuda.synchronize()
    prof_wall = (clock() - t0) / 8 * 1e3
    avgs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in avgs)
    b4_us = sum(e.self_device_time_total for e in avgs
                if "first_valid_kernel" in e.key)
    top = sorted(((e.self_device_time_total, e.key) for e in avgs
                  if e.self_device_time_total > 0), reverse=True)[:6]
    first_valid.first_valid_kernel.launches = b4_launches
    log(f"phase 10 device (bilinear, 8 tiles under the profiler): busy "
        f"{dev_us / 8 / 1e3:.4f} ms per tile of {prof_wall:.3f} ms wall "
        f"({100 * dev_us / 8 / 1e3 / prof_wall:.2f}%), of which B4 "
        f"{b4_us / 8 / 1e3:.5f} ms; top: " + "; ".join(
            f"{k[:50]} {us / 8 / 1e3:.4f}" for us, k in top))

    # -- phase 11: card vs CPU --------------------------------------------
    cpu = make_pipeline(store, "cpu")
    t0 = time.perf_counter()
    worst = 0
    for bands, method, style in MOSAIC_REQS:
        got, _, _, _ = render_masked(cpu, root, boxes[:2], bands, method,
                                     mask, style)
        for a, b in zip(card_tiles[(bands[0], method)][:2], got):
            d = int(np.count_nonzero(a != b))
            worst = max(worst, d)
            if (method == "near" and d) or d > a.size // 1000:
                raise AssertionError(f"card vs cpu {bands} {method}: {d} "
                                     f"bytes differ")
    first_valid.first_valid_kernel.launches = b4_launches
    log(f"phase 11: CPU tiles match the card (worst {worst} bytes of "
        f"65536; {time.perf_counter() - t0:.1f} s)")
    del cpu, pipe
    return b4_launches, main_args


def time_b4(main_args, card):
    """B4's device time at the main path's inputs (``main_args``, a
    sample of its calls: the mean over them, the first beside it) and at
    (128, 2048, 2048) with every pixel scanning all layers, beside its
    bound, its plain version and the same function composed from
    PyTorch's own ops (those two at the first input).  Returns the
    main-path row (mean ms, plain ms, mean bound ms, library ms, max
    |kernel - plain|)."""
    import torch
    from gsky_tpu_torch.ops import first_valid as fv
    saved = fv.first_valid_kernel.launches
    rows = []
    T, H, W = 128, 2048, 2048
    deep = torch.zeros((T, H, W), dtype=torch.bool, device="cuda")
    deep[-1, :, ::2] = True                   # only the last layer valid
    big = (torch.randn((T, H, W), device="cuda"), deep)
    for what, inputs in (("main path", main_args), ("deep", [big])):
        ms, bd = [], []
        for k, (stack, valid) in enumerate(inputs):
            def b4():
                return fv.mosaic_first_valid_kernel(stack, valid)
            b4_same(b4(), fv.mosaic_first_valid_plain(stack, valid),
                    f"B4 {what}")
            ms.append(kernel_device_ms(b4, "first_valid_kernel"))
            bd.append(b4_needed_bytes(valid) / HBM_BYTES_PER_S * 1e3)
            if what == "main path":
                v = valid != 0
                log(f"timing B4 main-path call {k * B4_TIMED_EVERY}: "
                    f"{ms[-1]:.5f} ms; pixels valid at layer 0 "
                    f"{100 * float(v[0].float().mean()):.2f}%, at no "
                    f"layer {100 * float((~v.any(0)).float().mean()):.2f}%")
        stack, valid = inputs[0]

        def b4():
            return fv.mosaic_first_valid_kernel(stack, valid)

        def b4p():
            return fv.mosaic_first_valid_plain(stack, valid)

        def library():
            idx = valid.to(torch.uint8).argmax(0)
            out = torch.gather(stack, 0, idx[None])[0]
            ok = valid.any(0)
            return torch.where(ok, out, 0.0), ok

        b4_same(library(), b4p(), f"B4 library {what}")
        call = cuda_time_ms(b4)
        pms = cuda_time_ms(b4p, reps=5)
        lms = cuda_time_ms(library, reps=10)
        t, h, w = stack.shape
        full = t * h * w * 5 + h * w * 5
        mean, mbd = float(np.mean(ms)), float(np.mean(bd))
        rows.append((mean, pms, mbd, lms, 0.0))
        if what == "main path":
            what = (f"main path, launch-bound at this size, mean over "
                    f"{len(ms)} calls (first {ms[0]:.5f}, min "
                    f"{min(ms):.5f}, max {max(ms):.5f}),")
        log(f"timing B4 {what} ({t}, {h}, {w}): device {mean:.5f} ms (per "
            f"call with host {call:.4f}), bound {mbd:.6f} ms (the bytes "
            f"its scan needs; {100 * mbd / mean:.2f}% of bound), full-read "
            f"bound {full / HBM_BYTES_PER_S * 1e3:.6f} ms ({full} bytes), "
            f"plain {pms:.4f} ms, library (argmax+gather+any+where) "
            f"{lms:.4f} ms ({card})")
    fv.first_valid_kernel.launches = saved
    del big, deep
    return rows[0]


# -- phase 12: the OWS front end over HTTP ---------------------------------

# 12a: the two-CRS layer's UTM-56S granules start at these UTM-55S
# points (carried across the zone line) and its tiles at this one
CRS_ORIGINS = ((620000.0, 6160000.0), (623000.0, 6157000.0))
CRS_TILES_AT = (640000.0, 6140000.0)
HTTP_CPU_TILES = 2           # tiles per route held against the CPU server


def write_crs_archive(root, data_paths, shape=(SCENE_H, SCENE_W)):
    """The two-CRS layer's collection under ``root``: two of phase 3's
    granules (hard links) and two new UTM-56S granules of the same size
    over them.  Returns the four paths."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.geotiff import write_geotiff
    h, w = shape
    u55, u56 = parse_crs("EPSG:32755"), parse_crs("EPSG:32756")
    rng = np.random.default_rng(56)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    paths = []
    for p in data_paths[:2]:
        paths.append(os.path.join(root, os.path.basename(p)))
        os.link(p, paths[-1])
    for i, (x, y) in enumerate(CRS_ORIGINS):
        ox, oy = u55.transform_to(u56, np.array([x]), np.array([y]))
        gt = GeoTransform(float(ox[0]), 30.0, 0.0, float(oy[0]), 0.0, -30.0)
        field = 2000.0 + 1200.0 * np.cos(xx / (70.0 + 13 * i)) \
            * np.sin(yy / (110.0 - 7 * i))
        data = (field + rng.normal(0, 100, (h, w))
                .astype(np.float32)).astype(np.int16)
        data[(xx + yy) < 1500] = -999
        paths.append(os.path.join(root, f"LC08_202001{14 + i:02d}_T1.tif"))
        write_geotiff(paths[-1], data, gt, u56, nodata=-999, compress=False)
    return paths


def iso(t):
    from gsky_tpu_torch.index.store import fmt_time
    return fmt_time(t)


def getmap_url(base, layer, box, style="", time_range=None):
    q = (f"service=WMS&request=GetMap&version=1.3.0&layers={layer}"
         f"&styles={style}&crs=EPSG:3857"
         f"&bbox={','.join(repr(float(v)) for v in box)}"
         f"&width=256&height=256&format=image/png")
    if time_range:
        q += f"&time={iso(time_range[0])},{iso(time_range[1])}"
    return f"{base}/ows?{q}"


def http_get(url):
    """(status, content type, body, seconds) of one GET over a socket."""
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=120) as r:
        body = r.read()
        return r.status, r.headers["Content-Type"], body, \
            time.perf_counter() - t0


class OwsPair:
    """The port's OWSServer on the card and on the CPU over one config
    directory and MAS store; the card's behind a standard-library HTTP
    server on an ephemeral 127.0.0.1 port."""

    def __init__(self, conf_dir, layers, store, gateway=None):
        """``gateway``: the card server's `ServingGateway`; None (phases
        12-16 measure renders) serves every request raw.  The CPU
        server has none."""
        from gsky_tpu_torch.index.client import MASClient
        from gsky_tpu_torch.server.config import ConfigWatcher
        from gsky_tpu_torch.server.ows import OWSServer
        os.makedirs(conf_dir, exist_ok=True)
        self.conf_path = os.path.join(conf_dir, "config.json")
        with open(self.conf_path, "w") as fp:
            json.dump({"service_config": {"mas_address": "in-process"},
                       "layers": layers}, fp)
        client = MASClient(store)
        self.watcher = watcher = ConfigWatcher(conf_dir, lambda a: client,
                                               install_signal=False)
        self.card = OWSServer(watcher, lambda a: client, device="cuda",
                              gateway=gateway)
        self.cpu = OWSServer(watcher, lambda a: client, device="cpu",
                             gateway=None)
        self.httpd = self.card.serve("127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def cpu_body(self, url, host=""):
        """The CPU server's body for ``url`` (``host``: the Host header,
        which a document's URLs name)."""
        from urllib.parse import parse_qs, urlsplit
        u = urlsplit(url)
        r = self.cpu.handle(u.path, parse_qs(u.query), host)
        if r.status != 200:
            raise AssertionError(f"CPU server: {r.status} {r.body[:300]}")
        return r.body


def run_route(pair, name, urls, want, card, expect_data=True, phase="12"):
    """GET ``urls`` serially with every kernel count set to 0 just
    before; the counts after must equal ``want`` ({"B1": n, ...}).
    Returns the bodies and logs tiles/s, p50, p90 and the share of a
    request's wall time outside the pipeline."""
    from gsky_tpu_torch.io.png import decode_png
    from gsky_tpu_torch.ops import first_valid, paged, stats, warp_render
    kernels = {"B1": paged.paged_render_kernel,
               "B2": warp_render.warp_render_kernel,
               "B3": stats.masked_stats_kernel,
               "B4": first_valid.first_valid_kernel}
    srv = pair.card
    before = dict(srv.spans)
    for k in kernels.values():
        k.launches = 0
    bodies, lat = [], []
    t0 = time.perf_counter()
    for url in urls:
        status, ctype, body, secs = http_get(url)
        if (status, ctype) != (200, "image/png"):
            raise AssertionError(f"{name}: {status} {ctype} {body[:300]}")
        bodies.append(body)
        lat.append(secs)
    wall = time.perf_counter() - t0
    got = {k: v.launches for k, v in kernels.items()}
    full = {k: want.get(k, 0) for k in kernels}
    if got != full:
        raise AssertionError(f"{name}: launches {got}, want {full}")
    for body in bodies:
        img = decode_png(body)
        if img.shape != (256, 256, 4):
            raise AssertionError(f"{name}: decoded {img.shape}")
        if expect_data != bool(img[..., 3].any()):
            raise AssertionError(f"{name}: tile has data: "
                                 f"{bool(img[..., 3].any())}")
    sp = {k: srv.spans[k] - before[k] for k in srv.spans}
    client = sum(lat)
    log(f"phase {phase} {name}: {len(urls)} tiles over HTTP, "
        f"{len(urls) / wall:.2f} tiles/s, p50 {np.median(lat) * 1e3:.3f} "
        f"ms, p90 {np.percentile(lat, 90) * 1e3:.3f} ms; launches {got}; "
        f"outside the pipeline {100 * (1 - sp['render'] / client):.2f}% "
        f"of a request's wall time (parse "
        f"{sp['parse'] / len(urls) * 1e3:.4f} ms, encode "
        f"{sp['encode'] / len(urls) * 1e3:.4f} ms, socket and HTTP "
        f"{(client - sp['handle']) / len(urls) * 1e3:.4f} ms; render "
        f"{sp['render'] / len(urls) * 1e3:.4f} ms) ({card})")
    return bodies


def same_decoded(method, card_body, cpu_body, what):
    """Card vs CPU bodies: decoded RGBA identical for nearest, at most
    0.1% of bytes differing otherwise.  Returns the bytes that differ."""
    from gsky_tpu_torch.io.png import decode_png
    a, b = decode_png(card_body), decode_png(cpu_body)
    d = int(np.count_nonzero(a != b))
    if (method == "near" and d) or d > a.size // 1000:
        raise AssertionError(f"{what}: {d} decoded bytes differ")
    return d


def phase_ows_fused(data_root, data_paths, card):
    """Phase 12a over phase 3's archive: the port's OWS server on the
    card over HTTP.  Plain layer: 32 native tiles bilinear (sent
    serially, then from 4 client threads: the same bodies), 4 near, 4
    cubic, one B1 launch each; 8 tiles at 4x the native ground
    resolution, one B2 each; a palette layer; a tile past the zoom
    limit (the placeholder, no launch); a layer over two of phase 3's
    granules and two UTM-56S ones, 8 tiles through `_render_fused`, two
    B2 launches each.  Then two tiles per route from the CPU server."""
    import concurrent.futures as cf
    crs_root = data_root + "_crs"
    shutil.rmtree(crs_root, ignore_errors=True)
    os.makedirs(crs_root)
    try:
        t0 = time.perf_counter()
        crs_paths = write_crs_archive(crs_root, data_paths)
        store = crawl([(p, NS) for p in data_paths]
                      + [(p, "B4X") for p in crs_paths])
        log(f"phase 12a: two UTM-56S granules written, both collections "
            f"crawled in {time.perf_counter() - t0:.1f} s")
        styles = [{"name": m, "title": m, "rgb_products": [NS],
                   "resample": m} for m in METHODS]
        layers = [
            {"name": "landsat", "data_source": data_root,
             "rgb_products": [NS], "styles": styles},
            {"name": "landsat_palette", "data_source": data_root,
             "rgb_products": [NS], "clip_value": 6000,
             "palette": {"interpolate": True, "colours": [
                 {"R": 0, "G": 0, "B": 128, "A": 255},
                 {"R": 40, "G": 200, "B": 40, "A": 255},
                 {"R": 255, "G": 255, "B": 0, "A": 255}]}},
            {"name": "landsat_limited", "data_source": data_root,
             "rgb_products": [NS], "zoom_limit": 100.0},
            {"name": "two_crs", "data_source": crs_root,
             "rgb_products": ["B4X"], "resample": "bilinear"},
        ]
        pair = OwsPair(os.path.join(crs_root, "conf"), layers, store)
        try:
            return ows_fused_routes(pair, card, cf)
        finally:
            pair.close()
    finally:
        shutil.rmtree(crs_root, ignore_errors=True)


def ows_fused_routes(pair, card, cf):
    # TIME ranges (the end exclusive) over every granule of a layer
    t_days = (1578614400.0, 1578960000.0)        # 2020-01-10 .. 01-14
    t_crs = (1578614400.0, 1579132800.0)         # 2020-01-10 .. 01-16
    native = tile_boxes()
    zoomed = zoom_boxes(4.0)
    crs_boxes = tile_boxes(*CRS_TILES_AT, nx=4, ny=2)
    # route: (urls, launches it must make, resampling method)
    routes = {
        "native bilinear": ([getmap_url(pair.base, "landsat", b,
                                        "bilinear", t_days)
                             for b in native], {"B1": len(native)},
                            "bilinear"),
        "native near": ([getmap_url(pair.base, "landsat", b, "near",
                                    t_days) for b in native[:4]],
                        {"B1": 4}, "near"),
        "native cubic": ([getmap_url(pair.base, "landsat", b, "cubic",
                                     t_days) for b in native[4:8]],
                         {"B1": 4}, "cubic"),
        "4x zoomed-out": ([getmap_url(pair.base, "landsat", b, "bilinear",
                                      t_days) for b in zoomed],
                          {"B2": len(zoomed)}, "bilinear"),
        "palette": ([getmap_url(pair.base, "landsat_palette", b, "",
                                t_days) for b in native[:2]],
                    {"B1": 2}, "near"),
        "placeholder": ([getmap_url(pair.base, "landsat_limited",
                                    zoomed[0], "", t_days)], {}, "near"),
        "two-CRS": ([getmap_url(pair.base, "two_crs", b, "", t_crs)
                     for b in crs_boxes], {"B2": 2 * len(crs_boxes)},
                    "bilinear"),
    }
    # warm-up (scene uploads, handles): one tile of each layer, uncounted
    for urls, _, _ in routes.values():
        http_get(urls[0])
    bodies = {name: run_route(pair, name, urls, want, card,
                              expect_data=name != "placeholder")
              for name, (urls, want, _) in routes.items()}

    # the 32 native tiles again, from 4 client threads at once
    urls = routes["native bilinear"][0]
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(4) as pool:
        conc = list(pool.map(http_get, urls))
    wall = time.perf_counter() - t0
    if [c[2] for c in conc] != bodies["native bilinear"]:
        raise AssertionError("phase 12a: concurrent bodies differ from "
                             "the serial ones")
    lat = [c[3] for c in conc]
    log(f"phase 12a: the 32 native tiles from 4 client threads: "
        f"{len(urls) / wall:.2f} tiles/s, p50 {np.median(lat) * 1e3:.3f} "
        f"ms, p90 {np.percentile(lat, 90) * 1e3:.3f} ms; bodies equal the "
        f"serial ones ({card})")

    t0 = time.perf_counter()
    worst = {}
    for name, (urls, _, method) in routes.items():
        worst[name] = max(
            same_decoded(method, body, pair.cpu_body(url), name)
            for url, body in zip(urls[:HTTP_CPU_TILES],
                                 bodies[name][:HTTP_CPU_TILES]))
    log(f"phase 12a: CPU server bodies match the card's (decoded bytes "
        f"differing, worst tile per route: {worst}; "
        f"{time.perf_counter() - t0:.1f} s)")
    return {name: len(urls) for name, (urls, _, _) in routes.items()}


def phase_ows_masked(root, store, card):
    """Phase 12b over phase 10's archive: the masked layer (pixel_qa
    bit tests) LC08_B4 bilinear and the NDVI expression, 8 tiles each
    over HTTP through `process` and B4 (one launch per namespace a
    tile); two tiles each from the CPU server."""
    mask = {"id": "pixel_qa", "bit_tests": CLOUD_SHADOW}
    layers = [
        {"name": "masked_b4", "data_source": root,
         "rgb_products": ["LC08_B4"], "resample": "bilinear",
         "mask": mask, "clip_value": 2000},
        {"name": "masked_ndvi", "data_source": root, "rgb_products": [NDVI],
         "resample": "bilinear", "mask": mask},
    ]
    dates = mosaic_dates()
    t_range = (dates[0][1] - 86400.0, dates[-1][1] + 86400.0)
    boxes = mosaic_boxes()[:8]
    pair = OwsPair(os.path.join(root, "conf"), layers, store)
    try:
        routes = {
            "masked LC08_B4": ([getmap_url(pair.base, "masked_b4", b, "",
                                           t_range) for b in boxes],
                               {"B4": len(boxes)}),
            "masked NDVI": ([getmap_url(pair.base, "masked_ndvi", b, "",
                                        t_range) for b in boxes],
                            {"B4": 2 * len(boxes)}),
        }
        for urls, _ in routes.values():
            http_get(urls[0])
        worst = {}
        for name, (urls, want) in routes.items():
            bodies = run_route(pair, name, urls, want, card)
            worst[name] = max(
                same_decoded("bilinear", body, pair.cpu_body(url), name)
                for url, body in zip(urls[:HTTP_CPU_TILES],
                                     bodies[:HTTP_CPU_TILES]))
        log(f"phase 12b: CPU server bodies match the card's (decoded "
            f"bytes differing, worst tile per route: {worst})")
    finally:
        pair.close()


# -- phase 13: wave serving ------------------------------------------------

WAVE_THREADS = 16            # 13a: in-process request threads
ANIM_REPEAT = 3              # 13b: each animation request timed this often
WAVE_DRILLS = 4              # 13c: concurrent warm drills
WAVE_DRILL_ROUNDS = 5
DAY = 86400.0


class WavesOn:
    """Phases 3-12 pin GSKY_WAVES=0 and GSKY_TILE_PIPELINE=0 (their
    per-call meaning); inside this block the defaults hold again (waves,
    the staged GetMap path), with ``extra`` knobs set, and a fresh wave
    scheduler and planner counters."""

    KEYS = ("GSKY_WAVES", "GSKY_TILE_PIPELINE", "GSKY_WAVE_TICK_MS")

    def __init__(self, **extra):
        self.extra = extra

    def __enter__(self):
        from gsky_tpu_torch.pipeline import autoplan, waves
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        for k in self.KEYS:
            os.environ.pop(k, None)
        os.environ.update(self.extra)
        waves.reset_waves()
        autoplan.reset_plan_state()
        return waves

    def __exit__(self, *exc):
        from gsky_tpu_torch.pipeline import waves
        waves.reset_waves()
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wave_stats_of(waves):
    """The stats of the card's wave scheduler ({} before its first
    request)."""
    import torch
    return waves.wave_stats().get(str(torch.device(
        "cuda", torch.cuda.current_device())), {})


def render_threads(pipe, root, boxes, method, threads):
    """``boxes`` through `render_composite_byte` from ``threads`` threads
    at once: (host tiles in box order, per-tile seconds, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    merc = parse_crs("EPSG:3857")

    def one(box):
        req = GeoTileRequest(collection=root, bands=[NS], bbox=BBox(*box),
                             crs=merc, width=256, height=256,
                             resample=method)
        t0 = time.perf_counter()
        out = pipe.render_composite_byte(req)
        if out is None:
            raise AssertionError(f"tile {box} not rendered")
        tile = out if isinstance(out, np.ndarray) else out.cpu().numpy()
        return tile, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        res = list(ex.map(one, boxes))
    return [r[0] for r in res], [r[1] for r in res], time.perf_counter() - t0


def phase_wave_tiles(pipe, root, boxes, card_tiles, card):
    """Phase 13a: phase 3's 32 native tiles per method from
    `WAVE_THREADS` threads, per call (GSKY_WAVES=0) and then with waves
    on, in the same run.  Per call the bodies equal phase 3's; with
    waves the nearest bodies are identical to them and the others within
    0.1% of bytes, through fewer B1 launches than tiles and no B2 or
    plain version.  Returns (B1 launches of the wave runs, the bilinear
    run's largest B1 launch's arguments)."""
    import torch
    from gsky_tpu_torch.ops import first_valid, paged, stats, warp_render
    from gsky_tpu_torch.pipeline import autoplan
    kernels = (paged.paged_render_kernel, warp_render.warp_render_kernel,
               stats.masked_stats_kernel, first_valid.first_valid_kernel)
    b1_total, biggest = 0, None
    for method in METHODS:
        pc_tiles, pc_lat, pc_wall = render_threads(pipe, root, boxes, method,
                                                   WAVE_THREADS)
        for a, b in zip(card_tiles[method], pc_tiles):
            if not np.array_equal(a, b):
                raise AssertionError(f"13a {method}: per-call tiles from "
                                     f"threads differ from phase 3's")
        with WavesOn() as waves:
            cap = CaptureB1(full=True)
            plain = PlainCalls()
            for k in kernels:
                k.launches = 0
            declined = pipe.executor.paged_declined
            try:
                w_tiles, w_lat, w_wall = render_threads(
                    pipe, root, boxes, method, WAVE_THREADS)
            finally:
                cap.remove()
                plain.remove()
            b1, b2 = (paged.paged_render_kernel.launches,
                      warp_render.warp_render_kernel.launches)
            st = wave_stats_of(waves)
            plan = autoplan.plan_stats()
        if not 0 < b1 < len(boxes) or b2 or plain.calls or st["failed"] \
                or pipe.executor.paged_declined != declined \
                or sum(n * c for n, c in st["occupancy"].items()) \
                != len(boxes):
            raise AssertionError(
                f"13a {method}: B1 {b1} for {len(boxes)} tiles, B2 {b2}, "
                f"plain {plain.calls}, waves {st}")
        diff = [int(np.count_nonzero(a != b))
                for a, b in zip(card_tiles[method], w_tiles)]
        if (method == "near" and any(diff)) or max(diff) > 65536 // 1000:
            raise AssertionError(f"13a {method}: wave bodies differ from "
                                 f"per-call ones by {diff} bytes")
        b1_total += b1
        if method == "bilinear":
            biggest = max(cap.args, key=lambda a: a[3].shape[0])
        log(f"phase 13a {method}: {len(boxes)} tiles from {WAVE_THREADS} "
            f"threads; waves: {len(boxes) / w_wall:.1f} tiles/s, p50 "
            f"{np.median(w_lat) * 1e3:.2f} ms, p90 "
            f"{np.percentile(w_lat, 90) * 1e3:.2f} ms, B1 launches {b1} "
            f"for {len(boxes)} tiles, occupancy {st['occupancy']}, "
            f"superblock lanes {st['superblock_lanes']} (planner: "
            f"{plan['superblocks']} superblocks, {plan['merged_lanes']} "
            f"lanes merged), bytes differing from per call {sum(diff)} "
            f"(worst tile {max(diff)}); per call (GSKY_WAVES=0): "
            f"{len(boxes) / pc_wall:.1f} tiles/s, p50 "
            f"{np.median(pc_lat) * 1e3:.2f} ms, p90 "
            f"{np.percentile(pc_lat, 90) * 1e3:.2f} ms ({card})")
    torch.cuda.synchronize()
    return b1_total, biggest


def time_b1_wave(pipe, args, per_tile_ms, card):
    """B1's device time for one wave launch at phase 13a's largest
    bilinear wave, beside the per-tile launch of phase 3 and the bound
    (every lane's tap pixels, operands and outputs)."""
    from gsky_tpu_torch.ops import paged
    pool, tables, params, sx, sy, method, n_ns, sb_of = args
    N = sx.shape[0]
    T = params.shape[0] // N
    saved = paged.paged_render_kernel.launches
    with pipe.executor.pool.locked_pool():
        ms = kernel_device_ms(lambda: paged.paged_render_scored(
            pool, tables, params, sx, sy, method, n_ns, sb_of),
            "paged_render")
    paged.paged_render_kernel.launches = saved
    nbytes = sum(bound_bytes(sx[n], sy[n], params[n * T:(n + 1) * T],
                             method, n_ns) for n in range(N)) \
        + tables.numel() * 4
    bd = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing B1 wave ({N} lanes, {method}, "
        f"{'superblock rows ' + str(tables.shape[0]) if sb_of is not None else 'no superblock'}"
        f"): device {ms:.5f} ms, {ms / N:.5f} ms a lane against "
        f"{per_tile_ms:.5f} ms a tile per call; bound {bd:.5f} ms "
        f"({nbytes} bytes) ({card})")
    return ms, N, bd


def anim_url(base, layer, box, style, times, fmt="image/apng"):
    q = (f"service=WMS&request=GetMap&version=1.3.0&layers={layer}"
         f"&styles={style}&crs=EPSG:3857"
         f"&bbox={','.join(repr(float(v)) for v in box)}"
         f"&width=256&height=256&format={fmt}"
         f"&time={','.join(iso(t) for t in times)}")
    return f"{base}/ows?{q}"


def http_get_headers(url):
    """(status, headers, body, seconds) of one GET over a socket."""
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as r:
        body = r.read()
        return r.status, dict(r.headers), body, time.perf_counter() - t0


def occupancy_delta(before, after):
    return {n: c - before.get(n, 0) for n, c in after.items()
            if c - before.get(n, 0)}


def phase_anim(root, store, card):
    """Phase 13b over phase 10's archive, its layer without a mask (near
    and bilinear) and its masked layer, over HTTP with the server's
    defaults (staged path, waves): an 8-frame APNG over the 8 dates and
    a 16-frame one at each date and 4 days after it (no exact match:
    the nearest date, so each pair shares a granule set and merges into
    a superblock); every decoded frame equals a lone GetMap at the date
    it resolved to (nearest identical, bilinear within 0.1% of bytes).
    A masked 4-frame APNG goes through the serial leg (B4, no B1).
    Returns the B1 launches of the animation requests."""
    from gsky_tpu_torch.io.png import apng_frames, decode_png
    from gsky_tpu_torch.ops import first_valid, paged, stats, warp_render
    from gsky_tpu_torch.pipeline import autoplan
    kernels = {"B1": paged.paged_render_kernel,
               "B2": warp_render.warp_render_kernel,
               "B3": stats.masked_stats_kernel,
               "B4": first_valid.first_valid_kernel}
    mask = {"id": "pixel_qa", "bit_tests": CLOUD_SHADOW}
    layers = [
        {"name": "plain_b4", "data_source": root,
         "rgb_products": ["LC08_B4"],
         "styles": [{"name": m, "title": m, "rgb_products": ["LC08_B4"],
                     "resample": m} for m in ("near", "bilinear")]},
        {"name": "masked_b4", "data_source": root,
         "rgb_products": ["LC08_B4"], "resample": "bilinear",
         "mask": mask, "clip_value": 2000},
    ]
    dates = [t for _, t in mosaic_dates()]
    box = mosaic_boxes()[0]
    b1_total = 0
    with WavesOn() as waves:
        pair = OwsPair(os.path.join(root, "conf_anim"), layers, store)
        try:
            # lone GetMaps at every date: the frames' references (and
            # the scene loads, outside the timed requests)
            t0 = time.perf_counter()
            lone = {}
            for style in ("near", "bilinear"):
                for t in dates:
                    st_, ct, body, _ = http_get(anim_url(
                        pair.base, "plain_b4", box, style, [t], "image/png"))
                    if (st_, ct) != (200, "image/png"):
                        raise AssertionError(f"13b lone GetMap {st_} {ct}")
                    lone[(style, t)] = decode_png(body)
            log(f"phase 13b: {len(lone)} lone GetMaps (8 scene loads) in "
                f"{time.perf_counter() - t0:.1f} s")
            pairs = [x for t in dates for x in (t, t + 4 * DAY)]
            for name, times, resolved in (
                    ("8 dates", dates, dates),
                    ("16 frames, dates and 4 days after",
                     pairs, [t for t in dates for _ in (0, 1)])):
                for style in ("near", "bilinear"):
                    for k in kernels.values():
                        k.launches = 0
                    autoplan.reset_plan_state()
                    before = wave_stats_of(waves)
                    lat, worst = [], 0
                    for _ in range(ANIM_REPEAT):
                        status, hdr, body, secs = http_get_headers(anim_url(
                            pair.base, "plain_b4", box, style, times))
                        if status != 200 or \
                                hdr.get("Content-Type") != "image/apng" or \
                                hdr.get("X-Gsky-Anim-Frames") != \
                                str(len(times)):
                            raise AssertionError(f"13b {name}: {status} "
                                                 f"{hdr}")
                        frames = [decode_png(f) for f in apng_frames(body)]
                        if len(frames) != len(times):
                            raise AssertionError(f"13b {name}: "
                                                 f"{len(frames)} frames")
                        for f, t in zip(frames, resolved):
                            d = int(np.count_nonzero(f != lone[(style, t)]))
                            worst = max(worst, d)
                            if (style == "near" and d) or d > f.size // 1000:
                                raise AssertionError(
                                    f"13b {name} {style}: a frame differs "
                                    f"from its lone GetMap by {d} bytes")
                        lat.append(secs)
                    after = wave_stats_of(waves)
                    got = {k: v.launches for k, v in kernels.items()}
                    occ = occupancy_delta(before.get("occupancy", {}),
                                          after["occupancy"])
                    sbl = after["superblock_lanes"] - \
                        before.get("superblock_lanes", 0)
                    n_frames = len(times) * ANIM_REPEAT
                    waves_n = sum(occ.values())
                    if not 0 < got["B1"] < n_frames or got["B2"] \
                            or got["B4"] or after["failed"] \
                            or sum(n * c for n, c in occ.items()) != n_frames:
                        raise AssertionError(f"13b {name} {style}: {got}, "
                                             f"occupancy {occ}")
                    if len(times) == 16 and not sbl:
                        raise AssertionError(f"13b {name}: no superblock")
                    b1_total += got["B1"]
                    log(f"phase 13b {name} {style}: {ANIM_REPEAT} requests "
                        f"of {len(times)} frames, p50 "
                        f"{np.median(lat) * 1e3:.1f} ms, max "
                        f"{max(lat) * 1e3:.1f} ms; B1 launches {got['B1']} "
                        f"for {n_frames} frames ({n_frames / waves_n:.2f} "
                        f"frames a wave, occupancy {occ}), superblock lanes "
                        f"{sbl} ({autoplan.plan_stats()['superblocks']} "
                        f"superblocks); frames vs lone GetMaps: worst "
                        f"{worst} bytes ({card})")
            # a masked layer: each frame through the modular route (B4)
            times = dates[:4]
            lone_m = [decode_png(http_get(anim_url(
                pair.base, "masked_b4", box, "", [t], "image/png"))[2])
                for t in times]
            for k in kernels.values():
                k.launches = 0
            before = wave_stats_of(waves)
            status, hdr, body, secs = http_get_headers(anim_url(
                pair.base, "masked_b4", box, "", times))
            got = {k: v.launches for k, v in kernels.items()}
            frames = [decode_png(f) for f in apng_frames(body)]
            after = wave_stats_of(waves)
            if status != 200 or hdr.get("X-Gsky-Anim-Frames") != "4" \
                    or got["B1"] or got["B2"] or got["B4"] < 4 \
                    or after.get("requests", 0) != before.get("requests", 0) \
                    or any(not np.array_equal(f, m)
                           for f, m in zip(frames, lone_m)):
                raise AssertionError(f"13b masked animation: {status} "
                                     f"{hdr} {got}")
            log(f"phase 13b masked 4 frames: {secs * 1e3:.1f} ms, serial "
                f"leg, B4 launches {got['B4']}, B1 0, frames equal lone "
                f"GetMaps ({card})")
        finally:
            pair.close()
    return b1_total


def phase_wave_drills(pipe, req, card):
    """Phase 13c: `WAVE_DRILLS` concurrent warm drills over phase 7's
    resident stack.  Per call first (GSKY_WAVES=0, B3 once a drill);
    then one wave of all four through one launch of B3's K-block form
    (no per-call B3), results equal to the per-call ones: a barrier in
    front of the scheduler's `drill_stats` hands the four to it
    together, since their host stages, under one interpreter lock,
    spread their arrivals over more than a window on a slow host; then
    `WAVE_DRILL_ROUNDS` rounds without the barrier for drills/s.
    Returns (K-block launches of the wave runs, the four blocks B3 got,
    clip bounds)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from gsky_tpu_torch.ops import stats
    from gsky_tpu_torch.pipeline.waves import WaveScheduler

    def rounds(n):
        outs, lat = [], []

        def one():
            t0 = time.perf_counter()
            r = pipe.process(req)
            return r, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(WAVE_DRILLS) as ex:
            for _ in range(n):
                for r, secs in ex.map(lambda _: one(), range(WAVE_DRILLS)):
                    outs.append(r)
                    lat.append(secs)
        return outs, lat, time.perf_counter() - t0

    stats.masked_stats_kernel.launches = 0
    ref, pc_lat, pc_wall = rounds(WAVE_DRILL_ROUNDS)
    pc_b3 = stats.masked_stats_kernel.launches
    captured = []
    many = stats.masked_stats_many

    def capture(datas, valids, lo, hi):
        if not captured:
            captured.append((list(datas), list(valids), lo, hi))
        return many(datas, valids, lo, hi)

    barrier = threading.Barrier(WAVE_DRILLS)
    submit = WaveScheduler.drill_stats

    def together(self, *a):
        barrier.wait(timeout=300)
        return submit(self, *a)

    stats.masked_stats_many = capture
    WaveScheduler.drill_stats = together
    try:
        with WavesOn() as waves:
            stats.masked_stats_kernel.launches = 0
            stats.masked_stats_many_kernel.launches = 0
            one_wave, _, _ = rounds(1)
            st = wave_stats_of(waves)
            k1 = (stats.masked_stats_many_kernel.launches,
                  stats.masked_stats_kernel.launches)
        WaveScheduler.drill_stats = submit
        if k1 != (1, 0) or st["occupancy"] != {WAVE_DRILLS: 1}:
            raise AssertionError(f"13c: K-block / per-call B3 launches {k1}, "
                                 f"occupancy {st['occupancy']}")
        for r in one_wave:
            same_drill(ref[0], r, "13c one wave vs per call", rtol=0.0)
        with WavesOn() as waves:
            stats.masked_stats_kernel.launches = 0
            stats.masked_stats_many_kernel.launches = 0
            outs, w_lat, w_wall = rounds(WAVE_DRILL_ROUNDS)
            st = wave_stats_of(waves)
            kw = (stats.masked_stats_many_kernel.launches,
                  stats.masked_stats_kernel.launches)
    finally:
        WaveScheduler.drill_stats = submit
        stats.masked_stats_many = many
    for r in outs:
        same_drill(ref[0], r, "13c waves vs per call", rtol=0.0)
    n = WAVE_DRILLS * WAVE_DRILL_ROUNDS
    log(f"phase 13c: {WAVE_DRILLS} concurrent warm drills handed to the "
        f"scheduler together: 1 wave, 1 B3 K-block launch, 0 per-call, "
        f"results equal per call; {WAVE_DRILL_ROUNDS} rounds as they "
        f"come: {n / w_wall:.2f} drills/s, p50 "
        f"{np.median(w_lat) * 1e3:.2f} ms, p90 "
        f"{np.percentile(w_lat, 90) * 1e3:.2f} ms, K-block launches "
        f"{kw[0]}, per-call B3 {kw[1]}, occupancy {st['occupancy']}; per "
        f"call (GSKY_WAVES=0): {n / pc_wall:.2f} drills/s, p50 "
        f"{np.median(pc_lat) * 1e3:.2f} ms, p90 "
        f"{np.percentile(pc_lat, 90) * 1e3:.2f} ms, B3 launches {pc_b3} "
        f"({card})")
    return 1 + kw[0], captured[0]


def time_b3_blocks(args, card):
    """B3's K-block form at phase 13c's four (1024, 262144) blocks: its
    device time, its plain version (a stack, then the per-row
    reduction), the library's reductions over the same blocks stacked
    (the stack made outside the timing) and the bound (every block read
    once, outputs written once)."""
    import torch
    from gsky_tpu_torch.ops import stats
    datas, valids, lo, hi = args
    K = len(datas)
    B, N = datas[0].shape

    def kb():
        return stats.masked_stats_many(datas, valids, lo, hi)

    def kbp():
        return stats.masked_stats_many_plain(datas, valids, lo, hi)

    d = torch.stack(datas)
    v8 = torch.stack(valids).view(torch.uint8)
    flo, fhi = stats.clip_f32(lo, hi)

    def library():
        inclip = (v8 != 0) & (d >= flo) & (d <= fhi)
        return torch.where(inclip, d, 0.0).sum(-1), \
            inclip.sum(-1, dtype=torch.int32)

    saved = stats.masked_stats_many_kernel.launches
    s, c = kb()
    sp, cp = kbp()
    torch.cuda.synchronize()
    if not (torch.equal(s, sp) and torch.equal(c, cp)):
        raise AssertionError("B3 K-block: kernel != plain")
    ms = kernel_device_ms(kb, "masked_stats_many_kernel", reps=20)
    pms = cuda_time_ms(kbp, reps=2)
    lms = cuda_time_ms(library, reps=5)
    stats.masked_stats_many_kernel.launches = saved
    del d, v8
    nbytes = K * (B * N * 5 + B * 8)
    bd = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing B3 K-block ({K} x ({B}, {N})): device {ms:.5f} ms, bound "
        f"{bd:.5f} ms ({nbytes} bytes, {100 * bd / ms:.1f}% of bound), "
        f"plain {pms:.3f} ms, library over the stack (where+sum+count) "
        f"{lms:.4f} ms ({card})")
    return ms, pms, bd, lms


# -- phase 14: fused band algebra and the multi-band RGB GetMap -----------

# a thresholded expression with literals: the fingerprint lifts them
EXPR_THR = "thr=LC08_B5 > 2600 ? LC08_B5 - LC08_B4 : 0"
EXPR_BANDS = (NDVI, EXPR_THR)
EXPR_HTTP_TILES = 8
# BASELINE config 2: Sentinel-2 L2A true colour, two adjacent MGRS tiles
# of one UTM zone, 10980 x 10980 uint16 a band (nodata 0, 10 m),
# overlapping by 490 px; written with overviews at 2, 4, 8 and 16
S2_SIZE, S2_RES, S2_OVERLAP = 10980, 10.0, 490
S2_BANDS = ("B02", "B03", "B04")
S2_STYLE = ["B04", "B03", "B02"]
S2_ORIGINS = ((600000.0, 6100000.0),
              (600000.0 + (S2_SIZE - S2_OVERLAP) * S2_RES, 6100000.0))
S2_OVERVIEWS = (2, 4, 8, 16)
S2_DATE = 1578614400.0                        # 2020-01-10
# tiles zoomed out to 2.5x the 10 m ground resolution read the 2x
# overview (a 2.0x tile's stride can land a hair under 2 after the
# grid's rotation, and take the full-size level)
S2_ZOOM = 2.5
S2_HTTP_TILES = 4


def expr_request(root, box, band, method, t_range):
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    return GeoTileRequest(collection=root, bands=[band], bbox=BBox(*box),
                          crs=parse_crs("EPSG:3857"), width=256,
                          height=256, start_time=t_range[0],
                          end_time=t_range[1], resample=method)


def render_expr_tiles(pipe, root, boxes, band, method, t_range, threads=1):
    """Expression tiles as the GetMap ladder serves them: the fused
    route (`render_composite_byte`), or where it declines `process` and
    auto `scale_to_byte`; from ``threads`` threads.  (host tiles in box
    order, per-tile seconds, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from gsky_tpu_torch.ops.scale import scale_to_byte

    def one(box):
        req = expr_request(root, box, band, method, t_range)
        t0 = time.perf_counter()
        out = pipe.render_composite_byte(req)
        if out is None:
            res = pipe.process(req)
            name = res.namespaces[0]
            out = scale_to_byte(res.data[name], res.valid[name], auto=True)
        tile = out if isinstance(out, np.ndarray) else out.cpu().numpy()
        secs = time.perf_counter() - t0
        if tile.shape != (256, 256) or (tile == 255).all():
            raise AssertionError(f"14a {band}: bad tile {tile.shape}")
        return tile, secs

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        res = list(ex.map(one, boxes))
    return [r[0] for r in res], [r[1] for r in res], time.perf_counter() - t0


def _kernel_counts():
    from gsky_tpu_torch.ops import first_valid, paged, stats, warp_render
    return {"B1": paged.paged_render_kernel,
            "B2": warp_render.warp_render_kernel,
            "B3": stats.masked_stats_kernel,
            "B4": first_valid.first_valid_kernel}


def phase_expr(root, store, card, boxes=None):
    """Phase 14a over phase 10's archive, expression layers without a
    mask band (NDVI, and a threshold with literals) over its two newest
    dates (four granules a tile): `mosaic_boxes()` bilinear per call
    (GSKY_WAVES=0), each tile one B1 launch at n_ns 2 or counted as
    declined to the unfused leg (`expr_fused_stats`); the same tiles
    with GSKY_EXPR_FUSE=0 (the modular route) give the same bytes; then
    from `WAVE_THREADS` threads in waves, the bodies equal per call.
    Returns (the B1 launches of the per-call and wave runs, the first
    per-call NDVI launch's arguments)."""
    from gsky_tpu_torch.ops import paged
    kernels = _kernel_counts()
    dates = [t for _, t in mosaic_dates()]
    t_range = (dates[-2] - DAY, dates[-1] + DAY)
    boxes = boxes or mosaic_boxes()
    pipe = make_pipeline(store, "cuda")
    # set-up outside the timing: scene loads, every tile's page staging
    # and control grid (both expressions read the same two bands)
    t0 = time.perf_counter()
    render_expr_tiles(pipe, root, boxes, EXPR_BANDS[0], "bilinear", t_range)
    log(f"phase 14a: 4 scenes loaded, every tile's pages staged in "
        f"{time.perf_counter() - t0:.1f} s")
    b1_total = 0
    per_call, paths = {}, {}
    for band in EXPR_BANDS:
        for k in kernels.values():
            k.launches = 0
        paged.reset_expr_fused_stats()
        cap = CaptureB1(full=True)
        plain = PlainCalls()
        try:
            tiles, lat, wall = render_expr_tiles(pipe, root, boxes, band,
                                                 "bilinear", t_range)
        finally:
            cap.remove()
            plain.remove()
        got = {k: v.launches for k, v in kernels.items()}
        st = paged.expr_fused_stats()
        fused = st["paths"].get("percall", 0)
        declined = st["paths"].get("unfused", 0)
        # a fused tile makes one B1 launch at n_ns 2; a declined one's
        # modular route one scored launch (B1, or B2 past the page
        # budget) over the same two namespaces
        if fused + declined != len(boxes) or got["B1"] < fused \
                or got["B1"] + got["B2"] != len(boxes) or got["B3"] \
                or got["B4"] or plain.calls \
                or any(a[6] != 2 for a in cap.args) \
                or st["programs"] != (1 if fused else 0):
            raise AssertionError(f"14a {band}: launches {got}, stats {st}, "
                                 f"plain {plain.calls}, n_ns "
                                 f"{sorted({a[6] for a in cap.args})}")
        b1_total += got["B1"]
        per_call[band] = tiles
        paths[band] = st["paths"]
        if band == NDVI:
            b1_args = cap.args[0]
        log(f"phase 14a {band}: {len(boxes)} tiles bilinear per call, "
            f"{len(boxes) / wall:.1f} tiles/s, p50 "
            f"{np.median(lat) * 1e3:.2f} ms, p90 "
            f"{np.percentile(lat, 90) * 1e3:.2f} ms; B1 launches "
            f"{got['B1']} at n_ns 2 ({fused} fused, {declined} declined to "
            f"the unfused leg); expr_fused_stats {st} ({card})")
    # the escape hatch: the modular route's bytes equal the fused ones
    os.environ["GSKY_EXPR_FUSE"] = "0"
    try:
        paged.reset_expr_fused_stats()
        for band in EXPR_BANDS:
            unfused, lat, wall = render_expr_tiles(pipe, root, boxes, band,
                                                   "bilinear", t_range)
            diff = sum(int(np.count_nonzero(a != b))
                       for a, b in zip(per_call[band], unfused))
            if diff:
                raise AssertionError(f"14a {band}: GSKY_EXPR_FUSE=0 bytes "
                                     f"differ from the fused ones by {diff}")
            log(f"phase 14a {band}: GSKY_EXPR_FUSE=0 (modular route) "
                f"{len(boxes) / wall:.1f} tiles/s, p50 "
                f"{np.median(lat) * 1e3:.2f} ms; bytes equal the fused "
                f"tiles ({card})")
        log(f"phase 14a: expr_fused_stats with GSKY_EXPR_FUSE=0: "
            f"{paged.expr_fused_stats()}")
    finally:
        del os.environ["GSKY_EXPR_FUSE"]
    # the same tiles from many threads in waves
    for band in EXPR_BANDS:
        with WavesOn() as waves:
            for k in kernels.values():
                k.launches = 0
            paged.reset_expr_fused_stats()
            tiles, lat, wall = render_expr_tiles(pipe, root, boxes, band,
                                                 "bilinear", t_range,
                                                 WAVE_THREADS)
            got = {k: v.launches for k, v in kernels.items()}
            st = wave_stats_of(waves)
            est = paged.expr_fused_stats()
        want_paths = {("wave" if k == "percall" else k): v
                      for k, v in paths[band].items()}
        if got["B1"] < 1 or got["B1"] > len(boxes) or st.get("failed") \
                or est["paths"] != want_paths:
            raise AssertionError(f"14a waves {band}: launches {got}, "
                                 f"waves {st}, stats {est}")
        diff = [int(np.count_nonzero(a != b))
                for a, b in zip(per_call[band], tiles)]
        if max(diff) > 65536 // 1000:
            raise AssertionError(f"14a waves {band}: bodies differ from per "
                                 f"call by {diff}")
        b1_total += got["B1"]
        log(f"phase 14a {band} in waves: {len(boxes)} tiles from "
            f"{WAVE_THREADS} threads, {len(boxes) / wall:.1f} tiles/s, p50 "
            f"{np.median(lat) * 1e3:.2f} ms, p90 "
            f"{np.percentile(lat, 90) * 1e3:.2f} ms; B1 launches "
            f"{got['B1']} ({got['B1'] / len(boxes):.3f} a tile), occupancy "
            f"{st['occupancy']}, superblock lanes {st['superblock_lanes']}; "
            f"bytes differing from per call {sum(diff)}; expr_fused_stats "
            f"{est} ({card})")
    return b1_total, b1_args


def time_expr_b1(args, card):
    """B1's device time at phase 14a's first NDVI tile (n_ns 2, its four
    granules' union windows; the pool it read, nothing staging into it
    now), beside its plain version and its bound."""
    from gsky_tpu_torch.ops import paged
    pool, tables, params, sx, sy, method, n_ns, sb_of = args
    saved = paged.paged_render_kernel.launches
    ms = kernel_device_ms(lambda: paged.paged_render_scored(
        pool, tables, params, sx, sy, method, n_ns, sb_of), "paged_render")
    pms = cuda_time_ms(lambda: paged.paged_render_scored_plain(
        pool, tables, params, sx, sy, method, n_ns, sb_of), reps=3)
    paged.paged_render_kernel.launches = saved
    nbytes = bound_bytes(sx, sy, params, method, n_ns,
                         tables.numel() * 4)
    bd = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"timing B1 at an NDVI tile ({method}, n_ns {n_ns}, T="
        f"{tables.shape[1]} S={tables.shape[2]}): device {ms:.5f} ms, "
        f"plain {pms:.3f}, bound {bd:.5f} ms ({nbytes} bytes) ({card})")
    return ms, pms, bd


def phase_ows_expr(root, store, card):
    """Phase 14c over phase 10's archive: the two expression layers
    without a mask over HTTP (serial ladder), `EXPR_HTTP_TILES` tiles
    each, one B1 launch a tile; two tiles each from the CPU server."""
    dates = [t for _, t in mosaic_dates()]
    t_range = (dates[-2] - DAY, dates[-1] + DAY)
    layers = [{"name": name, "data_source": root, "rgb_products": [band],
               "resample": "bilinear"}
              for name, band in (("ndvi", NDVI), ("threshold", EXPR_THR))]
    boxes = mosaic_boxes()[:EXPR_HTTP_TILES]
    pair = OwsPair(os.path.join(root, "conf_expr"), layers, store)
    try:
        worst = {}
        for layer in ("ndvi", "threshold"):
            urls = [getmap_url(pair.base, layer, b, "", t_range)
                    for b in boxes]
            http_get(urls[0])
            bodies = run_route(pair, layer, urls, {"B1": len(urls)}, card,
                               phase="14c")
            worst[layer] = max(
                same_decoded("bilinear", body, pair.cpu_body(url), layer)
                for url, body in zip(urls[:HTTP_CPU_TILES],
                                     bodies[:HTTP_CPU_TILES]))
        log(f"phase 14c: expression layers, CPU server bodies match the "
            f"card's (decoded bytes differing, worst tile: {worst})")
    finally:
        pair.close()


def write_s2_archive(root, size=S2_SIZE):
    """Two Sentinel-2 L2A-shaped MGRS tiles (`S2_ORIGINS`), three bands
    each (B02, B03, B04: uint16 reflectance, nodata 0 over a corner
    collar), tiled, uncompressed, with overviews; [(path, band)]."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.geotiff import write_geotiff
    utm = parse_crs("EPSG:32755")
    yy = np.arange(size, dtype=np.float32)[:, None]
    xx = np.arange(size, dtype=np.float32)[None, :]
    collar = (xx + yy) < size // 8
    out = []
    for t, (x0, y0) in enumerate(S2_ORIGINS):
        gt = GeoTransform(x0, S2_RES, 0.0, y0, 0.0, -S2_RES)
        for b, band in enumerate(S2_BANDS):
            rng = np.random.default_rng(70 + 3 * t + b)
            field = (900.0 + 150.0 * b + 400.0
                     * np.sin(xx / (310.0 + 40 * b + 17 * t))
                     * np.cos(yy / (270.0 + 30 * b))).astype(np.uint16)
            field += rng.integers(0, 60, (size, size), dtype=np.uint16)
            field[collar] = 0
            p = os.path.join(root, f"T55HFA{t}_20200110_{band}.tif")
            write_geotiff(p, field, gt, utm, nodata=0, compress=False,
                          overviews=S2_OVERVIEWS)
            out.append((p, band))
            del field
    return out


def s2_boxes(x, y, zoom, nx, ny):
    """nx x ny 256-px EPSG:3857 tiles at ``zoom`` x the 10 m ground
    resolution from the UTM point (x, y) east and south."""
    return tile_boxes(x, y, zoom=zoom * S2_RES / 30.0, nx=nx, ny=ny)


def s2_routes(methods=("bilinear", "near", "cubic"), n=16, n_native=8,
              n_other=4):
    """Phase 14b's routes: name -> (boxes, the rung they take, B2 launches
    a tile), per method (bilinear all of them, near and cubic the first
    ``n_other``)."""
    x1 = S2_ORIGINS[1][0]
    inside = s2_boxes(610000.0, 6090000.0, S2_ZOOM, 4, n // 4)
    # one column straddling the overlap strip: every tile over both
    overlap = s2_boxes(x1 + 100.0, 6095000.0, S2_ZOOM, 1, n)
    native = s2_boxes(650000.0, 6050000.0, 1.0, 4, n_native // 4)
    routes = {}
    for m in methods:
        k = None if m == "bilinear" else n_other
        routes[("rgba", m)] = (inside[:k], "rgba", 0)
        routes[("planes", m)] = (overlap[:k], "planes", 1)
        routes[("modular", m)] = (native[:k], "modular", 1)
    return routes


def rgb_request(root, box, method):
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    return GeoTileRequest(collection=root, bands=list(S2_STYLE),
                          bbox=BBox(*box), crs=parse_crs("EPSG:3857"),
                          width=256, height=256, resample=method)


def render_rgb(pipe, root, boxes, method):
    """RGB tiles as the serial GetMap ladder serves them: `render_rgb_auto`
    ("rgba" (H, W, 4) or "planes" (3, H, W)), else `process` and auto
    `scale_to_byte` per band ("modular").  ([(rung, host array)],
    per-tile seconds)."""
    import torch
    from gsky_tpu_torch.ops.scale import scale_to_byte
    out, secs = [], []
    for box in boxes:
        req = rgb_request(root, box, method)
        t0 = time.perf_counter()
        made = pipe.render_rgb_auto(req)
        if made is None:
            res = pipe.process(req)
            arr = torch.stack([scale_to_byte(res.data[n], res.valid[n],
                                             auto=True)
                               for n in res.namespaces[:3]])
            made = ("modular", arr)
        arr = made[1].cpu().numpy()
        secs.append(time.perf_counter() - t0)
        empty = not arr[..., 3].any() if made[0] == "rgba" \
            else (arr == 255).all()
        if arr.dtype != np.uint8 or empty:
            raise AssertionError(f"14b {made[0]}: an empty tile {box}")
        out.append((made[0], arr))
    return out, secs


def phase_rgb(root, store, card, routes=None):
    """Phase 14b: `s2_routes()` through `TilePipeline(device="cuda")` (the
    serial RGB ladder): 16 tiles at `S2_ZOOM` inside one MGRS tile, the
    RGBA rung (no kernel); 16 over the two tiles' overlap, the planes
    rung (one B2 launch a tile); 8 native tiles, whose full-size bands
    the scene cache does not take, the modular route (decoded windows,
    one B2 a tile); bilinear, plus 4 near and 4 cubic each.  Every
    route's kernel counts, set to 0 before it, equal its predicted
    launches.  Returns (the B2 launches, the first bilinear planes-rung
    launch's arguments)."""
    from gsky_tpu_torch.ops import warp_render
    kernels = _kernel_counts()
    routes = routes or s2_routes()
    pipe = make_pipeline(store, "cuda")
    # set-up outside the timing: scene loads, every tile's control grid
    t0 = time.perf_counter()
    for (rung, m), (boxes, _, _) in routes.items():
        if m == "bilinear":
            render_rgb(pipe, root, boxes, m)
    log(f"phase 14b: set-up (scenes at the 2x overview, every tile's "
        f"control grid) {time.perf_counter() - t0:.1f} s; cache "
        f"{len(pipe.executor.cache._scenes)} scenes")
    b2_total = 0
    for (rung, m), (boxes, want_rung, b2_each) in routes.items():
        for k in kernels.values():
            k.launches = 0
        plain = PlainCalls()
        orig = warp_render.warp_render_scored
        seen = []
        warp_render.warp_render_scored = \
            lambda *a: seen.append(a) or orig(*a)
        t0 = time.perf_counter()
        try:
            tiles, lat = render_rgb(pipe, root, boxes, m)
        finally:
            warp_render.warp_render_scored = orig
            plain.remove()
        if (rung, m) == ("planes", "bilinear"):
            b2_args = seen[0]
        wall = time.perf_counter() - t0
        got = {k: v.launches for k, v in kernels.items()}
        want = {"B1": 0, "B2": b2_each * len(boxes), "B3": 0, "B4": 0}
        rungs = {r for r, _ in tiles}
        if rungs != {want_rung} or got != want or plain.calls:
            raise AssertionError(f"14b {rung} {m}: rungs {rungs}, launches "
                                 f"{got} (want {want}), plain {plain.calls}")
        b2_total += got["B2"]
        log(f"phase 14b {rung} {m}: {len(boxes)} tiles, "
            f"{len(boxes) / wall:.1f} tiles/s, p50 "
            f"{np.median(lat) * 1e3:.2f} ms, p90 "
            f"{np.percentile(lat, 90) * 1e3:.2f} ms; launches {got} "
            f"({card})")
    return b2_total, b2_args


def time_planes_b2(args, card):
    """B2's device time at phase 14b's first planes-rung tile (n_ns 4, six
    scenes of the 2x overview), beside its plain version and its pixel
    and sector bounds."""
    from gsky_tpu_torch.ops import warp_render
    scenes, sx, sy, p16, method, n_ns = args
    saved = warp_render.warp_render_kernel.launches
    ms = kernel_device_ms(lambda: warp_render.warp_render_scored(
        scenes, sx, sy, p16, method, n_ns), "warp_render")
    pms = cuda_time_ms(lambda: warp_render.warp_render_scored_plain(
        scenes, sx, sy, p16, method, n_ns), reps=3)
    warp_render.warp_render_kernel.launches = saved
    other = other_bytes(sx, p16, n_ns)
    px = tap_footprint_px(sx, sy, p16, method)
    sec = tap_sectors(sx, sy, p16, method, scenes)
    bd_px = (4 * px + other) / HBM_BYTES_PER_S * 1e3
    bd_sec = (32 * sec + other) / HBM_BYTES_PER_S * 1e3
    log(f"timing B2 at an RGB planes tile ({method}, n_ns {n_ns}, B = "
        f"{len(scenes)} scenes of {tuple(scenes[0].shape)}): device "
        f"{ms:.5f} ms, plain {pms:.3f}; bounds {bd_px:.5f} ms ({px} "
        f"pixels) and {bd_sec:.5f} ms ({sec} sectors), + {other} bytes of "
        f"other operands ({card})")
    return ms, pms, bd_px, bd_sec


def phase_ows_rgb(root, store, card, routes=None):
    """Phase 14c over phase 14b's archive: the true-colour layer over
    HTTP (serial ladder), `S2_HTTP_TILES` tiles per rung bilinear with
    the rung's launches; two tiles per rung from the CPU server."""
    routes = routes or s2_routes(("bilinear",))
    layers = [{"name": "s2_truecolour", "data_source": root,
               "rgb_products": S2_STYLE, "resample": "bilinear"}]
    pair = OwsPair(os.path.join(root, "conf"), layers, store)
    t_range = (S2_DATE - DAY, S2_DATE + DAY)
    try:
        worst = {}
        for (rung, m), (boxes, _, b2_each) in routes.items():
            urls = [getmap_url(pair.base, "s2_truecolour", b, "", t_range)
                    for b in boxes[:S2_HTTP_TILES]]
            http_get(urls[0])
            bodies = run_route(pair, f"RGB {rung}", urls,
                               {"B2": b2_each * len(urls)}, card,
                               phase="14c")
            worst[rung] = max(
                same_decoded(m, body, pair.cpu_body(url), rung)
                for url, body in zip(urls[:HTTP_CPU_TILES],
                                     bodies[:HTTP_CPU_TILES]))
        log(f"phase 14c: RGB layer, CPU server bodies match the card's "
            f"(decoded bytes differing, worst tile per rung: {worst})")
    finally:
        pair.close()


# -- phases 15-16: WCS GetCoverage, DAP4 and WPS Execute over HTTP ---------

WCS_SIZE = 4096              # 15a: BASELINE config 4, 16 tiles of 1024
WCS_TILE = 1024              # the layers' wcs_max_tile_width / height
WCS_STREAM_SIZE = 5120       # 15d: past WCS_STREAM_PIXELS: streamed
WCS_DAP = 2048               # 15d: the DAP4 and NetCDF coverages
WCS_MASKED = 1024            # 15d: the masked coverage, tiles of half
WCS_NODATA = -9999.0
WCS_T = (1578614400.0, 1578960000.0)       # 2020-01-10 .. 01-14
WPS_DRILLS = 10


def wcs_box(px, zoom=1.0, x0=500000.0 + 9000.0 + 12000.0,
            y0=6200000.0 - 9000.0 - 12000.0):
    """An EPSG:3857 box of px x px pixels at ``zoom`` times the native
    ground resolution from the UTM point (x0, y0) east and south (phase
    3's tiles start there)."""
    (x, y0m, _, y1m), = tile_boxes(x0, y0, zoom, 1, 1)
    size = (y1m - y0m) / 256 * px
    return (x, y1m - size, x + size, y1m)


def wcs_url(base, layer, box, px, style="", fmt="GeoTIFF",
            time_range=WCS_T):
    return (f"{base}/ows?service=WCS&request=GetCoverage&version=1.0.0"
            f"&coverage={layer}&styles={style}&crs=EPSG:3857"
            f"&bbox={','.join(repr(float(v)) for v in box)}"
            f"&width={px}&height={px}&format={fmt}"
            f"&time={iso(time_range[0])},{iso(time_range[1])}")


def http_fetch(url, data=None):
    """(status, headers, body, seconds) of one request over a socket."""
    import urllib.request
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                timeout=600) as r:
        body = r.read()
        return r.status, r.headers, body, time.perf_counter() - t0


def tiff_values(body):
    """Every band of a GeoTIFF body, (bands, H, W) float32."""
    import io
    from gsky_tpu_torch.io.geotiff import GeoTIFF
    t = GeoTIFF(io.BytesIO(body))
    try:
        return np.stack([np.asarray(t.read(b + 1), np.float32)
                         for b in range(t.count)])
    finally:
        t.close()


def same_coverage(method, a, b, what):
    """Two coverages: nodata at the same pixels, the rest bit-exact for
    nearest and within 2 ulp otherwise.  Returns max |difference|."""
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape} {b.shape}")
    nd = a == WCS_NODATA
    if not np.array_equal(nd, b == WCS_NODATA):
        raise AssertionError(f"{what}: nodata differs at "
                             f"{int(np.count_nonzero(nd != (b == WCS_NODATA)))}"
                             f" pixels")
    d = np.abs(a.astype(np.float64) - b)
    if method == "near" and d.any():
        raise AssertionError(f"{what}: near not bit-exact")
    tol = 2 * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    if (d > tol).any():
        raise AssertionError(f"{what}: {int((d > tol).sum())} values over "
                             f"2 ulp, worst {float(d.max())}")
    return float(d.max())


def near_coverage(a, b, what, rel=1e-5, frac=1e-3):
    """Card vs CPU over the masked route (eager PyTorch warps on both):
    nodata at the same pixels but for ``frac`` of them, the values both
    hold within ``rel``.  Returns (pixels whose validity differs, max
    relative difference)."""
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape} {b.shape}")
    va, vb = a != WCS_NODATA, b != WCS_NODATA
    nd = int(np.count_nonzero(va != vb))
    both = va & vb
    d = np.abs(a[both].astype(np.float64) - b[both]) / np.maximum(
        np.abs(a[both]), 1e-30)
    worst = float(d.max()) if d.size else 0.0
    if nd > frac * a.size or worst > rel:
        raise AssertionError(f"{what}: validity differs at {nd} pixels, "
                             f"values by rel {worst}")
    return nd, worst


def coverage_ok(a, px, what, max_nodata=0.5):
    if a.shape != (1, px, px) or not np.isfinite(a).all():
        raise AssertionError(f"{what}: shape {a.shape} or non-finite")
    share = float((a == WCS_NODATA).mean())
    if share > max_nodata:
        raise AssertionError(f"{what}: {share:.3f} of the coverage nodata")
    return share


def reset_counts(kernels):
    for k in kernels.values():
        k.launches = 0


def read_counts(kernels):
    return {n: k.launches for n, k in kernels.items()}


class CheckWide:
    """While installed, the first B1 and the first B2 launch of each
    method whose output is ``hw`` is held against its plain version on
    the same inputs (on the card): `check_pair`'s bounds.  ``errs``
    maps (kernel, method) to the max |canvas difference|.  For the
    methods in ``timed`` the launch is also timed there (`time_wide`):
    ``times`` maps (kernel, method) to (device ms, plain ms, bound ms,
    bound bytes).  The plain versions are the ones installed before it
    (`PlainCalls` counts the main path's calls of them, not these), and
    the timing launches leave the launch counts as they were."""

    def __init__(self, hw, timed=()):
        from gsky_tpu_torch.ops import paged, warp_render
        self.hw = tuple(hw)
        self.timed = tuple(timed)
        self.errs = {}
        self.times = {}
        self.mods = (paged, warp_render)
        self.b1, self.b2 = paged.paged_render_scored, \
            warp_render.warp_render_scored
        self.p1, self.p2 = paged.paged_render_scored_plain, \
            warp_render.warp_render_scored_plain
        paged.paged_render_scored = self._b1
        warp_render.warp_render_scored = self._b2

    def _b1(self, pool, tables, params, sx, sy, method, n_ns, sb_of=None):
        ck, bk = self.b1(pool, tables, params, sx, sy, method, n_ns, sb_of)
        if tuple(sx.shape[-2:]) == self.hw and ("B1", method) not in \
                self.errs:
            cp, bp = self.p1(pool, tables, params, sx, sy, method, n_ns,
                             sb_of)
            self.errs[("B1", method)] = check_pair(
                method, ck, bk, cp, bp, f"15b B1 {method} {self.hw}")
            if method in self.timed and sx.numel() == sx.shape[-1] * \
                    sx.shape[-2]:
                from gsky_tpu_torch.ops import paged
                args = (pool, tables, params, sx, sy, method, n_ns, sb_of)
                nbytes = bound_bytes(sx, sy, params, method, n_ns,
                                     tables.nbytes)
                self.times[("B1", method)] = time_wide(
                    paged.paged_render_kernel, "paged_render",
                    lambda: self.b1(*args), lambda: self.p1(*args), nbytes)
        return ck, bk

    def _b2(self, scenes, sx, sy, params, method, n_ns):
        ck, bk = self.b2(scenes, sx, sy, params, method, n_ns)
        if tuple(sx.shape[-2:]) == self.hw and ("B2", method) not in \
                self.errs:
            cp, bp = self.p2(scenes, sx, sy, params, method, n_ns)
            self.errs[("B2", method)] = check_pair(
                method, ck, bk, cp, bp, f"15b B2 {method} {self.hw}")
            if method in self.timed:
                from gsky_tpu_torch.ops import warp_render
                args = (scenes, sx, sy, params, method, n_ns)
                nbytes = bound_bytes(sx, sy, params, method, n_ns)
                self.times[("B2", method)] = time_wide(
                    warp_render.warp_render_kernel, "warp_render",
                    lambda: self.b2(*args), lambda: self.p2(*args), nbytes)
        return ck, bk

    def remove(self):
        paged, warp_render = self.mods
        paged.paged_render_scored = self.b1
        warp_render.warp_render_scored = self.b2


def time_wide(counter, name, kernel, plain, nbytes):
    """(device ms, plain ms, bound ms, bound bytes) of one launch of
    ``kernel`` at a main path's inputs, warm L2, beside its plain
    version; ``counter``'s launches are left as they were."""
    saved = counter.launches
    ms = kernel_device_ms(kernel, name)
    pms = cuda_time_ms(plain, reps=3)
    counter.launches = saved
    return ms, pms, nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def lonlat_of(box):
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox, transform_bbox
    c = transform_bbox(BBox(*box), parse_crs("EPSG:3857"),
                       parse_crs("EPSG:4326"))
    return [c.xmin, c.ymin, c.xmax, c.ymax]


def phase_wcs(data_root, store, card):
    """Phase 15a-d over phase 3's archive, the port's OWS server on the
    card over HTTP with the default serving path (waves on).  Returns
    {"B1": n, "B2": n} launched by the exports, and the 15b errors."""
    from gsky_tpu_torch.server import ows
    conf = os.path.join(ROOT, "build", "smoke_wcs_conf")
    styles = [{"name": m, "title": m, "rgb_products": [NS], "resample": m}
              for m in METHODS]
    dap_box = wcs_box(WCS_DAP)
    tiles = ((WCS_SIZE + WCS_TILE - 1) // WCS_TILE) ** 2
    stream_tiles = ((WCS_STREAM_SIZE + WCS_TILE - 1) // WCS_TILE) ** 2
    layers = [
        {"name": "landsat", "data_source": data_root, "rgb_products": [NS],
         "styles": styles, "default_geo_bbox": lonlat_of(dap_box),
         "default_geo_size": [WCS_DAP, WCS_DAP],
         "wcs_max_tile_width": WCS_TILE, "wcs_max_tile_height": WCS_TILE},
        {"name": "landsat_256", "data_source": data_root,
         "rgb_products": [NS], "styles": styles,
         "wcs_max_tile_width": 256, "wcs_max_tile_height": 256},
    ]
    launches = _kernel_counts()
    total = {"B1": 0, "B2": 0}

    def legs_ok(what, got, n):
        """Every one of an export's ``n`` tiles took a leg: a declined
        tile is one B2 launch (one source CRS), a paged one a lane of a
        B1 wave launch."""
        st = srv.last_export
        eng, dec = st["paged_engaged"], st["paged_declined"]
        if eng + dec != n or got["B2"] != dec or bool(eng) != \
                bool(got["B1"]):
            raise AssertionError(f"{what}: {n} tiles, legs {eng} paged "
                                 f"{dec} declined, launches {got}")

    def counted(what, fn, want_b=1):
        reset_counts(launches)
        plain = PlainCalls()
        try:
            out = fn()
        finally:
            plain.remove()
        got = read_counts(launches)
        if plain.calls or got["B3"] or got["B4"]:
            raise AssertionError(f"{what}: launches {got}, plain calls "
                                 f"{plain.calls}")
        if got["B1"] + got["B2"] < want_b:
            raise AssertionError(f"{what}: launches {got}, want at least "
                                 f"{want_b} B1 + B2")
        total["B1"] += got["B1"]
        total["B2"] += got["B2"]
        return out, got

    with WavesOn():
        pair = OwsPair(conf, layers, store)
        srv = pair.card
        try:
            # -- 15a: config 4 ------------------------------------------
            box = wcs_box(WCS_SIZE)
            mpix = WCS_SIZE * WCS_SIZE / 1e6
            ref = None
            for method, label in (("cubic", "cold"), ("cubic", "warm"),
                                  ("near", "warm"), ("bilinear", "warm")):
                url = wcs_url(pair.base, "landsat", box, WCS_SIZE, method)
                sp0 = dict(srv.spans)
                (status, hdr, body, secs), got = counted(
                    f"15a {method}", lambda: http_fetch(url))
                if (status, hdr["Content-Type"]) != (200, "image/geotiff"):
                    raise AssertionError(f"15a: {status} {body[:300]}")
                a = tiff_values(body)
                nd = coverage_ok(a, WCS_SIZE, f"15a {method}")
                legs_ok(f"15a {method}", got, tiles)
                st = srv.last_export
                sp = {k: srv.spans[k] - sp0[k] for k in srv.spans}
                log(f"phase 15a {method} ({label}): {WCS_SIZE}x{WCS_SIZE} "
                    f"GetCoverage over HTTP {secs:.3f} s, "
                    f"{mpix / secs:.2f} Mpix/s, body {len(body)} B, nodata "
                    f"{nd:.4f}; launches {got} for {st['tiles']} tiles "
                    f"(paged engaged {st['paged_engaged']}, declined "
                    f"{st['paged_declined']}, gated {st['paged_gated']}); "
                    f"stage busy s: decode {st['decode_s']:.3f}, warp "
                    f"{st['warp_s']:.3f}, encode {st['encode_s']:.3f}, "
                    f"engine wall {st['wall_s']:.3f}; queue high-water "
                    f"warp {st.get('warp_queue_max')}, encode "
                    f"{st.get('encode_queue_max')}; scenes warmed "
                    f"{st['scenes_warmed']}, dedup saved "
                    f"{st['dedup_saved']}; server s: parse "
                    f"{sp['parse']:.3f}, render {sp['render']:.3f}, encode "
                    f"(GeoTIFF) {sp['encode']:.3f} ({card})")
                if method == "cubic":
                    if ref is not None and not np.array_equal(ref, a):
                        raise AssertionError("15a: warm cubic differs")
                    ref = a
            os.environ["GSKY_EXPORT_PIPELINE"] = "0"
            try:
                url = wcs_url(pair.base, "landsat", box, WCS_SIZE, "cubic")
                (status, _, body, secs), got = counted(
                    "15a serial", lambda: http_fetch(url))
            finally:
                del os.environ["GSKY_EXPORT_PIPELINE"]
            if status != 200 or not np.array_equal(tiff_values(body), ref):
                raise AssertionError("15a: GSKY_EXPORT_PIPELINE=0 body "
                                     "differs from the engine's")
            log(f"phase 15a cubic GSKY_EXPORT_PIPELINE=0 (tile by tile): "
                f"{secs:.3f} s, {mpix / secs:.2f} Mpix/s, launches {got}; "
                f"decoded body identical to the engine's ({card})")
            del ref

            # -- 15b: kernels at 1024 x 1024 against their plain versions
            chk = CheckWide((WCS_TILE, WCS_TILE),
                            timed=("bilinear", "cubic"))
            try:
                for method in METHODS:
                    for zoom in (1.0, 0.25):
                        # inside every granule, past the nodata collars
                        url = wcs_url(pair.base, "landsat",
                                      wcs_box(WCS_TILE, zoom, 551000.0,
                                              6149000.0), WCS_TILE,
                                      method)
                        (status, _, body, _), _ = counted(
                            f"15b {method} {zoom}",
                            lambda: http_fetch(url), 1)
                        coverage_ok(tiff_values(body), WCS_TILE,
                                    f"15b {method}")
            finally:
                chk.remove()
            want = {(k, m) for k in ("B1", "B2") for m in METHODS}
            if set(chk.errs) != want:
                raise AssertionError(f"15b: checked {sorted(chk.errs)}")
            log(f"phase 15b: B1 (a {WCS_TILE}^2 tile at 0.25x the native "
                f"ground resolution, paged) and B2 (a native one, "
                f"declined) against their plain versions on the same "
                f"inputs: max |difference| " + ", ".join(
                    f"{k} {m} {v:.3g}" for (k, m), v in
                    sorted(chk.errs.items())) + " (near bit-exact, "
                "<= 2 ulp otherwise)")
            for (k, m), (ms, pms, bd, nb) in sorted(chk.times.items()):
                log(f"timing 15b {k} {m} at {WCS_TILE}^2: device {ms:.5f} "
                    f"ms warm L2, plain {pms:.3f} ms, bound {bd:.5f} ms "
                    f"({nb} bytes: the taps' source pixels and the other "
                    f"operands) ({card})")
            if len(chk.times) != 4:
                raise AssertionError(f"15b: timed {sorted(chk.times)}")
            errs = chk.errs

            # -- 15c: card vs CPU, 1024 x 1024 in 256 x 256 tiles ---------
            t0 = time.perf_counter()
            for method in METHODS:
                url = wcs_url(pair.base, "landsat_256", wcs_box(1024), 1024,
                              method)
                (status, _, body, _), got = counted(
                    f"15c {method}", lambda: http_fetch(url), 1)
                cpu = tiff_values(pair.cpu_body(url))
                d = same_coverage(method, tiff_values(body), cpu,
                                  f"15c {method}")
                log(f"phase 15c {method}: 16 tiles of 256 x 256, launches "
                    f"{got}; CPU coverage within bounds (max |difference| "
                    f"{d:.3g})")
            log(f"phase 15c: {time.perf_counter() - t0:.1f} s")

            # -- 15d: the other legs --------------------------------------
            from gsky_tpu_torch.io.geotiff import GeoTIFFWriter
            sbox = wcs_box(WCS_STREAM_SIZE)
            url = wcs_url(pair.base, "landsat", sbox, WCS_STREAM_SIZE,
                          "bilinear")
            regions = []
            real = GeoTIFFWriter.write_region

            def spy(self, x0, y0, data):
                regions.append((x0, y0))
                return real(self, x0, y0, data)

            GeoTIFFWriter.write_region = spy
            try:
                (status, hdr, body, secs), got = counted(
                    "15d stream", lambda: http_fetch(url))
            finally:
                GeoTIFFWriter.write_region = real
            legs_ok("15d stream", got, stream_tiles)
            streamed = tiff_values(body)
            coverage_ok(streamed, WCS_STREAM_SIZE, "15d stream")
            if len(regions) != stream_tiles or \
                    int(hdr["Content-Length"]) != len(body):
                raise AssertionError(f"15d: {len(regions)} regions streamed")
            saved = ows.WCS_STREAM_PIXELS
            ows.WCS_STREAM_PIXELS = WCS_STREAM_SIZE ** 2
            try:
                (_, _, body2, secs2), _ = counted(
                    "15d in RAM", lambda: http_fetch(url))
            finally:
                ows.WCS_STREAM_PIXELS = saved
            if not np.array_equal(tiff_values(body2), streamed):
                raise AssertionError("15d: streamed GeoTIFF differs from "
                                     "the in-RAM leg")
            del streamed
            left = [f for f in os.listdir(srv.temp_dir)
                    if f.startswith(("wcs_", "dap_"))]
            log(f"phase 15d streamed GeoTIFF {WCS_STREAM_SIZE}^2: {secs:.3f}"
                f" s ({WCS_STREAM_SIZE ** 2 / 1e6 / secs:.2f} Mpix/s), "
                f"{stream_tiles} regions through write_region, launches "
                f"{got}; the same "
                f"request in RAM {secs2:.3f} s, decoded identical; temp "
                f"files left {len(left)} ({card})")
            if left:
                raise AssertionError(f"15d: temp files left {left}")

            gurl = wcs_url(pair.base, "landsat", dap_box, WCS_DAP, "near")
            (_, _, gbody, _), _ = counted("15d tif", lambda: http_fetch(gurl))
            want = tiff_values(gbody)[0]
            nurl = gurl.replace("format=GeoTIFF", "format=NetCDF")
            (status, hdr, nbody, secs), got = counted(
                "15d netcdf", lambda: http_fetch(nurl), 1)
            path = os.path.join(ROOT, "build", "smoke_wcs.nc")
            with open(path, "wb") as fp:
                fp.write(nbody)
            from gsky_tpu_torch.io.netcdf import NetCDF
            nc = NetCDF(path)
            try:
                nv = np.asarray(nc.read_slice(NS, None), np.float32)
            finally:
                nc.close()
                os.remove(path)
            if hdr["Content-Type"] != "application/x-netcdf" or \
                    not np.array_equal(nv, want):
                raise AssertionError("15d: NetCDF values differ from the "
                                     "GeoTIFF's")
            log(f"phase 15d NetCDF {WCS_DAP}^2: {secs:.3f} s, launches {got}, "
                f"values equal the GeoTIFF export's ({card})")

            ll = lonlat_of(wcs_box(WCS_DAP * 3 // 4))
            ce = (f"landsat{{{NS}}} | {ll[0]} < x < {ll[2]}, "
                  f"{ll[1]} < y < {ll[3]}, time >= {iso(WCS_T[0])}")
            from urllib.parse import quote
            durl = f"{pair.base}/ows?dap4.ce={quote(ce)}"
            (status, hdr, dbody, secs), got = counted(
                "15d dap4", lambda: http_fetch(durl), 1)
            if hdr.get("Transfer-Encoding") != "chunked" or \
                    hdr["Content-Type"] != \
                    "application/vnd.opendap.org.dap4.data":
                raise AssertionError(f"15d dap4: headers {dict(hdr)}")
            os.environ["GSKY_DAP_STREAM"] = "0"
            try:
                (_, _, inram, _), _ = counted(
                    "15d dap4 in RAM",
                    lambda: (0, None, pair.card.handle(
                        "/ows", {"dap4.ce": [ce]}, "").read(), 0.0))
            finally:
                del os.environ["GSKY_DAP_STREAM"]
            if dbody != inram:
                raise AssertionError("15d: streamed DAP4 differs from the "
                                     "in-RAM body")
            log(f"phase 15d DAP4 streamed ({WCS_DAP}^2 default size, "
                f"{srv.last_export['tiles']} tiles): {secs:.3f} s, {len(dbody)} B "
                f"chunked, launches "
                f"{got}; re-assembled equal to the in-RAM encode_dap4 body "
                f"({card})")

            abox = wcs_box(600)
            aurl = wcs_url(pair.base, "landsat", abox, 0, "near")
            (status, _, abody, secs), got = counted(
                "15d auto", lambda: http_fetch(aurl), 1)
            a = tiff_values(abody)
            if status != 200 or not 500 < a.shape[1] < 700 or \
                    not np.isfinite(a).all():
                raise AssertionError(f"15d auto-size: {a.shape}")
            log(f"phase 15d auto-size (width = height = 0): "
                f"{a.shape[2]} x {a.shape[1]} for a 600-pixel native box, "
                f"{secs:.3f} s, launches {got}")
        finally:
            pair.close()
            shutil.rmtree(conf, ignore_errors=True)
    return total, errs


def phase_wcs_masked(root, store, card):
    """Phase 15d's masked export over phase 10's archive: 1024 x 1024 in
    tiles of 512 through the engine's masked route (B4).  Returns the
    B4 launches."""
    mask = {"id": "pixel_qa", "bit_tests": CLOUD_SHADOW}
    layers = [{"name": "masked_b4", "data_source": root,
               "rgb_products": ["LC08_B4"], "resample": "bilinear",
               "mask": mask, "wcs_max_tile_width": WCS_MASKED // 2,
               "wcs_max_tile_height": WCS_MASKED // 2}]
    dates = mosaic_dates()
    t_range = (dates[0][1] - 86400.0, dates[-1][1] + 86400.0)
    box = wcs_box(WCS_MASKED, x0=600000.0, y0=6100000.0)
    launches = _kernel_counts()
    pair = OwsPair(os.path.join(root, "wcs_conf"), layers, store)
    try:
        url = wcs_url(pair.base, "masked_b4", box, WCS_MASKED, "",
                      time_range=t_range)
        reset_counts(launches)
        status, hdr, body, secs = http_fetch(url)
        got = read_counts(launches)
        a = tiff_values(body)
        share = coverage_ok(a, WCS_MASKED, "15d masked")
        cpu = tiff_values(pair.cpu_body(url))
        nd, rel = near_coverage(a, cpu, "15d masked card vs CPU")
        if got["B4"] < 4 or got["B1"] or got["B2"]:
            raise AssertionError(f"15d masked: launches {got}")
        log(f"phase 15d masked GetCoverage {WCS_MASKED}^2 (4 tiles): "
            f"{secs:.3f} s, launches {got}, nodata {share:.4f}; CPU: "
            f"validity differs at {nd} pixels, values within rel "
            f"{rel:.3g} ({card})")
        return got["B4"]
    finally:
        pair.close()


def phase_wps(root, store, card):
    """Phase 16 over phase 7's stack: WPS Execute (an XML POST) over
    HTTP, `WPS_DRILLS` times, the stack resident; the CSV equals
    `drill_csv(DrillPipeline.process_split(...))` called directly.
    Returns the B3 launches."""
    from xml.etree import ElementTree
    from gsky_tpu_torch.geo import geometry as geom
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.pipeline.drill import DrillPipeline, drill_csv
    from gsky_tpu_torch.pipeline.types import GeoDrillRequest
    from gsky_tpu_torch.server.config import ConfigWatcher
    from gsky_tpu_torch.server.ows import OWSServer
    conf = os.path.join(root, "wps_conf")
    os.makedirs(conf)
    with open(os.path.join(conf, "config.json"), "w") as fp:
        json.dump({"service_config": {"mas_address": "in-process"},
                   "layers": [],
                   "processes": [{"identifier": "ndvi_drill",
                                  "approx": False,
                                  "data_sources": [{
                                      "data_source": root,
                                      "rgb_products": ["ndvi"]}]}]}, fp)
    client = MASClient(store)
    srv = OWSServer(ConfigWatcher(conf, lambda a: client,
                                  install_signal=False),
                    lambda a: client, device="cuda", gateway=None)
    httpd = srv.serve("127.0.0.1", 0)
    g = geom.from_wkt(DRILL_POLY)
    gj = json.dumps({"type": "Polygon", "coordinates": [
        r.tolist() for r in g.polys[0]]})
    body = (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<wps:Execute service="WPS" version="1.0.0" '
        'xmlns:wps="http://www.opengis.net/wps/1.0.0" '
        'xmlns:ows="http://www.opengis.net/ows/1.1">'
        "<ows:Identifier>ndvi_drill</ows:Identifier><wps:DataInputs>"
        "<wps:Input><ows:Identifier>geometry</ows:Identifier><wps:Data>"
        f"<wps:ComplexData>{gj}</wps:ComplexData></wps:Data></wps:Input>"
        "</wps:DataInputs></wps:Execute>").encode()
    launches = _kernel_counts()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/ows?service=WPS"
    try:
        http_fetch(url, body)           # the first: the stack's upload
        lat = []
        reset_counts(launches)
        plain = PlainCalls()
        try:
            for _ in range(WPS_DRILLS):
                status, hdr, out, secs = http_fetch(url, body)
                lat.append(secs)
        finally:
            plain.remove()
        got = read_counts(launches)
        if status != 200 or got["B3"] < WPS_DRILLS or plain.calls \
                or got["B1"] or got["B2"]:
            raise AssertionError(f"16: {status}, launches {got}, plain "
                                 f"{plain.calls}")
        ns = {"wps": "http://www.opengis.net/wps/1.0.0"}
        blocks = [el.text for el in ElementTree.fromstring(out).iterfind(
            ".//wps:ComplexData", ns)]
        req = GeoDrillRequest(collection=root, bands=["ndvi"],
                              geometry_wkt=geom.from_geojson(gj).to_wkt(),
                              approx=False)
        res = DrillPipeline(MASClient(store), device="cuda") \
            .process_split(req, 0)
        want = drill_csv(res, list(res.values))
        if blocks != [want] or len(want.splitlines()) != DRILL_T:
            raise AssertionError("16: the WPS CSV differs from drill_csv "
                                 "of a direct process_split")
        wall = sum(lat)
        log(f"phase 16: WPS Execute (POST) over HTTP, {WPS_DRILLS} drills "
            f"of {DRILL_T} steps: {WPS_DRILLS / wall:.2f} drills/s, p50 "
            f"{np.median(lat) * 1e3:.2f} ms, p90 "
            f"{np.percentile(lat, 90) * 1e3:.2f} ms; launches {got}; CSV "
            f"({len(want)} B) equal to drill_csv of a direct "
            f"process_split ({card})")
        return got["B3"]
    finally:
        httpd.shutdown()
        httpd.server_close()


# -- phase 17: the serving gateway and the rest of the WMS surface ---------

GW_THREADS = 16              # 17a: client threads asking for one tile
GW_REQUESTS = 32             # 17a: their requests
GW_TILES = 16                # 17a: tiles timed as misses, then as hits
JPEG_NATIVE = 16             # 17a: JPEG tiles through B1
JPEG_PLANES = 8              # 17a: JPEG tiles through the planes rung (B2)
GFI_FUSED = 16               # 17a: GetFeatureInfo clicks through B1
GFI_MASKED = 8               # 17b: clicks on the masked layer (B4)
# the first natural-order row of the quality-85 tables (libjpeg's
# scaling of Annex K's), luminance and chrominance
JPEG_Q85_ROW0 = ((5, 3, 3, 5, 7, 12, 15, 18), (5, 5, 7, 14, 30, 30, 30, 30))


def http_status(url, headers=None):
    """(status, headers, body, seconds) of one GET over a socket, a 304
    or an error status included."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(
                urllib.request.Request(url, headers=headers or {}),
                timeout=120) as r:
            body = r.read()
            return r.status, dict(r.headers), body, \
                time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read(), time.perf_counter() - t0


def jpeg_header(body):
    """(height, width, ((id, h, v, tq), ...), [first natural-order row
    of each DQT table]) of a baseline JPEG."""
    import struct
    if body[:2] != b"\xff\xd8" or body[-2:] != b"\xff\xd9":
        raise AssertionError("not a JPEG")
    i, sof, rows = 2, None, []
    while True:
        marker = body[i + 1]
        n = struct.unpack(">H", body[i + 2:i + 4])[0]
        p = body[i + 4:i + 2 + n]
        if marker == 0xC0:
            _, h, w, nc = struct.unpack(">BHHB", p[:6])
            sof = (h, w, tuple((p[6 + 3 * c], p[7 + 3 * c] >> 4,
                                p[7 + 3 * c] & 15, p[8 + 3 * c])
                               for c in range(nc)))
        elif marker == 0xDB:
            # zig-zag positions of the natural order's first row
            rows.append(tuple(p[1 + z] for z in (0, 1, 5, 6, 14, 15, 27,
                                                 28)))
        elif marker == 0xDA:
            return sof + (rows,)
        i += 2 + n


def check_jpeg(body, components, what):
    h, w, comps, rows = jpeg_header(body)
    want_comps = ((1, 1, 1, 0),) if components == 1 else \
        ((1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1))
    if (h, w, comps) != (256, 256, want_comps) or \
            tuple(rows) != JPEG_Q85_ROW0[:min(components, 2)]:
        raise AssertionError(f"{what}: JPEG header {h}x{w} {comps} {rows}")


def info_url(base, layer, box, i, j, style="", time_range=None):
    q = (f"service=WMS&request=GetFeatureInfo&version=1.3.0&layers={layer}"
         f"&query_layers={layer}&styles={style}&crs=EPSG:3857"
         f"&bbox={','.join(repr(float(v)) for v in box)}"
         f"&width=256&height=256&i={i}&j={j}&info_format=application/json")
    if time_range:
        q += f"&time={iso(time_range[0])},{iso(time_range[1])}"
    return f"{base}/ows?{q}"


def same_info(method, card_body, cpu_body, what):
    """GetFeatureInfo card vs CPU: the same keys, "n/a" at the same
    pixels, dates equal, values equal for nearest and within 2 ulp of
    float32 otherwise.  Returns the count of valued namespaces."""
    a = json.loads(card_body)["features"][0]["properties"]
    b = json.loads(cpu_body)["features"][0]["properties"]
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: {a} against {b}")
    n = 0
    for k, v in a.items():
        w = b[k]
        if k == "available_dates" or v == "n/a" or w == "n/a" \
                or method == "near":
            ok = v == w
        else:
            iv, iw = (int(np.array([x], np.float32).view(np.int32)[0])
                      for x in (v, w))
            ok = abs(iv - iw) <= 2
        if not ok:
            raise AssertionError(f"{what}: {k} {v} against {w}")
        n += k != "available_dates" and v != "n/a"
    return n


def counted_urls(urls, want, what, kernels, headers=None):
    """GET ``urls`` serially (with ``headers``) with every kernel count
    set to 0 just before and no plain version called; the counts after
    must equal ``want``.  Returns the answers."""
    reset_counts(kernels)
    plain = PlainCalls()
    try:
        res = [http_status(u, headers) for u in urls]
    finally:
        plain.remove()
    got = read_counts(kernels)
    full = {k: want.get(k, 0) for k in kernels}
    if got != full or plain.calls:
        raise AssertionError(f"{what}: launches {got}, want {full}, plain "
                             f"calls {plain.calls}")
    bad = [r[:2] for r in res if r[0] not in (200, 304)]
    if bad:
        raise AssertionError(f"{what}: {bad[0]}")
    return res


def ms_stats(secs):
    return (f"p50 {np.median(secs) * 1e3:.3f} ms, p90 "
            f"{np.percentile(secs, 90) * 1e3:.3f} ms")


def phase_ows_gateway(data_root, store, card):
    """Phase 17a over phase 3's archive, the port's OWS server on the card
    over HTTP with a private `ServingGateway`, under the per-call
    settings of phases 3-12 (GSKY_WAVES=0): single-flight, hits, 304,
    misses against hits, a reload; JPEG through B1 and the planes rung
    (B2); GetFeatureInfo through B1; legends and DescribeLayer; each
    against a CPU server.  Returns the launches {"B1", "B2"}."""
    import threading
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor
    from gsky_tpu_torch.io.png import encode_jpeg, encode_png
    from gsky_tpu_torch.serving import ServingGateway
    if os.environ.get("GSKY_WAVES") != "0":
        raise AssertionError("phase 17 runs with GSKY_WAVES=0")
    conf = os.path.join(ROOT, "build", "smoke_gw_conf")
    legend = os.path.join(ROOT, "build", "smoke_legend.png")
    with open(legend, "wb") as fp:
        fp.write(encode_png([np.repeat(np.arange(0, 256, 4, dtype=np.uint8)
                                       [None], 12, axis=0)]))
    styles = [{"name": m, "title": m, "rgb_products": [NS], "resample": m}
              for m in METHODS]
    layers = [
        {"name": "landsat", "data_source": data_root, "rgb_products": [NS],
         "styles": styles, "feature_info_max_dates": 4},
        {"name": "grey3", "data_source": data_root,
         "rgb_products": [NS, NS, NS], "resample": "near"},
        {"name": "palette", "data_source": data_root, "rgb_products": [NS],
         "palette": {"interpolate": True, "colours": [
             {"R": 0, "G": 0, "B": 128, "A": 255},
             {"R": 40, "G": 200, "B": 40, "A": 200},
             {"R": 255, "G": 255, "B": 0, "A": 255}]}},
        {"name": "legend_file", "data_source": data_root,
         "rgb_products": [NS], "legend_path": legend},
    ]
    kernels = _kernel_counts()
    total = {"B1": 0, "B2": 0}
    boxes = tile_boxes()
    gw = ServingGateway()
    pair = OwsPair(conf, layers, store, gateway=gw)
    srv = pair.card
    try:
        # -- 17a gateway: one uncached tile from 16 threads ----------------
        url = getmap_url(pair.base, "landsat", boxes[5], "bilinear")
        fl, jn, hits = gw.flight.leaders, gw.flight.joined, gw.cache.hits
        barrier = threading.Barrier(GW_THREADS)

        def client(_):
            barrier.wait()
            return [http_status(url)
                    for _ in range(GW_REQUESTS // GW_THREADS)]
        reset_counts(kernels)
        plain = PlainCalls()
        try:
            with ThreadPoolExecutor(GW_THREADS) as ex:
                res = [r for rs in ex.map(client, range(GW_THREADS))
                       for r in rs]
        finally:
            plain.remove()
        got = read_counts(kernels)
        leaders, joined = gw.flight.leaders - fl, gw.flight.joined - jn
        hit = gw.cache.hits - hits
        tags = Counter(h.get("X-Gsky-Cache") for _, h, _, _ in res)
        bodies = {b for _, _, b, _ in res}
        if any(r[0] != 200 for r in res) or len(bodies) != 1 or \
                got != {"B1": 1, "B2": 0, "B3": 0, "B4": 0} or \
                plain.calls or leaders != 1 or \
                joined + hit != GW_REQUESTS - 1 or tags["miss"] != 1 or \
                tags["join"] + tags["hit"] != GW_REQUESTS - 1:
            raise AssertionError(
                f"17a single-flight: launches {got}, leaders {leaders}, "
                f"joined {joined}, hits {hit}, tags {dict(tags)}, "
                f"{len(bodies)} bodies")
        total["B1"] += 1
        body = bodies.pop()
        # the same server with no gateway renders the same bytes
        srv.gateway = None
        try:
            (raw,) = counted_urls([url], {"B1": 1}, "17a raw", kernels)
        finally:
            srv.gateway = gw
        total["B1"] += 1
        if raw[2] != body or "X-Gsky-Cache" in raw[1]:
            raise AssertionError("17a: the raw server's body differs")
        (again,) = counted_urls([url], {}, "17a repeat", kernels)
        etag = again[1]["ETag"]
        (nm,) = counted_urls([url], {}, "17a 304", kernels,
                             {"If-None-Match": etag})
        if again[1]["X-Gsky-Cache"] != "hit" or again[2] != body or \
                nm[0] != 304 or nm[2] or nm[1].get("Content-Length") != "0" \
                or nm[1].get("ETag") != etag:
            raise AssertionError(f"17a: repeat {again[:2]}, "
                                 f"If-None-Match {nm[:2]}")
        log(f"phase 17a: {GW_REQUESTS} requests for one uncached tile from "
            f"{GW_THREADS} threads: 1 B1 launch, leaders {leaders}, joined "
            f"{joined}, hits {hit} ({dict(tags)}); bodies equal the raw "
            f"server's; a repeat is a hit with 0 launches, If-None-Match a "
            f"304 with no body")
        urls = [getmap_url(pair.base, "landsat", b, "bilinear")
                for b in boxes[8:8 + GW_TILES]]
        miss = counted_urls(urls, {"B1": GW_TILES}, "17a misses", kernels)
        total["B1"] += GW_TILES
        hitr = counted_urls(urls, {}, "17a hits", kernels)
        if any(h[1]["X-Gsky-Cache"] != "hit" or h[2] != m[2]
               for h, m in zip(hitr, miss)) or \
                any(m[1]["X-Gsky-Cache"] != "miss" for m in miss):
            raise AssertionError("17a: misses then hits")
        log(f"phase 17a over HTTP, {GW_TILES} native bilinear tiles: miss "
            f"{ms_stats([m[3] for m in miss])}, hit "
            f"{ms_stats([h[3] for h in hitr])} ({card})")
        with open(pair.conf_path) as fp:
            cfg = json.load(fp)
        for st in cfg["layers"][0]["styles"]:
            st["clip_value"] = 4000.0           # the tile's scaling
        with open(pair.conf_path, "w") as fp:
            json.dump(cfg, fp)
        inv = gw.cache.invalidations
        pair.watcher.reload()
        (fresh,) = counted_urls([url], {"B1": 1}, "17a reload", kernels)
        total["B1"] += 1
        if gw.cache.invalidations <= inv or \
                fresh[1]["X-Gsky-Cache"] != "miss" or fresh[2] == body:
            raise AssertionError(
                f"17a: the reload did not re-render: invalidations "
                f"{inv} -> {gw.cache.invalidations}, "
                f"{fresh[1].get('X-Gsky-Cache')}, body "
                f"{'equal' if fresh[2] == body else 'differs'}")
        log(f"phase 17a: a reload that changed the layer invalidated "
            f"{gw.cache.invalidations - inv} entries; the tile rendered "
            f"again (1 B1 launch); gateway {gw.stats()}")

        # -- 17a JPEG -----------------------------------------------------
        jurls = [getmap_url(pair.base, "landsat", b, "near").replace(
            "image/png", "image/jpeg") for b in boxes[:JPEG_NATIVE]]
        purls = [getmap_url(pair.base, "grey3", b).replace(
            "image/png", "image/jpg") for b in boxes[16:16 + JPEG_PLANES]]
        for name, us, want, comps in (
                ("native (B1)", jurls, {"B1": JPEG_NATIVE}, 1),
                ("planes rung (B2)", purls, {"B2": JPEG_PLANES}, 3)):
            enc0 = srv.spans["encode"]
            t0 = time.perf_counter()
            res = counted_urls(us, want, f"17a JPEG {name}", kernels)
            wall = time.perf_counter() - t0
            for k, v in want.items():
                total[k] += v
            for r in res:
                if r[1].get("Content-Type") != "image/jpeg":
                    raise AssertionError(f"17a JPEG: {r[1]}")
                check_jpeg(r[2], comps, f"17a JPEG {name}")
            for u, r in zip(us[:HTTP_CPU_TILES], res):
                if pair.cpu_body(u) != r[2]:
                    raise AssertionError(f"17a JPEG {name}: the card's "
                                         f"bytes differ from the CPU's")
            log(f"phase 17a JPEG {name}: {len(us)} tiles, "
                f"{len(us) / wall:.2f} tiles/s, "
                f"{ms_stats([r[3] for r in res])}, encode "
                f"{(srv.spans['encode'] - enc0) / len(us) * 1e3:.4f} ms a "
                f"tile; headers parsed (256 x 256, sampling, DQT); "
                f"{HTTP_CPU_TILES} bodies equal the CPU server's ({card})")
        rng = np.random.default_rng(17)
        yy, xx = np.mgrid[0:256, 0:256]
        rgb = [np.clip(128 + 90 * np.sin(xx / (7.0 + c)) * np.cos(yy / 11.0)
                       + rng.normal(0, 12, (256, 256)), 0, 255)
               .astype(np.uint8) for c in range(3)]
        enc = []
        for _ in range(20):
            t0 = time.perf_counter()
            encode_jpeg(rgb)
            enc.append(time.perf_counter() - t0)
        log(f"phase 17a: encode_jpeg of a 256 x 256 RGB tile on the host: "
            f"median {np.median(enc) * 1e3:.3f} ms of 20")

        # -- 17a GetFeatureInfo --------------------------------------------
        clicks = [("near" if k < GFI_FUSED // 2 else "bilinear", boxes[k],
                   (37 * k + 5) % 256, (91 * k + 13) % 256)
                  for k in range(GFI_FUSED)]
        iurls = [info_url(pair.base, "landsat", b, i, j, m)
                 for m, b, i, j in clicks]
        res = counted_urls(iurls, {"B1": GFI_FUSED}, "17a GetFeatureInfo",
                           kernels)
        total["B1"] += GFI_FUSED
        valued = sum(same_info(m, r[2], pair.cpu_body(u), "17a info")
                     for (m, _, _, _), u, r in zip(clicks, iurls, res))
        if valued < GFI_FUSED // 2:
            raise AssertionError(f"17a GetFeatureInfo: {valued} values")
        log(f"phase 17a GetFeatureInfo: {GFI_FUSED} clicks, "
            f"{ms_stats([r[3] for r in res])}, {GFI_FUSED} B1 launches; "
            f"{valued} values equal the CPU server's (near exact, "
            f"bilinear <= 2 ulp) ({card})")

        # -- 17a legends and DescribeLayer ----------------------------------
        docs = [f"{pair.base}/ows?service=WMS&request=GetLegendGraphic"
                f"&layer={n}&format=image/png" for n in ("legend_file",
                                                         "palette")]
        docs.append(f"{pair.base}/ows?service=WMS&request=DescribeLayer"
                    f"&version=1.1.1&layers=landsat,grey3")
        res = counted_urls(docs, {}, "17a documents", kernels)
        host = pair.base.split("://", 1)[1]
        for u, r in zip(docs, res):
            if r[2] != pair.cpu_body(u, host):
                raise AssertionError(f"17a: {u} differs from the CPU's")
        with open(legend, "rb") as fp:
            if res[0][2] != fp.read():
                raise AssertionError("17a: the legend file was not sent")
        log("phase 17a: the legend file, the palette legend and "
            "DescribeLayer equal the CPU server's")
    finally:
        pair.close()
        shutil.rmtree(conf, ignore_errors=True)
        os.remove(legend)
    return total


def phase_ows_gateway_masked(root, store, card):
    """Phase 17b over phase 10's archive: GetFeatureInfo on the masked
    layer (pixel_qa bit tests), one B4 launch a click, against a CPU
    server.  Returns the B4 launches."""
    from gsky_tpu_torch.serving import ServingGateway
    mask = {"id": "pixel_qa", "bit_tests": CLOUD_SHADOW}
    layers = [{"name": "masked_b4", "data_source": root,
               "rgb_products": ["LC08_B4"], "resample": "bilinear",
               "mask": mask, "feature_info_max_dates": MOSAIC_DATES}]
    dates = mosaic_dates()
    t_range = (dates[0][1] - 86400.0, dates[-1][1] + 86400.0)
    boxes = mosaic_boxes()[:GFI_MASKED]
    pair = OwsPair(os.path.join(root, "conf_gw"), layers, store,
                   gateway=ServingGateway())
    try:
        urls = [info_url(pair.base, "masked_b4", b, (29 * k + 3) % 256,
                         (53 * k + 7) % 256, time_range=t_range)
                for k, b in enumerate(boxes)]
        res = counted_urls(urls, {"B4": GFI_MASKED},
                           "17b masked GetFeatureInfo", _kernel_counts())
        valued = sum(same_info("bilinear", r[2], pair.cpu_body(u),
                               "17b info") for u, r in zip(urls, res))
        dated = [json.loads(r[2])["features"][0]["properties"]
                 ["available_dates"] for r in res]
        if valued < GFI_MASKED // 2 or any(not d for d in dated):
            raise AssertionError(f"17b: {valued} values, dates {dated}")
        log(f"phase 17b GetFeatureInfo on the masked layer: {GFI_MASKED} "
            f"clicks, {ms_stats([r[3] for r in res])}, {GFI_MASKED} B4 "
            f"launches; {valued} values within 2 ulp of the CPU server's, "
            f"dates equal ({card})")
    finally:
        pair.close()
    return GFI_MASKED


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from gsky_tpu_torch.ops import (cuda_lib, first_valid, paged, stats,
                                    warp_render)
    t_start = time.perf_counter()
    card = card_facts()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    libs = [warp_render.LIBRARY, stats.LIBRARY, first_valid.LIBRARY]
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
    t0 = time.perf_counter()
    n_b1, direct, predicted = phase_b1_cases()
    if direct != predicted or direct == 0:
        raise AssertionError(f"phase 2: {direct} direct blocks, block_boxes "
                             f"predicts {predicted}")
    torch.cuda.synchronize()
    log(f"phase 2: {n_cmp} kernel-vs-plain comparisons passed; B1 on "
        f"64-slot windows: {n_b1} more, {direct} blocks read the pool "
        f"directly as block_boxes predicts ({predicted}) "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_wide, wide_err = phase_wide_ns()
    log(f"phase 2: B1 and B2 at n_ns {', '.join(str(n) for n, _ in WIDE_NS)}"
        f" with sparsely filled slots: {n_wide} comparisons bit-exact "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_wave, b3k_err = phase_wave_kernels()
    log(f"phase 2: wave forms: B1 with sb_of and B3's K-block form, "
        f"{n_wave} comparisons with their plain versions and their "
        f"per-call launches passed ({time.perf_counter() - t0:.1f} s)")

    # phases 3-12 measure the per-call path, their meaning since PR 1-7:
    # waves and the staged GetMap path off (phase 13 turns them on)
    os.environ["GSKY_WAVES"] = "0"
    os.environ["GSKY_TILE_PIPELINE"] = "0"

    # -- phase 3: end to end at real size -----------------------------
    data_root = os.path.join(ROOT, "build", "smoke_archive")
    shutil.rmtree(data_root, ignore_errors=True)
    os.makedirs(data_root)
    try:
        t0 = time.perf_counter()
        data_paths = write_archive(data_root)
        store = crawl((p, NS) for p in data_paths)
        log(f"phase 3: archive written + crawled in "
            f"{time.perf_counter() - t0:.1f} s")
        boxes = tile_boxes()
        pipe = make_pipeline(store, "cuda")
        # warm the scene cache (decode + upload of the 4 scenes) outside
        # the timed window: it is set-up, not tile latency
        t0 = time.perf_counter()
        render(pipe, data_root, boxes[:1], "near")
        log(f"phase 3: scene cache warm in {time.perf_counter() - t0:.1f} s")
        cap = CaptureB1()
        plain = PlainCalls()
        paged.paged_render_kernel.launches = 0
        warp_render.warp_render_kernel.launches = 0
        stats.masked_stats_kernel.launches = 0
        paged.reset_direct_blocks()
        card_tiles, lat = {}, []
        t0 = time.perf_counter()
        try:
            for method in METHODS:
                card_tiles[method], secs = render(pipe, data_root, boxes,
                                                  method)
                lat += secs
            wall = time.perf_counter() - t0
        finally:
            plain.remove()
            cap.remove()
        b1_launches = paged.paged_render_kernel.launches
        b2_main = warp_render.warp_render_kernel.launches
        direct = paged.direct_blocks()
        n_main = N_TILES * len(METHODS)
        if b1_launches != n_main or b2_main != 0 or plain.calls \
                or stats.masked_stats_kernel.launches:
            raise AssertionError(
                f"main path: B1 {b1_launches} (want {n_main}), B2 "
                f"{b2_main}, B3 {stats.masked_stats_kernel.launches}, "
                f"plain calls {plain.calls}")
        predicted = sum(predicted_direct_blocks(sx, sy, prm, m)
                        for sx, sy, prm, m in cap.args)
        if direct or predicted or len(cap.args) != n_main:
            raise AssertionError(
                f"main path: {direct} B1 blocks read the pool directly "
                f"(block_boxes predicts {predicted} over {len(cap.args)} "
                f"calls), want 0")
        del cap
        p50 = float(np.median(lat)) * 1e3
        log(f"phase 3: {n_main} tiles, {n_main / wall:.1f} tiles/s, p50 "
            f"{p50:.2f} ms, p90 {np.percentile(lat, 90) * 1e3:.2f} ms "
            f"({card}); B1 blocks over the staging budget 0 (predicted "
            f"0); pool {pipe.executor.pool.stats()}")

        spans, wall_ms, dev_ms, b1_ms = stage_breakdown(
            pipe, data_root, boxes, "bilinear")
        paged.paged_render_kernel.launches = b1_launches
        log("phase 3 breakdown, bilinear, ms per tile: " + ", ".join(
            f"{k} {v:.4f}" for k, v in spans.items()) +
            f"; wall {wall_ms:.4f}; device busy {dev_ms:.5f} "
            f"({100 * dev_ms / wall_ms:.2f}% of wall), of which B1 "
            f"{b1_ms:.5f} ({card})")

        # -- phase 4: the decline leg through B2 ------------------------
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        log(f"phase 4: device memory before the decline phases: allocated "
            f"{base} B, peak so far {torch.cuda.max_memory_allocated()} B")
        torch.cuda.reset_peak_memory_stats()
        plain = PlainCalls()
        os.environ["GSKY_PAGE_SLOTS"] = "1"
        warp_render.warp_render_kernel.launches = 0
        paged.paged_render_kernel.launches = 0
        decl, first_decline = {}, None
        try:
            for method in METHODS:
                decl[method], secs = render(pipe, data_root, boxes[:2], method)
                if first_decline is None:       # a group's first decline
                    first_decline = secs[0]
        finally:
            del os.environ["GSKY_PAGE_SLOTS"]
        b2_forced = warp_render.warp_render_kernel.launches
        plain.remove()
        if b2_forced != 2 * len(METHODS) or plain.calls \
                or paged.paged_render_kernel.launches:
            raise AssertionError(f"decline leg: B2 {b2_forced}, plain "
                                 f"{plain.calls}")
        for method in METHODS:
            compare_tiles(method, card_tiles[method][:2], decl[method],
                          "B2 vs B1")
        log(f"phase 4: {b2_forced} tiles through B2, bytes match B1; the "
            f"first (the group's first decline) took "
            f"{first_decline * 1e3:.3f} ms")

        # -- phase 4b: zoomed-out tiles decline at default settings -----
        t0 = time.perf_counter()
        zoom_tiles, zoom_lat, b2_launches = phase_zoomed(pipe, data_root)
        log(f"phase 4b: {b2_launches} tiles at {', '.join(map(str, ZOOMS))}x "
            f"the native ground resolution all declined to B2 (B2 launches "
            f"{b2_launches}, B1 0, plain calls 0); p50 "
            f"{np.median(zoom_lat) * 1e3:.2f} ms, p90 "
            f"{np.percentile(zoom_lat, 90) * 1e3:.2f} ms "
            f"({time.perf_counter() - t0:.1f} s; {card})")
        npg = phase_gate(pipe, data_root)
        log(f"gate: a tile whose windows need {npg} pages, with "
            f"GSKY_PAGE_SLOTS=32, declined through the VMEM gate alone "
            f"(32-slot page list)")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log(f"decline phases (4, 4b, gate): device memory peak {peak} B, "
            f"{peak - base} B over the {base} B allocated before them")
        # what the dense-stack decline leg paid on a group's first
        # decline: a copy of the group's scenes
        scenes = [s.dev for s in tile_group(pipe, data_root, boxes[0]).scenes]
        t0 = time.perf_counter()
        stacked = torch.stack(scenes)
        torch.cuda.synchronize()
        stack_first = (time.perf_counter() - t0) * 1e3
        nbytes = stacked.numel() * 4
        del stacked
        stack_warm = cuda_time_ms(lambda: torch.stack(scenes), reps=5)
        del scenes
        torch.cuda.empty_cache()
        log(f"torch.stack of the group's four scenes ({nbytes} B): "
            f"{stack_first:.3f} ms first (allocation included), "
            f"{stack_warm:.4f} ms warm ({card})")

        # -- phase 5: card vs CPU ---------------------------------------
        cpu = make_pipeline(store, "cpu")
        t0 = time.perf_counter()
        for method in METHODS:
            got, _ = render(cpu, data_root, boxes[:2], method)
            compare_tiles(method, card_tiles[method][:2], got, "card vs cpu")
            for zoom in ZOOMS:
                got, _ = render(cpu, data_root, zoom_boxes(zoom)[:2], method)
                compare_tiles(method, zoom_tiles[(zoom, method)][:2], got,
                              f"card vs cpu at {zoom}x")
        log(f"phase 5: CPU tiles match the card, native and at "
            f"{', '.join(map(str, ZOOMS))}x "
            f"({time.perf_counter() - t0:.1f} s)")
        del cpu

        # -- kernel timing at the main path's shapes --------------------
        ex = pipe.executor
        tables, tab_d, p16_d, sx, sy = main_operands(pipe, data_root,
                                                     boxes[0])
        dev = torch.device("cuda")
        b1_rows = []
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=dev)
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
                ms1c = kernel_device_ms(b1, "paged_render",
                                        between=flush.zero_)
                call1, pms1 = cuda_time_ms(b1), cuda_time_ms(b1p, reps=3)
                paged.paged_render_kernel.launches = saved
            by1 = bound_bytes(sx, sy, p16_d, method, 1, tables.nbytes)
            bd1 = by1 / HBM_BYTES_PER_S * 1e3
            b1_rows.append((method, err1, ms1, pms1, bd1))
            log(f"timing {method}: B1 device {ms1:.5f} ms warm L2, "
                f"{ms1c:.5f} ms cold L2 (per call with host {call1:.4f}, "
                f"plain {pms1:.3f}), bound {bd1:.5f} ms ({by1} bytes) "
                f"[T={tables.shape[0]} S={tables.shape[1]}] ({card})")
        b2_rows = time_b2(pipe, data_root, boxes[0], flush, card)
        del flush

        # -- phase 12a: the OWS front end over HTTP ----------------------
        t0 = time.perf_counter()
        http_a = phase_ows_fused(data_root, data_paths, card)
        log(f"phase 12a: {sum(http_a.values())} GetMap requests over HTTP "
            f"passed ({time.perf_counter() - t0:.1f} s)")

        # -- phase 13a: concurrent tiles in waves -------------------------
        t0 = time.perf_counter()
        b1_waves, wave_args = phase_wave_tiles(pipe, data_root, boxes,
                                               card_tiles, card)
        time_b1_wave(pipe, wave_args, b1_rows[1][2], card)
        del wave_args
        log(f"phase 13a: {time.perf_counter() - t0:.1f} s")

        # -- phase 15a-d: WCS GetCoverage and DAP4 over HTTP --------------
        t0 = time.perf_counter()
        wcs_launches, wcs_errs = phase_wcs(data_root, store, card)
        log(f"phase 15: launches {wcs_launches} "
            f"({time.perf_counter() - t0:.1f} s)")

        # -- phase 17a: the gateway, JPEG, GetFeatureInfo over HTTP -------
        t0 = time.perf_counter()
        gw_launches = phase_ows_gateway(data_root, store, card)
        log(f"phase 17a: launches {gw_launches} "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(data_root, ignore_errors=True)

    # -- phases 6-8: the drill and kernel B3 -------------------------
    n_b3, b3_err = phase_b3_kernel()
    log(f"phase 6: {n_b3} B3-vs-plain comparisons bit-exact")
    drill_root = os.path.join(ROOT, "build", "smoke_drill")
    shutil.rmtree(drill_root, ignore_errors=True)
    os.makedirs(drill_root)
    try:
        b3_launches, b3_args, b3_wave_launches, b3_wps = phase_drill(
            drill_root, card)
        b3_row = time_b3(b3_args, card)
    finally:
        shutil.rmtree(drill_root, ignore_errors=True)

    # -- phases 9-11: the masked temporal mosaic and kernel B4 ---------
    n_b4 = phase_b4_kernel()
    log(f"phase 9: {n_b4} B4-vs-plain comparisons bit-exact")
    mosaic_root = os.path.join(ROOT, "build", "smoke_mosaic")
    shutil.rmtree(mosaic_root, ignore_errors=True)
    os.makedirs(mosaic_root)
    try:
        mosaic = mosaic_store(mosaic_root)
        b4_launches, b4_args = phase_mosaic(mosaic_root, mosaic, card)
        b4_row = time_b4(b4_args, card)
        del b4_args

        # -- phase 15d: a masked layer's GetCoverage (B4) -----------------
        t0 = time.perf_counter()
        b4_wcs = phase_wcs_masked(mosaic_root, mosaic, card)
        log(f"phase 15d masked: {time.perf_counter() - t0:.1f} s")

        # -- phase 12b: masked layers over HTTP --------------------------
        t0 = time.perf_counter()
        phase_ows_masked(mosaic_root, mosaic, card)
        log(f"phase 12b: masked GetMap requests over HTTP passed "
            f"({time.perf_counter() - t0:.1f} s)")

        # -- phase 13b: TIME animations over HTTP -------------------------
        t0 = time.perf_counter()
        b1_anim = phase_anim(mosaic_root, mosaic, card)
        log(f"phase 13b: {time.perf_counter() - t0:.1f} s")

        # -- phase 14a, 14c: fused band algebra ---------------------------
        t0 = time.perf_counter()
        b1_expr, b1_expr_args = phase_expr(mosaic_root, mosaic, card)
        time_expr_b1(b1_expr_args, card)
        del b1_expr_args
        phase_ows_expr(mosaic_root, mosaic, card)
        log(f"phase 14a, 14c expressions: {time.perf_counter() - t0:.1f} s")

        # -- phase 17b: GetFeatureInfo on the masked layer (B4) -----------
        t0 = time.perf_counter()
        b4_gfi = phase_ows_gateway_masked(mosaic_root, mosaic, card)
        log(f"phase 17b: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(mosaic_root, ignore_errors=True)

    # -- phase 14b, 14c: the Sentinel-2 RGB GetMap ----------------------
    s2_root = os.path.join(ROOT, "build", "smoke_s2")
    shutil.rmtree(s2_root, ignore_errors=True)
    os.makedirs(s2_root)
    try:
        t0 = time.perf_counter()
        s2_paths = write_s2_archive(s2_root)
        s2 = crawl(s2_paths)
        size = sum(os.path.getsize(p) for p, _ in s2_paths)
        log(f"phase 14b: {len(s2_paths)} GeoTIFFs ({size / 1e9:.3f} GB, "
            f"overviews {S2_OVERVIEWS}) written + crawled in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        b2_rgb, b2_rgb_args = phase_rgb(s2_root, s2, card)
        time_planes_b2(b2_rgb_args, card)
        del b2_rgb_args
        phase_ows_rgb(s2_root, s2, card)
        log(f"phase 14b, 14c RGB: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(s2_root, ignore_errors=True)

    # the kernels line reports the bilinear rows (the GetMap default
    # interpolated method): B1 at phase 3's tile, B2 at input (c), the
    # 4x zoomed-out tile; every method's and input's numbers are logged
    # above.  Launches: every main path's run, phase 13's wave runs
    # included (B1 over a wave's lanes, B3's K-block form), and phase
    # 14's (B1: expression tiles per call and in waves; B2: the RGB
    # planes rung and the modular route), and phase 17's (B1: gateway
    # misses, JPEG tiles and clicks; B2: JPEG tiles of the planes rung;
    # B4: clicks on the masked layer)
    m, err1, ms1, pms1, bd1 = b1_rows[1]
    ms2, _, pms2, bd2, _, _ = b2_rows[("c", "bilinear")]
    b3_ms, b3_pms, b3_bd, b3_lib, b3_main_err = b3_row
    kernels = {"kernels": [
        {"name": "paged_render (B1)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/warp_render.cu",
         "replaces": "gsky_tpu/ops/paged.py:173",
         "launches": b1_launches + b1_waves + b1_anim + b1_expr
         + wcs_launches["B1"] + gw_launches["B1"],
         "max_abs_err": max(max(r[1] for r in b1_rows), wide_err,
                            max(v for (k, _), v in wcs_errs.items()
                                if k == "B1")),
         "ms": ms1, "plain_ms": pms1, "bound_ms": bd1,
         "bound_by": "bytes", "library_ms": None},
        {"name": "warp_render (B2)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/warp_render.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:456",
         "launches": b2_launches + b2_rgb + wcs_launches["B2"]
         + gw_launches["B2"],
         "max_abs_err": max(max(r[5] for r in b2_rows.values()),
                            wide_err,
                            max(v for (k, _), v in wcs_errs.items()
                                if k == "B2")),
         "ms": ms2, "plain_ms": pms2, "bound_ms": bd2,
         "bound_by": "bytes", "library_ms": None},
        {"name": "masked_stats (B3)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/masked_stats.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:362",
         "launches": b3_launches + b3_wave_launches + b3_wps,
         "max_abs_err": max(b3_err, b3_main_err, b3k_err),
         "ms": b3_ms, "plain_ms": b3_pms, "bound_ms": b3_bd,
         "bound_by": "bytes", "library_ms": b3_lib},
        {"name": "first_valid (B4)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/first_valid.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:308",
         "launches": b4_launches + b4_wcs + b4_gfi,
         "max_abs_err": b4_row[4],
         "ms": b4_row[0], "plain_ms": b4_row[1], "bound_ms": b4_row[2],
         "bound_by": "bytes", "library_ms": b4_row[3]},
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
