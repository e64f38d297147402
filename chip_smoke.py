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
   each again at every other tile of the ladder (phase 26), bit-exact
   to the default tile and its direct blocks as predicted at that tile;
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
   a tile per route from a second `OWSServer(device="cpu")` decodes
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
   its plain version on the same inputs; 15c a 512 x 512 export in
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
18. the grids and formats of satellite archives, written from fixed
   seeds with the port's writers under ``build/smoke_sat/``
   (GSKY_WAVES=0): 18a a Himawari-8 AHI 2 km full-disk band (5500 x
   5500 f32 NetCDF-3, CF geostationary mapping, space filled): 16
   native and 8 4x EPSG:3857 tiles over eastern Australia and 8 tiles
   on the western limb (part space); 18b eight MOD09A1-shaped
   HDF4-EOS sinusoidal h29v12 tiles (2400 x 2400 int16, DEFLATE): 16
   tiles bilinear and cubic over the 8 dates, then 8 warm polygon
   drills (B3, one a file); 18c a DEA-shaped Albers tile (4000 x 4000
   int16 GeoTIFF, EPSG:3577, 25 m): 16 tiles in EPSG:3857 and 4 in
   EPSG:3577; 18d two MODIS L1B-shaped swaths (2030 x 1354 f32 with
   2-D lon/lat, one at full resolution, one subsampled by 5): 16 fused
   tiles, 4 on the swath's edge and 8 masked by a QA band (B2 per
   geolocation group, then B4); 18e a 120 x 1000 x 1000 f32
   curvilinear stack: 10 warm drills (B3), and a WPS Execute of a VRT
   process over HTTP (host stats, no launch).  Per sub-phase: tiles/s
   or drills/s, p50, p90, launches (set to 0 just before), B1 blocks
   over the staging budget against `block_boxes`' prediction, host ms
   per stage and `_geoloc_ctrl`'s ms and steps; every request again
   on the CPU (tiles: nearest bytes equal, <= 0.1% otherwise; masked
   data <= 2 ulp; drills rel 1e-5); no plain-version call on the card.
   B1 and B2 against their plain versions at an AHI limb tile's and a
   swath edge tile's operands salted with NaN, +-inf and finite values
   past +-2**31.
19. the native codec, ranged ingest and a MAS over HTTP (GSKY_WAVES=0).
   19a: `gsky_tpu_torch/native/codec.cpp` built with the host C++
   compiler (its version logged); LZW streams of every code width
   (9-12, CLEARs mid-stream and on a full table, KwKwK codes), PackBits,
   predictor 2 (int16, uint8) and 3 (float32) decode as their plain
   Python versions do; LZW decode MB/s of both on one 512 x 512 int16
   tile.  19b: two acquisitions of LC08_B4, LC08_B5 (int16) and
   pixel_qa (uint16) at 7681 x 7821, EPSG:32755, 512^2 tiles, overviews
   2 and 4, LZW + predictor 2 (a test-side encoder: 9-bit literal
   codes), named ``LC8<path><row><year><doy>LGN00_<band>.TIF`` so that
   the crawler's built-in ``landsat`` rule dates them, crawled into a
   `MASShardedStore` and served by the port's masapi on 127.0.0.1; the
   card's `OWSServer` reaches it over HTTP (a config ``mas_address``, no
   ``mas_factory``): 16 fused tiles near and bilinear (staged LZW scene
   loads, one B1 each), 4 over the first date equal to the same raster
   uncompressed, 16 masked (ranged windows, one B4 each), 8 at 4x (the
   level-4 overview), 8 over LC08_B5 with GSKY_INGEST_WINDOW_FRAC=0.05
   (declined scenes: ranged windows through B2 until the fourth ask
   promotes a scene, as the reference's rule does); 4 fused tiles after
   a cache clear twice at GSKY_STAGING_MB=1024 (pinned, then reused
   buffers) and one scene load staged pageable, staged pinned and
   classic (bits equal); two tiles a route on a CPU server; the first
   B1, B2 and B4 launch of each route against its plain version; 0
   ranged-read fallbacks.  19c: WPS Execute over HTTP on a 120-step
   NetCDF-3 stack indexed through the masapi: the cold request reads
   its 120 windows ranged (no launch), warm ones go through B3 (its
   first launch bit-exact against the plain version), equal to the
   cold CSV and the CPU server's.
20. the serving path under load (phases 3-19 pin GSKY_PREFETCH=0, as
   the planner warms through the first server it saw).  Each sub-phase
   runs again on a CPU server (its own gateway) in the same
   environment: statuses, OGC exception codes and the Retry-After,
   X-GSKY-Degraded and X-Gsky-Cache headers equal, tiles decoded equal
   (nearest) or within 0.1% of bytes, drills within rel 1e-5.  The card
   server answers over HTTP with the process's `default_gateway`.
   Inside phase 3's block: 20a the render batcher (GSKY_WAVES=0,
   GSKY_RENDER_BATCH=1): 16 distinct native bilinear tiles from 16
   threads; each flush one B1 launch, the flush sizes summing to 16,
   the bodies equal to the same tiles per call, the first flush's
   launch equal to its plain version; 20b admission, fixed
   (GSKY_ADMIT_WMS=2, GSKY_ADMIT_QUEUE_S=0.05) then adaptive, 32
   distinct tiles from 16 threads: shed + 200s = 32, shed > 0, at most
   2 in use (polled), B1 launches = the 200s, every 503 ServerBusy with
   Retry-After 1; 20d pressure: force(1) answers ``brownout`` with the
   layer's overview (a hard link of one granule) and caches nothing;
   with waves on, 32 tiles from 16 threads in waves of at most half
   GSKY_WAVE_MAX; force(2) runs the relief once (scene and response
   caches empty), page staging declines and the next tile takes B2,
   its bytes its B1 tile's; force(None) and the label is gone; 20f a
   client pans 8 native tiles east with prefetch on (the default
   budget): hits, misses and wasted equal the CPU server's on the same
   keys, one B1 a tile, bodies equal the cold per-call ones.  Inside
   phase 10's block: 20c GSKY_FAULTS=decode:latency:2s on a masked
   layer with wms_timeout 1: 504 within 1.5 s, the render unwinds at
   its ``decode`` check, no B4; the next request 200 and one B4; a
   client that closes its socket 0.3 s into a 1 s decode: its token
   fires with ``client-disconnect``, no launch.  Inside phase 19: 20c
   a WPS drill under wcs_timeout 1 with mas:latency:2s: 504, the next
   drill 200 through B3; 20e over the masapi: mas:error:0.2 at seed 0,
   8 tiles all 200 with the CPU run's retries and faults; mas:error:1.0,
   a new tile 503 ServerBusy with Retry-After, an expired cached tile
   replayed ``stale`` (``stale-cache``), no launch.
21. observability on the card (`phase_obs`): traced and untraced tiles,
   ``/metrics`` against the launch counters, ``/debug/profile``.
22. the device guard, the prewarm and the encode pool (`phase_guard`,
   inside phase 3's block, GSKY_DEVICE_HANG_S=1 and
   GSKY_DEVICE_REINIT_BACKOFF=0.1,0.5): 22a the command line's server
   (``python -m gsky_tpu_torch.server.main``) in a process of its own,
   with prewarm and with GSKY_PREWARM=0: its prewarm line,
   ``gsky_compiles_total`` at listen and after one tile of each warmed
   shape (unmoved with prewarm), the first tile's latency; 22b 16 fused
   tiles from 4 threads in waves, then one at a time per call, each in
   rounds with GSKY_DEVICE_GUARD 1, 0, 0, 1 (p50, p90, tiles/s; bodies
   equal), and one guarded call's host cost (inline, a reused sync
   worker, a new thread a call); 22c injected incidents over HTTP,
   per call: ``device:crash`` (503 with Retry-After, suspect, then a
   rebuild: teardown, the probe on the card, every resident page
   rehydrated from the journal, the tile's bytes as before),
   ``device:oom`` (relief: pool trimmed, pressure escalated, the
   batcher's knee halved; the retry serves the tile), ``device:corrupt``
   on a GetCoverage (503; with GSKY_POOL_AUDIT=1 the audit's inf scan on
   the card quarantines a page the phase poisoned in the pool; the
   device stays healthy) and ``device:hang`` (503 after the 1 s
   watchdog); 22d the card's memory filled, then a tile: torch's own
   out-of-memory classified ``oom``, relief, the retry after the
   phase's OOM hook frees the filler; 22e the first wave's launch
   forced to fail: its entries served by their per-call leg (B2), the
   bodies those of healthy waves; 22f 32 tiles from 16 threads through
   the sized encode pool (wait and cpu phases, ``gsky_encode_pool_*``).
23. the fleet on one card (`Fleet`: worker nodes, ``python -m
   gsky_tpu_torch.worker.server``, each its own process and CUDA
   context, started together before phase 3 and used where their data
   is, each serving gRPC's ``gskyrpc.GDAL/Process``): 23a ``grpc``
   imports here (its version; the run fails without it); 23b (phase
   10's block) 16 masked tiles from 4 threads through an OWS server
   whose namespace names two workers, their bytes those of the same
   server's local modular route (B4 here, the warps on the workers),
   tiles/s, p50, p90, RPCs a tile, ``gsky_worker_rpc_seconds``,
   ``gsky_fleet_*`` and the locality rate, the RPC's split, the
   workers' device supervisors healthy (their kernels ran on gRPC's
   handler threads), and no decode child holding a CUDA context
   (nvidia-smi); and (phase
   18's block) 16 masked tiles of the curvilinear swath (B1/B2 on the
   workers, B4 here); 23c (phase 7's block) the worker's drill op over
   the stack, B3 on the worker, equal to this process's drill within
   rtol 1e-5; 23d a worker SIGKILLed mid-burst (every tile 200 with
   equal bytes, the node dead, reroutes > 0), then a worker with
   ``GSKY_FAULTS=node:latency:1.5s`` (hedges fired, equal bytes); 23e
   that worker SIGTERMed with RPCs in flight (no tile lost, exit 0),
   and the command line's OWS server SIGTERMed with 8 GetCoverage
   requests in flight (all 200, a request after the signal 503 with
   Retry-After, exit 0 within GSKY_DRAIN_TIMEOUT_S; phase 3's block);
   23f a master and two peer servers, each its own process, over phase
   3's archive: a 2048^2 GetCoverage over ``ows_cluster_nodes`` against
   the master's single-node export, then with a peer killed (its band
   rendered on the master, ``shard-fallback``), seconds and Mpix/s.
   The kernels line adds the workers' launches (their ``worker_info``).
24. the cache fabric and the elastic fleet on one card (phase 18's
   block; its three workers start after 23b's masked tiles and boot
   while phase 14b's archive is written), over phase 18d's MODIS L1B
   swath at 2030 x 1354, 16 tiles of
   256 x 256 at 1250 m, bilinear, each one B1 launch; workers with
   ``GSKY_FABRIC=1``, each with its own ``GSKY_POOL_JOURNAL``): 24a
   worker B loads the second granule first, A serves the 16 tiles
   (B1 on A), then a ``preempt`` RPC (grace 10 s, successor B): A
   drains, ships its journal and exits 0 inside the grace; B pulls the
   pages from A over ``page_fetch`` (``handoff_pages`` peer = the pages
   A held, cold 0, B's ``peer_filled`` > 0) and serves the same tiles
   (bytes equal to A's and to this process's local warp, 16 B1
   launches on B, no cold page stage); the hand-off's seconds and
   pages/s, B's first tile against A's, cold; 24b A restarted on its
   port and journal with ``GSKY_FABRIC_PAGE_PEERS`` naming B: its warm
   boot restores pages from B, its tiles' bytes the same; 24c a worker
   with ``GSKY_FAULTS=node:preempt:5s`` beside B under a 4-thread burst
   through a `WorkerClient`: every tile answered with equal bytes, the
   node out inside its grace (from its notice's log line to its exit),
   its ``gsky_preemptions_total`` counter (graceful) 1; 24d an
   `Autoscaler` over a `LocalSubprocessProvider` (min 1, max 3; its
   nodes start with empty journals and B as their page peer) driven by
   a `DemandSignal` of an admission controller under a burst: one
   scale-up whose node joins only when its readiness probe reports
   warm, its pool then holding B's hot set pulled from B (its warm
   boot's ``journal_export``, no cold stage), one scale-down that
   preempts a node with a hand-off, no failed tile,
   ``gsky_elastic_decisions_total`` equal to the autoscaler's record;
   24e (phase 3's block) two OWS servers on the replay ring: a tile
   rendered on its owner (one B1 launch, the wrapper's counter on its
   ``/debug``), replayed by the other
   (``X-Gsky-Cache: peer``, equal bytes, no launch), the fabric-off
   server's bytes the same with no ``gateway.fabric`` span, the owner
   killed and the other rendering itself (200, equal bytes).
25. multi-GPU serving on a *virtual* mesh: four members on the one card
   (``GSKY_MESH_DEVICES=cuda:0,cuda:0,cuda:0,cuda:0``), each on its own
   stream; every number is a one-card number.  25a (phase 3's block):
   its 32 native bilinear tiles from 16 threads over HTTP with waves on
   and ``GSKY_MESH=1`` (the granule layout): decoded tiles equal the
   unsharded waves', B1 launches equal the members' calls (each member
   at least one), ``gsky_mesh_waves_total{granule}``,
   ``gsky_mesh_chip_occupancy`` and ``gsky_mesh_chips`` read back from
   ``/metrics``; again with ``GSKY_MESH_PLACE=1``: per-member pools (the
   executor's own stages nothing), the journal's stage lines tagged per
   member, one member's pool torn down and restored by
   ``rehydrate_all``; 25b a 4096 x 4096 cubic GetCoverage at 4x the
   native ground resolution (its 16 blocks of 1024 paged, so they reach
   the wave) with ``GSKY_MESH_RULES`` sending them to x: values within
   2 ulp of the unsharded export, B2 launches = 16 blocks x 4 members,
   no B1; 25c (phase 7's block) four concurrent warm drills in one wave
   over the time layout: a B3 K-block launch a member, results equal
   per call; 25d ``GSKY_SPMD=1``: fused GetMap tiles over HTTP
   (``render_byte_spmd``, B2 a member, bytes equal to the single-device
   B2 leg), mosaics over phase 10's eight dates without a mask
   (``scene_mosaic_spmd``, canvases equal), a drill (B3 a member, psum;
   rtol 1e-5, counts equal) and a WPS drill over HTTP (200, where the
   port answered 501; CSV equal); 25e ``/debug``'s ``spmd`` and
   ``mesh`` blocks (``virtual``, 4 chips) and the prewarm's
   ``mesh_programs``.  Each part logs launches and bodies per member,
   the last wave's member skew and its wall time against the unsharded
   path.
26. the output tiles of B1 and B2 (phase 3's block, after 13a; the wave
   planner's `plan_block`) and the format registry's adapter tier.  26a, every
   tile of the ladder (`plan_blocks`) at phase 3's 256^2 tile (its four
   granules, and its first alone) per method, a bilinear wave of 10 of
   phase 3's tiles without and with ``sb_of``, 15b's 1024^2 tile at
   0.25x (B1) bilinear and cubic, B2's input (c) per method and 15b's
   native 1024^2 tile (B2) bilinear and cubic: canv and best
   bit-identical to the 8 x 32 launch and to the plain version, B1's
   blocks read from the pool directly equal to `block_boxes`' prediction
   at that tile, each tile's median device ms over 21 launches (CUDA
   events, each launch queued behind a spin of the card), and the tile
   `plan_block` picks marked, at most 1.05x the 8 x 32 time; 26b phase
   13's tiles in waves from 16 threads with GSKY_PLAN=1 and =0, over the
   default ladder and over one without 8 x 32 (every wave a planned
   tile): PNG bytes equal, ``gsky_plan_block_shape``'s gains by tile
   equal to B1's launches at that tile; 26c the prewarm over a config of
   phase 12a's layer, the same two ladders: each planned tile launched
   once at its lattice point, as its ``blocks`` report; 26d where PIL
   imports, a lossless JP2 with a .j2w (a PNG with a .pgw where PIL has
   no JPEG 2000 codec) crawled and served through B1, its tile
   byte-equal to a GeoTIFF's of the same pixels, or else the crawler's
   record of a JP2 naming the ImportError.  ``python3 chip_smoke.py
   --phase 26`` runs phase 1, phase 3's archive and phase 26 alone.
27. the soak on the card, through `tools/soak_torch.py`'s own scenario
   functions: 12 dates of one 7681 x 7821 int16 scene each, written
   uncompressed and crawled by the tool under ``build/smoke_soak/``
   (padded f32 on the card, more bytes than the scene cache's 2 GiB, so
   that it evicts), its churn for 30 s from 8 threads with the default
   serving path (waves, the staged GetMap path), native tiles (B1) and
   tiles of the reference's ground size, twice the native (B2 where
   their windows decline), then one lap
   of its wcs scenario (1024 x 1024 exports).  Both pass the tool's
   criteria: every request a 200, RSS and ``memory_allocated`` growth
   after the first quarter at most 256 MB each, the executor's caches
   and the scene cache's bytes within their bounds; the churn's server
   ends with no page pinned, no plain version runs on the main path,
   and the churn's first B1 and B2 launch of each method are held
   against their plain versions where they run.
   Logs the tool's JSON lines, tiles/s, the memory samples, the
   reserved and allocated peaks and the evictions.  ``python3
   chip_smoke.py --phase 27`` runs phase 1 and phase 27 alone.
28. the soak's overload, ingest and fleet over `SoakArchive`'s four
   Landsat-size dates, each held to the tool's criteria, no page
   pinned, no plain-version call, the first B1, B2 and B4 launch held
   against their plain versions (``--phase 28`` alone).
29. the soak's occupancy, algebra and animation over the same archive
   (`SOAK29_S`), each held to the tool's criteria but those read on
   the host's clock (the occupancy's gap comparison, reported: C.26),
   no page pinned, no plain-version call, the first B1 launch of each method and n_ns
   (expression lanes at n_ns 2 included) and the first B3 launch of
   each form held against their plain versions (``--phase 29`` alone).
30. the soak's fabric (``--seconds 20``) and elastic (``--seconds 30``)
   over the same archive, their worker nodes on the card (a process and
   a page journal each), each held to the tool's criteria, no page
   pinned, no plain-version call here, the first B1 launch (the seed
   laps, rendered here) and the first B4 launch (the remote tiles,
   mosaicked here) held against their plain versions, every node boot
   rendering on the card (``worker_info``'s ``platform``; the nodes'
   launches are reported: they warp in plain torch, as the reference's
   gather, and launch none).  Not in the default run (it boots
   9-11 node processes, 19-28 s each; phases 23 and 24 drive the fabric
   and elastic paths there): ``python3 chip_smoke.py --phase 30`` runs
   phase 1 and phase 30 alone, and prints its launches here and on the
   nodes as a JSON line.

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

import atexit
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from collections import Counter

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
CPU_TILES = 1                # 5: tiles a method and zoom held against the CPU
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


def predicted_direct_blocks(sx, sy, params, method, block=None):
    """`block_boxes`' count of B1 blocks of ``block`` = (rows, cols)
    (None: the default tile) that read the pool directly, over N tiles:
    sx/sy (N, h, w), params (N*T, 16)."""
    from gsky_tpu_torch.ops.paged import BLOCK, block_boxes
    T = params.shape[0] // sx.shape[0]
    total = 0
    for n in range(sx.shape[0]):
        _, fits = block_boxes(sx[n], sy[n], params[n * T:(n + 1) * T],
                              method, block or BLOCK)
        total += int((~fits).any(-1).sum())
    return total


def phase_b1_cases(dev="cuda"):
    """B1 against its plain version on 64-slot page windows of three
    1400 x 1400 scenes plus a padding row (`B1_CASES`): granule 0 a
    whole-scene window, granule 1 a window of page rows 2-7 and columns
    1-2 with an offset affine (boxes clip at its edges), granule 2 a
    narrower true extent.  Per call the kernel's direct-block count must
    equal `block_boxes`' prediction; each call again at every other tile
    of the ladder (`autoplan.plan_blocks`, phase 26), bit-identical to
    the default tile's, its direct blocks as `block_boxes` predicts at
    that tile.  Returns (comparisons, direct blocks counted, direct
    blocks predicted); the zoomed-out case must give a count > 0."""
    import torch
    from gsky_tpu_torch.ops import paged
    from gsky_tpu_torch.pipeline.autoplan import plan_blocks
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
                with pool.locked_pool() as parr:
                    cp, bp = paged.paged_render_scored_plain(
                        parr, tab_d, prm, sx, sy, method, n_ns)
                for tile in [paged.BLOCK] + [t for t in plan_blocks()
                                             if t != paged.BLOCK]:
                    blk = None if tile == paged.BLOCK else tile
                    want = predicted_direct_blocks(sx, sy, prm, method,
                                                   tile)
                    paged.reset_direct_blocks(dev)
                    with pool.locked_pool() as parr:
                        ck, bk = paged.paged_render_scored(
                            parr, tab_d, prm, sx, sy, method, n_ns, None,
                            blk)
                    got = paged.direct_blocks(dev)
                    what = f"B1 {name} {method} n_ns={n_ns} {tile}"
                    if blk is None:
                        check_pair(method, ck, bk, cp, bp, what)
                        base = (ck, bk)
                    else:
                        check_exact(what, ck, bk, *base)
                    if got != want:
                        raise AssertionError(
                            f"{what}: {got} blocks read the pool "
                            f"directly, block_boxes predicts {want}")
                    if name.startswith("zoomed") and not want:
                        raise AssertionError(f"{what}: no box over budget")
                    if not bool((bk > float("-inf")).any()):
                        raise AssertionError(f"{what}: nothing rendered")
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


def tile_group(pipe, root, box, px=256):
    """The scene group the fused route builds for the ``px``-px tile
    ``box``."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox, GeoTransform
    from gsky_tpu_torch.pipeline.tile import ns_prio
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    dst_gt = GeoTransform.from_bbox(BBox(*box), px, px)
    merc = parse_crs("EPSG:3857")
    req = GeoTileRequest(collection=root, bands=[NS], bbox=BBox(*box),
                         crs=merc)
    granules = pipe.index(req)
    _, ns_ids, prio = ns_prio(granules)
    return pipe.executor._scene_groups(granules, ns_ids, prio, dst_gt, merc,
                                       px, px)[0]


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
    (with ``full``, its whole argument list but the tile) and its output
    tile (``blks``: None for the default); the wrapper it calls counts
    launches as always."""

    def __init__(self, full=False):
        from gsky_tpu_torch.ops import paged
        self.mod = paged
        self.orig = paged.paged_render_scored
        self.full = full
        self.args = []
        self.blks = []
        paged.paged_render_scored = self._call

    def _call(self, pool, tables, params, sx, sy, method, n_ns, sb_of=None,
              blk=None):
        self.args.append((pool, tables, params, sx, sy, method, n_ns, sb_of)
                         if self.full else (sx, sy, params, method))
        self.blks.append(blk)
        return self.orig(pool, tables, params, sx, sy, method, n_ns, sb_of,
                         blk)

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


def write_drill_stack(path, T=DRILL_T):
    """A ``T``-step (1000 by default) NDVI-like float32 stack (8-day
    steps from 2000-01-01: a smooth field, a seasonal cycle and noise; a
    -9999 nodata block inside the polygon), written with the port's
    NetCDF-3 writer."""
    from gsky_tpu_torch.geo.crs import EPSG4326
    from gsky_tpu_torch.io.netcdf import write_netcdf3
    hw = DRILL_HW
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

    # -- phase 25c, 25d's drills: the time layout, GSKY_SPMD ------------
    t0 = time.perf_counter()
    mesh25 = phase_mesh_drills(pipe, req, root, store, card)
    stats.masked_stats_kernel.launches = b3_launches
    log(f"phase 25c, 25d drills: launches {mesh25} "
        f"({time.perf_counter() - t0:.1f} s)")

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
    return b3_launches, captured[0], kb_launches, wps_b3, mesh25


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
    """A MAS store of the port's crawler records of (path, namespace)
    or (path, namespace, fix): a namespace None keeps the crawler's
    own; ``fix`` rewrites the record before it is ingested."""
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.store import MASStore
    store = MASStore()
    for p, ns, *fix in paths:
        rec = extract(p)
        if rec.get("error"):
            raise AssertionError(rec["error"])
        for f in fix:
            rec = f(rec)
        for ds in rec["geo_metadata"]:
            ds["namespace"] = ns or ds["namespace"]
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
HTTP_CPU_TILES = 1           # tiles per route held against the CPU server


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

    def __init__(self, conf_dir, layers, store, gateway=None,
                 processes=(), cpu_gateway=None):
        """``gateway``: the card server's `ServingGateway`; None (phases
        12-16 measure renders) serves every request raw.
        ``cpu_gateway``: the CPU server's (phase 20), by default none.
        ``processes``: the config's WPS processes."""
        from gsky_tpu_torch.index.client import MASClient
        from gsky_tpu_torch.server.config import ConfigWatcher
        from gsky_tpu_torch.server.ows import OWSServer
        os.makedirs(conf_dir, exist_ok=True)
        self.conf_path = os.path.join(conf_dir, "config.json")
        with open(self.conf_path, "w") as fp:
            json.dump({"service_config": {"mas_address": "in-process"},
                       "layers": layers, "processes": list(processes)}, fp)
        client = MASClient(store)
        self.watcher = watcher = ConfigWatcher(conf_dir, lambda a: client,
                                               install_signal=False)
        self.card = OWSServer(watcher, lambda a: client, device="cuda",
                              gateway=gateway)
        self.cpu = OWSServer(watcher, lambda a: client, device="cpu",
                             gateway=cpu_gateway)
        self.httpd = self.card.serve("127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.cpu_httpd = None

    def close(self):
        for h in (self.httpd, self.cpu_httpd):
            if h is not None:
                h.shutdown()
                h.server_close()

    def cpu_base(self):
        """The CPU server over a socket of its own (started once)."""
        if self.cpu_httpd is None:
            self.cpu_httpd = self.cpu.serve("127.0.0.1", 0)
        return f"http://127.0.0.1:{self.cpu_httpd.server_address[1]}"

    def cpu_get(self, url, headers=None):
        """(status, headers, body, seconds) of ``url`` from the CPU
        server's handler."""
        from urllib.parse import parse_qs, urlsplit
        u = urlsplit(url)
        t0 = time.perf_counter()
        r = self.cpu.handle(u.path, parse_qs(u.query), "", None,
                            headers or {})
        return r.status, dict(r.headers), r.read(), \
            time.perf_counter() - t0

    def clear_caches(self):
        for srv in (self.card, self.cpu):
            if srv.gateway is not None:
                srv.gateway.cache.clear()

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
    B2 launches each.  Then a tile per route from the CPU server."""
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
    scenes, sx, sy, p16, method, n_ns = args[:6]
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

WCS_SIZE = 4096              # 25b: BASELINE config 4, 16 tiles of 1024
# 15a's exports: config 4's tiles of 1024, four of them (at 4096^2 its
# five exports took 41 s of the script, deflate mostly)
WCS_EXPORT = 2048
WCS_TILE = 1024              # the layers' wcs_max_tile_width / height
WCS_STREAM_SIZE = 5120       # 15d: past WCS_STREAM_PIXELS: streamed
WCS_DAP = 2048               # 15d: the DAP4 and NetCDF coverages
WCS_MASKED = 512             # 15d: the masked coverage, tiles of half
WCS_CPU = 512                # 15c: each method's export against the CPU's
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
    the timing launches leave the launch counts as they were.  With
    ``by_ns`` a B1 launch is held once for each (method, n_ns): the
    expression lanes' n_ns 2 beside a tile's n_ns 1."""

    def __init__(self, hw, timed=(), what="15b", by_ns=False):
        from gsky_tpu_torch.ops import paged, warp_render
        self.hw = tuple(hw)
        self.timed = tuple(timed)
        self.what = what
        self.by_ns = by_ns
        self.errs = {}
        self.times = {}
        self.mods = (paged, warp_render)
        self.b1, self.b2 = paged.paged_render_scored, \
            warp_render.warp_render_scored
        self.p1, self.p2 = paged.paged_render_scored_plain, \
            warp_render.warp_render_scored_plain
        paged.paged_render_scored = self._b1
        warp_render.warp_render_scored = self._b2

    def _b1(self, pool, tables, params, sx, sy, method, n_ns, sb_of=None,
            blk=None):
        ck, bk = self.b1(pool, tables, params, sx, sy, method, n_ns, sb_of,
                         blk)
        key = ("B1", f"{method} n_ns {n_ns}" if self.by_ns else method)
        if tuple(sx.shape[-2:]) == self.hw and key not in self.errs:
            cp, bp = self.p1(pool, tables, params, sx, sy, method, n_ns,
                             sb_of)
            self.errs[key] = check_pair(
                method, ck, bk, cp, bp, f"{self.what} B1 {key[1]} {self.hw}")
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

    def _b2(self, scenes, sx, sy, params, method, n_ns, blk=None):
        ck, bk = self.b2(scenes, sx, sy, params, method, n_ns, blk)
        if tuple(sx.shape[-2:]) == self.hw and ("B2", method) not in \
                self.errs:
            cp, bp = self.p2(scenes, sx, sy, params, method, n_ns)
            self.errs[("B2", method)] = check_pair(
                method, ck, bk, cp, bp, f"{self.what} B2 {method} {self.hw}")
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
    tiles = ((WCS_EXPORT + WCS_TILE - 1) // WCS_TILE) ** 2
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
            box = wcs_box(WCS_EXPORT)
            mpix = WCS_EXPORT * WCS_EXPORT / 1e6
            ref = None
            for method, label in (("cubic", "cold"), ("cubic", "warm"),
                                  ("near", "warm"), ("bilinear", "warm")):
                url = wcs_url(pair.base, "landsat", box, WCS_EXPORT,
                              method)
                sp0 = dict(srv.spans)
                (status, hdr, body, secs), got = counted(
                    f"15a {method}", lambda: http_fetch(url))
                if (status, hdr["Content-Type"]) != (200, "image/geotiff"):
                    raise AssertionError(f"15a: {status} {body[:300]}")
                a = tiff_values(body)
                nd = coverage_ok(a, WCS_EXPORT, f"15a {method}")
                legs_ok(f"15a {method}", got, tiles)
                st = srv.last_export
                sp = {k: srv.spans[k] - sp0[k] for k in srv.spans}
                log(f"phase 15a {method} ({label}): "
                    f"{WCS_EXPORT}x{WCS_EXPORT} "
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
                url = wcs_url(pair.base, "landsat", box, WCS_EXPORT, "cubic")
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

            # -- 15c: card vs CPU, WCS_CPU^2 in 256 x 256 tiles -----------
            t0 = time.perf_counter()
            for method in METHODS:
                url = wcs_url(pair.base, "landsat_256", wcs_box(WCS_CPU),
                              WCS_CPU, method)
                (status, _, body, _), got = counted(
                    f"15c {method}", lambda: http_fetch(url), 1)
                cpu = tiff_values(pair.cpu_body(url))
                d = same_coverage(method, tiff_values(body), cpu,
                                  f"15c {method}")
                log(f"phase 15c {method}: {(WCS_CPU // 256) ** 2} tiles of "
                    f"256 x 256, launches "
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
    """Phase 15d's masked export over phase 10's archive: WCS_MASKED^2 in
    4 tiles of half through the engine's masked route (B4).  Returns the
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


def wps_server(root, store, conf_name):
    """The port's OWS server on the card with a WPS drill process over
    phase 7's stack, behind HTTP on an ephemeral port: (httpd, its WPS
    URL, an XML Execute body over `DRILL_POLY`, the polygon's
    GeoJSON)."""
    from gsky_tpu_torch.geo import geometry as geom
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.server.config import ConfigWatcher
    from gsky_tpu_torch.server.ows import OWSServer
    conf = os.path.join(root, conf_name)
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
    url = f"http://127.0.0.1:{httpd.server_address[1]}/ows?service=WPS"
    return httpd, url, body, gj


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
    httpd, url, body, gj = wps_server(root, store, "wps_conf")
    launches = _kernel_counts()
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


# -- phase 18: the grids and formats of satellite archives ---------------

SAT_AHI_N = 5500             # 18a: Himawari-8 AHI 2 km full disk
SAT_AHI_DISK = 1.1e7         # the disk's width in metres (5500 x 2 km)
SAT_AHI_RES = 2000.0         # metres a pixel at the sub-satellite point
SAT_MODIS_N = 2400           # 18b: MOD09A1 500 m tile h29v12
SAT_MODIS_TILE = 1111950.5197   # a MODIS grid tile's width in metres
SAT_MODIS_RES = 463.31271653
SAT_MODIS_DATES = 8
SAT_AEA_N = 4000             # 18c: a DEA 100 km Albers tile at 25 m
SAT_AEA_X0, SAT_AEA_Y0 = 1500000.0, -3900000.0
SAT_SWATH = (2030, 1354)     # 18d: a MODIS L1B 1 km granule
SAT_SWATH_SUB = 5            # its second granule's geolocation step
SAT_STACK = (120, 1000, 1000)   # 18e: the curvilinear drill stack
SAT_TILES = 16               # fused tiles a sub-phase
SAT_MASKED = 8               # 18d masked tiles
SAT_DRILLS_B = 8             # 18b warm drills
SAT_DRILLS_E = 10            # 18e warm drills
MODIS_T0 = 1577836800.0      # 2020-01-01 (the A2020001 composite)
SAT_VRT = """<VRTDataset>
  <VRTRasterBand band="1" subClass="VRTDerivedRasterBand">
    <PixelFunctionType>bare</PixelFunctionType>
    <PixelFunctionLanguage>python</PixelFunctionLanguage>
    <PixelFunctionCode><![CDATA[
def bare(in_ar, out_ar, *args, **kwargs):
    v = in_ar[0].astype("float32")
    out_ar[:] = v
    out_ar[v < 1000] = -999
]]></PixelFunctionCode>
    <SimpleSource metadata-template="1">
      <SourceFilename>{{ .Data.Path }}</SourceFilename>
    </SimpleSource>
  </VRTRasterBand>
</VRTDataset>"""


def merc_tile(lon, lat, px_m, n=256):
    """An ``n``-pixel EPSG:3857 box centred on (lon, lat) whose pixels
    are ``px_m`` metres on the ground there."""
    from gsky_tpu_torch.geo.crs import EPSG3857
    x, y = EPSG3857.from_lonlat(lon, lat)
    half = n * px_m / np.cos(np.radians(lat)) / 2
    return (float(x - half), float(y - half), float(x + half),
            float(y + half))


def tile_grid(lon0, lat0, px_m, nx, ny, n=256):
    """``nx`` x ``ny`` adjacent ``merc_tile``s from (lon0, lat0) east
    and south."""
    step = n * px_m / 111320.0
    return [merc_tile(lon0 + i * step / np.cos(np.radians(lat0)),
                      lat0 - j * step, px_m, n)
            for j in range(ny) for i in range(nx)]


def write_himawari(path, n=None):
    """One AHI band of the full disk, Himawari-shaped: NetCDF-3 with a
    CF ``geostationary`` grid mapping (the real products are NetCDF-4,
    which needs h5py), x / y in metres, f32 brightness temperature,
    space filled with -999."""
    from gsky_tpu_torch.io.netcdf import write_netcdf3_raw
    n = n or SAT_AHI_N
    res = SAT_AHI_DISK / n
    x = -n * res / 2 + res * (np.arange(n) + 0.5)
    y = n * res / 2 - res * (np.arange(n) + 0.5)
    xx = (x / 5.43e6).astype(np.float32)[None]
    yy = (y / 5.41e6).astype(np.float32)[:, None]
    band = 280.0 + 20.0 * np.sin(xx * 13.0) * np.cos(yy * 16.0) \
        + 5.0 * np.sin(xx * 97.0 + yy * 61.0)
    band = band.astype(np.float32)
    band[xx ** 2 + yy ** 2 >= 1.0] = -999.0
    write_netcdf3_raw(path, [("y", n), ("x", n)], [
        ("x", ("x",), {"standard_name": "projection_x_coordinate",
                       "units": "m"}, x),
        ("y", ("y",), {"standard_name": "projection_y_coordinate",
                       "units": "m"}, y),
        ("geostationary", (), {
            "grid_mapping_name": "geostationary",
            "perspective_point_height": 35785863.0,
            "longitude_of_projection_origin": 140.7,
            "sweep_angle_axis": "y", "semi_major_axis": 6378137.0,
            "inverse_flattening": 298.257223563},
         np.zeros((), np.int32)),
        ("tbb_13", ("y", "x"), {"grid_mapping": "geostationary",
                                "_FillValue": np.float32(-999.0)}, band),
    ], {"Conventions": "CF-1.6"})


def write_modis_tile(path, k, n=None):
    """MOD09A1-shaped: tile h29v12 of the MODIS sinusoidal grid, one
    500 m int16 band (fill -28672), DEFLATE, HDF-EOS GCTP_SNSOID."""
    from gsky_tpu_torch.geo.crs import CRS_SINU_MODIS
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.hdf4 import write_hdf4
    n = n or SAT_MODIS_N
    res = SAT_MODIS_TILE / n
    # h29v12's upper-left corner on the sinusoidal grid
    gt = GeoTransform(-20015109.354 + 29 * SAT_MODIS_TILE, res, 0.0,
                      10007554.677 - 12 * SAT_MODIS_TILE, 0.0, -res)
    rng = np.random.default_rng(100 + k)
    yy = np.arange(n, dtype=np.float32)[:, None]
    xx = np.arange(n, dtype=np.float32)[None]
    refl = 1500 + 900 * np.sin(xx / (97.0 + 5 * k)) * np.cos(yy / 131.0)
    refl = refl.astype(np.int16)
    for _ in range(12):                     # clouds: fill
        cy, cx = rng.uniform(0, n, 2)
        r = rng.uniform(0.01, 0.04) * n
        sl = (slice(max(int(cy - r), 0), int(cy + r)),
              slice(max(int(cx - r), 0), int(cx + r)))
        refl[sl] = -28672
    write_hdf4(path, {"sur_refl_b01": refl}, gt=gt, crs=CRS_SINU_MODIS,
               fills={"sur_refl_b01": -28672.0}, compress="deflate")


def write_albers(path, n=None):
    """A DEA-shaped tile: int16, EPSG:3577 at 25 m, 100 km square."""
    from gsky_tpu_torch.geo.crs import EPSG3577
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.geotiff import write_geotiff
    n = n or SAT_AEA_N
    res = 100000.0 / n
    yy = np.arange(n, dtype=np.float32)[:, None]
    xx = np.arange(n, dtype=np.float32)[None]
    v = (1200 + 700 * np.sin(xx / 290.0) * np.cos(yy / 370.0)
         + 90 * np.sin(xx / 7.0 + yy / 11.0)).astype(np.int16)
    v[:n // 10, :n // 6] = -999
    write_geotiff(path, v, GeoTransform(SAT_AEA_X0, res, 0.0, SAT_AEA_Y0,
                                        0.0, -res), EPSG3577, nodata=-999,
                  compress=False)


def swath_lonlat(r, c, shape, k=0):
    """A MODIS-like descending swath over eastern Australia: rows
    along-track at 1 km, columns across-track to +-1165 km with the
    scan's growth toward the edges, heading 12 degrees west of south."""
    H, W = shape
    u = (c - W / 2.0) / (W / 2.0)
    d = 1165.0 * (u + 0.35 * u ** 3) / 1.35            # km across
    a = (r - H / 2.0) * 2030.0 / H                      # km along
    h = np.radians(-12.0)
    lat0, lon0 = -31.0 - 0.2 * k, 146.0 + 0.3 * k
    north = -a * np.cos(h) + d * np.sin(h)
    east = a * np.sin(h) + d * np.cos(h)
    lat = lat0 + north / 111.32
    lon = lon0 + east / (111.32 * np.cos(np.radians(lat)))
    return lon, lat


def write_swath(path, k, sub=1, shape=None, times=None):
    """A CF curvilinear granule: f32 ``bt`` (fill -9999) and an int16
    ``qa`` of bit flags (8 cloud, 2 edge) over (rows, cols), 2-D f32
    lon / lat at full resolution or every ``sub``-th pixel from 2, no
    1-D axis variables.  With ``times``: a (T, rows, cols) ``bt``."""
    from gsky_tpu_torch.io.netcdf import write_netcdf3_raw
    H, W = shape or SAT_SWATH
    rng = np.random.default_rng(200 + k)
    rr = np.arange(H, dtype=np.float64)[:, None]
    cc = np.arange(W, dtype=np.float64)[None]
    if sub > 1:
        gi = 2.0 + sub * np.arange((H - 3) // sub + 1)
        gj = 2.0 + sub * np.arange((W - 3) // sub + 1)
        lon, lat = swath_lonlat(gi[:, None] + 0.5, gj[None] + 0.5,
                                (H, W), k)
        dims = [("y", H), ("x", W), ("gy", len(gi)), ("gx", len(gj))]
        gdims = ("gy", "gx")
    else:
        lon, lat = swath_lonlat(rr + 0.5, cc + 0.5, (H, W), k)
        dims = [("y", H), ("x", W)]
        gdims = ("y", "x")
    bt = (250.0 + 30.0 * np.sin(cc / (37.0 + 3 * k)) * np.cos(rr / 53.0)
          + 4.0 * np.sin(cc / 3.0 + rr / 5.0)).astype(np.float32)
    bt[:H // 20, :W // 10] = -9999.0
    qa = np.zeros((H, W), np.int16)
    for _ in range(30):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        r = rng.uniform(0.01, 0.03) * W
        qa[max(int(cy - r), 0):int(cy + r),
           max(int(cx - r), 0):int(cx + r)] |= 8
    qa[:, :W // 40] |= 2
    variables = [
        ("lon", gdims, {"standard_name": "longitude"},
         lon.astype(np.float32)),
        ("lat", gdims, {"standard_name": "latitude"},
         lat.astype(np.float32))]
    if times is not None:
        dims = [("time", len(times))] + dims
        stack = np.empty((len(times), H, W), np.float32)
        for t in range(len(times)):
            stack[t] = bt + np.float32(3.0 * np.sin(t / 9.0))
        stack[:, H // 3:H // 3 + 40, W // 2:W // 2 + 60] = -9999.0
        variables += [
            ("time", ("time",), {"standard_name": "time", "units":
                                 "seconds since 1970-01-01 00:00:00"},
             np.asarray(times, np.float64)),
            ("bt", ("time", "y", "x"),
             {"_FillValue": np.float32(-9999.0)}, stack)]
    else:
        variables += [
            ("bt", ("y", "x"), {"_FillValue": np.float32(-9999.0)}, bt),
            ("qa", ("y", "x"), {}, qa)]
    write_netcdf3_raw(path, dims, variables, {"Conventions": "CF-1.6"})


def sub_geo_loc(rec, step):
    """The crawler flags full-resolution geolocation arrays only; a
    granule with subsampled ones gets its ``geo_loc`` (offsets, steps),
    SRS and footprint from a crawler rule, as a deployment's rule
    config gives them (the footprint: the arrays' extent)."""
    from gsky_tpu_torch.index.rulesets import RuleSet, apply_ruleset
    from gsky_tpu_torch.io.netcdf import NetCDF
    path = rec["filename"]
    with NetCDF(path) as nc:
        lon = np.asarray(nc.variables["lon"][:], np.float64)
        lat = np.asarray(nc.variables["lat"][:], np.float64)
    rule = RuleSet.from_json({
        "collection": "swath_sub", "srs_text": "EPSG:4326",
        "proj4_text": "+proj=longlat +datum=WGS84 +no_defs",
        "pattern": re.escape(os.path.basename(path)) + "$",
        "bbox": [float(lon.min()), float(lat.min()), float(lon.max()),
                 float(lat.max())],
        "geo_loc": {"x_dataset_template": "lon", "y_dataset_template": "lat",
                    "line_offset": 2, "pixel_offset": 2, "line_step": step,
                    "pixel_step": step}})
    return apply_ruleset(rule, rule.match(path), rec, path)


def tile_request(coll, band, box, method, crs="EPSG:3857", t=None,
                 mask=None, n=256):
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import BBox
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    t0, t1 = t if t is not None else (None, None)
    return GeoTileRequest(collection=coll, bands=[band], bbox=BBox(*box),
                          crs=parse_crs(crs), width=n, height=n,
                          start_time=t0, end_time=t1, resample=method,
                          mask=mask)


def fused_tiles(pipe, reqs, partial=False):
    """`render_composite_byte` of each request: (host uint8 tiles,
    per-tile seconds).  Each tile holds data; with ``partial`` each one
    also holds nodata (it crosses the data's edge)."""
    import torch
    tiles, secs = [], []
    for req in reqs:
        t0 = time.perf_counter()
        out = pipe.render_composite_byte(req)
        if out is None:
            raise AssertionError(f"tile {req.bbox} not rendered")
        if isinstance(out, torch.Tensor):
            if out.is_cuda:
                torch.cuda.synchronize()
            out = out.cpu().numpy()
        secs.append(time.perf_counter() - t0)
        if out.dtype != np.uint8 or out.shape != (req.height, req.width):
            raise AssertionError(f"bad tile {out.dtype} {out.shape}")
        if (out == 255).all() or (partial and not (out == 255).any()):
            raise AssertionError(f"tile {req.bbox}: nodata share "
                                 f"{float((out == 255).mean())}")
        tiles.append(out)
    return tiles, secs


class SatRun:
    """One sub-phase's counters: kernel launches (set to 0 on entry),
    plain calls (none allowed), B1 calls captured for the staging
    prediction, the executor's stage spans and geolocation grids."""

    def __init__(self, ex=None):
        from gsky_tpu_torch.ops import paged
        self.ex = ex
        self.kernels = _kernel_counts()
        reset_counts(self.kernels)
        paged.reset_direct_blocks()
        self.spans = dict(ex.spans) if ex is not None else {}
        self.gl = (ex.geoloc_seconds, dict(ex.geoloc_steps)) \
            if ex is not None else (0.0, {})
        self.plain = PlainCalls()
        self.cap = CaptureB1()
        self.t0 = time.perf_counter()

    def close(self):
        from gsky_tpu_torch.ops import paged
        self.wall = time.perf_counter() - self.t0
        self.plain.remove()
        self.cap.remove()
        self.launches = read_counts(self.kernels)
        self.direct = paged.direct_blocks()
        self.predicted = sum(predicted_direct_blocks(sx, sy, prm, m)
                             for sx, sy, prm, m in self.cap.args)
        self.cap = None
        if self.plain.calls:
            raise AssertionError(f"{self.plain.calls} plain-version calls "
                                 f"on the card's main path")
        if self.direct != self.predicted:
            raise AssertionError(f"{self.direct} B1 blocks over the staging "
                                 f"budget, block_boxes predicts "
                                 f"{self.predicted}")
        return self

    def need(self, *names):
        for k in names:
            if not self.launches[k]:
                raise AssertionError(f"{k} launched no time: "
                                     f"{self.launches}")

    def report(self, what, secs, card, unit="tiles"):
        ex = self.ex
        parts = [f"phase {what}: {len(secs)} {unit}, "
                 f"{len(secs) / sum(secs):.2f} {unit}/s, p50 "
                 f"{np.median(secs) * 1e3:.3f} ms, p90 "
                 f"{np.percentile(secs, 90) * 1e3:.3f} ms; launches "
                 f"{self.launches}; B1 blocks over the staging budget "
                 f"{self.direct} (block_boxes predicts {self.predicted})"]
        if ex is not None:
            sp = {k: (ex.spans.get(k, 0.0) - self.spans.get(k, 0.0))
                  / len(secs) * 1e3 for k in ex.spans}
            parts.append("host ms a tile: " + ", ".join(
                f"{k} {v:.4f}" for k, v in sp.items() if v))
            gs = ex.geoloc_seconds - self.gl[0]
            steps = {s: n - self.gl[1].get(s, 0)
                     for s, n in ex.geoloc_steps.items()
                     if n - self.gl[1].get(s, 0)}
            if steps:
                n = sum(steps.values())
                parts.append(f"_geoloc_ctrl {gs / n * 1e3:.3f} host ms a "
                             f"grid over {n} grids, steps ended at "
                             f"{dict(sorted(steps.items()))}")
        log("; ".join(parts) + f" ({card})")


def same_tiles(method, card_tiles, cpu_tiles, what):
    for a, b in zip(card_tiles, cpu_tiles):
        compare_tiles(method, [a], [b], what)
    return len(card_tiles)


def sat_fused(pipe, cpu, reqs, what, card, partial=False, want=()):
    """A sub-phase of fused tiles: counted on the card, then the same
    requests on the CPU (bytes equal for nearest, <= 0.1% otherwise)."""
    run = SatRun(pipe.executor)
    try:
        tiles, secs = fused_tiles(pipe, reqs, partial)
    finally:
        run.close()
    if run.launches["B1"] + run.launches["B2"] != len(reqs) or \
            run.launches["B3"] or run.launches["B4"]:
        raise AssertionError(f"{what}: launches {run.launches} for "
                             f"{len(reqs)} tiles")
    run.need(*want)
    run.report(what, secs, card)
    got, _ = fused_tiles(cpu, reqs, partial)
    same_tiles(reqs[0].resample, tiles, got, f"{what} card vs cpu")
    return run.launches


def sat_drills(pipe, cpu, req, n, what, card, want_b3):
    """One cold drill (the stacks upload: GSKY_DRILL_CACHE=sync), then
    ``n`` warm ones counted: ``want_b3`` B3 launches each; the CPU's
    answer equal within rtol 1e-5."""
    import torch
    t0 = time.perf_counter()
    cold = pipe.process(req)
    cold_s = time.perf_counter() - t0
    run = SatRun()
    secs = []
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            res = pipe.process(req)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    finally:
        run.close()
    if run.launches != {"B1": 0, "B2": 0, "B3": n * want_b3, "B4": 0}:
        raise AssertionError(f"{what}: launches {run.launches}, want B3 "
                             f"{n * want_b3}")
    same_drill(cold, res, f"{what} warm vs the first")
    run.report(what, secs, card, unit="drills")
    sp = pipe.spans
    log(f"phase {what}: the first drill (stacks uploaded) {cold_s:.3f} s; "
        f"drill stage totals s: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sp.items() if v))
    err = same_drill(cpu.process(req), res, f"{what} card vs cpu")
    if not max(max(c) for c in res.counts.values()):
        raise AssertionError(f"{what}: no valid pixel")
    return run.launches, err


def out_of_domain(pipe, req, what):
    """B1 and B2 against their plain versions at a tile's own operands,
    its dense coordinates salted with NaN, +-inf and finite values past
    +-2**31 (as geolocation extrapolation and the geostationary inverse
    over space give): every method, kernel counts untouched.  Returns
    the largest |kernel - plain| canvas difference."""
    import torch
    from gsky_tpu_torch.ops import paged, warp_render
    from gsky_tpu_torch.ops.warp import _bilerp_grid, params16
    from gsky_tpu_torch.pipeline.tile import ns_prio
    ex = pipe.executor
    saved = {k: v.launches for k, v in _kernel_counts().items()}
    granules = pipe.index(req)
    _, ns_ids, prio = ns_prio(granules)
    group = ex._scene_groups(granules, ns_ids, prio, req.dst_gt(), req.crs,
                             req.height, req.width)[0]
    os.environ["GSKY_PAGE_SLOTS"] = "64"
    try:
        tables, p16, _ = ex._paged_from_group(group, 1)
    finally:
        del os.environ["GSKY_PAGE_SLOTS"]
    ex.pool.unpin(tables)
    dev = ex.device
    sx, sy = _bilerp_grid(group.ctrl_dev[:, None], req.height, req.width,
                          group.step)
    sx, sy = sx.clone(), sy.clone()
    natural = int((~torch.isfinite(sx)).sum())
    salt = (float("nan"), float("inf"), -float("inf"), 3.0e9, -3.0e9,
            2.0 ** 31, 1.0e30, -1.0e30)
    for i, v in enumerate(salt):
        sx[0, 8 * i, ::3] = v
        sy[0, 8 * i + 3, 1::3] = v
        sx[0, 4 * i:4 * i + 4, 200 + i] = v
        sy[0, 100 + i, 4 * i:4 * i + 4] = -v
    n_bad = int((~torch.isfinite(sx) | ~torch.isfinite(sy)
                 | (sx.abs() >= 2.0 ** 31) | (sy.abs() >= 2.0 ** 31)).sum())
    tab_d = torch.from_numpy(tables[None]).to(dev)
    p16_d = torch.from_numpy(p16).to(dev)
    n = len(group.scenes)
    scenes = [s.dev for s in group.scenes]
    b2p = params16(torch.from_numpy(group.params[:n].astype(np.float32))
                   .to(dev))
    worst = 0.0
    for method in METHODS:
        with ex.pool.locked_pool() as parr:
            ck, bk = paged.paged_render_scored(parr, tab_d, p16_d, sx, sy,
                                               method, 1)
            cp, bp = paged.paged_render_scored_plain(parr, tab_d, p16_d,
                                                     sx, sy, method, 1)
        worst = max(worst, check_pair(method, ck, bk, cp, bp,
                                      f"{what} B1 {method}"))
        ck, bk = warp_render.warp_render_scored(scenes, sx[0], sy[0], b2p,
                                                method, 1)
        cp, bp = warp_render.warp_render_scored_plain(scenes, sx[0], sy[0],
                                                      b2p, method, 1)
        worst = max(worst, check_pair(method, ck, bk, cp, bp,
                                      f"{what} B2 {method}"))
    torch.cuda.synchronize()
    for k, v in _kernel_counts().items():
        v.launches = saved[k]
    log(f"phase 18 out of domain, {what}: B1 and B2 equal their plain "
        f"versions (best exact, canvas exact for near, <= 2 ulp "
        f"otherwise; max |diff| {worst}) over {n_bad} of {sx.numel()} "
        f"dense coordinates NaN, +-inf or past +-2**31 ({natural} "
        f"non-finite from the grid itself), T={tables.shape[0]} "
        f"S={tables.shape[1]}")
    return worst


def sat_ows(root, store, coll, card):
    """18e's WPS Execute over HTTP of a VRT process (a Python pixel
    function over the Albers tile): no kernel launch; the body equals
    the CPU server's."""
    from urllib.parse import quote
    conf = os.path.join(root, "conf")
    os.makedirs(conf, exist_ok=True)
    with open(os.path.join(conf, "drill.vrt"), "w") as fp:
        fp.write(SAT_VRT)
    pair = OwsPair(conf, [], store, processes=[
        {"identifier": "bare_vrt", "approx": False,
         "data_sources": [{"data_source": coll, "rgb_products": ["dea"],
                           "vrt_url": "drill.vrt"}]}])
    try:
        geom = json.dumps({"type": "Polygon", "coordinates": [[
            [148.96, -35.2], [149.2, -35.2], [149.2, -35.4],
            [148.96, -35.4], [148.96, -35.2]]]})
        url = (f"{pair.base}/ows?service=WPS&request=Execute&identifier="
               f"bare_vrt&datainputs={quote('geometry=' + geom)}")
        kernels = _kernel_counts()
        reset_counts(kernels)
        t0 = time.perf_counter()
        status, ctype, body, _ = http_get(url)
        secs = time.perf_counter() - t0
        if (status, ctype) != (200, "text/xml") or b"2020-01-20," not in body:
            raise AssertionError(f"18e VRT WPS: {status} {body[:400]}")
        got = read_counts(kernels)
        if any(got.values()):
            raise AssertionError(f"18e VRT WPS launched {got}")
        stamp = re.compile(rb'creationTime="[^"]*"')
        if stamp.sub(b"", body) != stamp.sub(b"", pair.cpu_body(url)):
            raise AssertionError("18e VRT WPS: the CPU server's body differs")
        row = body.split(b"2020-01-20,")[1].split(b"\n")[0].split(b"<")[0]
        log(f"phase 18e: WPS Execute of a VRT process over HTTP in "
            f"{secs * 1e3:.3f} ms (host stats, no launch), mean "
            f"{row.decode()}; body equals the CPU server's ({card})")
    finally:
        pair.close()


def phase_sat(root, card):
    """Phase 18.  Returns ({kernel: launches}, the out-of-domain checks'
    max |kernel - plain|, B3's largest relative card-vs-CPU drill
    difference)."""
    import torch
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.pipeline import drill as tdrill
    from gsky_tpu_torch.pipeline.types import GeoDrillRequest, MaskSpec
    total = dict.fromkeys(_kernel_counts(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    dirs = {k: os.path.join(root, k)
            for k in ("ahi", "modis", "dea", "swath", "stack")}
    for d in dirs.values():
        os.makedirs(d)
    t0 = time.perf_counter()
    ahi = os.path.join(dirs["ahi"], "ahi_fd_b13_20200115.nc")
    write_himawari(ahi)
    modis = []
    for k in range(SAT_MODIS_DATES):
        p = os.path.join(dirs["modis"],
                         f"MOD09A1.A2020{1 + 8 * k:03d}.h29v12.hdf")
        write_modis_tile(p, k)
        modis.append(p)
    dea = os.path.join(dirs["dea"], "dea_x15y-39_2020-01-20.tif")
    write_albers(dea)
    sw_full = os.path.join(dirs["swath"], "MOD021KM.A2020015.nc")
    sw_sub = os.path.join(dirs["swath"], "MOD021KM.A2020016.nc")
    write_swath(sw_full, 0)
    write_swath(sw_sub, 1, sub=SAT_SWATH_SUB)
    stack = os.path.join(dirs["stack"], "swath_stack.nc")
    T, sh, sw = SAT_STACK
    write_swath(stack, 2, shape=(sh, sw),
                times=MODIS_T0 + 86400.0 * np.arange(T))
    paths = [ahi, dea, sw_full, sw_sub, stack] + modis
    size = sum(os.path.getsize(p) for p in paths)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = crawl(
        [(ahi, None), (dea, "dea"), (sw_full, None),
         (sw_sub, None, lambda r: sub_geo_loc(r, SAT_SWATH_SUB)),
         (stack, None)] + [(p, None) for p in modis])
    log(f"phase 18: {len(paths)} files ({size / 1e9:.3f} GB: AHI "
        f"{SAT_AHI_N}^2 f32 NetCDF-3, {SAT_MODIS_DATES} HDF4 {SAT_MODIS_N}^2 "
        f"int16 deflate, Albers {SAT_AEA_N}^2 int16 GeoTIFF, swaths "
        f"{SAT_SWATH} f32, stack {SAT_STACK} f32) written in {t_write:.1f} "
        f"s, crawled in {time.perf_counter() - t0:.1f} s")
    pipe = make_pipeline(store, "cuda")
    cpu = make_pipeline(store, "cpu")
    worst_odd = 0.0

    # -- 18a: the Himawari full disk (geostationary) -------------------
    t0 = time.perf_counter()
    native = tile_grid(145.5, -22.0, SAT_AHI_RES * 1.25, 4,
                       SAT_TILES // 4)
    zoomed = tile_grid(138.0, -18.0, SAT_AHI_RES * 5.0, 4, 2)
    # the western limb (59.5 E at the equator): 12-degree tiles from
    # 58 E, part disk, part space, inside the footprint the index keeps
    # for the full disk (its corners are in space: 68-213 E, +-44)
    limb = [merc_tile(64.0, lat, 12.0 * 111320.0 * np.cos(np.radians(lat))
                      / 256) for lat in (-30.0, -10.0, 10.0, 30.0)]
    reqs = [tile_request(dirs["ahi"], "tbb_13", b, "bilinear")
            for b in native + zoomed]
    fused_tiles(pipe, reqs[:1])                       # the scene uploads
    log(f"phase 18a: scene cache warm in {time.perf_counter() - t0:.1f} s")
    add(sat_fused(pipe, cpu, reqs, "18a AHI native and 4x, bilinear", card))
    lreqs = [tile_request(dirs["ahi"], "tbb_13", b, m)
             for b in limb for m in ("near", "bilinear")]
    add(sat_fused(pipe, cpu, lreqs, "18a AHI limb, near and bilinear",
                  card, partial=True))
    worst_odd = max(worst_odd, out_of_domain(pipe, lreqs[1], "AHI limb"))

    # -- 18b: MODIS sinusoidal HDF4 over 8 dates ------------------------
    t0 = time.perf_counter()
    boxes = tile_grid(139.0, -34.5, SAT_MODIS_RES * 1.1, 4,
                      SAT_TILES // 8)
    reqs = [tile_request(dirs["modis"], "sur_refl_b01", b, m)
            for m in ("bilinear", "cubic") for b in boxes]
    fused_tiles(pipe, reqs[:1])
    log(f"phase 18b: {SAT_MODIS_DATES} scenes warm in "
        f"{time.perf_counter() - t0:.1f} s")
    add(sat_fused(pipe, cpu, reqs, "18b MODIS h29v12, 8 dates", card))
    os.environ["GSKY_DRILL_CACHE"] = "sync"
    try:
        dreq = GeoDrillRequest(
            collection=dirs["modis"], bands=["sur_refl_b01"], approx=False,
            geometry_wkt="POLYGON((140.0 -35.0,140.8 -35.05,140.7 -35.6,"
                         "140.1 -35.55,140.0 -35.0))")
        launches, err_b = sat_drills(
            tdrill.DrillPipeline(MASClient(store), device="cuda"),
            tdrill.DrillPipeline(MASClient(store), device="cpu"), dreq,
            SAT_DRILLS_B, "18b MODIS drills", card, SAT_MODIS_DATES)
        add(launches)

        # -- 18c: the Albers tile -------------------------------------
        t0 = time.perf_counter()
        boxes = tile_grid(149.0, -35.15, 25.0 * 1.2, 4, SAT_TILES // 4)
        reqs = [tile_request(dirs["dea"], "dea", b, "bilinear")
                for b in boxes]
        fused_tiles(pipe, reqs[:1])
        log(f"phase 18c: scene warm in {time.perf_counter() - t0:.1f} s")
        add(sat_fused(pipe, cpu, reqs, "18c Albers in EPSG:3857", card))
        x, y = SAT_AEA_X0 + 20000.0, SAT_AEA_Y0 - 30000.0
        nat = [(x + i * 6400.0, y - 6400.0 * (j + 1),
                x + (i + 1) * 6400.0, y - 6400.0 * j)
               for j in range(2) for i in range(2)]
        reqs = [tile_request(dirs["dea"], "dea", b, "near", "EPSG:3577")
                for b in nat]
        add(sat_fused(pipe, cpu, reqs, "18c Albers in EPSG:3577, near",
                      card))

        # -- 18d: MODIS L1B swaths (curvilinear) -----------------------
        d1, d2 = 1579046400.0, 1579132800.0     # 2020-01-15, -16
        t0 = time.perf_counter()
        boxes = tile_grid(143.0, -27.5, 1250.0, 4, 2)
        reqs = [tile_request(dirs["swath"], "bt", b, "bilinear",
                             t=(d, d)) for d in (d1, d2) for b in boxes]
        fused_tiles(pipe, reqs[:1])
        fused_tiles(pipe, reqs[len(boxes):len(boxes) + 1])
        log(f"phase 18d: scenes and geolocation grids warm in "
            f"{time.perf_counter() - t0:.1f} s")
        add(sat_fused(pipe, cpu, reqs, "18d swath fused (full and 5x "
                      "subsampled geolocation)", card, want=("B1",)))
        edge = [tile_request(dirs["swath"], "bt", merc_tile(
            lon, lat, 2000.0), "bilinear", t=(d1, d1))
            for lon, lat in swath_edge_points()]
        add(sat_fused(pipe, cpu, edge, "18d swath edge", card,
                      partial=True))
        worst_odd = max(worst_odd, out_of_domain(pipe, edge[0],
                                                 "swath edge"))
        mask = MaskSpec(id="qa", bit_tests=["1000", "1000", "10", "10"])
        mboxes = tile_grid(145.0, -29.0, 1100.0, 4, SAT_MASKED // 4)
        # both granules (the range's end is exclusive): two geolocation
        # groups, each its own B2 launch per band, then B4 at T = 2
        mreqs = [tile_request(dirs["swath"], "bt", b, "bilinear",
                              t=(d1, d2 + 1.0), mask=mask) for b in mboxes]
        run = SatRun(pipe.executor)
        secs, outs = [], []
        try:
            for r in mreqs:
                t1 = time.perf_counter()
                res = pipe.process(r)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t1)
                outs.append(res)
        finally:
            run.close()
        run.need("B2", "B4")
        if run.launches["B4"] != len(mreqs) or run.launches["B3"]:
            raise AssertionError(f"18d masked: launches {run.launches}")
        run.report("18d swath masked (QA bit tests)", secs, card)
        # the mask moved pixels to the other date's value or to nodata:
        # the same tiles without it differ (on the CPU, no launch)
        moved = 0
        for r, res in zip(mreqs, outs):
            bare = cpu.process(dataclasses.replace(r, mask=None))
            moved += int(((bare.data["bt"] != res.data["bt"].cpu())
                          | (bare.valid["bt"] != res.valid["bt"].cpu()))
                         .sum())
        if not moved:
            raise AssertionError("18d masked: the QA mask changed nothing")
        for r, res in zip(mreqs, outs):
            ref = cpu.process(r)
            d, v = res.data["bt"], res.valid["bt"]
            rd, rv = ref.data["bt"], ref.valid["bt"]
            if not torch.equal(v.cpu(), rv) or not v.any():
                raise AssertionError(f"18d masked: validity differs "
                                     f"({int((v.cpu() != rv).sum())} px) "
                                     f"or is empty")
            u = ulp_diff(d.cpu()[rv], rd[rv])
            if u > 2:
                raise AssertionError(f"18d masked: {u} ulp > 2")
        add(run.launches)

        # -- 18e: the curvilinear drill stack and WPS over a VRT --------
        dreq = GeoDrillRequest(
            collection=dirs["stack"], bands=["bt"], approx=False,
            geometry_wkt="POLYGON((144.0 -30.0,147.0 -30.2,146.8 -32.6,"
                         "144.2 -32.4,144.0 -30.0))")
        launches, err_e = sat_drills(
            tdrill.DrillPipeline(MASClient(store), device="cuda"),
            tdrill.DrillPipeline(MASClient(store), device="cpu"), dreq,
            SAT_DRILLS_E, "18e curvilinear stack drills", card, 1)
        add(launches)
    finally:
        os.environ.pop("GSKY_DRILL_CACHE", None)
    sat_ows(root, store, dirs["dea"], card)
    return total, worst_odd, max(err_b, err_e)


# -- phase 19: the native codec, ranged ingest, a MAS over HTTP -------------

LZW_DOYS = ("010", "026")     # 19b: two acquisitions of 2020 (phase 10 has 8)
LZW_TILE = 512                # the archive's tile size
LZW_OVERVIEWS = (2, 4)
LZW_FUSED = 16                # 19b: fused tiles (staged loads, B1)
LZW_MASKED = 16               # 19b: masked tiles (ranged windows, B4)
LZW_ZOOM = 8                  # 19b: tiles at 4x (overview level 4)
LZW_ROUTED = 8                # 19b: window-routed tiles over LC08_B5
LZW_PLAIN = 4                 # 19b: tiles held against uncompressed rasters
LZW_CPU = 2                   # 19b: tiles per route held against the CPU
LZW_ROUTE_FRAC = "0.05"       # GSKY_INGEST_WINDOW_FRAC for the routed tiles
LZW_PROMOTE = 4               # the reference's GSKY_INGEST_WINDOW_PROMOTE
INGEST_T = 120                # 19c: the drill stack's timesteps
INGEST_DRILLS = 5             # 19c: warm drills
LZW_CLEAR, LZW_EOI = 256, 257
# UTM-55S origins of 19b's tile grids (`tile_boxes`), inside both dates
LZW_AT = {"fused": (600000.0, 6100000.0), "masked": (620000.0, 6080000.0),
          "zoom": (560000.0, 6140000.0), "routed": (640000.0, 6060000.0)}


def lzw_encode(data, clear_every=0, seen=None):
    """A TIFF LZW encoder (MSB-first codes, the decoder's early width
    change, a CLEAR when the table would pass 4093 entries and, with
    ``clear_every``, after that many codes).  ``seen`` (a dict) gets the
    code widths used, the CLEARs and the KwKwK codes emitted."""
    codes = []

    def reset():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = reset()
    codes.append((LZW_CLEAR, width))
    since = kwkwk = 0
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        code = table[w]
        kwkwk += since > 0 and code == nxt - 1
        codes.append((code, width))
        since += 1
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
        w = bytes([c])
        if nxt >= 4094 or (clear_every and since >= clear_every):
            codes.append((LZW_CLEAR, width))
            table, nxt, width = reset()
            since = 0
    if w:
        code = table[w]
        kwkwk += since > 0 and code == nxt - 1
        codes.append((code, width))
        if since and nxt + 1 >= (1 << width) and width < 12:
            width += 1
    codes.append((LZW_EOI, width))
    if seen is not None:
        seen["widths"] = sorted({wd for _, wd in codes})
        seen["clears"] = sum(c == LZW_CLEAR for c, _ in codes)
        seen["kwkwk"] = kwkwk
    acc, nbits = 0, 0
    for code, wd in codes:
        acc = (acc << wd) | code
        nbits += wd
    pad = -nbits % 8
    return (acc << pad).to_bytes((nbits + pad) // 8, "big")


def lzw_literal(raw):
    """A valid TIFF LZW stream of 9-bit literal codes: a CLEAR every 254
    codes keeps the table from widening them, eight codes pack into nine
    bytes (vectorised: the archive's writer)."""
    b = np.frombuffer(raw, np.uint8)
    n = b.size
    per = 253
    groups = max(1, -(-n // per))
    codes = np.empty((groups, per + 1), np.uint16)
    codes[:, 0] = LZW_CLEAR
    lit = np.zeros(groups * per, np.uint16)
    lit[:n] = b
    codes[:, 1:] = lit.reshape(groups, per)
    total = n + groups + 1
    c = np.zeros(total + (-total % 8), np.uint16)
    c[:n + groups] = codes.reshape(-1)[:n + groups]
    c[n + groups] = LZW_EOI
    c = c.reshape(-1, 8)
    out = np.empty((len(c), 9), np.uint8)
    out[:, 0] = c[:, 0] >> 1
    for k in range(1, 8):
        out[:, k] = ((c[:, k - 1] & ((1 << k) - 1)) << (8 - k)) \
            | (c[:, k] >> (k + 1))
    out[:, 8] = c[:, 7] & 0xFF
    return out.tobytes()


def predict_h(block):
    """Predictor 2 on a (rows, cols) integer block (wrapping deltas)."""
    d = block.copy()
    d[:, 1:] = block[:, 1:] - block[:, :-1]
    return d


def predict_fp(data):
    """Predictor 3 on a (rows, cols) float block: per row, the bytes in
    big-endian significance planes, delta-coded as uint8."""
    h, w = data.shape
    be = data.astype(data.dtype.newbyteorder(">")).view(np.uint8)
    planes = np.transpose(be.reshape(h, w, data.dtype.itemsize),
                          (0, 2, 1)).reshape(h, -1)
    enc = planes.copy()
    enc[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return enc.tobytes()


def packbits_encode(data):
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and (
                j + 1 >= len(data) or data[j + 1] != data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def phase_codec(card):
    """19a: build the native codec and hold its decoders against their
    plain Python versions; LZW decode MB/s of both on one 512 x 512 int16
    tile.  Returns the number of comparisons."""
    from gsky_tpu_torch import native
    from gsky_tpu_torch.io import geotiff as tg
    t0 = time.perf_counter()
    lib = native.codec()
    built = time.perf_counter() - t0
    ver = subprocess.run([native.compiler(), "--version"],
                         capture_output=True, text=True).stdout
    log(f"phase 19a: {os.path.relpath(lib.path, ROOT)} built and loaded in "
        f"{built:.2f} s by {ver.splitlines()[0] if ver else '?'} ({card})")
    rng = np.random.default_rng(19)
    noise = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    smooth = np.cumsum(rng.integers(-2, 3, 60000)).astype(np.uint8).tobytes()
    payloads = {"noise": noise, "smooth": smooth, "kwkwk": b"a" * 8000,
                "text": b"TOBEORNOTTOBEORTOBEORNOT#" * 600,
                "mixed": noise[:5000] + bytes(9000) + smooth[:20000]}
    n_cmp, widths, clears, kwkwk = 0, set(), 0, 0
    for name, data in payloads.items():
        for every in (0, 300):
            seen = {}
            enc = lzw_encode(data, every, seen)
            widths |= set(seen["widths"])
            clears += seen["clears"]
            kwkwk += seen["kwkwk"]
            got = lib.lzw_decode(enc, len(data))
            if got != data or tg.lzw_decode_plain(enc, len(data)) != data:
                raise AssertionError(f"19a: LZW {name} (CLEAR every "
                                     f"{every}) decodes differently")
            n_cmp += 1
        pb = packbits_encode(data)
        if lib.packbits_decode(pb, len(data)) != data or \
                tg.packbits_decode_plain(pb, len(data)) != data:
            raise AssertionError(f"19a: PackBits {name} differs")
        n_cmp += 1
    if widths != {9, 10, 11, 12} or clears < 20 or not kwkwk:
        raise AssertionError(f"19a: streams covered widths {widths}, "
                             f"{clears} CLEARs, {kwkwk} KwKwK codes")
    for dt in (np.int16, np.uint8):
        info = np.iinfo(dt)
        arr = rng.integers(info.min, info.max, (512, 512, 1),
                           dtype=np.int64).astype(dt)
        got = arr.copy()
        if not lib.unpredict_h(got) or \
                not np.array_equal(got, tg.unpredict_h_plain(arr)):
            raise AssertionError(f"19a: predictor 2 on {dt.__name__}")
        n_cmp += 1
    f = rng.normal(size=(512, 512)).astype(np.float32)
    raw = predict_fp(f)
    got = lib.unpredict_fp(raw, 512, 512, 1, 4)
    if got != tg.unpredict_fp_plain(raw, 512, 512, 1, 4) or \
            not np.array_equal(np.frombuffer(got, "<f4").reshape(512, 512),
                               f):
        raise AssertionError("19a: predictor 3 on float32")
    n_cmp += 1
    # one 512 x 512 int16 tile of a smooth band, predictor 2, its real
    # LZW stream (codes widen to 12 bits)
    yy, xx = np.mgrid[0:512, 0:512].astype(np.float32)
    tile = (900.0 + 500.0 * np.sin(xx / 97.0) * np.cos(yy / 131.0)
            + rng.integers(-60, 61, (512, 512))).astype(np.int16)
    raw = predict_h(tile).astype("<i2").tobytes()
    enc = lzw_encode(raw)
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        out = lib.lzw_decode(enc, len(raw))
    nat = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    py = tg.lzw_decode_plain(enc, len(raw))
    pys = time.perf_counter() - t0
    if out != raw or py != raw:
        raise AssertionError("19a: the timed tile decodes differently")
    a = np.frombuffer(raw, "<i2").reshape(512, 512, 1)
    t0 = time.perf_counter()
    for _ in range(reps):
        b = a.copy()
        lib.unpredict_h(b)
    un = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    tg.unpredict_h_plain(a.copy())
    unp = time.perf_counter() - t0
    mb = len(raw) / 1e6
    log(f"phase 19a: {n_cmp} codec-vs-plain comparisons equal (LZW code "
        f"widths {sorted(widths)}, {clears} CLEARs, {kwkwk} KwKwK codes; "
        f"PackBits; predictor 2 int16/uint8, 3 float32); one 512 x 512 "
        f"int16 tile ({len(enc)} B LZW stream): decode native "
        f"{mb / nat:.1f} MB/s, Python {mb / pys:.2f} MB/s "
        f"({pys / nat:.0f}x); predictor 2 native {mb / un:.0f} MB/s, "
        f"numpy {mb / unp:.0f} MB/s (host, {card})")
    return n_cmp


def write_lzw(path, data, gt, crs, nodata):
    """One integer band as a tiled LZW + predictor-2 GeoTIFF with
    overview IFDs at block centres (`write_geotiff`'s sampling)."""
    from gsky_tpu_torch.io import geotiff as tg

    class Writer(tg.GeoTIFFWriter):
        def _encode_block(self, block):
            ts = self.tile_size
            full = np.full((ts, ts), nodata, dtype=self.dtype)
            full[:block.shape[1], :block.shape[2]] = block[0]
            return lzw_literal(predict_h(full).astype(
                self.dtype.newbyteorder("<")).tobytes())

        def _base_tags(self, width, height, tile_map, txs, tys):
            tags = super()._base_tags(width, height, tile_map, txs, tys)
            return [(t, typ, [tg.COMP_LZW] if t == tg.T_COMPRESSION
                     else v) for t, typ, v in tags] + \
                [(tg.T_PREDICTOR, 3, [2])]

    h, w = data.shape
    wr = Writer(path, 1, h, w, data.dtype, gt, crs, nodata=nodata,
                tile_size=LZW_TILE, compress=False)
    ts = LZW_TILE
    for ty in range(wr.tiles_y):
        for tx in range(wr.tiles_x):
            wr.write_tile(tx, ty, data[None, ty * ts:(ty + 1) * ts,
                                       tx * ts:(tx + 1) * ts])
    for f in LZW_OVERVIEWS:
        wr.append_overview(data[f // 2::f, f // 2::f][:h // f, :w // f])
    wr.close()


def lzw_stamp(doy):
    return MOSAIC_T0 + (int(doy) - 1) * 86400.0


def write_lzw_archive(root, shape=(SCENE_H, SCENE_W)):
    """19b: per acquisition LC08_B4 and LC08_B5 (int16, nodata -999) under
    ``bands/`` and pixel_qa (uint16, fill 1, cloud and shadow blobs) under
    ``qa/``, LZW + predictor 2, named as the USGS names them so that the
    built-in ``landsat`` rule dates them; the first date's LC08_B4 again
    uncompressed under ``plain/``.  Returns [(path, namespace)]."""
    from gsky_tpu_torch.geo.crs import parse_crs
    from gsky_tpu_torch.geo.transform import GeoTransform
    from gsky_tpu_torch.io.geotiff import write_geotiff
    h, w = shape
    utm = parse_crs("EPSG:32755")
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    collar = (xx + yy) < 1500
    for d in ("bands", "qa", "plain"):
        os.makedirs(os.path.join(root, d))
    out = []
    for i, doy in enumerate(LZW_DOYS):
        rng = np.random.default_rng(90 + i)
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
        qa = np.full(shape, 322, np.uint16)
        qa[cloud] = 352
        qa[shadow] = 328
        for arr, fill in ((red, -999), (nir, -999), (qa, 1)):
            arr[collar] = fill
        name = f"LC80900852020{doy}LGN00"
        for band, sub, ns, arr, nd in (
                ("B4", "bands", "LC08_B4", red, -999),
                ("B5", "bands", "LC08_B5", nir, -999),
                ("pixel_qa", "qa", "pixel_qa", qa, 1)):
            p = os.path.join(root, sub, f"{name}_{band}.TIF")
            write_lzw(p, arr, gt, utm, nd)
            out.append((p, ns))
        if i == 0:
            p = os.path.join(root, "plain", f"{name}_B4.TIF")
            write_geotiff(p, red, gt, utm, nodata=-999, compress=False,
                          overviews=LZW_OVERVIEWS)
            out.append((p, "LC08_B4"))
        del red, nir, qa, cloud, shadow
    return out


class CaptureFirst:
    """The first call's arguments of ``mod.name`` while installed; the
    wrapper it calls counts launches as always."""

    def __init__(self, mod, name):
        self.mod, self.name = mod, name
        self.orig = getattr(mod, name)
        self.args = None
        setattr(mod, name, self._call)

    def _call(self, *a, **k):
        if self.args is None:
            self.args = (a, k)
        return self.orig(*a, **k)

    def remove(self):
        setattr(self.mod, self.name, self.orig)


def csv_rows(body):
    """(dates, values) of every CSV block of a WPS Execute response."""
    from xml.etree import ElementTree
    ns = {"wps": "http://www.opengis.net/wps/1.0.0"}
    out = []
    for el in ElementTree.fromstring(body).iterfind(".//wps:ComplexData",
                                                    ns):
        rows = [line.split(",") for line in (el.text or "").splitlines()]
        out.append(([r[0] for r in rows], np.array(
            [[float(v) if v else np.nan for v in r[1:]] for r in rows])))
    return out


def same_csv(a, b, what, rtol=1e-5):
    ra, rb = csv_rows(a), csv_rows(b)
    if len(ra) != len(rb) or not ra:
        raise AssertionError(f"{what}: {len(ra)} vs {len(rb)} CSV blocks")
    for (da, va), (db, vb) in zip(ra, rb):
        if da != db or va.shape != vb.shape or \
                not np.array_equal(np.isnan(va), np.isnan(vb)):
            raise AssertionError(f"{what}: dates or NaNs differ")
        ok = ~np.isnan(va)
        rel = np.abs(va[ok] - vb[ok]) / np.maximum(np.abs(va[ok]), 1e-30)
        if rel.size and rel.max() > rtol:
            raise AssertionError(f"{what}: rel {rel.max()} > {rtol}")
    return ra[0][0]


def phase_ingest(root, card, dev="cuda", serving=None):
    """Phases 19b and 19c over an archive written under ``root``, then
    ``serving(root, watcher, card server, CPU server, card)`` (phase
    20c's drill and 20e) while the masapi and the stack are up.
    Returns ({kernel: launches} of the main path, max |kernel - plain|
    of its captured launches, ``serving``'s result)."""
    import torch
    from urllib.parse import parse_qs, urlsplit
    from gsky_tpu_torch import ingest
    from gsky_tpu_torch.geo import geometry as geom
    from gsky_tpu_torch.index import api as mas_api
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.index.rulesets import match_rule
    from gsky_tpu_torch.index.sharded import MASShardedStore
    from gsky_tpu_torch.index.store import fmt_time
    from gsky_tpu_torch.ingest import staging
    from gsky_tpu_torch.io.geotiff import GeoTIFF
    from gsky_tpu_torch.ops import first_valid, paged, warp_render
    from gsky_tpu_torch.ops import stats as kstats
    from gsky_tpu_torch.pipeline import drill as tdrill
    from gsky_tpu_torch.pipeline import drill_cache as DC
    from gsky_tpu_torch.pipeline.scene_cache import SceneCache
    from gsky_tpu_torch.pipeline.types import Granule
    from gsky_tpu_torch.server.config import ConfigWatcher
    from gsky_tpu_torch.server.ows import OWSServer

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    total = dict.fromkeys(_kernel_counts(), 0)
    t0 = time.perf_counter()
    paths = write_lzw_archive(root)
    drill_dir = os.path.join(root, "drill")
    os.makedirs(drill_dir)
    drill_path = os.path.join(drill_dir, "ndvi_stack.nc")
    write_drill_stack(drill_path, INGEST_T)
    size = sum(os.path.getsize(p) for p, _ in paths) \
        + os.path.getsize(drill_path)
    with GeoTIFF(paths[0][0]) as g:
        dims = f"{g.width} x {g.height}"
    log(f"phase 19b: {len(paths)} GeoTIFFs ({len(paths) - 1} LZW + "
        f"predictor 2, {dims}, {LZW_TILE}^2 tiles, overviews "
        f"{LZW_OVERVIEWS}; one uncompressed) and 19c's {INGEST_T}-step "
        f"stack ({size / 1e9:.3f} GB) written in "
        f"{time.perf_counter() - t0:.1f} s ({card})")

    # -- crawl with the built-in rules into a sharded store --------------
    t0 = time.perf_counter()
    store = MASShardedStore(root)
    recs = {}
    for p, ns in paths + [(drill_path, None)]:
        rec = extract(p)
        if rec.get("error"):
            raise AssertionError(f"19b crawl {p}: {rec['error']}")
        if p.endswith(".TIF"):
            rule, m = match_rule(p)
            doy = os.path.basename(p)[13:16]
            want = [fmt_time(lzw_stamp(doy))]
            if rule.collection != "landsat" or any(
                    ds["timestamps"] != want for ds in rec["geo_metadata"]):
                raise AssertionError(f"19b: {p} matched {rule.collection}, "
                                     f"timestamps {rec['geo_metadata']}")
        for ds in rec["geo_metadata"]:
            ds["namespace"] = ns or ds["namespace"]
        store.ingest(rec)
        recs[p] = rec
    qa_path = next(p for p, ns in paths if ns == "pixel_qa")
    qa_band = match_rule(qa_path)[1].group("band")
    log(f"phase 19b: crawled into a MASShardedStore of shards "
        f"{sorted(store._shards)} in {time.perf_counter() - t0:.2f} s; "
        f"the built-in 'landsat' rule dated every GeoTIFF from its name "
        f"(its band group reads {qa_band!r} of '..._pixel_qa.TIF': it "
        f"takes no '_'); namespaces set from the band ({card})")

    api = mas_api.MasAPI(store)
    mas_httpd = api.serve("127.0.0.1", 0)
    bands, qa = os.path.join(root, "bands"), os.path.join(root, "qa")
    plain_dir = os.path.join(root, "plain")
    conf = os.path.join(root, "conf")
    os.makedirs(conf)
    mask = {"id": "pixel_qa", "data_source": qa,
            "bit_tests": CLOUD_SHADOW}
    styles = [{"name": m, "title": m, "rgb_products": ["LC08_B4"],
               "resample": m} for m in ("near", "bilinear")]
    with open(os.path.join(conf, "config.json"), "w") as fp:
        json.dump({
            "service_config": {
                "mas_address": f"127.0.0.1:{mas_httpd.server_address[1]}"},
            "layers": [
                {"name": "lzw", "data_source": bands,
                 "rgb_products": ["LC08_B4"], "time_generator": "mas",
                 "styles": styles},
                {"name": "lzw_b5", "data_source": bands,
                 "rgb_products": ["LC08_B5"], "time_generator": "mas"},
                {"name": "lzw_masked", "data_source": bands,
                 "rgb_products": ["LC08_B4"], "resample": "bilinear",
                 "time_generator": "mas", "mask": mask,
                 "clip_value": 2000},
                {"name": "plain_b4", "data_source": plain_dir,
                 "rgb_products": ["LC08_B4"], "time_generator": "mas",
                 "styles": styles}],
            "processes": [
                {"identifier": "ingest_drill", "approx": False,
                 "data_sources": [{"data_source": drill_dir,
                                   "rgb_products": ["ndvi"]}]},
                # phase 20c: the same drill under a 1 s budget
                {"identifier": "ingest_drill_dl", "approx": False,
                 "data_sources": [{"data_source": drill_dir,
                                   "rgb_products": ["ndvi"],
                                   "wcs_timeout": 1}]}]}, fp)
    # no mas_factory: every namespace reaches the masapi over HTTP
    watcher = ConfigWatcher(conf, install_signal=False)
    srv = OWSServer(watcher, device=dev, gateway=None)
    cpu = OWSServer(watcher, device="cpu", gateway=None)
    httpd = srv.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    ex = srv.executor
    kernels = _kernel_counts()
    t_both = (lzw_stamp(LZW_DOYS[0]) - 86400.0,
              lzw_stamp(LZW_DOYS[-1]) + 86400.0)
    t_first = (t_both[0], lzw_stamp(LZW_DOYS[0]) + 86400.0)
    errs = {"B1": 0.0, "B2": 0.0, "B3": 0.0, "B4": 0.0}
    for k in ("GSKY_STAGING_MB", "GSKY_INGEST_WINDOW_FRAC",
              "GSKY_INGEST", "GSKY_DRILL_CACHE"):
        os.environ.pop(k, None)
    staging.reset_staging_pool()
    ingest.stats.reset()

    def route(name, urls, need, method="near", check=None):
        """GET ``urls`` over HTTP with the counts set to 0 just before;
        ``need``: kernels that must have launched.  Two tiles again
        from the CPU server."""
        run = SatRun(ex)
        caps = [CaptureFirst(paged, "paged_render_scored"),
                CaptureFirst(warp_render, "warp_render_scored"),
                CaptureFirst(first_valid, "mosaic_first_valid_kernel")]
        bodies, secs = [], []
        try:
            for u in urls:
                status, ctype, body, s = http_get(u)
                if (status, ctype) != (200, "image/png"):
                    raise AssertionError(f"19b {name}: {status} "
                                         f"{body[:300]}")
                bodies.append(body)
                secs.append(s)
        finally:
            for c in reversed(caps):
                c.remove()
        run.close()
        run.need(*need)
        if check is not None:
            check(run.launches)
        for k in total:
            total[k] += run.launches[k]
        run.report(f"19b {name}", secs, card)
        hold(caps, run.launches)
        for u, b in list(zip(urls, bodies))[:LZW_CPU]:
            uu = urlsplit(u)
            r = cpu.handle(uu.path, parse_qs(uu.query), "")
            if r.status != 200:
                raise AssertionError(f"19b {name} CPU: {r.status}")
            same_decoded(method, b, r.body, f"19b {name} card vs CPU")
        return bodies

    def hold(caps, launches):
        """Each captured launch against its plain version on the same
        inputs (B1 on the pool as it is now); those launches do not
        count."""
        import inspect
        saved = {k: v.launches for k, v in kernels.items()}
        b1, b2, b4 = (None if c.args is None else inspect.signature(
            c.orig).bind(*c.args[0], **c.args[1]).arguments for c in caps)
        if b1 is not None:
            with ex.pool.locked_pool() as parr:
                kw = dict(b1, pool=parr)
                ck, bk = paged.paged_render_scored(**kw)
                cp, bp = paged.paged_render_scored_plain(**kw)
            errs["B1"] = max(errs["B1"], check_pair(
                kw["method"], ck, bk, cp, bp, "19b B1 vs plain"))
        if b2 is not None:
            ck, bk = warp_render.warp_render_scored(**b2)
            cp, bp = warp_render.warp_render_scored_plain(**b2)
            errs["B2"] = max(errs["B2"], check_pair(
                b2["method"], ck, bk, cp, bp, "19b B2 vs plain"))
        if b4 is not None:
            b4_same(first_valid.mosaic_first_valid_kernel(**b4),
                    first_valid.mosaic_first_valid_plain(**b4),
                    "19b B4 vs plain")
        for k, v in kernels.items():
            v.launches = saved[k]

    try:
        # -- fused tiles: staged loads of two LZW scenes, then B1 --------
        boxes = tile_boxes(*LZW_AT["fused"], nx=4, ny=4)[:LZW_FUSED]
        for m in ("near", "bilinear"):
            t0 = time.perf_counter()
            route(f"fused {m}", [getmap_url(base, "lzw", b, m, t_both)
                                 for b in boxes], ("B1",), m,
                  lambda n: n["B1"] == len(boxes) and not n["B4"])
            if m == "near":
                log(f"phase 19b: the first fused pass (two staged "
                    f"scene loads included) took "
                    f"{time.perf_counter() - t0:.2f} s; staging "
                    f"{staging.default_staging_pool().stats()}, staged "
                    f"loads {ex.cache.staged_loads} (GSKY_STAGING_MB "
                    f"default) ({card})")
        # -- the same rasters uncompressed: the same bytes --------------
        pl = boxes[:LZW_PLAIN]
        a = route("first date, LZW", [getmap_url(base, "lzw", b, "near",
                                                 t_first) for b in pl],
                  ("B1",))
        b = route("first date, uncompressed",
                  [getmap_url(base, "plain_b4", b, "near", t_first)
                   for b in pl], ("B1",))
        if a != b:
            raise AssertionError("19b: LZW tiles differ from the "
                                 "uncompressed rasters'")
        log(f"phase 19b: {len(pl)} tiles over the first date's LZW band "
            f"equal those over the same raster uncompressed, byte for byte")
        # -- masked tiles: ranged windows of LZW blocks, then B4 --------
        mboxes = tile_boxes(*LZW_AT["masked"], nx=4, ny=4)[:LZW_MASKED]
        before = ingest.stats.snapshot()
        route("masked", [getmap_url(base, "lzw_masked", b, "",
                                    t_both) for b in mboxes],
              ("B4",), "bilinear",
              lambda n: n["B4"] == len(mboxes) and not n["B1"])
        after = ingest.stats.snapshot()
        log(f"phase 19b masked: ranged windows "
            f"{after['ranged_windows'] - before['ranged_windows']}, "
            f"coalesced requests "
            f"{after['ranged_reads'] - before['ranged_reads']} for "
            f"{after['ranged_read_bytes'] - before['ranged_read_bytes']} "
            f"B, {after['read_s'] - before['read_s']:.3f} s in ranged "
            f"fetches ({card})")
        # -- 4x: the overview IFD at level 4 ----------------------------
        zboxes = tile_boxes(*LZW_AT["zoom"], zoom=4.0, nx=4,
                            ny=2)[:LZW_ZOOM]
        route("4x", [getmap_url(base, "lzw", b, "bilinear", t_both)
                     for b in zboxes], (), "bilinear",
              lambda n: n["B1"] + n["B2"] == len(zboxes))
        # -- window routing over LC08_B5 scenes not resident ------------
        os.environ["GSKY_INGEST_WINDOW_FRAC"] = LZW_ROUTE_FRAC
        decisions = []
        orig_route = ex.cache._route_window

        def spy(key, g, bbox, crs):
            r = orig_route(key, g, bbox, crs)
            decisions.append((key, r))
            return r

        ex.cache._route_window = spy
        w0 = ex.cache.window_routed
        try:
            rboxes = tile_boxes(*LZW_AT["routed"], nx=4,
                                ny=2)[:LZW_ROUTED]
            # a declined scene sends the tile down the modular route: its
            # ranged windows warped and mosaicked by B2
            route("window-routed", [getmap_url(base, "lzw_b5", b, "",
                                               t_both) for b in rboxes],
                  ("B2",))
        finally:
            del ex.cache._route_window
            os.environ.pop("GSKY_INGEST_WINDOW_FRAC", None)
        routed = ex.cache.window_routed - w0
        by_key = {}
        for key, r in decisions:
            by_key.setdefault(key, []).append(r)
        for key, seq in by_key.items():
            n = seq.index(False) if False in seq else len(seq)
            if any(seq[n:]) or n > LZW_PROMOTE - 1 or \
                    (n < len(seq) and n != LZW_PROMOTE - 1):
                raise AssertionError(f"19b: routing of {key[0]}: {seq}")
        if routed != sum(r for _, r in decisions) or not routed:
            raise AssertionError(f"19b: window_routed {routed}")
        log(f"phase 19b window-routed: {routed} declines over "
            f"{len(by_key)} scenes, each promoted on its "
            f"{LZW_PROMOTE}th ask as the reference's rule does "
            f"(decisions {[seq for seq in by_key.values()]})")

        # -- staging at GSKY_STAGING_MB 1024, and the load itself -------
        os.environ["GSKY_STAGING_MB"] = "1024"
        staging.reset_staging_pool()
        try:
            for rnd in range(2):
                ex.cache.clear()
                t0 = time.perf_counter()
                route(f"fused near, GSKY_STAGING_MB 1024, round {rnd}",
                      [getmap_url(base, "lzw", b, "near", t_both)
                       for b in boxes[:4]], ("B1",))
                log(f"phase 19b: 4 fused tiles after a cache clear "
                    f"(two staged loads) in "
                    f"{time.perf_counter() - t0:.2f} s; staging "
                    f"{staging.default_staging_pool().stats()} ({card})")
            rec = recs[paths[0][0]]["geo_metadata"][0]
            g = Granule(path=paths[0][0], ds_name=paths[0][0],
                        namespace="LC08_B4", base_namespace="LC08_B4",
                        band=1, time_index=None,
                        timestamp=lzw_stamp(LZW_DOYS[0]),
                        srs="EPSG:32755",
                        geo_transform=rec["geotransform"], nodata=-999.0)
            # one load each: pinned from the rounds' pool (a reused
            # buffer, no cudaHostAlloc), pageable (over the default
            # budget), classic
            loads = {}
            for what, ingest_on, mb in (("staged, pinned (1024 MB)", "1",
                                         "1024"),
                                        ("staged, pageable (128 MB)", "1",
                                         "128"),
                                        ("classic", "0", "128")):
                os.environ["GSKY_INGEST"] = ingest_on
                if mb != os.environ["GSKY_STAGING_MB"]:
                    os.environ["GSKY_STAGING_MB"] = mb
                    staging.reset_staging_pool()
                sc = SceneCache(device=dev)
                sync()
                t0 = time.perf_counter()
                s = sc.get(g)
                sync()
                loads[what] = (time.perf_counter() - t0, s.dev)
                del sc
            a_, b_ = loads["staged, pinned (1024 MB)"][1], \
                loads["classic"][1]
            if not torch.equal(a_.view(torch.int32), b_.view(torch.int32)):
                raise AssertionError("19b: a staged scene's bits differ "
                                     "from the classic load's")
            log(f"phase 19b: one {dims} LZW scene load (decode, "
                "NaN-encode, upload, host clock): " + ", ".join(
                    f"{k} {v[0] * 1e3:.1f} ms" for k, v in loads.items())
                + f"; staged bits equal the classic ({card})")
            del loads, a_, b_
        finally:
            for k in ("GSKY_STAGING_MB", "GSKY_INGEST"):
                os.environ.pop(k, None)
            staging.reset_staging_pool()
        n_tiles = 2 * len(boxes) + 2 * len(pl) + len(mboxes) \
            + len(zboxes) + len(rboxes) + 8
        reqs = sum(p.mas.requests for _, p in srv._pipelines.values())
        fb = ingest.stats.snapshot()["fallbacks"]
        if fb:
            raise AssertionError(f"19b: {fb} ranged reads fell back")
        log(f"phase 19b: {n_tiles} tiles over HTTP; the card server's MAS "
            f"clients sent {reqs} requests; the masapi answered "
            f"{api.cache.hits} from its cache and computed "
            f"{api.cache.misses}; ranged-read fallbacks 0; ingest "
            f"{ingest.stats.snapshot()} ({card})")

        # -- 19c: a drill whose index comes over HTTP -------------------
        g = geom.from_wkt(DRILL_POLY)
        gj = json.dumps({"type": "Polygon", "coordinates": [
            r.tolist() for r in g.polys[0]]})
        body = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<wps:Execute service="WPS" version="1.0.0" '
            'xmlns:wps="http://www.opengis.net/wps/1.0.0" '
            'xmlns:ows="http://www.opengis.net/ows/1.1">'
            "<ows:Identifier>ingest_drill</ows:Identifier><wps:DataInputs>"
            "<wps:Input><ows:Identifier>geometry</ows:Identifier>"
            f"<wps:Data><wps:ComplexData>{gj}</wps:ComplexData></wps:Data>"
            "</wps:Input></wps:DataInputs></wps:Execute>").encode()
        url = f"{base}/ows?service=WPS"
        dc = DC.for_device(torch.device(dev))
        dc.clear()
        reset_counts(kernels)
        before = ingest.stats.snapshot()
        t0 = time.perf_counter()
        status, _, cold, _ = http_fetch(url, body)
        cold_s = time.perf_counter() - t0
        after = ingest.stats.snapshot()
        nwin = after["ranged_windows"] - before["ranged_windows"]
        if status != 200 or kernels["B3"].launches or nwin != INGEST_T:
            raise AssertionError(f"19c cold: {status}, B3 "
                                 f"{kernels['B3'].launches}, ranged "
                                 f"windows {nwin}")
        if not dc.wait_idle(600):
            raise AssertionError("19c: the stack upload did not finish")
        run = SatRun()
        cap = CaptureFirst(tdrill, "masked_stats")
        lat = []
        try:
            for _ in range(INGEST_DRILLS):
                status, _, warm, s = http_fetch(url, body)
                lat.append(s)
        finally:
            cap.remove()
        run.close()
        run.need("B3")
        for k in total:
            total[k] += run.launches[k]
        same_csv(cold, warm, "19c warm vs cold")
        r = cpu.handle("/ows", {"service": ["WPS"]}, "", body, {})
        dates = same_csv(r.body, warm, "19c card vs CPU")
        saved = kernels["B3"].launches
        s_k, c_k = kstats.masked_stats(*cap.args[0])
        s_p, c_p = kstats.masked_stats_plain(*cap.args[0])
        kernels["B3"].launches = saved
        if not (torch.equal(c_k, c_p) and torch.equal(
                s_k.view(torch.int32), s_p.view(torch.int32))):
            raise AssertionError("19c: B3 differs from its plain version")
        errs["B3"] = float((s_k - s_p).abs().max())
        log(f"phase 19c: WPS Execute over HTTP, the index over HTTP: cold "
            f"{cold_s * 1e3:.1f} ms ({nwin} ranged NetCDF-3 windows, "
            f"{after['ranged_reads'] - before['ranged_reads']} requests, "
            f"no launch); {INGEST_DRILLS} warm drills of {len(dates)} "
            f"steps {ms_stats(lat)}; launches {run.launches}; B3 "
            f"bit-exact against its plain version at "
            f"{tuple(cap.args[0][0].shape)}; warm = cold, card = CPU "
            f"(rel 1e-5) ({card})")
        served = None if serving is None else \
            serving(root, watcher, srv, cpu, card)
        dc.clear()
    finally:
        httpd.shutdown()
        httpd.server_close()
        mas_httpd.shutdown()
        mas_httpd.server_close()
    return total, errs, served


# -- phase 20: the serving path under load -------------------------------

SRV_THREADS = 16             # 20a, 20b, 20d: client threads
SRV_BATCH_TILES = 16         # 20a: distinct native bilinear tiles
SRV_ADMIT_TILES = 32         # 20b: distinct tiles under admission
SRV_PAN = 8                  # 20f: tiles a client pans east
SRV_FAULT_TILES = 8          # 20e: tiles under mas:error:0.2
SRV_WAVE_MAX = 16            # GSKY_WAVE_MAX's default; brownout halves it


def ogc_code(body):
    m = re.search(rb'exceptionCode="([^"]*)"', body)
    return m.group(1).decode() if m else None


def fetch_threads(get, urls, threads):
    """``get(url)`` of every url from ``threads`` threads started
    together: the answers in url order and the wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    import threading
    go = threading.Event()

    def one(u):
        go.wait(60)
        return get(u)
    with ThreadPoolExecutor(threads) as ex:
        futs = [ex.submit(one, u) for u in urls]
        t0 = time.perf_counter()
        go.set()
        out = [f.result() for f in futs]
    return out, time.perf_counter() - t0


def same_answer(card_ans, cpu_ans, method, what):
    """Card vs CPU answers: equal status, OGC exception code and the
    Retry-After, X-GSKY-Degraded and X-Gsky-Cache headers; 200 bodies
    decode equal (nearest) or within 0.1% of bytes."""
    (cs, ch, cb, _), (ps, ph, pb, _) = card_ans, cpu_ans
    if cs != ps:
        raise AssertionError(f"{what}: card {cs}, CPU {ps}: {pb[:200]}")
    for k in ("Retry-After", "X-GSKY-Degraded", "X-Gsky-Cache"):
        if ch.get(k) != ph.get(k):
            raise AssertionError(f"{what}: {k} card {ch.get(k)!r}, CPU "
                                 f"{ph.get(k)!r}")
    if cs == 200:
        return same_decoded(method, cb, pb, what)
    if ogc_code(cb) != ogc_code(pb):
        raise AssertionError(f"{what}: codes {ogc_code(cb)}, "
                             f"{ogc_code(pb)}")
    return 0


class PlannerIdle:
    """Wraps the prefetch planner's warm callback to count warms in
    flight, so a caller can wait until the planner is idle."""

    def __init__(self, planner, warm_fn):
        import threading
        self.planner, self.inner = planner, warm_fn
        self.busy, self.lock = 0, threading.Lock()
        planner.warm_fn = self

    def __call__(self, *key):
        with self.lock:
            self.busy += 1
        try:
            return self.inner(*key)
        finally:
            with self.lock:
                self.busy -= 1

    def wait(self, timeout=60.0):
        end = time.monotonic() + timeout
        quiet = 0
        while time.monotonic() < end:
            with self.planner._lock:
                pending = len(self.planner._pending)
            quiet = quiet + 1 if not pending and not self.busy else 0
            if quiet >= 3:
                return
            time.sleep(0.01)
        raise AssertionError("the prefetch planner did not go idle")


def phase_serving(data_root, data_paths, store, card):
    """Phases 20a, 20b, 20d and 20f over phase 3's archive.  Returns the
    launches {kernel: n} of their main-path runs."""
    import torch
    from gsky_tpu_torch.ingest import prefetch
    from gsky_tpu_torch.ingest import stats as ingest_stats
    from gsky_tpu_torch.ops import paged
    from gsky_tpu_torch.pipeline import drill_cache as DC
    from gsky_tpu_torch.resilience import default_monitor
    from gsky_tpu_torch.serving import AdmissionController, \
        ServingGateway, default_gateway
    kernels = _kernel_counts()
    total = dict.fromkeys(kernels, 0)
    # the overview: one of phase 3's granules (a hard link) in a
    # collection of its own, so that its tile differs from the layer's
    ov_dir = os.path.join(ROOT, "build", "smoke_archive_ov")
    shutil.rmtree(ov_dir, ignore_errors=True)
    os.makedirs(ov_dir)
    ov_path = os.path.join(ov_dir, os.path.basename(data_paths[0]))
    os.link(data_paths[0], ov_path)
    from gsky_tpu_torch.index.crawler import extract
    rec = extract(ov_path)
    for ds in rec["geo_metadata"]:
        ds["namespace"] = NS
    store.ingest(rec)
    styles = [{"name": m, "title": m, "rgb_products": [NS], "resample": m}
              for m in METHODS]
    layers = [
        {"name": "plain", "data_source": data_root, "rgb_products": [NS],
         "styles": styles},
        {"name": "browned", "data_source": data_root,
         "rgb_products": [NS],
         "overviews": [{"name": "browned_ov", "data_source": ov_dir,
                        "rgb_products": [NS], "zoom_limit": 1.0e6}]},
        {"name": "ov_direct", "data_source": ov_dir, "rgb_products": [NS]},
    ]
    pair = OwsPair(os.path.join(data_root, "conf20"), layers, store,
                   gateway=default_gateway, cpu_gateway=ServingGateway())
    gw = pair.card.gateway
    saved_admission = gw.admission
    boxes = tile_boxes()
    try:
        def card_get(u):
            return http_status(u)

        # -- 20a: the render batcher -------------------------------------
        urls = [getmap_url(pair.base, "plain", b, "bilinear")
                for b in boxes[:SRV_BATCH_TILES]]
        http_status(urls[0])                # warm: scenes resident
        pair.clear_caches()
        ex = pair.card.executor
        reset_counts(kernels)
        percall, wall_pc = fetch_threads(card_get, urls, SRV_THREADS)
        pc_launch = read_counts(kernels)
        if any(a[0] != 200 for a in percall) or \
                pc_launch["B1"] != SRV_BATCH_TILES:
            raise AssertionError(f"20a per call: {[a[0] for a in percall]}"
                                 f", launches {pc_launch}")
        pair.clear_caches()
        os.environ["GSKY_RENDER_BATCH"] = "1"
        cap = CaptureFirst(paged, "paged_render_scored")
        run = SatRun(ex)
        try:
            batched, wall_b = fetch_threads(card_get, urls, SRV_THREADS)
        finally:
            run.close()
            cap.remove()
        b = ex.batcher
        if run.launches["B1"] != b.paged_batches or \
                sum(b.flush_sizes) != SRV_BATCH_TILES or \
                run.launches["B2"]:
            raise AssertionError(f"20a: launches {run.launches}, flushes "
                                 f"{b.flush_sizes}")
        if [a[2] for a in batched] != [a[2] for a in percall]:
            raise AssertionError("20a: batched tiles differ from the "
                                 "per-call tiles")
        for k in total:
            total[k] += run.launches[k]
        import inspect
        args = inspect.signature(cap.orig).bind(*cap.args[0],
                                                **cap.args[1]).arguments
        saved = kernels["B1"].launches
        with ex.pool.locked_pool() as parr:
            kw = dict(args, pool=parr)
            ck, bk = paged.paged_render_scored(**kw)
            cp, bp = paged.paged_render_scored_plain(**kw)
        kernels["B1"].launches = saved
        err = check_pair("bilinear", ck, bk, cp, bp, "20a flush vs plain")
        cpu_b, _ = fetch_threads(pair.cpu_get, urls[:2], 2)
        for u, c, p in zip(urls, batched, cpu_b):
            same_answer(c, p, "bilinear", "20a card vs CPU")
        os.environ.pop("GSKY_RENDER_BATCH")
        log(f"phase 20a: {SRV_BATCH_TILES} tiles from {SRV_THREADS} threads "
            f"batched: {SRV_BATCH_TILES / wall_b:.1f} tiles/s, "
            f"{ms_stats([a[3] for a in batched])}; {b.paged_batches} "
            f"flushes of {b.flush_sizes} tiles, one B1 launch each "
            f"(launches {run.launches}), padding {b.pad_waste_bytes} B, "
            f"knee {b.knee}; per call: {SRV_BATCH_TILES / wall_pc:.1f} "
            f"tiles/s, {ms_stats([a[3] for a in percall])}; bytes equal; "
            f"the first flush's B1 (N={int(args['tables'].shape[0])}) vs "
            f"plain max |diff| {err} ({card})")

        # -- 20b: admission, fixed then adaptive ------------------------
        os.environ.update({"GSKY_ADMIT_ADAPTIVE": "0", "GSKY_ADMIT_WMS": "2",
                           "GSKY_ADMIT_QUEUE_S": "0.05"})
        urls = [getmap_url(pair.base, "plain", b, "bilinear")
                for b in boxes[:SRV_ADMIT_TILES]]
        import threading
        for mode in ("fixed", "adaptive"):
            adaptive = mode == "adaptive"
            pair.clear_caches()
            gw.admission = AdmissionController(adaptive=adaptive)
            pair.cpu.gateway.admission = AdmissionController(
                adaptive=adaptive)
            peak, stop = [0], threading.Event()

            def watch():
                while not stop.is_set():
                    peak[0] = max(peak[0], gw.admission.stats()[
                        "classes"]["WMS"]["in_use"])
                    time.sleep(0.0005)
            w = threading.Thread(target=watch, daemon=True)
            w.start()
            reset_counts(kernels)
            try:
                got, wall = fetch_threads(card_get, urls, SRV_THREADS)
            finally:
                stop.set()
                w.join(10)
            n = read_counts(kernels)
            st = gw.admission.stats()["classes"]["WMS"]
            ok = [a for a in got if a[0] == 200]
            shed = [a for a in got if a[0] == 503]
            if len(ok) + len(shed) != len(urls) or not shed or \
                    n["B1"] != len(ok) or st["shed"] != len(shed) or \
                    peak[0] > 2 or st["in_use"]:
                raise AssertionError(
                    f"20b {mode}: 200s {len(ok)}, 503s {len(shed)}, B1 "
                    f"{n['B1']}, peak in use {peak[0]}, stats {st}")
            for a in shed:
                if ogc_code(a[2]) != "ServerBusy" or \
                        a[1].get("Retry-After") != "1":
                    raise AssertionError(f"20b {mode}: {a[0]} {a[1]}")
            for k in total:
                total[k] += n[k]
            cpu_got, _ = fetch_threads(pair.cpu_get, urls, SRV_THREADS)
            cst = pair.cpu.gateway.admission.stats()["classes"]["WMS"]
            for a in cpu_got:
                if a[0] not in (200, 503) or (a[0] == 503 and (
                        ogc_code(a[2]) != "ServerBusy"
                        or a[1].get("Retry-After") != "1")):
                    raise AssertionError(f"20b {mode} CPU: {a[0]} {a[1]}")
            log(f"phase 20b {mode} (GSKY_ADMIT_WMS 2, queue 0.05 s): "
                f"{len(urls)} distinct tiles from {SRV_THREADS} threads: "
                f"{len(ok)} 200 ({ms_stats([a[3] for a in ok])}), "
                f"{len(shed)} shed 503 ServerBusy Retry-After 1 "
                f"({ms_stats([a[3] for a in shed])}); in use at most "
                f"{peak[0]}; B1 launches {n['B1']} = the 200s; "
                f"effective_limit {st['effective_limit']}, limit "
                f"{st['limit']}, adjustments {st['adjustments']}, "
                f"recent {st['recent_ms']} ms, baseline "
                f"{st['baseline_ms']} ms; wall {wall:.3f} s; CPU server "
                f"{sum(a[0] == 200 for a in cpu_got)} 200, {cst['shed']} "
                f"shed, codes and Retry-After equal ({card})")
        for k in ("GSKY_ADMIT_ADAPTIVE", "GSKY_ADMIT_WMS",
                  "GSKY_ADMIT_QUEUE_S"):
            os.environ.pop(k)
        gw.admission = saved_admission
        pair.cpu.gateway.admission = AdmissionController()

        # -- 20d: pressure and brownout ---------------------------------
        mon = default_monitor()
        box = boxes[SRV_ADMIT_TILES - 1]
        pair.clear_caches()
        direct = getmap_url(pair.base, "ov_direct", box)
        ov_tile = http_status(direct)
        browned = getmap_url(pair.base, "browned", box)
        entries = len(gw.cache)
        try:
            mon.force(1)
            reset_counts(kernels)
            card_a = http_status(browned)
            n = read_counts(kernels)
            cpu_a = pair.cpu_get(browned)
            same_answer(card_a, cpu_a, "near", "20d brownout")
            if card_a[0] != 200 or \
                    card_a[1].get("X-GSKY-Degraded") != "brownout":
                raise AssertionError(f"20d brownout: {card_a[:2]}")
            same_decoded("near", card_a[2], ov_tile[2],
                         "20d brownout tile vs the overview's")
            if len(gw.cache) != entries:
                raise AssertionError("20d: a degraded response was cached")
            for k in total:
                total[k] += n[k]
            log(f"phase 20d force(1): X-GSKY-Degraded brownout, the tile "
                f"is the overview's ({n}), the CPU server's label and "
                f"bytes equal, nothing cached ({card})")
            # waves on: a wave takes at most half GSKY_WAVE_MAX lanes
            with WavesOn() as waves:
                pair.clear_caches()
                urls = [getmap_url(pair.base, "plain", b, "bilinear")
                        for b in boxes[:SRV_ADMIT_TILES]]
                reset_counts(kernels)
                got, wall = fetch_threads(card_get, urls, SRV_THREADS)
                n = read_counts(kernels)
                ws = wave_stats_of(waves)
                occ = ws.get("occupancy", {})
                if any(a[0] != 200 or a[1].get("X-GSKY-Degraded")
                       != "brownout" for a in got) or not occ or \
                        max(occ) > SRV_WAVE_MAX // 2 or \
                        ws["effective_max"] != SRV_WAVE_MAX // 2 or \
                        ws["queue_depth"] != 1:
                    raise AssertionError(f"20d waves: {ws}")
                cpu_a = pair.cpu_get(urls[0])
                same_answer(got[0], cpu_a, "bilinear", "20d waves")
                for k in total:
                    total[k] += n[k]
                log(f"phase 20d force(1), waves on: {len(urls)} tiles from "
                    f"{SRV_THREADS} threads, {len(urls) / wall:.1f} "
                    f"tiles/s; lanes per wave {occ} <= {SRV_WAVE_MAX // 2}"
                    f" (GSKY_WAVE_MAX {SRV_WAVE_MAX} halved), run-ahead "
                    f"{ws['queue_depth']}; launches {n} ({card})")
            # critical: caches emptied, staging declined -> B2
            sc = pair.card.executor.cache
            ref = http_status(getmap_url(pair.base, "plain", box,
                                         "bilinear"))
            trims = mon.trims
            pair.card.executor.pool.declined = 0
            mon.force(2)
            stacks = sum(len(c._stacks) for c in DC._caches.values())
            if mon.trims != trims + 1 or sc._scenes or len(gw.cache) \
                    or stacks:
                raise AssertionError(f"20d force(2): trims {mon.trims}, "
                                     f"scenes {len(sc._scenes)}, "
                                     f"responses {len(gw.cache)}, drill "
                                     f"stacks {stacks}")
            pair.clear_caches()
            reset_counts(kernels)
            url = getmap_url(pair.base, "plain", box, "bilinear")
            card_a = http_status(url)
            n = read_counts(kernels)
            if card_a[0] != 200 or n["B1"] or n["B2"] != 1 or \
                    not pair.card.executor.pool.declined:
                raise AssertionError(f"20d force(2): {card_a[:2]}, {n}")
            d = same_decoded("bilinear", card_a[2], ref[2],
                             "20d B2 tile vs its B1 tile")
            same_answer(card_a, pair.cpu_get(url), "bilinear",
                        "20d force(2)")
            for k in total:
                total[k] += n[k]
            log(f"phase 20d force(2): relief ran once (trims "
                f"{mon.trims}), scene, drill and response caches empty; "
                f"the pool declined staging, the tile took B2 ({n}), "
                f"{d} decoded bytes from its B1 tile; CPU server equal "
                f"({card})")
        finally:
            mon.force(None)
            mon.reset()
        card_a = http_status(browned)
        if "X-GSKY-Degraded" in card_a[1]:
            raise AssertionError("20d force(None): still labelled")
        same_answer(card_a, pair.cpu_get(browned), "near", "20d cleared")

        # -- 20f: prefetch along a pan ----------------------------------
        os.environ["GSKY_PREFETCH"] = "1"
        row = boxes[SRV_PAN:2 * SRV_PAN]
        urls = [getmap_url(pair.base, "plain", b, "bilinear") for b in row]
        cold = {u: a[2] for u, a in zip(urls, percall[SRV_PAN:])}
        outcomes = {}
        for who in ("card", "cpu"):
            prefetch.reset_default_planner()
            ingest_stats.reset()
            pair.clear_caches()
            srv = pair.card if who == "card" else pair.cpu
            planner = prefetch.default_planner()
            idle = PlannerIdle(planner, srv._prefetch_warm)
            reset_counts(kernels)
            lat = []
            for u in urls:
                a = http_status(u) if who == "card" else pair.cpu_get(u)
                if a[0] != 200:
                    raise AssertionError(f"20f {who}: {a[0]}")
                if who == "card" and a[2] != cold[u]:
                    raise AssertionError("20f: a tile differs from the "
                                         "cold server's")
                if who == "cpu":
                    same_decoded("bilinear", cold[u], a[2], "20f CPU")
                lat.append(a[3])
                idle.wait()
            n = read_counts(kernels)
            st = planner.stats()
            outcomes[who] = (st["hit"], st["miss"], st["wasted"],
                             st["predicted"], st["warmed"])
            if who == "card":
                if n["B1"] != len(urls) or st["warm_errors"]:
                    raise AssertionError(f"20f: launches {n}, {st}")
                for k in total:
                    total[k] += n[k]
                log(f"phase 20f: a client pans {len(urls)} native tiles "
                    f"east: prefetch hit {st['hit']}, miss {st['miss']}, "
                    f"wasted {st['wasted']}, predicted {st['predicted']},"
                    f" warmed {st['warmed']}; launches {n}; "
                    f"{ms_stats(lat)}; bytes equal the cold server's "
                    f"({card})")
        prefetch.reset_default_planner()
        os.environ["GSKY_PREFETCH"] = "0"
        if outcomes["card"] != outcomes["cpu"]:
            raise AssertionError(f"20f: outcomes {outcomes}")
        log(f"phase 20f: the CPU server's planner scores the same "
            f"(hit, miss, wasted, predicted, warmed) {outcomes['cpu']}")
    finally:
        gw.admission = saved_admission
        for k in ("GSKY_RENDER_BATCH", "GSKY_ADMIT_ADAPTIVE",
                  "GSKY_ADMIT_WMS", "GSKY_ADMIT_QUEUE_S"):
            os.environ.pop(k, None)
        os.environ["GSKY_PREFETCH"] = "0"
        pair.close()
        gw.cache.clear()
        shutil.rmtree(ov_dir, ignore_errors=True)
    return total


def cancel_reasons():
    """Records the reason of every cancel token that fires while
    installed (``remove()`` restores `CancelToken.cancel`)."""
    from gsky_tpu_torch.resilience import cancel

    class Spy:
        def __init__(self):
            self.reasons = []
            self.orig = cancel.CancelToken.cancel
            spy = self

            def cancel_(tok, reason="cancelled"):
                fired = spy.orig(tok, reason)
                if fired:
                    spy.reasons.append(reason)
                return fired
            cancel.CancelToken.cancel = cancel_

        def remove(self):
            cancel.CancelToken.cancel = self.orig
    return Spy()


def wait_for(cond, what, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"{what}: not within {timeout} s")


def raw_disconnect(base, url, after_s):
    """Send ``url``'s GET over a raw socket and close it ``after_s``
    later, before any answer."""
    import socket
    from urllib.parse import urlsplit
    host, port = urlsplit(base).netloc.split(":")
    sock = socket.create_connection((host, int(port)), 30)
    u = urlsplit(url)
    sock.sendall(f"GET {u.path}?{u.query} HTTP/1.1\r\nHost: x\r\n\r\n"
                 .encode())
    time.sleep(after_s)
    sock.close()


OBS_TILES = 16               # 21a: fused tiles a run, traced and not
OBS_THREADS = 4              # 21a: client threads
OBS_PROFILE_TILES = 8        # 21c: fused tiles inside a capture
PROFILE_S = 3.0              # 21c: a capture's window
PROFILE_LEAD_S = 1.0         # 21c: the profiler's start-up before work


def kernel_events(trace_dir, names):
    """The CUDA kernel events of a `/debug/profile` capture's Chrome
    trace whose names contain each of ``names``; the capture's
    directory is removed.  Returns {name: count} and the event count."""
    with open(os.path.join(trace_dir, "trace.json")) as fp:
        evs = json.load(fp)["traceEvents"]
    shutil.rmtree(trace_dir, ignore_errors=True)
    return {n: sum(1 for e in evs if e.get("cat") == "kernel"
                   and n in e.get("name", "")) for n in names}, len(evs)


def profile_window(srv, fire, names, what, card, tries=3):
    """Phase 21c: ``srv``'s ``/debug/profile`` (a `torch.profiler`
    capture) while ``fire()`` runs inside its window, an overlapping
    capture refused with 409.  ``names`` maps a substring of a CUDA
    kernel's name to the wrappers (`cuda_lib.Kernel`) that launch it;
    the Chrome trace's kernel events of each must equal the wrappers'
    launch delta over ``fire``.  The tracer can drop records (see
    `kernel_device_ms`): a window that saw fewer is taken again, up to
    ``tries``; one that saw more fails.  Returns the launches."""
    import threading
    done = {}
    for attempt in range(tries):
        t = threading.Thread(target=lambda: done.__setitem__(
            "r", srv.handle("/debug/profile",
                            {"seconds": [str(PROFILE_S)]})))
        t.start()
        wait_for(srv._profile_mutex.locked, f"21c {what} capture", 30.0)
        time.sleep(PROFILE_LEAD_S)
        busy = srv.handle("/debug/profile", {"seconds": ["0.1"]})
        if busy.status != 409:
            raise AssertionError(f"21c {what}: an overlapping capture got "
                                 f"{busy.status}")
        before = {n: sum(k.launches for k in ks) for n, ks in names.items()}
        t0 = time.perf_counter()
        fire()
        fired = time.perf_counter() - t0
        want = {n: sum(k.launches for k in ks) - before[n]
                for n, ks in names.items()}
        t.join(timeout=PROFILE_S + 120)
        if t.is_alive():
            raise AssertionError(f"21c {what}: the capture did not end")
        r = done.pop("r")
        doc = json.loads(r.body)
        if r.status != 200 or fired > PROFILE_S - PROFILE_LEAD_S - 0.5:
            raise AssertionError(f"21c {what}: capture {r.status} {doc}, "
                                 f"work {fired:.2f} s of the window")
        got, n_evs = kernel_events(doc["trace_dir"], names)
        if any(got[n] > want[n] for n in names) or not all(want.values()):
            raise AssertionError(f"21c {what}: trace kernels {got}, "
                                 f"launches {want}")
        if got == want:
            log(f"phase 21c {what}: /debug/profile?seconds={PROFILE_S} "
                f"while the work ran ({fired * 1e3:.1f} ms): kernel events "
                f"{got}, equal to the wrappers' launches; an overlapping "
                f"capture 409 ({n_evs} trace events; window "
                f"{attempt + 1}) ({card})")
            return want
        log(f"phase 21c {what}: the trace saw {got} of {want} launches; "
            f"again")
    raise AssertionError(f"21c {what}: {tries} windows dropped records")


def phase_obs(data_root, data_paths, card):
    """Phase 21 over phase 3's archive: the observability seam on the
    card, a card `OWSServer(gateway=None)` behind HTTP, over a store of
    phase 3's granules alone (phase 20's store also holds a granule
    under a directory it has removed, which the layer's path prefix
    matches).
    21a: `OBS_TILES` fused nearest tiles from `OBS_THREADS` threads
    (waves and the staged path on), traced and untraced in turns
    (GSKY_TRACE 1, 0, 0, 1): bodies equal; latency printed beside the
    reference's claim; one traced tile's span tree holds tile.dispatch
    and tile.readback, its record's device.duration their sum.
    21b: /metrics after 21a: gsky_requests_total{WMS,200} moved by the
    200s served, gsky_wave_dispatches_total by B1's launches.
    21c: /debug/profile while fused and zoomed-out tiles run (per call):
    paged_render and warp_render kernel events equal the launches.
    21d: the first traced B1 launch against its plain version.
    Returns the launches {kernel: n}."""
    import inspect
    from gsky_tpu_torch.obs import parse_exposition
    from gsky_tpu_torch.ops import paged
    kernels = _kernel_counts()
    total = dict.fromkeys(kernels, 0)
    store = crawl((p, NS) for p in data_paths)
    styles = [{"name": m, "title": m, "rgb_products": [NS], "resample": m}
              for m in METHODS]
    pair = OwsPair(os.path.join(data_root, "conf21"),
                   [{"name": "plain", "data_source": data_root,
                     "rgb_products": [NS], "styles": styles}], store)
    srv = pair.card
    recs = []
    srv.metrics.write = recs.append
    boxes = tile_boxes()[:OBS_TILES]
    urls = [getmap_url(pair.base, "plain", b, "near") for b in boxes]

    def scrape():
        st, _, body, _ = http_status(pair.base + "/metrics")
        if st != 200:
            raise AssertionError(f"21b: /metrics {st}")
        return parse_exposition(body.decode())

    def count(fams, name, labels=None):
        return sum(v for (n, lab), v in fams[name]["samples"].items()
                   if n == name and (labels is None
                                     or set(labels) <= set(lab)))
    try:
        with WavesOn():
            warm, _ = fetch_threads(http_status, urls, OBS_THREADS)
            if any(a[0] != 200 for a in warm):
                raise AssertionError(f"21a warm: {[a[0] for a in warm]}")
            runs = {"1": [], "0": []}
            fams0 = scrape()
            reset_counts(kernels)
            cap = CaptureFirst(paged, "paged_render_scored")
            n_rec = len(recs)
            try:
                for mode in ("1", "0", "0", "1"):
                    os.environ["GSKY_TRACE"] = mode
                    try:
                        got, wall = fetch_threads(http_status, urls,
                                                  OBS_THREADS)
                    finally:
                        os.environ.pop("GSKY_TRACE")
                    runs[mode].append((got, wall))
            finally:
                cap.remove()
            launches = read_counts(kernels)
            fams1 = scrape()
        ok = sum(1 for rs in runs.values() for got, _ in rs
                 for a in got if a[0] == 200)
        bodies = [[a[2] for a in got] for rs in runs.values()
                  for got, _ in rs]
        if ok != 4 * OBS_TILES or any(b != bodies[0] for b in bodies) \
                or bodies[0] != [a[2] for a in warm]:
            raise AssertionError("21a: traced and untraced bodies differ "
                                 "or a tile failed")
        for k in total:
            total[k] += launches[k]
        lat = {m: [a[3] for got, _ in rs for a in got]
               for m, rs in runs.items()}
        rate = {m: len(lat[m]) / sum(w for _, w in rs)
                for m, rs in runs.items()}
        p50 = {m: float(np.median(v)) * 1e3 for m, v in lat.items()}
        log(f"phase 21a: {OBS_TILES} fused near tiles from {OBS_THREADS} "
            f"threads, two runs each, bodies equal: traced p50 "
            f"{p50['1']:.3f} ms, p90 {np.percentile(lat['1'], 90) * 1e3:.3f}"
            f" ms, {rate['1']:.1f} tiles/s; untraced p50 {p50['0']:.3f} ms, "
            f"p90 {np.percentile(lat['0'], 90) * 1e3:.3f} ms, "
            f"{rate['0']:.1f} tiles/s; traced/untraced p50 "
            f"{p50['1'] / p50['0']:.4f} (the reference claims under 2% of "
            f"hot p50 on CPU/TPU; host clocks, printed only) ({card})")
        # one traced tile: its span tree and its record
        traced = [r for r in recs[n_rec:] if r["trace_id"]]
        if len(traced) != 2 * OBS_TILES or \
                len(recs) - n_rec != 4 * OBS_TILES:
            raise AssertionError(f"21a: {len(traced)} traced records of "
                                 f"{len(recs) - n_rec}")
        rec = traced[0]
        st, _, body, _ = http_status(
            f"{pair.base}/debug/trace/{rec['trace_id']}")
        tr = json.loads(body)
        names = [s["name"] for s in tr["spans"]]
        if st != 200 or "tile.dispatch" not in names or \
                "tile.readback" not in names:
            raise AssertionError(f"21a: trace {st} spans {names}")
        span_ns = sum(s["dur_s"] for s in tr["spans"]
                      if s["name"] in ("tile.dispatch", "tile.readback"))
        span_ns *= 1e9
        dev_ns = rec["device"]["duration"]
        if rec["device"]["platform"] != srv.device.type or \
                abs(dev_ns - span_ns) > 1e6:
            raise AssertionError(f"21a: device {rec['device']}, spans "
                                 f"{span_ns:.0f} ns")
        log(f"phase 21a: trace {rec['trace_id']}: spans {sorted(names)}; "
            f"record device.duration {dev_ns} ns (platform "
            f"{rec['device']['platform']}), "
            f"tile.dispatch + tile.readback {span_ns:.0f} ns")
        # -- 21b: /metrics against the launch counters --------------------
        req = count(fams1, "gsky_requests_total",
                    {("service", "WMS"), ("status", "200")}) \
            - count(fams0, "gsky_requests_total",
                    {("service", "WMS"), ("status", "200")})
        wd = count(fams1, "gsky_wave_dispatches_total") \
            - count(fams0, "gsky_wave_dispatches_total")
        bf = count(fams1, "gsky_batch_flushes_total") \
            - count(fams0, "gsky_batch_flushes_total")
        if req != ok or wd + bf != launches["B1"] or not launches["B1"] \
                or launches["B2"]:
            raise AssertionError(f"21b: requests {req} (served {ok}), "
                                 f"wave dispatches {wd}, batch flushes "
                                 f"{bf}, launches {launches}")
        log(f"phase 21b: /metrics: gsky_requests_total{{WMS,200}} +{req:g}"
            f" = the 200s served; gsky_wave_dispatches_total +{wd:g}, "
            f"gsky_batch_flushes_total +{bf:g} = B1 launches "
            f"{launches['B1']} for {4 * OBS_TILES} tiles")
        # -- 21d: the first traced B1 launch vs its plain version ---------
        args = inspect.signature(cap.orig).bind(*cap.args[0],
                                                **cap.args[1]).arguments
        saved = kernels["B1"].launches
        with srv.executor.pool.locked_pool() as parr:
            kw = dict(args, pool=parr)
            ck, bk = paged.paged_render_scored(**kw)
            cp, bp = paged.paged_render_scored_plain(**kw)
        kernels["B1"].launches = saved
        err = check_pair("near", ck, bk, cp, bp, "21d traced B1 vs plain")
        log(f"phase 21d: the first traced B1 launch (N="
            f"{int(args['tables'].shape[0])}) vs plain: max |diff| {err}")
        # -- 21c: a profile capture while tiles render (per call) ---------
        fused = [getmap_url(pair.base, "plain", b, "near")
                 for b in tile_boxes()[OBS_TILES:OBS_TILES
                                       + OBS_PROFILE_TILES]]
        zoomed = getmap_url(pair.base, "plain", zoom_boxes(4.0)[0], "near")
        http_status(zoomed)             # its scenes' overviews resident

        def fire():
            got, _ = fetch_threads(http_status, fused + [zoomed],
                                   OBS_THREADS)
            if any(a[0] != 200 for a in got):
                raise AssertionError(f"21c: {[a[0] for a in got]}")
        n = profile_window(srv, fire, {"paged_render": [kernels["B1"]],
                                       "warp_render": [kernels["B2"]]},
                           "fused and zoomed-out tiles", card)
        total["B1"] += n["paged_render"]
        total["B2"] += n["warp_render"]
    finally:
        pair.close()
    return total, err


def phase_deadline(root, store, card):
    """Phase 20c over phase 10's archive: a decode latency fault past a
    masked layer's 1 s wms_timeout (504, the render unwinds at its
    cancellation check, no B4), a clean request after it (200, one B4),
    and a client that closes its socket mid-decode (the token fires with
    ``client-disconnect``, no launch).  Returns the launches."""
    from gsky_tpu_torch.resilience import cancel_stats, faults, \
        reset_cancel_stats
    from gsky_tpu_torch.serving import ServingGateway, default_gateway
    kernels = _kernel_counts()
    total = dict.fromkeys(kernels, 0)
    mask = {"id": "pixel_qa", "bit_tests": CLOUD_SHADOW}
    layers = [
        {"name": "masked_dl", "data_source": root,
         "rgb_products": ["LC08_B4"], "resample": "bilinear",
         "mask": mask, "clip_value": 2000, "wms_timeout": 1},
        {"name": "masked", "data_source": root,
         "rgb_products": ["LC08_B4"], "resample": "bilinear",
         "mask": mask, "clip_value": 2000}]
    dates = mosaic_dates()
    t_two = (dates[-2][1] - 86400.0, dates[-1][1] + 86400.0)
    boxes = mosaic_boxes()
    pair = OwsPair(os.path.join(root, "conf20"), layers, store,
                   gateway=default_gateway, cpu_gateway=ServingGateway())
    spy = cancel_reasons()
    try:
        for who in ("card", "cpu"):
            base = pair.base if who == "card" else pair.cpu_base()
            url = getmap_url(base, "masked_dl", boxes[0], "", t_two)
            clean = getmap_url(base, "masked_dl", boxes[1], "", t_two)
            faults.configure("decode:latency:2s", 0)
            reset_cancel_stats()
            reset_counts(kernels)
            a = http_status(url)
            if a[0] != 504 or a[3] > 1.5:
                raise AssertionError(f"20c {who}: {a[0]} in {a[3]:.3f} s")
            wait_for(lambda: cancel_stats()["stages"], "20c unwind")
            stages = cancel_stats()["stages"]
            time.sleep(0.1)
            n = read_counts(kernels)
            if n["B4"] or set(stages) != {"decode"}:
                raise AssertionError(f"20c {who}: launches {n}, stages "
                                     f"{stages}")
            faults.reset()
            reset_counts(kernels)
            b = http_status(clean)
            n2 = read_counts(kernels)
            if b[0] != 200 or (who == "card" and n2["B4"] != 1):
                raise AssertionError(f"20c {who} clean: {b[0]}, {n2}")
            if who == "card":
                card_504, card_clean = a, b
                total["B4"] += n2["B4"]
            else:
                same_answer(card_504, a, "bilinear", "20c 504")
                same_answer(card_clean, b, "bilinear", "20c clean")
            log(f"phase 20c {who}: decode:latency:2s past wms_timeout 1: "
                f"{a[0]} ({ogc_code(a[2])}) in {a[3] * 1e3:.1f} ms; the "
                f"render unwound at stage {stages}, launches {n}; the "
                f"clean request {b[0]} in {b[3] * 1e3:.1f} ms, launches "
                f"{n2} ({card})")
            # a client that goes away mid-decode
            faults.configure("decode:latency:1s", 0)
            reset_cancel_stats()
            spy.reasons.clear()
            reset_counts(kernels)
            t0 = time.perf_counter()
            raw_disconnect(base, getmap_url(base, "masked", boxes[2], "",
                                            t_two), 0.3)
            wait_for(lambda: "client-disconnect" in spy.reasons
                     and cancel_stats()["stages"], "20c disconnect")
            secs = time.perf_counter() - t0
            time.sleep(0.1)
            n = read_counts(kernels)
            faults.reset()
            if any(n.values()):
                raise AssertionError(f"20c {who} disconnect: launches {n}")
            log(f"phase 20c {who}: a client closed its socket 0.3 s into "
                f"a 1 s decode: the token fired with {spy.reasons}, the "
                f"render unwound at {cancel_stats()['stages']} "
                f"{secs:.2f} s after the request, launches {n} ({card})")
        # -- 21c: a profile capture while a masked tile renders (B4) ------
        # (a tile not asked for before: the gateway would replay it)
        masked = getmap_url(pair.base, "masked", boxes[3], "", t_two)

        def fire():
            a = http_status(masked)
            if a[0] != 200:
                raise AssertionError(f"21c masked: {a[0]}")
        total["B4"] += profile_window(
            pair.card, fire, {"first_valid_kernel": [kernels["B4"]]},
            "a masked tile", card)["first_valid_kernel"]
    finally:
        faults.reset()
        spy.remove()
        pair.close()
    return total


def phase_backend(root, watcher, srv, cpu, card):
    """Phases 20c (the WPS part) and 20e over phase 19's archive and
    masapi, inside phase 19: a WPS drill past a short wcs_timeout (504),
    the next one through B3 (200); then mas:error faults at the MAS
    client.  Returns the launches."""
    t_phase = time.perf_counter()
    from urllib.parse import parse_qs, urlsplit
    from gsky_tpu_torch.resilience import faults, get_breaker, registry
    from gsky_tpu_torch.serving import ServingGateway
    kernels = _kernel_counts()
    total = dict.fromkeys(kernels, 0)
    cfg = watcher.get("")
    addr = cfg.service_config.mas_address
    breaker = get_breaker(f"mas:{addr}")

    def get(server, url, body=None):
        u = urlsplit(url)
        t0 = time.perf_counter()
        r = server.handle(u.path, parse_qs(u.query), "", body, {})
        return r.status, dict(r.headers), r.read(), \
            time.perf_counter() - t0

    # -- 20c: a drill past its deadline, then one through B3 --------------
    from gsky_tpu_torch.geo import geometry as geom
    g = geom.from_wkt(DRILL_POLY)
    gj = json.dumps({"type": "Polygon", "coordinates": [
        r.tolist() for r in g.polys[0]]})

    def execute(ident):
        return (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<wps:Execute service="WPS" version="1.0.0" '
            'xmlns:wps="http://www.opengis.net/wps/1.0.0" '
            'xmlns:ows="http://www.opengis.net/ows/1.1">'
            f"<ows:Identifier>{ident}</ows:Identifier><wps:DataInputs>"
            "<wps:Input><ows:Identifier>geometry</ows:Identifier>"
            f"<wps:Data><wps:ComplexData>{gj}</wps:ComplexData></wps:Data>"
            "</wps:Input></wps:DataInputs></wps:Execute>").encode()
    url = "/ows?service=WPS"
    ans = {}
    for who, server in (("card", srv), ("cpu", cpu)):
        faults.configure("mas:latency:2s", 0)
        reset_counts(kernels)
        a = get(server, url, execute("ingest_drill_dl"))
        faults.reset()
        if a[0] != 504 or a[3] > 1.5:
            raise AssertionError(f"20c WPS {who}: {a[0]} in {a[3]:.3f} s")
        time.sleep(2.2)             # the abandoned drill unwinds
        n = read_counts(kernels)
        breaker.record_success()
        reset_counts(kernels)
        b = get(server, url, execute("ingest_drill_dl"))
        n2 = read_counts(kernels)
        if b[0] != 200 or n["B3"] or (who == "card" and n2["B3"] != 1):
            raise AssertionError(f"20c WPS {who}: {b[0]}, launches {n}, "
                                 f"{n2}")
        if who == "card":
            total["B3"] += n2["B3"]
        ans[who] = (a, b)
        log(f"phase 20c WPS {who}: mas:latency:2s past wcs_timeout 1: "
            f"{a[0]} in {a[3] * 1e3:.1f} ms, launches {n}; the next drill "
            f"{b[0]} in {b[3] * 1e3:.1f} ms, launches {n2} ({card})")
    if ans["card"][0][0] != ans["cpu"][0][0] or \
            ogc_code(ans["card"][0][2]) != ogc_code(ans["cpu"][0][2]):
        raise AssertionError("20c WPS: card and CPU answers differ")
    same_csv(ans["card"][1][2], ans["cpu"][1][2], "20c WPS card vs CPU")

    # -- 21c: a profile capture while a drill runs (B3) -------------------
    from gsky_tpu_torch.ops import stats

    def fire():
        breaker.record_success()
        a = get(srv, url, execute("ingest_drill_dl"))
        if a[0] != 200:
            raise AssertionError(f"21c drill: {a[0]}")
    total["B3"] += profile_window(
        srv, fire, {"masked_stats": [stats.masked_stats_kernel,
                                     stats.masked_stats_many_kernel]},
        "a WPS drill", card)["masked_stats"]

    # -- 20e: faults at the MAS client, then the MAS lost ---------------
    t_both = (lzw_stamp(LZW_DOYS[0]) - 86400.0,
              lzw_stamp(LZW_DOYS[-1]) + 86400.0)
    boxes = tile_boxes(*LZW_AT["fused"], nx=4, ny=4)
    urls = [getmap_url("", "lzw", b, "near", t_both)
            for b in boxes[:SRV_FAULT_TILES]]
    fresh = getmap_url("", "lzw", boxes[-1], "near", t_both)
    saved = srv.gateway, cpu.gateway
    srv.gateway, cpu.gateway = ServingGateway(), ServingGateway()
    try:
        res = {}
        for who, server in (("card", srv), ("cpu", cpu)):
            faults.configure("mas:error:0.2", 0)
            breaker.record_success()
            r0 = registry.stats()["retries"].get("mas", 0)
            f0 = registry.stats()["faults_injected"].get("mas", 0)
            reset_counts(kernels)
            got = [get(server, u) for u in urls]
            n = read_counts(kernels)
            retries = registry.stats()["retries"].get("mas", 0) - r0
            injected = registry.stats()["faults_injected"].get("mas", 0) \
                - f0
            if any(a[0] != 200 for a in got) or not injected:
                raise AssertionError(f"20e {who}: {[a[0] for a in got]}, "
                                     f"faults {injected}")
            if who == "card":
                total["B1"] += n["B1"]
            # the MAS lost: a new tile 503, an expired one replayed stale
            faults.configure("mas:error:1.0", 0)
            breaker.record_success()
            reset_counts(kernels)
            new = get(server, fresh)
            for ent in server.gateway.cache._entries.values():
                ent.expires = time.monotonic() - 1.0
            breaker.record_success()
            stale = get(server, urls[0])
            n_lost = read_counts(kernels)
            faults.reset()
            breaker.record_success()
            if new[0] != 503 or ogc_code(new[2]) != "ServerBusy" or \
                    not new[1].get("Retry-After") or stale[0] != 200 or \
                    stale[1].get("X-Gsky-Cache") != "stale" or \
                    stale[1].get("X-GSKY-Degraded") != "stale-cache" or \
                    stale[2] != got[0][2] or any(n_lost.values()):
                raise AssertionError(f"20e {who} lost: {new[:2]}, "
                                     f"{stale[:2]}, {n_lost}")
            res[who] = (got, retries, injected, new, stale)
            log(f"phase 20e {who}: mas:error:0.2 (seed 0): "
                f"{len(got)} tiles 200, {injected} faults injected, "
                f"{retries} retries, launches {n}; mas:error:1.0: a new "
                f"tile {new[0]} {ogc_code(new[2])} Retry-After "
                f"{new[1].get('Retry-After')}, an expired cached tile "
                f"replayed {stale[1].get('X-Gsky-Cache')} "
                f"({stale[1].get('X-GSKY-Degraded')}), no launch ({card})")
        (cg, cr, ci, cn, cs), (pg, pr, pi, pn, ps) = res["card"], res["cpu"]
        if (cr, ci) != (pr, pi):
            raise AssertionError(f"20e: retries card {cr}/{ci}, CPU "
                                 f"{pr}/{pi}")
        for a, b in zip(cg, pg):
            same_answer(a, b, "near", "20e tiles")
        same_answer(cn, pn, "near", "20e MAS lost")
        same_answer(cs, ps, "near", "20e stale replay")
    finally:
        faults.reset()
        srv.gateway, cpu.gateway = saved
    log(f"phase 20c (WPS), 20e: {time.perf_counter() - t_phase:.1f} s")
    return total


GUARD_TILES = 16             # 22b: fused tiles a round
GUARD_THREADS = 4            # 22b: client threads
POOL_TILES = 32              # 22f: tiles through the encode pool
POOL_THREADS = 16            # 22f: client threads
GUARD_ENV = {"GSKY_DEVICE_HANG_S": "1",
             "GSKY_DEVICE_REINIT_BACKOFF": "0.1,0.5"}


def scrape_families(base, names):
    """{family: {(sample, labels): value}} of /metrics for the families
    whose name starts with one of ``names``."""
    from gsky_tpu_torch.obs import parse_exposition
    st, _, body, _ = http_status(base + "/metrics")
    if st != 200:
        raise AssertionError(f"/metrics {st}")
    return {n: f["samples"] for n, f in parse_exposition(
        body.decode()).items() if n.startswith(tuple(names))}


def family_line(fams):
    return "; ".join(
        f"{s}{{{','.join(f'{k}={v}' for k, v in lab)}}} {val:g}"
        for fam in sorted(fams) for (s, lab), val in
        sorted(fams[fam].items()))


def device_families(base):
    return family_line(scrape_families(
        base, ("gsky_device_", "gsky_pool_rehydrated_pages_total")))


def sample(fams, name, labels=(), family=None):
    """The sum of the samples ``name`` (of ``family``, by default the
    family of that name) whose labels include ``labels``."""
    return sum(v for (n, lab), v in fams.get(family or name, {}).items()
               if n == name and set(labels) <= set(lab))


def serve_process(conf_dir, crawl_file, log_dir, prewarm, port=0,
                  extra_env=None):
    """The port's server as its command line starts it, in a process of
    its own (waves and the staged path at their defaults, GSKY_PREWARM
    as given, on ``port``, 0 a free one; ``extra_env`` over that):
    (process, base url, its start-up lines)."""
    import queue
    import threading
    env = {k: v for k, v in os.environ.items()
           if k not in ("GSKY_WAVES", "GSKY_TILE_PIPELINE",
                        "GSKY_POOL_JOURNAL")}
    env.update(PYTHONUNBUFFERED="1", GSKY_PREWARM=prewarm,
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "gsky_tpu_torch.server.main", "-host",
         "127.0.0.1", "-port", str(port), "-conf", conf_dir, "-local_mas",
         crawl_file, "-log_dir", log_dir], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    seen, deadline = [], time.monotonic() + 300
    while time.monotonic() < deadline:
        try:
            ln = lines.get(timeout=1.0).rstrip()
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        seen.append(ln)
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", ln)
        if m:
            proc.output = lines       # its later lines, as they come
            return proc, f"http://127.0.0.1:{m.group(1)}", seen
    proc.kill()
    proc.wait()
    raise AssertionError(f"22a: the server did not start: {seen[-20:]}")


def stop_process(proc):
    proc.terminate()
    try:
        proc.wait(timeout=15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def phase_prewarm(data_root, data_paths, card):
    """22a: the command line's server over phase 3's archive, started
    with prewarm on and again with it off (GSKY_PREWARM=0): the prewarm
    line (seconds, launches), ``gsky_compiles_total`` once it listens,
    then one tile of each warmed shape (a method at 256 x 256), the first
    one's latency; with prewarm on the count must not move, and the
    residency journal lives under -log_dir."""
    from gsky_tpu_torch.index.crawler import extract
    conf = os.path.join(data_root, "conf22a")
    os.makedirs(conf, exist_ok=True)
    styles = [{"name": m, "title": m, "rgb_products": [NS], "resample": m}
              for m in METHODS]
    with open(os.path.join(conf, "config.json"), "w") as fp:
        json.dump({"service_config": {"mas_address": "in-process"},
                   "layers": [{"name": "plain", "data_source": data_root,
                               "rgb_products": [NS], "styles": styles}]},
                  fp)
    crawl_file = os.path.join(data_root, "crawl22.jsonl")
    with open(crawl_file, "w") as fp:
        for p in data_paths:
            rec = extract(p)
            for ds in rec["geo_metadata"]:
                ds["namespace"] = NS
            fp.write(json.dumps(rec) + "\n")
    urls = [getmap_url("", "plain", tile_boxes()[0], m) for m in METHODS]
    out = {}
    for prewarm in ("1", "0"):
        log_dir = os.path.join(data_root, f"logs22_{prewarm}")
        t0 = time.perf_counter()
        proc, base, seen = serve_process(conf, crawl_file, log_dir,
                                         prewarm)
        try:
            started = time.perf_counter() - t0
            warm = [ln for ln in seen if ln.startswith("prewarm:")]
            if (prewarm == "1") != bool(warm):
                raise AssertionError(f"22a: prewarm {prewarm}: {seen}")
            c0 = sample(scrape_families(base, ("gsky_compiles",)),
                        "gsky_compiles_total")
            lat = []
            for u in urls:
                st, _, body, secs = http_status(base + u)
                if st != 200:
                    raise AssertionError(f"22a: {st} {body[:300]}")
                lat.append(secs)
            c1 = sample(scrape_families(base, ("gsky_compiles",)),
                        "gsky_compiles_total")
        finally:
            stop_process(proc)
        journal = os.path.join(log_dir, "gsky_pool_journal.jsonl")
        if prewarm == "1" and (c1 != c0 or c0 == 0
                               or not os.path.exists(journal)):
            raise AssertionError(f"22a: gsky_compiles_total {c0} -> {c1} "
                                 f"over the warmed shapes; journal "
                                 f"{os.path.exists(journal)}")
        out[prewarm] = (started, warm, c0, c1, lat)
        log(f"phase 22a: GSKY_PREWARM={prewarm}: listening after "
            f"{started:.3f} s ({'; '.join(warm) or 'no prewarm'}); "
            f"gsky_compiles_total {c0:g} at listen, {c1:g} after one tile "
            f"each of {', '.join(METHODS)} at 256 x 256; first tile "
            f"{lat[0] * 1e3:.3f} ms, next {lat[1] * 1e3:.3f} and "
            f"{lat[2] * 1e3:.3f} ms ({card})")
    return out


def guard_rounds(pair, urls, threads, what, card):
    """22b: ``urls`` from ``threads`` threads in rounds with the guard
    on and off (1, 0, 0, 1): p50, p90 and tiles/s of each; bodies
    equal.  Returns the launches."""
    kernels = _kernel_counts()
    reset_counts(kernels)
    runs = {"1": [], "0": []}
    for mode in ("1", "0", "0", "1"):
        os.environ["GSKY_DEVICE_GUARD"] = mode
        try:
            got, wall = fetch_threads(http_status, urls, threads)
        finally:
            os.environ.pop("GSKY_DEVICE_GUARD")
        runs[mode].append((got, wall))
    launches = read_counts(kernels)
    bodies = [[a[2] for a in got] for rs in runs.values() for got, _ in rs]
    if any(a[0] != 200 for rs in runs.values() for got, _ in rs
           for a in got) or any(b != bodies[0] for b in bodies):
        raise AssertionError("22b: a tile failed or the bodies differ "
                             "with the guard on and off")
    stats = {}
    for m, rs in runs.items():
        lat = [a[3] for got, _ in rs for a in got]
        stats[m] = (float(np.median(lat)) * 1e3,
                    float(np.percentile(lat, 90)) * 1e3,
                    len(lat) / sum(w for _, w in rs))
    log(f"phase 22b {what}: {len(urls)} fused near tiles from {threads} "
        f"threads, two rounds each way, bodies equal: guard on p50 "
        f"{stats['1'][0]:.3f} ms, p90 {stats['1'][1]:.3f} ms, "
        f"{stats['1'][2]:.1f} tiles/s; guard off p50 {stats['0'][0]:.3f} "
        f"ms, p90 {stats['0'][1]:.3f} ms, {stats['0'][2]:.1f} tiles/s; "
        f"on/off p50 {stats['1'][0] / stats['0'][0]:.4f} (host clocks) "
        f"({card}); launches {launches}")
    return launches


def guard_overhead(card, n=2000):
    """22b: the host cost of one guarded call on the card, a one-launch
    thunk with its readback: inline, through `supervised_sync` (a reused
    sync worker) and on a new thread a call entering the caller's
    stream (the reference's watchdog design).  Mean microseconds."""
    import threading
    import torch
    from gsky_tpu_torch import device_guard
    x = torch.zeros(8, device="cuda")
    stream = torch.cuda.current_stream()

    def thunk():
        return (x + 1).cpu()

    def new_thread():
        def run():
            with torch.cuda.stream(stream):
                thunk()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join()

    ways = {"inline": thunk,
            "reused worker": lambda: device_guard.supervised_sync(
                "smoke.overhead", thunk),
            "new thread": new_thread}
    us = {}
    for name, fn in ways.items():
        for _ in range(50):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us[name] = (time.perf_counter() - t0) / n * 1e6
    log(f"phase 22b: one guarded call (a launch and its readback), mean "
        f"of {n}: " + ", ".join(f"{k} {v:.2f} us" for k, v in us.items())
        + f" (host clocks; {card})")
    return us


def oom_first_seed(spec):
    """A fault seed whose ``device`` draws under ``spec`` fire on the
    first and on none of the next seven: one OOM, then a clean retry
    and readback."""
    from gsky_tpu_torch.resilience import faults
    for seed in range(1000):
        faults.configure(spec, seed)
        fired = []
        for _ in range(8):
            try:
                faults.inject("device")
                fired.append(False)
            except faults.InjectedDeviceFault:
                fired.append(True)
        if fired == [True] + [False] * 7:
            faults.configure(None)
            return seed
    raise AssertionError(f"no seed fires {spec} once")


def phase_incidents(pair, card):
    """22c, the per-call path (waves off): injected crash, OOM,
    corruption and hang over HTTP.  Returns the launches."""
    from gsky_tpu_torch import device_guard
    from gsky_tpu_torch.resilience import default_monitor, faults
    kernels = _kernel_counts()
    reset_counts(kernels)
    sup = device_guard.default_supervisor()
    pool = pair.card.executor.pool
    url = getmap_url(pair.base, "plain", tile_boxes()[1], "bilinear")

    def get(what, want=200):
        st, hdr, body, secs = http_status(url)
        if st != want:
            raise AssertionError(f"{what}: {st} {body[:300]}")
        return hdr, body, secs

    def after_backoff():
        time.sleep(sup.stats()["retry_in_s"] + 0.05)

    _, body0, _ = get("22c healthy")
    # -- crash: 503, suspect; past the backoff a rebuild, pages back -----
    resident = pool.stats()["resident"]
    faults.configure("device:crash:1")
    hdr, _, _ = get("22c crash", 503)
    faults.configure(None)
    st = sup.stats()
    if not hdr.get("Retry-After") or st["state"] != "suspect" \
            or st["crashes"] != 1:
        raise AssertionError(f"22c crash: Retry-After "
                             f"{hdr.get('Retry-After')}, {st}")
    reh0, td0 = pool.stats()["rehydrated"], pool.stats()["teardowns"]
    after_backoff()
    _, body, _ = get("22c after the rebuild")
    st, ps = sup.stats(), pool.stats()
    if body != body0 or st["state"] != "healthy" or st["reinits"] != 1 \
            or ps["teardowns"] != td0 + 1 \
            or ps["rehydrated"] - reh0 != resident or not resident:
        raise AssertionError(f"22c rebuild: bytes equal {body == body0}, "
                             f"{st}, pool {ps}, resident before "
                             f"{resident}")
    log(f"phase 22c crash: 503 Retry-After {hdr['Retry-After']}, suspect; "
        f"after the backoff one rebuild (teardown, probe on the card, "
        f"{ps['rehydrated'] - reh0} of {resident} pages rehydrated from "
        f"the journal), the tile's bytes as before; "
        f"{device_families(pair.base)}")
    # -- oom: relief, then a retry that succeeds --------------------------
    spec = "device:oom:0.5"
    faults.configure(spec, oom_first_seed(spec))
    knee = pair.card.executor.batcher.knee
    trimmed = pool.stats()["trimmed"]
    esc = default_monitor().stats()["escalations"]
    _, body, _ = get("22c oom")
    faults.configure(None)
    st = sup.stats()
    ok = (body == body0, st["ooms"], st["oom_retries"], st["state"],
          pool.stats()["trimmed"] > trimmed,
          default_monitor().stats()["escalations"] - esc,
          pair.card.executor.batcher.knee)
    if ok != (True, 1, 1, "healthy", True, 1, max(1, knee // 2)):
        raise AssertionError(f"22c oom: {ok}")
    # the escalation floors the pressure state at brownout for a while
    default_monitor().reset()
    log(f"phase 22c oom: relief (pool trimmed "
        f"{pool.stats()['trimmed'] - trimmed} pages, pressure escalated, "
        f"batcher knee {knee} -> {ok[-1]}) then the retry served the "
        f"tile, bytes as before; {device_families(pair.base)}")
    # -- corrupt: the integrity probe answers 503, the audit quarantines -
    os.environ["GSKY_POOL_AUDIT"] = "1"
    try:
        _, body, _ = get("22c warm")                 # pages resident
        key, slot = next(iter(pool._slots.items()))
        pool._pool[slot, 1, 1] = float("inf")        # a flipped page
        cov = wcs_url(pair.base, "plain", wcs_box(256), 256, style="near")
        faults.configure("device:corrupt:1")
        st0 = sup.stats()
        c_st, _, c_body, _ = http_status(cov)
        faults.configure(None)
        st = sup.stats()
        if c_st != 503 or st["corruptions"] != st0["corruptions"] + 1 \
                or st["quarantined_pages"] != 1 \
                or st["state"] != "healthy" or key in pool._slots:
            raise AssertionError(f"22c corrupt: {c_st} {c_body[:200]}, "
                                 f"{st}, page still resident "
                                 f"{key in pool._slots}")
        _, body, _ = get("22c after the quarantine")
        if body != body0:
            raise AssertionError("22c corrupt: the re-staged tile differs")
    finally:
        os.environ.pop("GSKY_POOL_AUDIT")
    log(f"phase 22c corrupt: a poisoned GetCoverage readback answered 503 "
        f"(DeviceCorruption); the audit (inf scan on the card) "
        f"quarantined the page poisoned in the pool, the device stayed "
        f"healthy, the next tile re-staged it, bytes as before; "
        f"{device_families(pair.base)}")
    # -- hang: DeviceHang after the 1 s watchdog --------------------------
    faults.configure("device:hang:1.5s")
    _, _, secs = get("22c hang", 503)
    faults.configure(None)
    st = sup.stats()
    if st["hangs"] != 1 or st["state"] != "suspect" \
            or not 1.0 <= secs < 1.5:
        raise AssertionError(f"22c hang: {secs:.3f} s, {st}")
    time.sleep(0.6)             # the abandoned sync ends its 1.5 s sleep
    after_backoff()
    _, body, _ = get("22c after the hang")
    if body != body0 or sup.stats()["state"] != "healthy":
        raise AssertionError(f"22c hang: {sup.stats()}")
    log(f"phase 22c hang: 503 (DeviceHang) after {secs:.3f} s against the "
        f"1 s watchdog; after the backoff a rebuild and the tile as "
        f"before ({card}); {device_families(pair.base)}")
    return read_counts(kernels)


# 22d's fill after its one large tensor, largest first: 2 MB and 1 MB
# + 512 B blocks in the caching allocator's large pool (over 1 MB), then
# 1 MB, 64 KB, 4 KB and 512 B blocks in its small pool
FILL_SIZES = (2 << 20, (1 << 20) + 512, 1 << 20, 64 << 10, 4 << 10, 512)


def phase_real_oom(pair, card):
    """22d: the card's free memory filled, then a tile: torch's own
    out-of-memory error, classified ``oom``; the relief runs and an OOM
    hook this phase registers frees the filler before the retry (or
    the request fails after relief, as the reference's does).  Returns
    the launches."""
    import torch
    from gsky_tpu_torch import device_guard
    from gsky_tpu_torch.resilience import default_monitor
    kernels = _kernel_counts()
    reset_counts(kernels)
    sup = device_guard.default_supervisor()
    url = getmap_url(pair.base, "plain", tile_boxes()[1], "bilinear")
    st0, _, body0, _ = http_status(url)     # its scenes and pages resident
    if st0 != 200:
        raise AssertionError(f"22d warm: {st0}")
    hogs = []

    def free_hogs():
        hogs.clear()
        torch.cuda.empty_cache()

    device_guard.register_oom_hook(free_hogs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    hogs.append(torch.empty(free - (64 << 20), dtype=torch.uint8,
                            device="cuda"))
    # The rest, so that no allocation of any size can succeed: large-pool
    # blocks until no 20 MB segment is left, the large pool's holes, the
    # small pool's 1 MB blocks until no 2 MB segment is left, then every
    # hole of every segment down to the allocator's 512 B grain.  A fill
    # that leaves a 2 MB segment or a hole lets the tile's small tensors
    # through and no out-of-memory happens.
    for size in FILL_SIZES:
        try:
            while True:
                hogs.append(torch.empty(size, dtype=torch.uint8,
                                        device="cuda"))
        except torch.cuda.OutOfMemoryError:
            pass
    left = torch.cuda.mem_get_info()[0]
    n_hogs = len(hogs)
    st0 = sup.stats()
    d_st, _, d_body, d_secs = http_status(url)
    st = sup.stats()
    free_hogs()
    default_monitor().reset()
    oom = [i for i in st["incidents"] if i["kind"] == "oom"]
    if d_st == 200:
        outcome = "the retry succeeded after the phase's OOM hook freed " \
            "the filler"
        good = d_body == body0 and st["oom_retries"] == \
            st0["oom_retries"] + 1
    else:
        outcome = "the request failed after relief, as the reference's " \
            "fails (DeviceGuardError: 503)"
        good = d_st == 503
    if not good or st["ooms"] <= st0["ooms"] or not oom \
            or "out of memory" not in oom[-1]["error"].lower():
        raise AssertionError(f"22d: {d_st} {d_body[:300]}, {st}")
    log(f"phase 22d: the card filled ({n_hogs} tensors, the first "
        f"{free - (64 << 20)} B of {free} B free, {left} B left of {total}"
        f" B); the tile's out-of-memory, torch's own error, classified "
        f"oom ({oom[-1]['error'][:80]!r}); relief ran and {outcome} in "
        f"{d_secs * 1e3:.3f} ms ({card}); {device_families(pair.base)}")
    return read_counts(kernels)


def phase_wave_failover(pair, card):
    """22e: 16 near tiles from 16 threads in waves, healthy, then with
    the first wave's launch forced to fail: every entry of that wave is
    served by its per-call leg (B2), bytes equal to the healthy wave's.
    Returns the launches."""
    import threading
    from gsky_tpu_torch.pipeline import waves as W
    kernels = _kernel_counts()
    urls = [getmap_url(pair.base, "plain", b, "near")
            for b in tile_boxes()[:WAVE_THREADS]]
    healthy, _ = fetch_threads(http_status, urls, WAVE_THREADS)
    f0 = scrape_families(pair.base, ("gsky_wave_",))
    reset_counts(kernels)
    real = W.WaveScheduler._dispatch_group
    once = threading.Lock()

    def failing(self, *a, **k):
        if once.acquire(blocking=False):
            raise RuntimeError("forced wave launch failure")
        return real(self, *a, **k)

    W.WaveScheduler._dispatch_group = failing
    try:
        got, wall = fetch_threads(http_status, urls, WAVE_THREADS)
    finally:
        W.WaveScheduler._dispatch_group = real
    launches = read_counts(kernels)
    f1 = scrape_families(pair.base, ("gsky_wave_",))
    fb = sample(f1, "gsky_wave_fallbacks_total") \
        - sample(f0, "gsky_wave_fallbacks_total")
    disp = sample(f1, "gsky_wave_dispatches_total") \
        - sample(f0, "gsky_wave_dispatches_total")
    if any(a[0] != 200 for a in healthy + got) \
            or [a[2] for a in got] != [a[2] for a in healthy] \
            or not fb or launches["B2"] != fb or launches["B1"] != disp:
        raise AssertionError(f"22e: fallbacks {fb}, dispatches {disp}, "
                             f"launches {launches}, statuses "
                             f"{[a[0] for a in got]}")
    log(f"phase 22e: the first wave's launch forced to fail: its {fb:g} "
        f"entries served through their per-call leg (B2 {launches['B2']})"
        f", the other {WAVE_THREADS - fb:g} in {disp:g} wave launches (B1 "
        f"{launches['B1']}); all {WAVE_THREADS} bodies equal the healthy "
        f"waves'; gsky_wave_fallbacks_total +{fb:g}; {wall:.3f} s "
        f"({card})")
    return launches


def phase_encode_pool(pair, card):
    """22f: `POOL_TILES` distinct bilinear tiles from `POOL_THREADS`
    threads on the staged path, encoded on the sized pool: the encode
    wait and cpu phases, the gsky_encode_pool_* families, tiles/s."""
    kernels = _kernel_counts()
    urls = [getmap_url(pair.base, "plain", b, "bilinear")
            for b in tile_boxes()[:POOL_TILES]]
    names = ("gsky_encode_",)
    f0 = scrape_families(pair.base, names)
    reset_counts(kernels)
    got, wall = fetch_threads(http_status, urls, POOL_THREADS)
    launches = read_counts(kernels)
    f1 = scrape_families(pair.base, names)
    if any(a[0] != 200 for a in got):
        bad = [a[2][:200] for a in got if a[0] != 200]
        raise AssertionError(f"22f: {[a[0] for a in got]} {bad[:1]}")
    def moved(suffix, p):
        fam = "gsky_encode_seconds"
        return sample(f1, fam + suffix, {("phase", p)}, fam) \
            - sample(f0, fam + suffix, {("phase", p)}, fam)

    # (observations, seconds) of each phase over the run
    ph = {p: (moved("_count", p), moved("_sum", p))
          for p in ("wait", "cpu")}
    enc = sample(f1, "gsky_encode_pool_encoded_total") \
        - sample(f0, "gsky_encode_pool_encoded_total")
    err = sample(f1, "gsky_encode_pool_errors_total") \
        - sample(f0, "gsky_encode_pool_errors_total")
    if enc != POOL_TILES or err or ph["wait"][0] != POOL_TILES \
            or ph["cpu"][0] != POOL_TILES:
        raise AssertionError(f"22f: encoded {enc}, errors {err}, {ph}")
    pools = {k: v for k, v in f1.items()
             if k.startswith("gsky_encode_pool_")}
    log(f"phase 22f: {POOL_TILES} bilinear tiles from {POOL_THREADS} "
        f"threads on the staged path, {POOL_TILES / wall:.1f} tiles/s; "
        f"encode wait {ph['wait'][1] / POOL_TILES * 1e3:.4f} ms a tile, "
        f"cpu {ph['cpu'][1] / POOL_TILES * 1e3:.4f} ms a tile; "
        f"{family_line(pools)} ({card}); launches {launches}")
    return launches


def phase_guard(data_root, data_paths, card):
    """Phase 22 over phase 3's archive: the device guard, the prewarm
    and the encode pool on the card.  22a the command line's server
    with and without prewarm (`phase_prewarm`); on one card
    `OWSServer(gateway=None)`: 22b the guard's cost in waves and per
    call (`guard_rounds`),
    22c injected incidents and 22d a real out-of-memory
    (`phase_incidents`), 22e a wave's failover (`phase_wave_failover`),
    22f the encode pool (`phase_encode_pool`).  GSKY_DEVICE_HANG_S=1 and
    GSKY_DEVICE_REINIT_BACKOFF=0.1,0.5 inside 22b-f, the residency
    journal in the archive's directory; the supervisor, the fault plan
    and the pressure monitor reset at the end.  Returns the launches."""
    from gsky_tpu_torch import resilience
    kernels = _kernel_counts()
    total = dict.fromkeys(kernels, 0)
    t0 = time.perf_counter()
    # 22a: the command line's server with its watchdog at the default
    # deadline: without prewarm its first tile loads the kernels inside
    # a guarded call, which outlasted 22b-f's 1 s on a busy host
    phase_prewarm(data_root, data_paths, card)
    saved = {k: os.environ.get(k) for k in
             list(GUARD_ENV) + ["GSKY_POOL_JOURNAL"]}
    os.environ.update(GUARD_ENV)
    os.environ["GSKY_POOL_JOURNAL"] = os.path.join(data_root,
                                                   "journal22.jsonl")
    try:
        store = crawl((p, NS) for p in data_paths)
        styles = [{"name": m, "title": m, "rgb_products": [NS],
                   "resample": m} for m in METHODS]
        pair = OwsPair(os.path.join(data_root, "conf22"),
                       [{"name": "plain", "data_source": data_root,
                         "rgb_products": [NS], "styles": styles}], store)
        try:
            with WavesOn():
                urls = [getmap_url(pair.base, "plain", b, "near")
                        for b in tile_boxes()[:GUARD_TILES]]
                fetch_threads(http_status, urls, GUARD_THREADS)  # warm
                parts = [guard_rounds(pair, urls, GUARD_THREADS,
                                      "in waves", card)]
            fetch_threads(http_status, urls, 1)                  # warm
            parts.append(guard_rounds(pair, urls, 1, "per call", card))
            guard_overhead(card)
            parts.append(phase_incidents(pair, card))
            parts.append(phase_real_oom(pair, card))
            with WavesOn():
                parts.append(phase_wave_failover(pair, card))
                parts.append(phase_encode_pool(pair, card))
        finally:
            pair.close()
        for part in parts:
            for k in total:
                total[k] += part[k]
    finally:
        resilience.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"phase 22: launches {total} ({time.perf_counter() - t0:.1f} s)")
    return total


def swath_edge_points():
    """Centres of four tiles on the full-resolution swath's edges (half
    of each tile off the swath), from its own geolocation."""
    H, W = SAT_SWATH
    pts = [(H * 0.3, 0.0), (H * 0.7, float(W)), (0.0, W * 0.4),
           (float(H), W * 0.6)]
    return [tuple(float(v) for v in swath_lonlat(r, c, SAT_SWATH))
            for r, c in pts]


# -- phase 23: the fleet on one card -----------------------------------------

FLEET_POOL = 4               # 23: decode children a worker node
FLEET_TILES = 16             # 23b: masked tiles a burst (archive, swath)
FLEET_THREADS = 4            # 23b, 23d: request threads
FLEET_LATENCY = "1.5s"       # 23d: the slow node's GSKY_FAULTS latency
FLEET_SLOW_TILES = 4         # 23d hedging, 23e worker drain: tiles each
DRAIN_REQUESTS = 8           # 23e: requests in flight at the SIGTERM
DRAIN_SIZE = 2048            # 23e: their GetCoverage edge
CLUSTER_SIZE = 2048          # 23f: the coverage's edge
CLUSTER_TILE = 256           # 23f: its layer's WCS tile edge
# a worker's launch counts (`worker_info`'s "kernels") by kernel
WORKER_SYMBOLS = {"B1": ("launch_paged_render",),
                  "B2": ("launch_warp_render",),
                  "B3": ("launch_masked_stats", "launch_masked_stats_many"),
                  "B4": ("launch_first_valid",)}


def phase_grpc_probe():
    """23a: the worker RPC's carrier, ``grpc``, imports here (raises if
    not: there is no other carrier); the port's own proto3 codec stands
    in for ``google.protobuf``."""
    import grpc
    log(f"phase 23a: grpc {grpc.__version__} imports; the worker RPC is "
        f"gRPC's gskyrpc.GDAL/Process over the port's own proto3 codec")
    return grpc.__version__


class Fleet:
    """Worker nodes (``python -m gsky_tpu_torch.worker.server``), each in
    a process of its own, started together; their output lines kept."""

    def __init__(self):
        self.procs = {}          # address -> Popen
        self.lines = {}
        self.queues = {}
        self.notice_at = {}      # pid -> its preemption notice's arrival
        self.exit_at = {}        # pid -> its exit (its output closed)

    def start(self, n, env=None, port=0):
        """``n`` workers with ``env`` over the environment, on ``port``
        (0: each a free one); a callable that waits for them to listen
        and returns their addresses."""
        import queue
        import threading
        started = []
        for _ in range(n):
            e = dict(os.environ)
            e.update(PYTHONUNBUFFERED="1", GSKY_DRILL_CACHE="sync",
                     PYTHONPATH=ROOT + os.pathsep
                     + e.get("PYTHONPATH", ""))
            e.update(env or {})
            p = subprocess.Popen(
                [sys.executable, "-m", "gsky_tpu_torch.worker.server",
                 "-p", str(port), "-host", "127.0.0.1", "-n",
                 str(FLEET_POOL), "-oom_threshold", "0"], cwd=ROOT, env=e,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            q = queue.Queue()
            threading.Thread(target=self._read, args=(p, q),
                             daemon=True).start()
            started.append((p, q, []))
        return lambda: self._wait(started)

    def _read(self, p, q):
        """A worker's output lines into ``q``; the arrival of its
        preemption notice's log line and its exit on this clock."""
        for ln in p.stdout:
            if "preemption notice" in ln:
                self.notice_at.setdefault(p.pid, time.perf_counter())
            q.put(ln)
        p.wait()
        self.exit_at[p.pid] = time.perf_counter()

    def output(self, addr):
        """The lines a worker printed so far."""
        q = self.queues[addr]
        while not q.empty():
            self.lines[addr].append(q.get().rstrip())
        return self.lines[addr]

    def _wait(self, started, timeout=300):
        import queue
        addrs = []
        deadline = time.monotonic() + timeout
        for p, q, seen in started:
            while True:
                if time.monotonic() > deadline or p.poll() is not None:
                    raise AssertionError(f"23: a worker did not start: "
                                         f"{seen[-20:]}")
                try:
                    ln = q.get(timeout=1.0).rstrip()
                except queue.Empty:
                    continue
                seen.append(ln)
                m = re.search(r"gsky-rpc-torch listening on "
                              r"127\.0\.0\.1:(\d+)", ln)
                if m:
                    break
            addr = f"127.0.0.1:{m.group(1)}"
            self.procs[addr] = p
            self.lines[addr] = seen
            self.queues[addr] = q
            addrs.append(addr)
        return addrs

    def info(self, addr):
        from gsky_tpu_torch.worker import gskyrpc as pb
        from gsky_tpu_torch.worker.client import dial
        ch, call = dial(addr)
        try:
            res = call(pb.Task(operation="worker_info"), timeout=30.0)
        finally:
            ch.close()
        return json.loads(res.info_json)

    def counts(self, addrs):
        """The workers' launches by kernel (their own counters)."""
        out = dict.fromkeys(WORKER_SYMBOLS, 0)
        for a in addrs:
            k = self.info(a)["kernels"]
            for name, syms in WORKER_SYMBOLS.items():
                out[name] += sum(k[s] for s in syms)
        return out

    def signal(self, addr, sig):
        self.procs[addr].send_signal(sig)

    def wait(self, addr, timeout):
        return self.procs.pop(addr).wait(timeout)

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                pass
        self.procs = {}


def count_delta(before, after):
    return {k: after[k] - before[k] for k in before}


def cuda_holders():
    """Pids that hold a CUDA context, as nvidia-smi lists them."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return [int(x) for x in r.stdout.split() if x.strip().isdigit()]


def children_of(pid):
    """The pids whose parent is ``pid`` (from /proc/<n>/stat)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fp:
                stat = fp.read()
        except OSError:
            continue
        # the fields after the command name, which may hold spaces
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def check_no_child_context(fleet, card):
    """23b: no decode child of a worker holds a CUDA context.  Where
    nvidia-smi shows this container's pids, the children are absent
    from its list; where it shows another pid namespace's, the list has
    exactly one entry for each CUDA process of this run (this one and
    the workers), so no child added one."""
    holders = cuda_holders()
    workers = [p.pid for p in fleet.procs.values() if p.poll() is None]
    kids = [c for w in workers for c in children_of(w)]
    if not kids:
        raise AssertionError("23b: the workers have no decode children")
    ours = {os.getpid(), *workers}
    if set(holders) & ours:
        bad = set(holders) & set(kids)
        if bad or not set(workers) <= set(holders):
            raise AssertionError(f"23b: CUDA contexts {holders}: workers "
                                 f"{workers}, decode children {kids}")
        how = f"nvidia-smi lists this process and the workers {workers}"
    else:
        if len(holders) != len(ours):
            raise AssertionError(f"23b: nvidia-smi lists {len(holders)} "
                                 f"CUDA processes, this run has "
                                 f"{len(ours)} ({holders})")
        how = (f"nvidia-smi lists {len(holders)} CUDA processes (another "
               f"pid namespace): this one and the {len(workers)} workers")
    log(f"phase 23b: no decode child holds a CUDA context: {how}, none "
        f"of their {len(kids)} decode children ({card})")


def fleet_server(conf_root, namespaces, store):
    """The port's OWSServer on the card over a config tree of one
    directory per namespace (``namespaces``: {name: (layers,
    worker_nodes)}; "" is the root), behind HTTP; no serving gateway."""
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.server.config import ConfigWatcher
    from gsky_tpu_torch.server.ows import OWSServer
    for ns, (layers, nodes) in namespaces.items():
        d = os.path.join(conf_root, ns) if ns else conf_root
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as fp:
            json.dump({"service_config": {"mas_address": "in-process",
                                          "worker_nodes": list(nodes)},
                       "layers": layers}, fp)
    client = MASClient(store)
    server = OWSServer(ConfigWatcher(conf_root, lambda a: client,
                                     install_signal=False),
                       lambda a: client, device="cuda", gateway=None)
    httpd = server.serve("127.0.0.1", 0)
    return server, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def router_of(server, ns):
    cfg = server.watcher.get(ns)
    return server._pipeline(cfg).remote.fleet


def rpc_calls(base):
    """(count, seconds) of the worker RPCs so far."""
    fams = scrape_families(base, ("gsky_worker_rpc_seconds",))
    return tuple(sample(fams, f"gsky_worker_rpc_seconds{s}",
                        family="gsky_worker_rpc_seconds")
                 for s in ("_count", "_sum"))


def fleet_burst(base, urls, threads, want, what, during=None):
    """GET ``urls`` from ``threads`` threads; every answer 200 with the
    body ``want[i]``.  ``during(n_done)`` runs after each answer.
    Returns the seconds of each request and the wall."""
    import threading
    done = [0]
    lock = threading.Lock()

    def one(u):
        ans = http_status(u)
        with lock:
            done[0] += 1
            n = done[0]
        if during is not None:
            during(n)
        return ans

    got, wall = fetch_threads(one, urls, threads)
    for i, (st, hd, body, _) in enumerate(got):
        if st != 200:
            raise AssertionError(f"{what}: tile {i}: {st} {body[:300]}")
        if body != want[i]:
            raise AssertionError(f"{what}: tile {i}: the bytes differ "
                                 f"from the local modular route's")
    return [a[3] for a in got], wall


def fleet_report(what, secs, wall, rpc0, launches, router, base, card):
    """A burst's line: tiles/s, p50, p90, RPCs a tile and their mean
    (``gsky_worker_rpc_seconds`` since ``rpc0``), launches, the
    router's locality rate, and the families it publishes."""
    n, s = (a - b for a, b in zip(rpc_calls(base), rpc0))
    fams = scrape_families(base, ("gsky_worker_rpc_seconds",
                                  "gsky_fleet_"))
    # the RPC histogram's count and sum, not its buckets
    fams = {f: {(k, lab): v for (k, lab), v in fs.items()
                if not k.endswith("_bucket")} for f, fs in fams.items()}
    log(f"phase {what}: {len(secs)} tiles, {len(secs) / wall:.2f} tiles/s, "
        f"p50 {np.median(secs) * 1e3:.2f} ms, p90 "
        f"{np.percentile(secs, 90) * 1e3:.2f} ms, {n / len(secs):.2f} "
        f"RPCs a tile, {s / max(n, 1) * 1e3:.2f} ms an RPC (mean); "
        f"launches here and on the workers {launches}; locality rate "
        f"{router.locality_rate()}, routed {router.routed}, rerouted "
        f"{router.rerouted}; process totals: {family_line(fams)} ({card})")


# the spans of a remote tile's trace that `rpc_split` averages
RPC_SPANS = ("rpc.worker", "worker.warp", "worker.decode",
             "worker.dispatch", "worker.readback")


def rpc_split(base, n, what, card):
    """Where a remote tile's time goes, from the traces of the last
    ``n`` tiles with worker RPCs in the flight recorder (``/debug/trace
    ?format=jsonl``): the mean of the tile's root span and of the wall
    its RPCs cover; per RPC the mean ``rpc.worker`` span (the client's
    call, inside its limiter), the worker's adopted spans (``worker.warp``,
    the node's whole op, and in it ``worker.decode`` with the decode
    pool's queue wait ``pool_wait_s``, ``worker.dispatch`` and
    ``worker.readback``) and the carrier: the mean RPC span less the
    mean ``worker.warp`` (the codec, gRPC's HTTP/2 framing, its threads
    and the socket).  Host clocks of one machine."""
    st, _, body, _ = http_status(base + "/debug/trace?format=jsonl")
    traces = sorted((json.loads(ln) for ln in body.decode().splitlines()
                     if ln.strip()), key=lambda t: t["t0"])
    traces = [t for t in traces
              if any(s["name"] == "rpc.worker" for s in t["spans"])][-n:]
    if st != 200 or len(traces) < n:
        raise AssertionError(f"{what}: {len(traces)} traced remote tiles "
                             f"of {n} ({st})")
    durs = {k: [] for k in RPC_SPANS}
    waits, tiles, walls = [], [], []
    for t in traces:
        rpcs = [s for s in t["spans"] if s["name"] == "rpc.worker"]
        tiles.append(t["dur_s"])
        walls.append(max(s["t0"] + s["dur_s"] for s in rpcs)
                     - min(s["t0"] for s in rpcs))
        for s in t["spans"]:
            if s["name"] in durs:
                durs[s["name"]].append(s["dur_s"])
            if s["name"] == "worker.decode":
                waits.append((s.get("attrs") or {}).get("pool_wait_s",
                                                        float("nan")))
    ms = {k: float(np.mean(v)) * 1e3 if v else 0.0
          for k, v in durs.items()}
    log(f"phase {what}: traces of {n} remote tiles: tile "
        f"{np.mean(tiles) * 1e3:.2f} ms, its RPCs' wall "
        f"{np.mean(walls) * 1e3:.2f} ms (mean); "
        f"{len(durs['rpc.worker'])} rpc.worker spans of "
        f"{ms['rpc.worker']:.2f} ms, {len(durs['worker.warp'])} "
        f"worker.warp of {ms['worker.warp']:.2f} ms: worker.decode "
        f"{ms['worker.decode']:.2f} ms ({len(durs['worker.decode'])}; "
        f"pool wait {np.nanmean(waits) * 1e3 if waits else 0.0:.2f} ms), "
        f"worker.dispatch {ms['worker.dispatch']:.2f} ms, worker.readback "
        f"{ms['worker.readback']:.2f} ms; carrier "
        f"{ms['rpc.worker'] - ms['worker.warp']:.2f} ms an RPC ({card})")


def phase_fleet_masked(root, store, fleet, workers, card):
    """23b (phase 10's archive), 23d and 23e's worker drain: the masked
    LC08_B4 layer from a server whose ``fleet`` namespace names two
    worker nodes, against the same server's local modular route; then a
    worker SIGKILLed mid-burst (failover), a slow node (hedging) and a
    worker SIGTERMed with RPCs in flight (its drain).  Returns the
    launches here and on the workers, and the slow node's address."""
    mask = {"id": "pixel_qa", "bit_tests": CLOUD_SHADOW}
    layer = {"name": "masked_b4", "data_source": root,
             "rgb_products": ["LC08_B4"], "resample": "bilinear",
             "mask": mask, "clip_value": 2000}
    slow_ready = fleet.start(1, {"GSKY_FAULTS": f"node:latency:"
                                                f"{FLEET_LATENCY}"})
    kernels = _kernel_counts()
    total = dict.fromkeys(kernels, 0)
    dates = mosaic_dates()
    t_range = (dates[0][1] - 86400.0, dates[-1][1] + 86400.0)
    boxes = mosaic_boxes()[:FLEET_TILES]
    conf = os.path.join(root, "conf23")
    # the slow node is named before it listens: its namespace's client
    # is built at its first request, after the node is up
    slow = slow_ready()[0]
    server, httpd, base = fleet_server(conf, {
        "": ([layer], []), "fleet": ([layer], workers),
        "hedge": ([layer], [workers[0], slow])}, store)
    try:
        local = [getmap_url(base, "masked_b4", b, "", t_range)
                 for b in boxes]
        remote = [u.replace("/ows?", "/ows/fleet?") for u in local]
        want = [http_status(u)[2] for u in local]
        http_status(remote[0])                          # the client, warm
        check_no_child_context(fleet, card)

        # -- 23b: the remote tiles ------------------------------------
        reset_counts(kernels)
        w0, r0 = fleet.counts(workers), rpc_calls(base)
        secs, wall = fleet_burst(base, remote, FLEET_THREADS, want,
                                 "23b masked")
        here, there = read_counts(kernels), count_delta(
            w0, fleet.counts(workers))
        launches = {k: here[k] + there[k] for k in here}
        if here["B4"] != len(boxes) or here["B1"] or here["B2"]:
            raise AssertionError(f"23b masked: launches here {here}")
        for k in total:
            total[k] += launches[k]
        fleet_report("23b masked remote", secs, wall, r0,
                     {"here": here, "workers": there},
                     router_of(server, "fleet"), base, card)
        rpc_split(base, len(boxes), "23b masked", card)
        # the workers' kernels ran on gRPC's handler threads (through
        # the device guard's sync workers): no incident on either card
        # context, no CUDA error
        for w in workers:
            dev = fleet.info(w)["device"]
            if dev["state"] != "healthy" or dev["incidents"] \
                    or dev["last_error"]:
                raise AssertionError(f"23b: worker {w}'s device {dev}")

        # -- 23d: a worker SIGKILLed in the middle of a burst ---------
        victim = workers[1]
        killed = []

        def kill(n):
            if n == FLEET_TILES // 4 and not killed:
                killed.append(time.perf_counter())
                fleet.signal(victim, signal.SIGKILL)
                fleet.procs[victim].wait(30)
                killed.append(hold_port(int(victim.rsplit(":", 1)[1])))

        router = router_of(server, "fleet")
        re0 = router.rerouted
        reset_counts(kernels)
        secs, wall = fleet_burst(base, remote, FLEET_THREADS, want,
                                 "23d failover", during=kill)
        for k, v in read_counts(kernels).items():
            total[k] += v
        fleet.wait(victim, 30)
        killed[1].close()
        state = router.monitor.state(victim)
        if state != "dead" or router.rerouted <= re0:
            raise AssertionError(f"23d: the killed node is {state}, "
                                 f"rerouted {re0} -> {router.rerouted}")
        log(f"phase 23d: {victim} SIGKILLed after {FLEET_TILES // 4} of "
            f"{FLEET_TILES} tiles: every tile 200 with the local route's "
            f"bytes, the node {state}, rerouted {router.rerouted - re0}; "
            f"p50 {np.median(secs) * 1e3:.2f} ms, p90 "
            f"{np.percentile(secs, 90) * 1e3:.2f} ms ({card})")

        # -- 23d: hedging past a slow node ----------------------------
        hedged = [u.replace("/ows?", "/ows/hedge?") for u in local]
        reset_counts(kernels)
        w0 = fleet.counts([workers[0], slow])
        secs, wall = fleet_burst(base, hedged[:FLEET_SLOW_TILES],
                                 FLEET_THREADS, want, "23d hedging")
        hr = router_of(server, "hedge")
        fired = hr.hedge.hedges
        if fired <= 0:
            raise AssertionError(f"23d: no hedge fired: {hr.hedge.stats()}")
        for k, v in read_counts(kernels).items():
            total[k] += v
        for k, v in count_delta(w0, fleet.counts([workers[0],
                                                   slow])).items():
            total[k] += v
        log(f"phase 23d: node {slow} with GSKY_FAULTS=node:latency:"
            f"{FLEET_LATENCY}: {len(secs)} tiles, hedges {hr.hedge.stats()}"
            f", bytes equal; p50 {np.median(secs) * 1e3:.2f} ms, p90 "
            f"{np.percentile(secs, 90) * 1e3:.2f} ms ({card})")

        # -- 23e: a worker SIGTERMed with RPCs in flight --------------
        drained = []

        def term(n):
            if n == 1 and not drained:
                drained.append(time.perf_counter())
                fleet.signal(slow, signal.SIGTERM)

        reset_counts(kernels)
        w_live = fleet.counts([workers[0]])
        n = FLEET_SLOW_TILES
        secs, wall = fleet_burst(base, hedged[n:2 * n], FLEET_THREADS,
                                 want[n:2 * n], "23e worker drain",
                                 during=term)
        rc = fleet.wait(slow, 60)
        gone = time.perf_counter() - drained[0]
        if rc != 0:
            raise AssertionError(f"23e: the drained worker exited {rc}")
        for k, v in read_counts(kernels).items():
            total[k] += v
        for k, v in count_delta(w_live, fleet.counts([workers[0]])).items():
            total[k] += v
        time.sleep(0.2)                  # its last lines read
        lines = [ln for ln in fleet.output(slow) if "drain" in ln]
        log(f"phase 23e: {slow} SIGTERMed with RPCs in flight during a "
            f"{len(secs)}-tile burst: every tile 200 with equal bytes; the "
            f"node exited 0 {gone:.3f} s after the signal "
            f"({lines[-1] if lines else 'no drain line'}) ({card})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    return total


def phase_fleet_swath(sat_root, store, fleet, workers, card):
    """23b over phase 18's curvilinear swath: the masked swath layer
    (QA bit tests, nearest) from the workers, B1/B2 on the workers and
    B4 here, against the same server's local modular route."""
    d1, d2 = 1579046400.0, 1579132800.0
    layer = {"name": "swath", "data_source": os.path.join(sat_root, "swath"),
             "rgb_products": ["bt"], "resample": "near",
             "mask": {"id": "qa", "bit_tests": ["1000", "1000", "10", "10"]}}
    boxes = tile_grid(145.0, -29.0, 1100.0, 4, FLEET_TILES // 4)
    kernels = _kernel_counts()
    gc.collect()        # the closed clients of 23d: out of fleet_stats
    server, httpd, base = fleet_server(
        os.path.join(sat_root, "conf23"),
        {"": ([layer], []), "fleet": ([layer], workers)}, store)
    try:
        local = [getmap_url(base, "swath", b, "", (d1, d2 + 1.0))
                 for b in boxes]
        remote = [u.replace("/ows?", "/ows/fleet?") for u in local]
        want = [http_status(u)[2] for u in local]
        # each worker loads both scenes and their geolocation grids
        fetch_threads(http_status, remote[:4], FLEET_THREADS)
        reset_counts(kernels)
        w0, r0 = fleet.counts(workers), rpc_calls(base)
        secs, wall = fleet_burst(base, remote, FLEET_THREADS, want,
                                 "23b swath")
        here, there = read_counts(kernels), count_delta(
            w0, fleet.counts(workers))
        if here["B4"] != len(boxes) or there["B1"] + there["B2"] == 0:
            raise AssertionError(f"23b swath: launches here {here}, on "
                                 f"the workers {there}")
        fleet_report("23b swath remote", secs, wall, r0,
                     {"here": here, "workers": there},
                     router_of(server, "fleet"), base, card)
        rpc_split(base, len(boxes), "23b swath", card)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    return {k: here[k] + there[k] for k in here}


def phase_fleet_drill(drill_root, fleet, workers, card):
    """23c: the worker's ``drill`` op over phase 7's stack (B3 on the
    worker, its drill cache synchronous) against this process's drill
    of the same file, rtol 1e-5.  Returns the launches."""
    from gsky_tpu_torch.geo import geometry as geom
    from gsky_tpu_torch.index.client import Dataset
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.pipeline.drill import drill_file
    from gsky_tpu_torch.pipeline.types import GeoDrillRequest
    from gsky_tpu_torch.worker import WorkerClient
    from gsky_tpu_torch.worker import gskyrpc as pb
    path = os.path.join(drill_root, "modis_ndvi_stack.nc")
    ds = extract(path)["geo_metadata"][0]
    sel = list(range(DRILL_T))
    task = pb.Task(operation="drill")
    g = task.granule
    g.path, g.ds_name, g.namespace = path, ds["ds_name"], "ndvi"
    g.srs, g.array_type = "EPSG:4326", ds["array_type"]
    g.geo_transform.extend(ds["geotransform"])
    g.nodata, g.has_nodata = float(ds["nodata"]), True
    task.drill.geometry_wkt = DRILL_POLY
    task.drill.time_indices.extend(sel)
    client = WorkerClient(workers[:1])
    try:
        w0 = fleet.counts(workers[:1])
        t0 = time.perf_counter()
        res = client.process(task)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = client.process(task)
        warm = time.perf_counter() - t0
    finally:
        client.close()
    if res.error:
        raise AssertionError(f"23c: {res.error}")
    there = count_delta(w0, fleet.counts(workers[:1]))
    if there["B3"] < 1:
        raise AssertionError(f"23c: the worker launched {there}")
    dset = Dataset(file_path=path, ds_name=ds["ds_name"], namespace="ndvi",
                   array_type=ds["array_type"], srs="EPSG:4326",
                   geo_transform=list(ds["geotransform"]), timestamps=[],
                   timestamps_iso=[], polygon="", nodata=float(ds["nodata"]))
    req = GeoDrillRequest(collection="", bands=["ndvi"],
                          geometry_wkt=DRILL_POLY, clip_lower=-3.0e38,
                          clip_upper=3.0e38)
    vals, counts, _ = drill_file(dset, sel, geom.from_wkt(DRILL_POLY), req,
                                 device="cuda")
    if list(res.series.counts) != [int(c) for c in np.asarray(counts)]:
        raise AssertionError("23c: the worker's counts differ")
    a = np.asarray(vals, np.float64)
    b = np.asarray(res.series.means, np.float64)
    ok = np.isfinite(a)
    rel = float(np.max(np.abs(a[ok] - b[ok])
                       / np.maximum(np.abs(a[ok]), 1e-30)))
    if rel > 1e-5:
        raise AssertionError(f"23c: the worker's means differ by {rel}")
    log(f"phase 23c: the worker's drill op over the {DRILL_T}-step stack "
        f"(B3 on the worker: {there}) equals this process's drill within "
        f"rel {rel:.3g}; first {first * 1e3:.1f} ms (the stack's upload "
        f"included), warm {warm * 1e3:.1f} ms over the RPC ({card})")
    return there


def hold_port(port):
    """Bind (without listening) the port of a process just killed, so
    that a connection to it is refused at once: left free, the port is
    in the ephemeral range, and an outgoing connection can take it as
    its own local port and connect to itself."""
    import socket
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    return s


def free_ports(n):
    """``n`` ports free on 127.0.0.1 now."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def phase_ows_fleet(data_root, data_paths, card):
    """23e's OWS drain, 23f and 24e over phase 3's archive: six servers
    as the command line starts them (GSKY_PREWARM=0), each its own
    process, started together on ports chosen first (a master names its
    peers, a fabric gateway its peer): one for the drain, a master and
    two peers for the cluster, two gateways on the fabric's replay ring
    over the drain server's config.  Returns 24e's renders on the
    fabric gateways."""
    import threading
    from gsky_tpu_torch.index.crawler import extract
    crawl_file = os.path.join(data_root, "crawl23.jsonl")
    with open(crawl_file, "w") as fp:
        for p in data_paths:
            rec = extract(p)
            for ds in rec["geo_metadata"]:
                ds["namespace"] = NS
            fp.write(json.dumps(rec) + "\n")
    ports = free_ports(6)

    def conf(name, layer, nodes=()):
        d = os.path.join(data_root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as fp:
            json.dump({"service_config": {"mas_address": "in-process",
                                          "ows_cluster_nodes": list(nodes)},
                       "layers": [layer]}, fp)
        return d

    drain_layer = {"name": "plain", "data_source": data_root,
                   "rgb_products": [NS], "wcs_max_tile_width": 1024,
                   "wcs_max_tile_height": 1024}
    # cache_max_age 0: every request renders (the gateway keeps none)
    cov = {"name": "cov", "data_source": data_root, "rgb_products": [NS],
           "wcs_max_tile_width": CLUSTER_TILE,
           "wcs_max_tile_height": CLUSTER_TILE, "cache_max_age": 0}
    peer_conf = conf("conf23f_peer", cov)
    specs = {"drain": conf("conf23e", drain_layer),
             "master": conf("conf23f_master", cov,
                            ["local"] + [f"http://127.0.0.1:{p}"
                                         for p in ports[2:4]]),
             "peer1": peer_conf, "peer2": peer_conf,
             "fab1": os.path.join(data_root, "conf23e"),
             "fab2": os.path.join(data_root, "conf23e")}
    gw = {n: f"http://127.0.0.1:{p}" for n, p in zip(specs, ports)}
    envs = {n: {"GSKY_FABRIC": "1", "GSKY_FABRIC_SELF": gw[n],
                "GSKY_FABRIC_PEERS": gw[m]}
            for n, m in (("fab1", "fab2"), ("fab2", "fab1"))}
    servers = {}
    t0 = time.perf_counter()

    def start(name, port):
        servers[name] = serve_process(
            specs[name], crawl_file, os.path.join(data_root, f"logs_{name}"),
            "0", port, envs.get(name))

    ts = [threading.Thread(target=start, args=(n, p))
          for n, p in zip(specs, ports)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    try:
        if len(servers) != len(specs):
            raise AssertionError(f"23e/f, 24e: started {sorted(servers)}")
        log(f"phase 23e/f, 24e: {len(specs)} servers listening after "
            f"{time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        fab24 = phase_fabric_replay(servers["fab1"], servers["fab2"],
                                    servers["drain"][1], card)
        log(f"phase 24e: {time.perf_counter() - t1:.1f} s")
        phase_ows_drain(*servers["drain"][:2], card)
        phase_cluster(servers["master"][1],
                      [servers["peer1"], servers["peer2"]], card)
    finally:
        for proc, _, _ in servers.values():
            if proc.poll() is None:
                stop_process(proc)
    return fab24


def fabric_state(base):
    """A gateway's fabric replay outcomes, its B1 and B2 launches (the
    wrappers' own counters, ``/debug``'s ``torch.kernels``) and its
    executor's paged engagements, from ``/debug``."""
    st, _, body, _ = http_status(base + "/debug")
    if st != 200:
        raise AssertionError(f"/debug {st}")
    d = json.loads(body)
    fab = d.get("fabric", {}).get("replay", {}).get("outcomes", {})
    k = d["torch"]["kernels"]
    b1, b2 = (sum(k[s] for s in WORKER_SYMBOLS[n]) for n in ("B1", "B2"))
    return Counter(fab), b1, b2, d["executor"]["paged"]["engaged"]


def state_delta(before, after):
    """(outcomes, B1 launches, B2 launches) between two states; raises
    unless the paged engagements moved with the B1 launches."""
    (o0, l0, m0, e0), (o1, l1, m1, e1) = before, after
    if e1 - e0 != l1 - l0:
        raise AssertionError(f"24e: B1 launches {l1 - l0}, paged "
                             f"engagements {e1 - e0}")
    return dict(o1 - o0), l1 - l0, m1 - m0


def fabric_spans(base):
    """The ``gateway.fabric`` spans' ``hit`` of every trace the server's
    flight recorder holds."""
    st, _, body, _ = http_status(base + "/debug/trace?format=jsonl")
    if st != 200:
        raise AssertionError(f"/debug/trace {st}")
    traces = [json.loads(ln) for ln in body.decode().splitlines()
              if ln.strip()]
    return [sp.get("attrs", {}).get("hit") for t in traces
            for sp in t["spans"] if sp["name"] == "gateway.fabric"]


def phase_fabric_replay(s1, s2, base_off, card):
    """24e: two gateways on the fabric's replay ring (``s1``, ``s2``:
    (process, base url, lines)) and the drain server (``base_off``,
    the fabric off) over one config.  Tiles are asked of s1 until two
    that s1 owns were rendered there (one B1 launch each, read from the
    wrapper's counter on ``/debug``); s2 then answers the first with
    ``X-Gsky-Cache: peer``, s1's bytes and no launch, its trace holding
    a ``gateway.fabric`` span that hit; the fabric-off server answers
    the same bytes with no such span; s1 killed, s2 renders the second
    itself (its fetch fails over): 200, s1's bytes.  Returns the B1
    launches on the two gateways."""
    (p1, base1, _), (_, base2, _) = s1, s2
    owned, others, renders = [], 0, 0
    for box in tile_boxes():
        u = getmap_url("", "plain", box)
        before = fabric_state(base1)
        st, hd, body, secs = http_status(base1 + u)
        out, b1, b2 = state_delta(before, fabric_state(base1))
        if st != 200 or hd.get("X-Gsky-Cache") != "miss" or \
                (b1, b2) != (1, 0):
            raise AssertionError(f"24e: s1 {st} {hd.get('X-Gsky-Cache')}, "
                                 f"B1 {b1} B2 {b2}, outcomes {out}: "
                                 f"{body[:200]}")
        renders += b1
        if out == {"owner_local": 1}:
            owned.append((u, body, secs))
            if len(owned) == 2:
                break
        elif out == {"miss": 1}:
            others += 1           # s2 owns it: s1 asked, then rendered
        else:
            raise AssertionError(f"24e: s1's outcomes {out}")
    if len(owned) != 2:
        raise AssertionError(f"24e: s1 owns {len(owned)} of the tiles")
    u, want, own_s = owned[0]
    before = fabric_state(base2)
    st, hd, body, peer_s = http_status(base2 + u)
    out, b1, b2 = state_delta(before, fabric_state(base2))
    if st != 200 or hd.get("X-Gsky-Cache") != "peer" or body != want \
            or (b1, b2) != (0, 0) or out != {"hit": 1}:
        raise AssertionError(f"24e peer: {st} {hd.get('X-Gsky-Cache')}, "
                             f"same bytes {body == want}, B1 {b1} B2 {b2}, "
                             f"outcomes {out}")
    if True not in fabric_spans(base2):
        raise AssertionError("24e: no gateway.fabric span that hit on s2")
    st, hd, off_body, off_s = http_status(base_off + u)
    if st != 200 or off_body != want or "X-Gsky-Cache" not in hd:
        raise AssertionError(f"24e fabric off: {st}, same bytes "
                             f"{off_body == want}")
    if fabric_spans(base_off):
        raise AssertionError("24e: a gateway.fabric span with the fabric "
                             "off")
    p1.kill()
    p1.wait()
    held = hold_port(int(base1.rsplit(":", 1)[1]))
    try:
        u2, want2, _ = owned[1]
        before = fabric_state(base2)
        st, hd, body, dead_s = http_status(base2 + u2)
        out, b1, b2 = state_delta(before, fabric_state(base2))
    finally:
        held.close()
    if st != 200 or body != want2 or hd.get("X-Gsky-Cache") != "miss" \
            or (b1, b2) != (1, 0) or not (out.get("error")
                                          or out.get("breaker_open")):
        raise AssertionError(f"24e owner dead: {st} "
                             f"{hd.get('X-Gsky-Cache')}, same bytes "
                             f"{body == want2}, B1 {b1} B2 {b2}, outcomes "
                             f"{out}")
    renders += b1
    log(f"phase 24e: s1 rendered {renders - 1} tiles (one B1 launch each, "
        f"{len(owned)} it owns, {others} s2 owns); s2 replayed an s1-owned "
        f"tile from s1 (X-Gsky-Cache peer, s1's bytes, no render, a "
        f"gateway.fabric span that hit) in {peer_s * 1e3:.2f} ms against "
        f"s1's render {own_s * 1e3:.2f} ms; the fabric-off server's "
        f"answer is s1's bytes, with no gateway.fabric span "
        f"({off_s * 1e3:.2f} ms, its own render); s1 killed, s2 rendered "
        f"the other s1-owned tile itself in {dead_s * 1e3:.2f} ms (outcomes "
        f"{out}), s1's bytes ({card})")
    return {"B1": renders, "B2": 0, "B3": 0, "B4": 0}


def phase_ows_drain(proc, base, card):
    """23e: the command line's server, SIGTERMed with DRAIN_REQUESTS
    GetCoverage requests in flight: every one answers 200, a request
    after the signal gets 503 with Retry-After, and the process exits 0
    within GSKY_DRAIN_TIMEOUT_S."""
    from concurrent.futures import ThreadPoolExecutor
    timeout_s = float(os.environ.get("GSKY_DRAIN_TIMEOUT_S", "30"))
    # distinct coverages: the gateway would join equal ones
    urls = [wcs_url(base, "plain", wcs_box(
        DRAIN_SIZE, x0=500000.0 + 21000.0 + 3000.0 * i), DRAIN_SIZE)
        for i in range(DRAIN_REQUESTS + 1)]
    # the scenes loaded by a coverage the burst does not repeat
    st, _, body, _ = http_status(urls.pop())
    if st != 200:
        raise AssertionError(f"23e: {st} {body[:300]}")
    with ThreadPoolExecutor(DRAIN_REQUESTS) as ex:
        futs = [ex.submit(http_status, u) for u in urls]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st, _, body, _ = http_status(base + "/debug")
            if json.loads(body)["drain"]["inflight"] >= DRAIN_REQUESTS:
                break
            time.sleep(0.01)
        else:
            raise AssertionError(
                f"23e: the requests never were all in flight: "
                f"{[f.result()[:2] for f in futs if f.done()]}")
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        # the handler runs on the server's main thread between its
        # bytecodes: the late request goes once the drain has begun
        # (/debug keeps answering through it)
        while time.monotonic() < deadline and not json.loads(
                http_status(base + "/debug")[2])["drain"]["draining"]:
            time.sleep(0.01)
        late = http_status(urls[0])
        done = [f.result() for f in futs]
    rc = proc.wait(timeout_s + 15)
    exit_s = time.perf_counter() - t_sig
    if [d[0] for d in done] != [200] * DRAIN_REQUESTS:
        raise AssertionError(f"23e: in flight {[d[0] for d in done]}")
    if late[0] != 503 or not late[1].get("Retry-After"):
        raise AssertionError(f"23e: after the signal {late[0]} "
                             f"{late[1]}")
    if rc != 0 or exit_s > timeout_s:
        raise AssertionError(f"23e: exit {rc} after {exit_s:.1f} s")
    time.sleep(0.2)                  # its last lines read
    lines = []
    while not proc.output.empty():
        lines.append(proc.output.get())
    drain = [ln.strip() for ln in lines if "drain" in ln]
    log(f"phase 23e: the command line's server SIGTERMed with "
        f"{DRAIN_REQUESTS} {DRAIN_SIZE}^2 GetCoverage requests in flight: "
        f"all 200; a request after the signal {late[0]} with Retry-After "
        f"{late[1].get('Retry-After')}; exit 0 {exit_s:.3f} s after the "
        f"signal ({drain[-1] if drain else 'no drain line'}) ({card})")


def phase_cluster(base, peers, card):
    """23f: a CLUSTER_SIZE^2 GetCoverage from the master (``base``),
    whose ``ows_cluster_nodes`` are itself and ``peers`` ((process, base
    url, lines) each), against its own single-node export
    (``wshard=1``); then with a peer killed, its band rendered on the
    master, labelled ``shard-fallback``, with the single node's values."""
    url = wcs_url(base, "cov", wcs_box(CLUSTER_SIZE), CLUSTER_SIZE)
    small = wcs_url(base, "cov", wcs_box(CLUSTER_SIZE), 256) + "&wshard=1"
    for b in [base] + [b for _, b, _ in peers]:
        http_status(b + small[len(base):])      # each node's scenes loaded

    def peer_wcs():
        return [sample(scrape_families(b, ("gsky_requests",)),
                       "gsky_requests_total", (("service", "WCS"),))
                for _, b, _ in peers]

    runs = {}
    before = peer_wcs()
    for what, u in (("single node", url + "&wshard=1"),
                    ("cluster of 3", url)):
        st, hd, body, secs = http_status(u)
        if st != 200:
            raise AssertionError(f"23f {what}: {st} {body[:300]}")
        runs[what] = (tiff_values(body), hd, secs)
    if [n - m for n, m in zip(peer_wcs(), before)] != [1, 1]:
        raise AssertionError("23f: a peer was not sent its band")
    single = runs["single node"][0]
    got, hd, _ = runs["cluster of 3"]
    if "X-GSKY-Degraded" in hd:
        raise AssertionError(f"23f: degraded {hd['X-GSKY-Degraded']}")
    # the bands are cut along tile rows, and CLUSTER_SIZE is a multiple
    # of CLUSTER_TILE: each band's tiles are the single node's tiles, so
    # no value may differ, at a seam or elsewhere
    differ = int(np.count_nonzero(got != single))
    if differ:
        raise AssertionError(f"23f: {differ} values differ from the "
                             f"single node's")
    peers[1][0].kill()
    peers[1][0].wait()
    held = hold_port(int(peers[1][1].rsplit(":", 1)[1]))
    try:
        st, hd, body, secs = http_status(url)
    finally:
        held.close()
    if st != 200 or hd.get("X-GSKY-Degraded") != "shard-fallback":
        raise AssertionError(f"23f fallback: {st} {hd}")
    fb = tiff_values(body)
    fb_differ = int(np.count_nonzero(fb != single))
    if fb_differ:
        raise AssertionError(f"23f fallback: {fb_differ} values differ")
    runs["a peer killed"] = (fb, hd, secs)
    mpx = CLUSTER_SIZE * CLUSTER_SIZE / 1e6
    log("phase 23f: GetCoverage " + "; ".join(
        f"{k} {v[2]:.3f} s, {mpx / v[2]:.2f} Mpix/s"
        for k, v in runs.items()) +
        f"; values differing from the single node's: cluster {differ}, "
        f"fallback {fb_differ} of {single.size}; fallback labelled "
        f"shard-fallback ({card})")


# -- phase 24: the cache fabric and the elastic fleet on one card -------------

FAB_TILES = 16               # 24: swath tiles a node serves
FAB_PX = 1250.0              # 24: their ground metres a pixel (18d's)
FAB_GRACE = 10.0             # 24a: the preempt notice's grace
FAB_FAULT_GRACE = 5.0        # 24c: the fault node's grace
FAB_THREADS = 4              # 24c: request threads
FAB_BURST = 8                # 24d: request threads under admission
FAB_ADMIT = 2                # 24d: the admission limit they queue on
FAB_SCALE_S = 120.0          # 24d: the longest one scale step may take
FAB_D1, FAB_D2 = 1579046400.0, 1579132800.0    # the swath's two dates


def fabric_env(sat_root, name, **extra):
    """A phase-24 worker's environment: the fabric on, a page journal
    of its own."""
    env = {"GSKY_FABRIC": "1", "GSKY_POOL_JOURNAL":
           os.path.join(sat_root, f"journal24-{name}.jsonl")}
    env.update(extra)
    return env


def start_fabric_workers(fleet, sat_root):
    """24's workers A and B (the hand-off) and C (the preempt fault,
    without prewarm: its launch counts are then its tiles'), started
    together: a callable that waits for them, {name: addr}."""
    waits = {"A": fleet.start(1, fabric_env(sat_root, "A")),
             "B": fleet.start(1, fabric_env(sat_root, "B")),
             "C": fleet.start(1, fabric_env(
                 sat_root, "C", GSKY_PREWARM="0",
                 GSKY_FAULTS=f"node:preempt:{FAB_FAULT_GRACE:g}s"))}
    return lambda: {n: w()[0] for n, w in waits.items()}


def fabric_jobs(sat_root, store):
    """24's warps: (granule, dst geotransform, CRS) of the
    full-resolution swath for each of the FAB_TILES tiles, and one of
    the second (5x subsampled) granule."""
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.pipeline.tile import TilePipeline
    pipe = TilePipeline(MASClient(store), device="cuda")
    swath = os.path.join(sat_root, "swath")
    boxes = tile_grid(143.0, -27.5, FAB_PX, 4, FAB_TILES // 4)
    jobs = []
    for d, bs in ((FAB_D1, boxes), (FAB_D2, boxes[:1])):
        for b in bs:
            req = tile_request(swath, "bt", b, "bilinear", t=(d, d))
            gs = pipe.index(req)
            if len(gs) != 1 or not gs[0].geo_loc:
                raise AssertionError(f"24: tile {b}: granules {gs}")
            jobs.append((gs[0], req.dst_gt(), req.crs))
    return jobs[:-1], jobs[-1]


def remote_warp(client, job):
    g, gt, crs = job
    got = client.warp(g, gt, crs, 256, 256, "bilinear")
    if got is None:
        raise AssertionError(f"24: an empty warp of {g.path}")
    return got


def local_warp(ex, job):
    """This process's warp of ``job`` (B1 through its own pool): the
    local route the workers' answers are held against."""
    g, gt, crs = job
    canv, val = ex.warp_mosaic_scenes([g], [0], [1.0], gt, crs, 256, 256,
                                      1, "bilinear")
    return canv[0].cpu().numpy(), val[0].cpu().numpy()


def same_warp(got, want, what):
    """Bytes equal: the f32 canvas bit for bit, the validity equal."""
    a, v = got
    wa, wv = want
    if a.tobytes() != wa.tobytes() or not np.array_equal(v, wv):
        raise AssertionError(f"{what}: {int(np.count_nonzero(a != wa))} "
                             f"values and {int(np.count_nonzero(v != wv))} "
                             f"validity pixels differ")
    if not v.any():
        raise AssertionError(f"{what}: no valid pixel")


def serve_tiles(client, jobs, want, what):
    """``jobs`` one after another: the answers (equal to ``want``) and
    each one's seconds."""
    secs = []
    for i, j in enumerate(jobs):
        t0 = time.perf_counter()
        got = remote_warp(client, j)
        secs.append(time.perf_counter() - t0)
        same_warp(got, want[i], f"{what} tile {i}")
    return secs


def pool_cold(pages):
    """A pool's cold stages (its stages less its peer fills)."""
    return pages["staged"] - pages["peer_filled"]


def wait_until(fn, what, timeout, step=0.05):
    """Poll ``fn`` until it returns something true; that value."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(step)
    raise AssertionError(f"24: {what} after {timeout} s")


def phase_fabric(sat_root, store, fleet, fab_ready, card):
    """Phase 24a-d over phase 18d's swath (module docstring).  Returns
    the launches on the workers, by kernel."""
    import threading
    from gsky_tpu_torch.fleet import elastic
    from gsky_tpu_torch.pipeline.executor import WarpExecutor
    from gsky_tpu_torch.worker import WorkerClient
    jobs, second = fabric_jobs(sat_root, store)
    ex = WarpExecutor(device="cuda")
    want = [local_warp(ex, j) for j in jobs]
    launches = Counter()
    addrs = fab_ready()
    a, b, c = addrs["A"], addrs["B"], addrs["C"]

    # -- 24a: the hand-off ---------------------------------------------
    cb, ca = WorkerClient([b]), WorkerClient([a])
    try:
        k0 = fleet.counts([b])
        t0 = time.perf_counter()
        remote_warp(cb, second)
        b_other_s = time.perf_counter() - t0
        launches.update(count_delta(k0, fleet.counts([b])))
        k0 = fleet.counts([a])
        secs_a = serve_tiles(ca, jobs, want, "24a on A")
        ka = count_delta(k0, fleet.counts([a]))
        launches.update(ka)
        if ka["B1"] != FAB_TILES or ka["B2"]:
            raise AssertionError(f"24a: launches on A {ka}")
        held = fleet.info(a)["pages"]
        info_b = fleet.info(b)
        if info_b["pages"]["peer_filled"] or info_b["elastic"]["handoff"][
                "entries"]:
            raise AssertionError(f"24a: B before the hand-off {info_b}")
        t_notice = time.perf_counter()
        ack = elastic.control_rpc(a, "preempt", {
            "v": 1, "grace_s": FAB_GRACE, "successor": b, "peers": [b]})
        done = wait_until(
            lambda: (lambda e: e if e["handoff"]["entries"]
                     and not e["handoff"]["active"] else None)(
                fleet.info(b)["elastic"]), "B's hand-off fill", FAB_GRACE)
        t_fill = time.perf_counter() - t_notice
        ho, hp = done["handoff"], done["counters"]["handoff_pages"]
        n = held["resident"]
        if ho != {"entries": n, "filled": n, "cold": 0, "active": 0} or \
                hp != {"peer": n, "cold": 0} or not n:
            raise AssertionError(f"24a: A held {n} pages; B's hand-off "
                                 f"{ho}, handoff_pages {hp}")
        p0 = fleet.info(b)["pages"]
        if p0["peer_filled"] != n:
            raise AssertionError(f"24a: B's pool {p0}")
        k0 = fleet.counts([b])
        secs_b = serve_tiles(cb, jobs, want, "24a on B")
        kb = count_delta(k0, fleet.counts([b]))
        launches.update(kb)
        p1 = fleet.info(b)["pages"]
        if kb["B1"] != FAB_TILES or kb["B2"] or \
                pool_cold(p1) != pool_cold(p0) or p1["hits"] <= p0["hits"]:
            raise AssertionError(f"24a: on B launches {kb}, pool before "
                                 f"{p0}, after {p1}")
        rc = fleet.wait(a, FAB_GRACE + 15)
        t_exit = time.perf_counter() - t_notice
        if rc != 0 or t_exit > FAB_GRACE:
            raise AssertionError(f"24a: A exited {rc} after {t_exit:.2f} s")
    finally:
        ca.close()
        cb.close()
    log(f"phase 24a: A served {FAB_TILES} swath tiles (B1 {ka['B1']}, "
        f"first {secs_a[0] * 1e3:.2f} ms cold, p50 "
        f"{np.median(secs_a[1:]) * 1e3:.2f} ms), held {n} pages "
        f"({n * held['page_shape'][0] * held['page_shape'][1] * 4} B); "
        f"preempt (grace {FAB_GRACE:g} s, {ack}): B's hand-off fill done "
        f"{t_fill:.3f} s after the notice, {n / t_fill:.1f} pages/s "
        f"({n * 4 * held['page_shape'][0] * held['page_shape'][1] / t_fill / 1e6:.1f} MB/s) "
        f"over the carrier; handoff_pages {hp}; B (which had loaded the "
        f"second granule first, {b_other_s * 1e3:.2f} ms) served the "
        f"same tiles: bytes equal to A's and the local warp's, B1 "
        f"{kb['B1']}, cold stages 0, pool hits +{p1['hits'] - p0['hits']}; "
        f"B's first tile {secs_b[0] * 1e3:.2f} ms (its scene decoded, its "
        f"pages inherited) against A's cold {secs_a[0] * 1e3:.2f} ms, p50 "
        f"{np.median(secs_b[1:]) * 1e3:.2f} ms; A exited 0 "
        f"{t_exit:.3f} s after the notice ({card})")

    # -- 24b: A restarted, warm from B; 24c runs while it boots --------
    t_boot = time.perf_counter()
    a2_ready = fleet.start(1, fabric_env(sat_root, "A",
                                         GSKY_FABRIC_PAGE_PEERS=b),
                           port=int(a.rsplit(":", 1)[1]))

    # -- 24c: the preempt fault ----------------------------------------
    cc = WorkerClient([c, b])
    # the fault node exits two seconds before its grace ends, which a
    # slow burst outlasts: its worker_info read until it is gone, the
    # last answer kept.  Every RPC rolls the node's faults, so the
    # reads start only once a burst tile has carried the notice (its
    # log line), which must land on a busy node
    pid = fleet.procs[c].pid
    last_c = {}
    gone = threading.Event()

    def watch_c():
        while pid not in fleet.notice_at:
            if gone.wait(0.02):
                return
        while not gone.is_set():
            try:
                last_c["info"] = fleet.info(c)
            except Exception:  # exited (or not answering): keep the last
                if fleet.procs[c].poll() is not None:
                    return
            gone.wait(0.2)

    watcher = threading.Thread(target=watch_c, daemon=True)
    watcher.start()
    try:
        k0 = fleet.counts([b])
        t0 = time.perf_counter()
        got, wall = fetch_threads(lambda j: remote_warp(cc, j), jobs,
                                  FAB_THREADS)
        for i, g in enumerate(got):
            same_warp(g, want[i], f"24c tile {i}")
        # a burst tile carried the notice: its log line, read by now
        wait_until(lambda: fleet.notice_at.get(pid),
                   "the fault node's notice from the burst", 5.0)
        if fleet.procs[c].poll() is None:
            try:
                last_c["info"] = fleet.info(c)
            except Exception:  # draining to its exit: the last answer
                pass           # stands, as the watcher keeps it
        gone.set()
        watcher.join(35)
        info_c = last_c.get("info")
        if info_c is None:
            raise AssertionError("24c: the fault node answered no "
                                 "worker_info after its notice")
        kc = {name: sum(info_c["kernels"][sym] for sym in syms)
              for name, syms in WORKER_SYMBOLS.items()}
        kb = count_delta(k0, fleet.counts([b]))
        rc = fleet.wait(c, FAB_FAULT_GRACE + 15)
        # the notice came with the node's first RPC: its log line's
        # arrival, to the node's exit
        t_notice = fleet.notice_at[pid] - t0
        t_exit = wait_until(lambda: fleet.exit_at.get(pid),
                            "the fault node's exit time", 5.0) \
            - fleet.notice_at[pid]
    finally:
        cc.close()
    el_c = info_c["elastic"]
    if not el_c["preempted"] or \
            el_c["counters"]["preemptions"] != {"graceful": 1, "nograce": 0}:
        raise AssertionError(f"24c: the fault node's elastic block {el_c}")
    if t_notice < 0:
        raise AssertionError(f"24c: the notice came {-t_notice:.3f} s "
                             f"before the burst")
    if rc != 0 or t_exit > FAB_FAULT_GRACE:
        raise AssertionError(f"24c: the fault node exited {rc} "
                             f"{t_exit:.3f} s after its notice")
    if kc["B1"] + kb["B1"] < FAB_TILES or kc["B2"] or kb["B2"]:
        raise AssertionError(f"24c: launches on the fault node {kc}, on B "
                             f"{kb}")
    launches.update(kc)
    launches.update(kb)
    log(f"phase 24c: GSKY_FAULTS=node:preempt:{FAB_FAULT_GRACE:g}s on one "
        f"of two nodes under a {FAB_THREADS}-thread burst: {FAB_TILES} "
        f"tiles, all equal to the local warp, {FAB_TILES / wall:.2f} "
        f"tiles/s; B1 on the fault node {kc['B1']}, on B {kb['B1']}; the "
        f"node preempted, its "
        f"gsky_preemptions_total{{graceful}} counter "
        f"{el_c['counters']['preemptions']['graceful']}, its notice "
        f"{t_notice:.3f} s into the burst, exit 0 {t_exit:.3f} s after the "
        f"notice ({card})")

    # -- 24b's checks --------------------------------------------------
    a2 = a2_ready()[0]
    boot_s = time.perf_counter() - t_boot
    pages = wait_until(lambda: (lambda p: p if p["rehydrated"] else None)(
        fleet.info(a2)["pages"]), "A's warm boot", 60.0)
    c2 = WorkerClient([a2])
    try:
        k0 = fleet.counts([a2])
        secs = serve_tiles(c2, jobs, want, "24b on A restarted")
        ka2 = count_delta(k0, fleet.counts([a2]))
        launches.update(ka2)
        p1 = fleet.info(a2)["pages"]
    finally:
        c2.close()
    log(f"phase 24b: A restarted on {a2} with its journal and "
        f"GSKY_FABRIC_PAGE_PEERS={b}: listening {boot_s:.2f} s after the "
        f"start; its warm boot restored {pages['rehydrated']} pages "
        f"(peer_filled {pages['peer_filled']}, cold stages "
        f"{pool_cold(pages)}); its {FAB_TILES} tiles equal A's (B1 "
        f"{ka2['B1']}, cold stages after them {pool_cold(p1)}), first "
        f"{secs[0] * 1e3:.2f} ms ({card})")
    fleet.signal(a2, signal.SIGTERM)
    if fleet.wait(a2, 60) != 0:
        raise AssertionError("24b: A restarted did not drain to exit 0")

    # -- 24d: the autoscaler -------------------------------------------
    launches.update(phase_autoscale(sat_root, fleet, b, jobs, want, card))
    return dict(launches)


def phase_autoscale(sat_root, fleet, b, jobs, want, card):
    """24d: an `Autoscaler` over B and a `LocalSubprocessProvider` whose
    nodes start with an empty journal of their own and
    ``GSKY_FABRIC_PAGE_PEERS`` = B, driven by the demand of an admission
    controller (limit FAB_ADMIT) that FAB_BURST threads queue on: one
    scale-up, its node joining only once its warm boot has taken B's hot
    set and pulled those pages from B; then at lower load one scale-down
    that preempts a node with a hand-off.  Returns the launches of the
    tiles served."""
    import threading
    from gsky_tpu_torch.fleet import elastic
    from gsky_tpu_torch.obs import parse_exposition, render_metrics
    from gsky_tpu_torch.serving.admission import AdmissionController
    from gsky_tpu_torch.worker import WorkerClient

    log_dir = os.path.join(sat_root, "logs24d")
    os.makedirs(log_dir, exist_ok=True)
    provider = elastic.LocalSubprocessProvider(
        extra_env={"GSKY_FABRIC": "1", "GSKY_FABRIC_PAGE_PEERS": b,
                   "PYTHONUNBUFFERED": "1",
                   "PYTHONPATH": ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", "")},
        log_dir=log_dir, journal_dir=sat_root)
    adm = AdmissionController(limits={"WMS": FAB_ADMIT},
                              queue_deadline_s=60.0, adaptive=False)
    client = WorkerClient([b])
    c0 = elastic.counters()["decisions"]
    scaler = elastic.Autoscaler(
        provider, client, name="smoke24", min_nodes=1, max_nodes=3,
        interval_s=0.25, up=0.8, down=0.25, up_ticks=2, down_ticks=4,
        cooldown_s=5.0, ready_timeout_s=FAB_SCALE_S, drain_grace_s=3.0,
        demand=elastic.DemandSignal(admission=adm, alpha=0.5))
    level, stop = [FAB_BURST], threading.Event()
    served, failed, lock = [0], [], threading.Lock()

    def load(i):
        k = i
        while not stop.is_set():
            if i >= level[0]:
                time.sleep(0.02)
                continue
            try:
                with adm.admit("WMS", "smoke24"):
                    got = remote_warp(client, jobs[k % len(jobs)])
                same_warp(got, want[k % len(jobs)], "24d")
                with lock:
                    served[0] += 1
            except Exception as e:  # counted, and the phase fails
                with lock:
                    failed.append(repr(e))
            k += FAB_BURST

    def decided(d):
        return [e for e in scaler.decisions if e["dir"] == d]

    threads = [threading.Thread(target=load, args=(i,), daemon=True)
               for i in range(FAB_BURST)]
    kb0 = fleet.counts([b])
    t0 = time.perf_counter()
    scaler.start()
    for t in threads:
        t.start()
    try:
        up = wait_until(lambda: decided("up"), "no scale-up", 60.0)[0]
        t_up = time.perf_counter() - t0
        level[0] = 1            # half the limit: between down and up
        join = wait_until(lambda: decided("join"), "no join", FAB_SCALE_S)
        t_join = time.perf_counter() - t0
        new = up["node"]
        # what the node held when it joined: B's hot set from B
        joined_pages = elastic.probe_info(new)["pages"]

        def node_b1(addr):
            return sum(elastic.probe_info(addr)["kernels"][s]
                       for s in WORKER_SYMBOLS["B1"])
        n0, new0 = served[0], node_b1(new)
        wait_until(lambda: served[0] - n0 >= FAB_TILES, "tiles after the "
                   "join", 60.0)
        level[0] = 0
        wait_until(lambda: not any(adm.stats()["classes"]["WMS"][f]
                                   for f in ("in_use", "queued")),
                   "the load's end", 60.0)
        new_b1 = node_b1(new) - new0
        b_b1 = count_delta(kb0, fleet.counts([b]))["B1"]
        down = wait_until(lambda: decided("down"), "no scale-down", 60.0)[0]
        t_down = time.perf_counter() - t0
        victim, succ = down["node"], down["successor"]
        if victim == b:
            rc = fleet.wait(b, 30)
        else:
            # its own exit, before the retire's terminate (grace + 2 s)
            proc = provider._procs[victim]
            rc = wait_until(lambda: proc.poll() is not None and
                            (proc.returncode,), "the victim's exit",
                            30.0)[0]
        t_gone = time.perf_counter() - t0
        ho = elastic.probe_info(succ)["elastic"]["handoff"]
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        scaler.stop()
        client.close()
        provider.close()
    dirs = Counter(e["dir"] for e in scaler.decisions)
    c1 = elastic.counters()["decisions"]
    fams = parse_exposition(render_metrics())
    metric = {dict(lab)["dir"]: v for (nm, lab), v in
              fams["gsky_elastic_decisions_total"]["samples"].items()}
    mine = {d: c1[d] - c0.get(d, 0) for d in ("up", "down")}
    if failed or dirs["up"] != 1 or dirs["down"] != 1 or dirs["join"] != 1 \
            or join[0]["reason"] != "ready" or rc != 0 or not new_b1 \
            or join[0]["warm_fraction"] < elastic.WARM_FRAC \
            or not joined_pages["peer_filled"] \
            or joined_pages["peer_filled"] != joined_pages["staged"] \
            or mine != {"up": dirs["up"], "down": dirs["down"]} \
            or {d: metric[d] - c0.get(d, 0) for d in mine} != mine \
            or not ho["entries"] or ho["cold"] or ho["active"]:
        raise AssertionError(f"24d: decisions {scaler.decisions}, failed "
                             f"{failed[:3]}, exit {rc}, B1 on the new node "
                             f"{new_b1}, metric {metric}, counters {mine}, "
                             f"successor's hand-off {ho}, the new node's "
                             f"pool at its join {joined_pages}")
    log(f"phase 24d: {served[0]} tiles, none failed, bytes equal; "
        f"scale-up {t_up:.2f} s into the burst ({FAB_BURST} threads on an "
        f"admission limit of {FAB_ADMIT}, demand {up}); {new} joined "
        f"{t_join - t_up:.2f} s later ({join[0]}; its pool then "
        f"{joined_pages['peer_filled']} pages from B, no cold stage); B1 "
        f"launches on B "
        f"{b_b1}, on the new node {new_b1}; at no load the scale-down {t_down:.2f} s in "
        f"({down}), the victim out {t_gone - t_down:.2f} s later, its "
        f"successor's hand-off {ho}; gsky_elastic_decisions_total {metric} "
        f"({card})")
    if b_b1 + new_b1 != served[0]:
        raise AssertionError(f"24d: {served[0]} tiles, B1 on B {b_b1}, on "
                             f"the new node {new_b1}")
    return {"B1": served[0], "B2": 0, "B3": 0, "B4": 0}


# -- phase 25: multi-GPU serving on a virtual mesh --------------------------

MESH_MEMBERS = 4             # 25: members of the virtual mesh
MESH_DEVICES = ",".join(["cuda:0"] * MESH_MEMBERS)
MESH_TILES = 32              # 25a: native tiles a run (config 1)
MESH_THREADS = 16            # 25a: client threads
MESH_SPMD_TILES = 8          # 25d: GSKY_SPMD fused tiles
MESH_MOSAIC_TILES = 4        # 25d: GSKY_SPMD mosaics over phase 10's dates
MESH_WCS_ZOOM = 0.25         # 25b: the coverage's pixel, x the native one
MESH_X_RULE = r"kind=scored\b.*\bw=1024\b=>x"   # 25b: its blocks to x


class MeshOn:
    """A virtual mesh of `MESH_MEMBERS` members on the one card
    (``GSKY_MESH_DEVICES``), with ``env`` set (GSKY_MESH, GSKY_SPMD,
    GSKY_MESH_RULES, GSKY_MESH_PLACE, GSKY_POOL_JOURNAL); the mesh
    dispatcher, the per-member pools and the wave schedulers fresh on
    entry and dropped on exit, the knobs restored."""

    KEYS = ("GSKY_MESH", "GSKY_MESH_DEVICES", "GSKY_MESH_RULES",
            "GSKY_MESH_PLACE", "GSKY_SPMD", "GSKY_POOL_JOURNAL")

    def __init__(self, **env):
        self.env = dict(env, GSKY_MESH_DEVICES=MESH_DEVICES)

    @staticmethod
    def _reset():
        from gsky_tpu_torch.mesh import dispatch, pools
        from gsky_tpu_torch.pipeline import waves
        waves.reset_waves()
        dispatch.reset_mesh()
        pools.reset_mesh_pools()

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        for k in self.KEYS:
            os.environ.pop(k, None)
        os.environ.update(self.env)
        self._reset()
        return self

    def __exit__(self, *exc):
        self._reset()
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_words():
    """What phase 25's mesh is: members sharing a card, or cards."""
    devs = MESH_DEVICES.split(",")
    if len(set(devs)) < len(devs):
        return "virtual mesh on one card"
    return f"mesh over {len(devs)} cards"


def mesh_line(what, st, wall, plain_wall, card):
    """Phase 25's per-member line from a dispatcher's stats."""
    log(f"phase {what}: {mesh_words()}, members "
        f"{', '.join(st['devices'])}: kernel calls per member by layout "
        f"{st['launches_by_layout']}, bodies per member "
        f"{st['member_dispatches']}; shard skew of the last wave "
        f"{st['skew_ms_last']} ms (member waits "
        f"{st['member_wait_ms_last']} ms); wall {wall:.3f} s against "
        f"{plain_wall:.3f} s unsharded ({card})")


def spmd_line(what, md, wall, plain_wall, card):
    """Phase 25's per-member line for the GSKY_SPMD routes (no wave, so
    no readback skew)."""
    log(f"phase {what}: {mesh_words()}, members "
        f"{', '.join(map(str, md.mesh.members))}: bodies per member "
        f"{md.mesh.member_stats()} (one kernel call each); shard skew not "
        f"observed (no wave readback); wall {wall:.3f} s against "
        f"{plain_wall:.3f} s unsharded ({card})")


def all_ok(answers, ctype, what):
    for status, ct, body, _ in answers:
        if (status, ct) != (200, ctype):
            raise AssertionError(f"{what}: {status} {ct} {body[:300]}")


def same_pngs(a, b, what):
    from gsky_tpu_torch.io.png import decode_png
    for (_, _, x, _), (_, _, y, _) in zip(a, b):
        if not np.array_equal(decode_png(x), decode_png(y)):
            raise AssertionError(f"{what}: decoded tiles differ")


def phase_mesh(data_root, data_paths, card):
    """Phase 25a, 25b, 25d's GetMap and 25e, over phase 3's archive
    (crawled afresh: earlier phases add records of archives since
    removed) with the port's OWS server on the card over HTTP: the mesh
    layouts and the GSKY_SPMD route on a virtual 4-member mesh, each
    against the same requests unsharded.  Returns the kernels launched
    on the mesh's paths {"B1": n, "B2": n}."""
    from collections import Counter
    from gsky_tpu_torch.device_guard import journal
    from gsky_tpu_torch.mesh import dispatch as mdisp
    from gsky_tpu_torch.mesh import pools as mpools
    from gsky_tpu_torch.server.prewarm import prewarm
    conf = os.path.join(ROOT, "build", "smoke_mesh_conf")
    shutil.rmtree(conf, ignore_errors=True)
    styles = [{"name": m, "title": m, "rgb_products": [NS], "resample": m}
              for m in METHODS]
    layers = [{"name": "landsat", "data_source": data_root,
               "rgb_products": [NS], "styles": styles,
               "wcs_max_tile_width": WCS_TILE,
               "wcs_max_tile_height": WCS_TILE}]
    launches = _kernel_counts()
    out = {"B1": 0, "B2": 0}
    pair = OwsPair(conf, layers, crawl((p, NS) for p in data_paths))
    try:
        srv = pair.card
        urls = [getmap_url(pair.base, "landsat", b, "bilinear")
                for b in tile_boxes()[:MESH_TILES]]
        http_get(urls[0])               # the scene cache warm: set-up

        # -- 25a: the granule layout ------------------------------------
        with WavesOn():
            plain, plain_wall = fetch_threads(http_get, urls, MESH_THREADS)
        all_ok(plain, "image/png", "25a unsharded")
        with WavesOn(), MeshOn(GSKY_MESH="1"):
            f0 = scrape_families(pair.base, ("gsky_mesh_",))
            reset_counts(launches)
            got, wall = fetch_threads(http_get, urls, MESH_THREADS)
            n = read_counts(launches)
            st = mdisp.active_mesh().stats()
            f1 = scrape_families(pair.base, ("gsky_mesh_",))
            dbg = json.loads(http_get(pair.base + "/debug")[2])
        all_ok(got, "image/png", "25a")
        same_pngs(plain, got, "25a mesh vs unsharded")
        gran = st["launches_by_layout"].get("granule", [])
        waves = st["waves_by_layout"].get("granule", 0)
        occ = sample(f1, "gsky_mesh_chip_occupancy_count",
                     family="gsky_mesh_chip_occupancy") \
            - sample(f0, "gsky_mesh_chip_occupancy_count",
                     family="gsky_mesh_chip_occupancy")
        mw = sample(f1, "gsky_mesh_waves_total", (("layout", "granule"),)) \
            - sample(f0, "gsky_mesh_waves_total", (("layout", "granule"),))
        if len(gran) != MESH_MEMBERS or min(gran) < 1 \
                or n["B1"] != sum(gran) or n["B2"] or n["B3"] or n["B4"] \
                or set(st["waves_by_layout"]) != {"granule"} \
                or st["entries_by_layout"]["granule"] != MESH_TILES \
                or mw != waves or occ != MESH_MEMBERS * waves \
                or sample(f1, "gsky_mesh_chips") != MESH_MEMBERS:
            raise AssertionError(f"25a: launches {n}, mesh {st}, /metrics "
                                 f"{family_line(f1)}")
        out["B1"] += n["B1"]
        log(f"phase 25a: {MESH_TILES} native bilinear tiles from "
            f"{MESH_THREADS} threads over HTTP with GSKY_MESH=1: decoded "
            f"tiles equal the unsharded waves'; {waves} granule waves, B1 "
            f"launches {n['B1']} ({gran} a member); /metrics "
            f"gsky_mesh_waves_total{{granule}} +{mw:g}, "
            f"gsky_mesh_chip_occupancy count +{occ:g}, gsky_mesh_chips "
            f"{sample(f1, 'gsky_mesh_chips'):g}; {MESH_TILES / wall:.1f} "
            f"tiles/s against {MESH_TILES / plain_wall:.1f} unsharded")
        mesh_line("25a", st, wall, plain_wall, card)

        # -- 25e: /debug's blocks and the prewarm's mesh lattice ---------
        virtual = mesh_words().startswith("virtual")
        if not (dbg["spmd"]["virtual"] is virtual
                and dbg["spmd"]["chips"] == MESH_MEMBERS
                and dbg["mesh"]["virtual"] is virtual
                and dbg["mesh"]["chips"] == MESH_MEMBERS):
            raise AssertionError(f"25e: /debug spmd {dbg['spmd']}, mesh "
                                 f"{dbg['mesh']}")
        saved = read_counts(launches)
        with MeshOn(GSKY_MESH="1"):
            pw = prewarm(pair.watcher.configs, srv.executor)
            pst = mdisp.active_mesh().stats()
        for k, v in saved.items():
            launches[k].launches = v
        if pw["mesh_programs"] < 2 or pw["failures"]:
            raise AssertionError(f"25e: prewarm {pw}")
        log(f"phase 25e: /debug spmd {dbg['spmd']}; mesh chips "
            f"{dbg['mesh']['chips']}, virtual {dbg['mesh']['virtual']}, "
            f"devices {dbg['mesh']['devices']}; prewarm with GSKY_MESH=1: "
            f"{pw} (member bodies {pst['member_dispatches']}) ({card})")

        # -- 25a: per-member page pools ---------------------------------
        jpath = os.path.join(ROOT, "build", "smoke_mesh_journal.jsonl")
        if os.path.exists(jpath):
            os.remove(jpath)
        own0 = srv.executor.pool.stats()["staged"]
        with WavesOn(), MeshOn(GSKY_MESH="1", GSKY_MESH_PLACE="1",
                               GSKY_POOL_JOURNAL=jpath):
            reset_counts(launches)
            placed, pwall = fetch_threads(http_get, urls, MESH_THREADS)
            n = read_counts(launches)
            mp = mpools.active_mesh_pools()
            staged = [p.stats()["staged"] for p in mp.pools]
            resident = [p.stats()["resident"] for p in mp.pools]
            _, tags = journal.replay_chips()
            by_chip = Counter(tags.values())
            c = int(np.argmax(resident))
            mp.teardown_chip(c)
            torn = mp.pools[c].stats()["resident"]
            restored = mp.rehydrate_all()
            back = [p.stats()["resident"] for p in mp.pools]
            pst = mdisp.active_mesh().stats()
        all_ok(placed, "image/png", "25a placed")
        same_pngs(plain, placed, "25a placed vs unsharded")
        if srv.executor.pool.stats()["staged"] != own0 or not sum(staged) \
                or [by_chip[i] for i in range(MESH_MEMBERS)] != staged \
                or torn or restored != {c: resident[c]} or back != resident:
            raise AssertionError(
                f"25a placement: own pool staged {own0} -> "
                f"{srv.executor.pool.stats()['staged']}, member pools "
                f"staged {staged}, resident {resident}, journal tags "
                f"{dict(by_chip)}, torn {torn}, restored {restored}, "
                f"back {back}")
        out["B1"] += n["B1"]
        log(f"phase 25a GSKY_MESH_PLACE=1: decoded tiles equal; pages "
            f"staged per member pool {staged} (the executor's own pool "
            f"none), journal stage lines tagged per member "
            f"{[by_chip[i] for i in range(MESH_MEMBERS)]}; member {c}'s "
            f"pool torn down ({resident[c]} pages) and rehydrate_all "
            f"restored {restored}, every pool as before; B1 {n['B1']}")
        mesh_line("25a placed", pst, pwall, plain_wall, card)

        # -- 25b: the x layout ------------------------------------------
        box = wcs_box(WCS_SIZE, MESH_WCS_ZOOM, 551000.0, 6149000.0)
        url = wcs_url(pair.base, "landsat", box, WCS_SIZE, "cubic")
        blocks = ((WCS_SIZE + WCS_TILE - 1) // WCS_TILE) ** 2
        with WavesOn():
            reset_counts(launches)
            status, _, body, plain_s = http_fetch(url)
            n0 = read_counts(launches)
            legs = dict(srv.last_export)
        if status != 200 or legs["paged_engaged"] != blocks or n0["B2"]:
            raise AssertionError(f"25b unsharded: {status}, launches {n0}, "
                                 f"legs {legs}")
        ref = tiff_values(body)
        with WavesOn(), MeshOn(GSKY_MESH="1", GSKY_MESH_RULES=MESH_X_RULE):
            reset_counts(launches)
            status, _, body, secs = http_fetch(url)
            n = read_counts(launches)
            st = mdisp.active_mesh().stats()
        if status != 200:
            raise AssertionError(f"25b: {status} {body[:300]}")
        err = same_coverage("cubic", ref, tiff_values(body), "25b")
        if n["B1"] or n["B2"] != blocks * MESH_MEMBERS \
                or set(st["waves_by_layout"]) != {"x"} \
                or st["entries_by_layout"]["x"] != blocks:
            raise AssertionError(f"25b: launches {n}, mesh {st}")
        out["B2"] += n["B2"]
        log(f"phase 25b: a {WCS_SIZE}^2 cubic GetCoverage at "
            f"{1 / MESH_WCS_ZOOM:g}x the native ground resolution, its "
            f"{blocks} blocks of {WCS_TILE}^2 sent to x by GSKY_MESH_RULES="
            f"{MESH_X_RULE!r}: B2 {n['B2']} = {blocks} blocks x "
            f"{MESH_MEMBERS} members, B1 0 (unsharded: B1 {n0['B1']} in "
            f"waves); values within 2 ulp of the unsharded export (max "
            f"|diff| {err:.3g}); {secs:.3f} s against {plain_s:.3f} s")
        mesh_line("25b", st, secs, plain_s, card)

        # -- 25d: a fused GetMap through render_byte_spmd ----------------
        few = urls[:MESH_SPMD_TILES]
        os.environ["GSKY_PAGE_SLOTS"] = "1"     # per call through B2
        try:
            t0 = time.perf_counter()
            one = [http_get(u) for u in few]
            one_s = time.perf_counter() - t0
        finally:
            del os.environ["GSKY_PAGE_SLOTS"]
        routes0 = dict(srv.executor.route_counts)
        with MeshOn(GSKY_SPMD="1"):
            reset_counts(launches)
            t0 = time.perf_counter()
            spmd = [http_get(u) for u in few]
            spmd_s = time.perf_counter() - t0
            n = read_counts(launches)
            md = mdisp.active_mesh()
            spmd_line("25d GetMap", md, spmd_s, one_s, card)
        all_ok(one + spmd, "image/png", "25d GetMap")
        same_pngs(one, spmd, "25d GetMap vs the single-device B2 leg")
        routes = sum(v - routes0.get(k, 0)
                     for k, v in srv.executor.route_counts.items()
                     if k.startswith("render_byte_spmd:"))
        if n["B2"] != MESH_SPMD_TILES * MESH_MEMBERS or n["B1"] \
                or routes != MESH_SPMD_TILES:
            raise AssertionError(f"25d GetMap: launches {n}, routes "
                                 f"{routes}")
        out["B2"] += n["B2"]
        log(f"phase 25d: {MESH_SPMD_TILES} fused GetMap tiles with "
            f"GSKY_SPMD=1 through render_byte_spmd ({routes} routed): B2 "
            f"{n['B2']} ({MESH_MEMBERS} a tile), decoded tiles equal the "
            f"single-device B2 leg's")
    finally:
        pair.close()
        shutil.rmtree(conf, ignore_errors=True)
    return out


def phase_mesh_drills(pipe, req, root, store, card):
    """Phase 25c and 25d's drills over phase 7's resident stack: four
    concurrent warm drills in one wave over the time layout (one B3
    K-block launch a member, results equal the per-call ones), a drill
    through GSKY_SPMD's sharded reduction (B3 a member, psum), and a WPS
    drill over HTTP with GSKY_SPMD=1 (200, the per-call CSV).  Returns
    the B3 launches {"B3": per-member blocks, "B3K": K-block}."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from xml.etree import ElementTree
    from gsky_tpu_torch.mesh import dispatch as mdisp
    from gsky_tpu_torch.ops import stats
    from gsky_tpu_torch.pipeline.waves import WaveScheduler
    t0 = time.perf_counter()
    ref = pipe.process(req)                 # per call: GSKY_WAVES=0
    one_s = time.perf_counter() - t0

    def round_of(n):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n) as ex:
            res = list(ex.map(lambda _: pipe.process(req), range(n)))
        return res, time.perf_counter() - t0

    barrier = threading.Barrier(WAVE_DRILLS)
    submit = WaveScheduler.drill_stats

    def together(self, *a):
        barrier.wait(timeout=300)
        return submit(self, *a)

    WaveScheduler.drill_stats = together
    try:
        with WavesOn():
            plain, plain_s = round_of(WAVE_DRILLS)
        barrier.reset()
        with WavesOn(), MeshOn(GSKY_MESH="1"):
            stats.masked_stats_kernel.launches = 0
            stats.masked_stats_many_kernel.launches = 0
            got, wall = round_of(WAVE_DRILLS)
            k = (stats.masked_stats_many_kernel.launches,
                 stats.masked_stats_kernel.launches)
            st = mdisp.active_mesh().stats()
    finally:
        WaveScheduler.drill_stats = submit
    for r in plain + got:
        same_drill(ref, r, "25c vs per call", rtol=0.0)
    if k != (MESH_MEMBERS, 0) or st["waves_by_layout"] != {"time": 1} \
            or st["launches_by_layout"] != {"time": [1] * MESH_MEMBERS}:
        raise AssertionError(f"25c: K-block / per-call B3 {k}, mesh {st}")
    log(f"phase 25c: {WAVE_DRILLS} concurrent warm drills ({DRILL_T} x "
        f"{DRILL_HW}^2) in one wave over the time layout: B3 K-block "
        f"launches {k[0]} (one a member, a block each), per-call B3 0, "
        f"results equal per call and the unsharded wave's")
    mesh_line("25c", st, wall, plain_s, card)
    b3 = {"B3": 0, "B3K": k[0]}

    # -- 25d: the drill with GSKY_SPMD=1 --------------------------------
    with MeshOn(GSKY_SPMD="1"):
        stats.masked_stats_kernel.launches = 0
        t0 = time.perf_counter()
        r = pipe.process(req)
        spmd_s = time.perf_counter() - t0
        n = stats.masked_stats_kernel.launches
        md = mdisp.active_mesh()
        spmd_line("25d drill", md, spmd_s, one_s, card)
    worst = same_drill(ref, r, "25d drill with GSKY_SPMD=1", rtol=1e-5)
    if n != MESH_MEMBERS:
        raise AssertionError(f"25d drill: B3 {n}, want {MESH_MEMBERS}")
    b3["B3"] += n
    log(f"phase 25d: a warm drill with GSKY_SPMD=1: B3 {n} (a (bands / 2, "
        f"pixels / 2) block a member, psum over x), counts equal per "
        f"call, means within rel {worst:.3g}")

    # -- 25d: WPS over HTTP, 200 where the port answered 501 -------------
    os.environ["GSKY_DRILL_CACHE"] = "sync"
    httpd, url, body, _ = wps_server(root, store, "wps_mesh_conf")
    try:
        http_fetch(url, body)               # the stack's upload: set-up
        st0, _, plain_out, plain_s = http_fetch(url, body)
        with MeshOn(GSKY_SPMD="1"):
            stats.masked_stats_kernel.launches = 0
            st1, _, out, wps_s = http_fetch(url, body)
            n = stats.masked_stats_kernel.launches
    finally:
        del os.environ["GSKY_DRILL_CACHE"]
        httpd.shutdown()
        httpd.server_close()
    ns = {"wps": "http://www.opengis.net/wps/1.0.0"}

    def rows(doc):
        text = [el.text for el in ElementTree.fromstring(doc).iterfind(
            ".//wps:ComplexData", ns)]
        return [ln.split(",") for t in text for ln in t.splitlines()]

    a, b = rows(plain_out), rows(out)
    same = len(a) == len(b) == DRILL_T and all(
        x[0] == y[0] and all((p == q) or abs(float(p) - float(q))
                             <= 1e-4 + 1e-5 * abs(float(p))
                             for p, q in zip(x[1:], y[1:]))
        for x, y in zip(a, b))
    if (st0, st1) != (200, 200) or n != MESH_MEMBERS or not same:
        raise AssertionError(f"25d WPS: statuses {st0} {st1}, B3 {n}, CSV "
                             f"rows equal {same}")
    b3["B3"] += n
    log(f"phase 25d: WPS Execute over HTTP with GSKY_SPMD=1: 200 (the "
        f"port answered 501 before), B3 {n}, its {DRILL_T}-row CSV equal "
        f"to the per-call one within the CSV's 4 decimals; {wps_s:.3f} s "
        f"against {plain_s:.3f} s per call ({card})")
    return b3


def phase_mesh_mosaic(root, store, card):
    """Phase 25d's mosaic over phase 10's archive (config 3's eight
    dates, no mask band): `process` through scene_mosaic_spmd (B2 on
    every member), canvases equal to the single-device B2 leg's.
    Returns the B2 launches."""
    from gsky_tpu_torch.mesh import dispatch as mdisp
    from gsky_tpu_torch.ops import warp_render
    pipe = make_pipeline(store, "cuda")
    reqs = [mosaic_request(root, box, [NS], "bilinear", None)
            for box in mosaic_boxes()[:MESH_MOSAIC_TILES]]
    pipe.process(reqs[0])                       # scenes cached: set-up
    os.environ["GSKY_PAGE_SLOTS"] = "1"         # per call through B2
    try:
        t0 = time.perf_counter()
        one = [pipe.process(r) for r in reqs]
        one_s = time.perf_counter() - t0
    finally:
        del os.environ["GSKY_PAGE_SLOTS"]
    with MeshOn(GSKY_SPMD="1"):
        warp_render.warp_render_kernel.launches = 0
        t0 = time.perf_counter()
        got = [pipe.process(r) for r in reqs]
        wall = time.perf_counter() - t0
        n = warp_render.warp_render_kernel.launches
        spmd_line("25d mosaic", mdisp.active_mesh(), wall, one_s, card)
    for a, b in zip(one, got):
        for ns in a.namespaces:
            if not (torch_equal(a.valid[ns], b.valid[ns])
                    and torch_equal(a.data[ns], b.data[ns])):
                raise AssertionError(f"25d mosaic: {ns} differs from the "
                                     f"single-device B2 leg")
    routes = sum(v for k, v in pipe.executor.route_counts.items()
                 if k.startswith("scene_mosaic_spmd:"))
    if n != MESH_MOSAIC_TILES * MESH_MEMBERS or routes != MESH_MOSAIC_TILES:
        raise AssertionError(f"25d mosaic: B2 {n}, routed {routes}")
    log(f"phase 25d: {MESH_MOSAIC_TILES} mosaics of {MOSAIC_DATES} dates "
        f"through scene_mosaic_spmd: B2 {n} ({MESH_MEMBERS} a mosaic), "
        f"canvases and validity equal the single-device B2 leg's")
    return n


# -- phase 26: the output tiles of B1 and B2 ---------------------------

SWEEP_REPS = 21             # timed launches a tile and point; the median
SWEEP_SPIN = 1_000_000      # card clock cycles spun before a timed launch
TILE_SLACK = 1.05           # the planned tile's time over the default's
SWEEP_WAVE = 10             # lanes of 26a's wave
WCS_ORIGIN = (551000.0, 6149000.0)   # 15b's 1024^2 tiles start here


def event_ms(fn, reps=SWEEP_REPS):
    """Median device ms of one call of ``fn`` over ``reps`` calls: CUDA
    events around each call, each call queued behind a spin of the card
    (`torch.cuda._sleep`), so that the events take the launch's device
    time and none of the host's enqueue (warm L2: the same inputs)."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        torch.cuda._sleep(SWEEP_SPIN)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def b1_lane(pipe, root, box, px=256):
    """One B1 lane as the fused route builds it for the ``px``-px tile
    ``box``: host tables (T, S), host params (T, 16), sx and sy (h, w) on
    the card.  The tile must take the paged leg."""
    from gsky_tpu_torch.ops.paged import page_slots
    from gsky_tpu_torch.ops.warp import _bilerp_grid
    ex = pipe.executor
    group = tile_group(pipe, root, box, px)
    if ex.page_spans(group, page_slots()) is None:
        raise AssertionError(f"26a: the {px}^2 tile {box} declines")
    tables, p16, _ = ex._paged_from_group(group, 1)
    ex.pool.unpin(tables)
    sx, sy = _bilerp_grid(group.ctrl_dev[:, None], px, px, group.step)
    return tables, p16, sx[0].contiguous(), sy[0].contiguous()


def stack_lanes(lanes, dev):
    """B1's wave operands over ``lanes`` (`b1_lane`): tables (N, T, S) and
    params (N*T, 16), the lanes padded to the most granules (namespace -1
    rows over the null page) and slots (the null page), sx and sy (N, h,
    w)."""
    import torch
    from gsky_tpu_torch.ops.paged import PARAMS_W
    T = max(t.shape[0] for t, _, _, _ in lanes)
    S = max(t.shape[1] for t, _, _, _ in lanes)
    tables = np.zeros((len(lanes), T, S), np.int32)
    params = np.zeros((len(lanes), T, PARAMS_W), np.float32)
    params[:, :, 10] = -1.0
    for n, (t, p, _, _) in enumerate(lanes):
        tables[n, :t.shape[0], :t.shape[1]] = t
        params[n, :p.shape[0]] = p
    return (torch.from_numpy(tables).to(dev),
            torch.from_numpy(params.reshape(-1, PARAMS_W)).to(dev),
            torch.stack([sx for _, _, sx, _ in lanes]).contiguous(),
            torch.stack([sy for _, _, _, sy in lanes]).contiguous())


def sweep_points(pipe, root):
    """26a's points: phase 3's 256^2 tile (its granules, and its first
    alone) per method; a bilinear wave of `SWEEP_WAVE` of phase 3's tiles
    without and with ``sb_of`` (the table's rows reversed); 15b's 1024^2
    tile at 0.25x (paged), bilinear and cubic (B1); B2's input (c) (a 4x
    tile) per method and 15b's native 1024^2 tile, bilinear and cubic.
    Returns [(kernel, name, method, operands)]."""
    import torch
    dev = pipe.executor.device
    boxes = tile_boxes()
    points = []
    lane = b1_lane(pipe, root, boxes[0])
    for T in sorted({lane[0].shape[0], 1}, reverse=True):
        one = stack_lanes([(lane[0][:T], lane[1][:T], lane[2], lane[3])],
                          dev)
        for m in METHODS:
            points.append(("B1", f"256^2 T{T}", m, one + (None,)))
    wave = stack_lanes([b1_lane(pipe, root, b)
                        for b in boxes[:SWEEP_WAVE]], dev)
    points.append(("B1", f"wave {SWEEP_WAVE}", "bilinear", wave + (None,)))
    rev = torch.arange(SWEEP_WAVE - 1, -1, -1, device=dev)
    points.append(("B1", f"wave {SWEEP_WAVE} sb_of", "bilinear",
                   (wave[0][rev].contiguous(),) + wave[1:]
                   + (rev.to(torch.int32).contiguous(),)))
    wide = stack_lanes([b1_lane(pipe, root,
                                wcs_box(WCS_TILE, 0.25, *WCS_ORIGIN),
                                WCS_TILE)], dev)
    for m in ("bilinear", "cubic"):
        points.append(("B1", f"{WCS_TILE}^2 0.25x", m, wide + (None,)))
    c = b2_operands(pipe, root, zoom_boxes(4.0)[0])
    for m in METHODS:
        points.append(("B2", "(c) 4x", m, c))
    from gsky_tpu_torch.ops.warp import _bilerp_grid, params16
    g = tile_group(pipe, root, wcs_box(WCS_TILE, 1.0, *WCS_ORIGIN),
                   WCS_TILE)
    n = len(g.scenes)
    p16 = params16(torch.from_numpy(g.params[:n].astype(np.float32))
                   .to(dev))
    sx, sy = _bilerp_grid(g.ctrl_dev, WCS_TILE, WCS_TILE, g.step)
    native = ([s.dev for s in g.scenes], p16, sx.contiguous(),
              sy.contiguous())
    for m in ("bilinear", "cubic"):
        points.append(("B2", f"{WCS_TILE}^2 native", m, native))
    return points


def b1_launch(pool, tables, params, sx, sy, method, sb_of, blk):
    """A launch of kernel B1 at one namespace as `paged_render_scored`
    makes it, on outputs allocated once and without the wrapper's checks
    (its ``sb_of`` range check reads back from the card): what 26a
    times."""
    import torch
    from gsky_tpu_torch.ops import paged, warp_render
    N, h, w = sx.shape
    _, T, S = tables.shape
    rows, cols = warp_render.check_tile(blk)
    canv = torch.empty((N, 1, h, w), dtype=torch.float32, device=pool.device)
    best = torch.empty_like(canv)
    args = (warp_render.method_code(method), 1, pool.data_ptr(),
            tables.data_ptr(), params.data_ptr(), sx.data_ptr(),
            sy.data_ptr(), canv.data_ptr(), best.data_ptr(), N, T, S,
            pool.shape[1], pool.shape[2], h, w, paged.STAGE_BUDGET,
            paged._direct_counter(pool.device).data_ptr(),
            None if sb_of is None else sb_of.data_ptr(), rows, cols)
    return lambda: paged.paged_render_kernel(pool.device, *args)


def sweep_b1(pool, ops, method, tiles):
    """B1 at every tile of ``tiles`` (the default first) over one point's
    operands: canv and best bit-identical to the default tile's launch and
    to the plain version, the blocks read from the pool directly equal
    `block_boxes`' prediction.  Returns {tile: (ms, direct blocks)}."""
    from gsky_tpu_torch.ops import paged
    tables, params, sx, sy, sb_of = ops
    cp, bp = paged.paged_render_scored_plain(pool, tables, params, sx, sy,
                                             method, 1, sb_of)
    out = {}
    for tile in tiles:
        blk = None if tile == paged.BLOCK else tile
        paged.reset_direct_blocks(pool.device)
        ck, bk = paged.paged_render_scored(pool, tables, params, sx, sy,
                                           method, 1, sb_of, blk)
        direct = paged.direct_blocks(pool.device)
        want = predicted_direct_blocks(sx, sy, params, method, tile)
        if direct != want:
            raise AssertionError(f"26a B1 {tile}: {direct} direct blocks, "
                                 f"block_boxes predicts {want}")
        check_exact(f"26a B1 {method} {tile} vs plain", ck, bk, cp, bp)
        ms = event_ms(b1_launch(pool, tables, params, sx, sy, method, sb_of,
                                blk))
        out[tile] = (ms, direct)
    return out


def sweep_b2(ops, method, tiles):
    """B2 at every tile of ``tiles`` over one point's operands, bit-
    identical to its plain version (and so to the default tile's).
    Returns {tile: (ms, 0)}."""
    from gsky_tpu_torch.ops import warp_render
    scenes, p16, sx, sy = ops
    cp, bp = warp_render.warp_render_scored_plain(scenes, sx, sy, p16,
                                                  method, 1)
    out = {}
    for tile in tiles:
        blk = None if tile == warp_render.DEFAULT_TILE else tile
        ck, bk = warp_render.warp_render_scored(scenes, sx, sy, p16, method,
                                                1, blk)
        check_exact(f"26a B2 {method} {tile} vs plain", ck, bk, cp, bp)
        out[tile] = (event_ms(lambda: warp_render.warp_render_scored(
            scenes, sx, sy, p16, method, 1, blk)), 0)
    return out


def phase_tile_sweep(pipe, root, card, points=None):
    """Phase 26a: B1 and B2 at every tile of the ladder (`plan_blocks`)
    at `sweep_points`: outputs bit-identical across tiles and to the
    plain versions, B1's direct blocks as `block_boxes` predicts, each
    tile's median device ms (`event_ms`), and the tile `plan_block`
    picks, whose time must be at most `TILE_SLACK` x the default's.
    The launch counts are left as they were (comparisons, not the main
    path).  Returns a row per point and tile (for a fit of the model)."""
    from gsky_tpu_torch.ops import paged, warp_render
    from gsky_tpu_torch.pipeline import autoplan
    saved = (paged.paged_render_kernel.launches,
             warp_render.warp_render_kernel.launches)
    default = warp_render.DEFAULT_TILE
    tiles = [default] + [t for t in autoplan.plan_blocks() if t != default]
    pool = pipe.executor.pool
    pr, pc = pool.page_rows, pool.page_cols
    rows = []
    for kernel, name, method, ops in points or sweep_points(pipe, root):
        if kernel == "B1":
            tables, params, sx, sy, _ = ops
            N, T, S = sx.shape[0], tables.shape[1], tables.shape[2]
            with pool.locked_pool() as parr:
                got = sweep_b1(parr, ops, method, tiles)
            pick = autoplan.plan_block(sx.shape[1], sx.shape[2], 1, method,
                                       T=T, S=S, pr=pr, pc=pc, N=N)
        else:
            scenes, _, sx, _ = ops
            N, T, S = 1, len(scenes), 0
            got = sweep_b2(ops, method, tiles)
            pick = autoplan.plan_block(
                sx.shape[0], sx.shape[1], 1, method, T=T, S=0,
                win=tuple(scenes[0].shape), N=1)
        pick = pick or default
        h, w = sx.shape[-2:]
        for t, (ms, direct) in got.items():
            rows.append({"kernel": kernel, "point": name, "method": method,
                         "h": h, "w": w, "N": N, "T": T, "S": S,
                         "tile": list(t), "ms": ms, "direct": direct,
                         "picked": t == pick})
        log(f"26a {kernel} {name} {method} (N {N}, T {T}): " + ", ".join(
            f"{r}x{c} {ms:.5f}{'*' if (r, c) == pick else ''}"
            for (r, c), (ms, _) in got.items())
            + f" ms; direct blocks {[d for _, d in got.values()]}; "
            f"plan_block {pick[0]}x{pick[1]} ({card})")
        if got[pick][0] > TILE_SLACK * got[default][0]:
            raise AssertionError(
                f"26a {kernel} {name} {method}: the planned tile "
                f"{pick} takes {got[pick][0]:.5f} ms, the default "
                f"{got[default][0]:.5f}")
    paged.paged_render_kernel.launches, \
        warp_render.warp_render_kernel.launches = saved
    return rows


# 26b-c: with a ladder without the default, every point plans a tile
NO_DEFAULT_LADDER = "4x32,2x64"


class CaptureB2:
    """Keeps every B2 call's output tile (``blks``: None for the
    default) while installed."""

    def __init__(self):
        from gsky_tpu_torch.ops import warp_render
        self.mod = warp_render
        self.orig = warp_render.warp_render_scored
        self.blks = []
        warp_render.warp_render_scored = self._call

    def _call(self, scenes, sx, sy, params, method, n_ns, blk=None):
        self.blks.append(blk)
        return self.orig(scenes, sx, sy, params, method, n_ns, blk)

    def remove(self):
        self.mod.warp_render_scored = self.orig


def tile_names(blks):
    """Launches by tile name ("8x32" for the default): a Counter."""
    from gsky_tpu_torch.ops.warp_render import DEFAULT_TILE
    return Counter("%dx%d" % tuple(b or DEFAULT_TILE) for b in blks)


def block_shape_gains(before):
    """`gsky_plan_block_shape`'s samples by tile since ``before`` (a
    Counter of them, or None for the samples themselves)."""
    from gsky_tpu_torch.obs.metrics import PLAN_BLOCK_SHAPE
    now = Counter({dict(lab)["shape"]: v
                   for _, lab, v in PLAN_BLOCK_SHAPE.samples()})
    if before is None:
        return now
    return Counter({k: int(now[k] - before[k]) for k in now
                    if now[k] != before[k]})


class PlanEnv:
    """GSKY_PLAN and GSKY_PLAN_BLOCKS set (None: unset) inside the block,
    and restored after it; the planner's memo and counters reset."""

    def __init__(self, plan, ladder):
        self.want = {"GSKY_PLAN": plan, "GSKY_PLAN_BLOCKS": ladder}

    def __enter__(self):
        from gsky_tpu_torch.pipeline import autoplan
        self.saved = {k: os.environ.get(k) for k in self.want}
        for k, v in self.want.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autoplan.reset_plan_state()

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_tile_waves(pipe, root, boxes, card):
    """Phase 26b: phase 13's tiles per method from `WAVE_THREADS` threads
    in waves, with GSKY_PLAN=1 and =0, over the default ladder and over
    `NO_DEFAULT_LADDER` (every wave then takes a planned tile): the PNG
    bytes of each tile equal across the two; with planning on, the
    gains of ``gsky_plan_block_shape`` by tile equal B1's launches at
    that tile (8x32 where none is planned), with it off none.  Returns
    the B1 launches."""
    from gsky_tpu_torch.io.png import encode_png
    from gsky_tpu_torch.ops import paged
    total = 0
    for ladder in (None, NO_DEFAULT_LADDER):
        for method in METHODS:
            pngs = {}
            for plan in ("1", "0"):
                with PlanEnv(plan, ladder), WavesOn():
                    before = block_shape_gains(None)
                    cap = CaptureB1()
                    n0 = paged.paged_render_kernel.launches
                    try:
                        tiles, _, wall = render_threads(
                            pipe, root, boxes, method, WAVE_THREADS)
                    finally:
                        cap.remove()
                    total += paged.paged_render_kernel.launches - n0
                    gains = block_shape_gains(before)
                launched = tile_names(cap.blks)
                want = launched if plan == "1" else Counter()
                if gains != want or not cap.blks:
                    raise AssertionError(
                        f"26b {method} GSKY_PLAN={plan} ladder {ladder}: "
                        f"gsky_plan_block_shape gained {dict(gains)}, B1 "
                        f"launched {dict(launched)}")
                pngs[plan] = [encode_png([t]) for t in tiles]
                log(f"26b {method} GSKY_PLAN={plan} ladder "
                    f"{ladder or 'default'}: {len(boxes)} tiles in "
                    f"{len(cap.blks)} B1 launches by tile "
                    f"{dict(launched)}, {len(boxes) / wall:.1f} tiles/s "
                    f"({card})")
            if pngs["1"] != pngs["0"]:
                raise AssertionError(f"26b {method} ladder {ladder}: PNG "
                                     f"bytes differ with planning on")
    return total


def phase_tile_prewarm(pipe, root, store, card):
    """Phase 26c: `server.prewarm.prewarm` over a config of phase 12a's
    landsat layer (near, bilinear and cubic styles) on the card's
    executor, waves on, over the default ladder and over
    `NO_DEFAULT_LADDER`: every lattice point whose tile `plan_block`
    plans (B1 per method, tile edge and wave size; B2 per method and
    tile edge) launched once more at that tile, and the launches at a
    planned tile equal prewarm's ``blocks``.  Returns the B1 and B2
    launches."""
    from gsky_tpu_torch.index.client import MASClient
    from gsky_tpu_torch.ops import paged, warp_render
    from gsky_tpu_torch.pipeline.autoplan import plan_block
    from gsky_tpu_torch.server import prewarm as pw
    from gsky_tpu_torch.server.config import ConfigWatcher
    conf = os.path.join(root, "conf26")
    os.makedirs(conf, exist_ok=True)
    styles = [{"name": m, "title": m, "rgb_products": [NS], "resample": m}
              for m in METHODS]
    with open(os.path.join(conf, "config.json"), "w") as fp:
        json.dump({"service_config": {"mas_address": "in-process"},
                   "layers": [{"name": "landsat", "data_source": root,
                               "rgb_products": [NS], "styles": styles}]},
                  fp)
    client = MASClient(store)
    watcher = ConfigWatcher(conf, lambda a: client, install_signal=False)
    ex = pipe.executor
    pool = ex.pool
    launches = Counter()
    for ladder in (None, NO_DEFAULT_LADDER):
        with PlanEnv("1", ladder), WavesOn():
            specs = pw.layer_specs(watcher.configs)
            sizes = pw._env_list("GSKY_PREWARM_SIZES", "256")
            bucket = int(os.environ.get("GSKY_PREWARM_BUCKET", 512))
            want = Counter()
            for method, _n, _a, _c in specs:
                for hw in sizes:
                    plans = [plan_block(hw, hw, 1, method, T=1, S=0,
                                        win=(bucket, bucket))]
                    plans += [plan_block(hw, hw, 1, method, T=1, S=1,
                                         pr=pool.page_rows,
                                         pc=pool.page_cols, N=W)
                              for W in pw.wave_size_lattice()]
                    want.update(tile_names(b for b in plans if b))
            c1, c2 = CaptureB1(), CaptureB2()
            n1 = paged.paged_render_kernel.launches
            n2 = warp_render.warp_render_kernel.launches
            try:
                out = pw.prewarm(watcher.configs, ex)
            finally:
                c1.remove()
                c2.remove()
            launches["B1"] += paged.paged_render_kernel.launches - n1
            launches["B2"] += warp_render.warp_render_kernel.launches - n2
        got = tile_names(b for b in c1.blks + c2.blks if b is not None)
        if out["failures"] or got != want or dict(got) != out["blocks"]:
            raise AssertionError(
                f"26c ladder {ladder}: planned launches {dict(got)}, "
                f"lattice plans {dict(want)}, prewarm {out}")
        log(f"26c ladder {ladder or 'default'}: prewarm {out['programs']} "
            f"launches, planned tiles {out['blocks']} each launched once "
            f"at its lattice point ({out['seconds']} s; {card})")
    return launches


def phase_adapter(root, card, device="cuda"):
    """Phase 26d: the registry's PIL adapter.  Where PIL imports with
    JPEG 2000: a lossless 8-bit JP2 (1024^2, seeded) beside an ESRI world
    file (.j2w, 0.0001 degree pixels; a PNG and a .pgw where PIL has no
    JPEG 2000 codec) and a GeoTIFF of the same pixels and geotransform
    (EPSG:4326), each crawled into a MAS store and rendered as a
    bilinear 256^2 EPSG:3857 tile through `TilePipeline(device="cuda")`,
    one B1 launch each: the image's tile byte-equal to the GeoTIFF's.
    Where PIL does not import: the crawler's record of a JP2 names the
    ImportError.  Returns the B1 launches."""
    from gsky_tpu_torch.geo.crs import EPSG4326, parse_crs
    from gsky_tpu_torch.geo.transform import BBox, GeoTransform, \
        transform_bbox
    from gsky_tpu_torch.index.crawler import extract
    from gsky_tpu_torch.io.geotiff import write_geotiff
    from gsky_tpu_torch.ops import paged
    from gsky_tpu_torch.pipeline.types import GeoTileRequest
    adir = os.path.join(root, "adapter26")
    os.makedirs(adir, exist_ok=True)
    rng = np.random.default_rng(26)
    yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float32)
    data = (120 + 60 * np.sin(xx / 37.0) * np.cos(yy / 53.0)
            + rng.normal(0, 8, (1024, 1024))).clip(1, 255).astype(np.uint8)
    try:
        from PIL import Image, features
    except ImportError:
        Image = None
    jp2 = Image is not None and features.check("jpg_2000")
    img = os.path.join(adir, "S2_B04_20200110" + (".jp2" if jp2 or
                                                  Image is None else ".png"))
    if Image is None:
        with open(img, "wb") as fp:
            fp.write(b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(64))
        rec = extract(img)
        if "No module named 'PIL'" not in rec.get("error", ""):
            raise AssertionError(f"26d: the record without PIL: {rec}")
        log(f"26d: PIL does not import here; the crawler's record of a "
            f"JP2 names the ImportError: {rec['error']!r}")
        return 0
    if jp2:
        Image.fromarray(data, "L").save(img, "JPEG2000", irreversible=False)
    else:
        Image.fromarray(data, "L").save(img, "PNG")
    with open(img[:-4] + (".j2w" if jp2 else ".pgw"), "w") as fp:
        fp.write("0.0001\n0.0\n0.0\n-0.0001\n148.00005\n-35.00005\n")
    tif = os.path.join(adir, "S2_B04_20200110.tif")
    write_geotiff(tif, data, GeoTransform(148.0, 0.0001, 0.0, -35.0, 0.0,
                                          -0.0001), EPSG4326,
                  compress=False)
    merc = parse_crs("EPSG:3857")
    # ~1 source pixel a pixel: the windows fit the page slots (B1)
    box = transform_bbox(BBox(148.02, -35.045, 148.045, -35.02), EPSG4326,
                         merc)
    tiles = {}
    n0 = paged.paged_render_kernel.launches
    for path in (img, tif):
        rec = extract(path)
        if rec.get("error"):
            raise AssertionError(f"26d: {path}: {rec['error']}")
        store = crawl([(path, "S2_B04")])
        pipe = make_pipeline(store, device)
        req = GeoTileRequest(collection=adir, bands=["S2_B04"],
                             bbox=box, crs=merc, width=256, height=256,
                             resample="bilinear")
        out = pipe.render_composite_byte(req)
        tiles[path] = out if isinstance(out, np.ndarray) \
            else out.cpu().numpy()
    b1 = paged.paged_render_kernel.launches - n0
    same = np.array_equal(tiles[img], tiles[tif])
    if b1 != 2 or not same or not tiles[img].any():
        raise AssertionError(f"26d: B1 {b1} (want 2), tiles equal {same}")
    import PIL
    what = "a lossless JP2 with a .j2w" if jp2 \
        else "no JPEG 2000 codec: a PNG with a .pgw"
    log(f"26d: PIL {PIL.__version__}, {what} crawled through the adapter, "
        f"its 256^2 bilinear tile through B1 byte-equal to the GeoTIFF's "
        f"of the same pixels ({card})")
    return b1


def phase_tiles(pipe, root, store, card):
    """Phase 26: 26a `phase_tile_sweep`, 26b `phase_tile_waves`, 26c
    `phase_tile_prewarm`, 26d `phase_adapter`.  Returns the launches of
    26b-d ({"B1": n, "B2": n})."""
    t0 = time.perf_counter()
    phase_tile_sweep(pipe, root, card)
    log(f"phase 26a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    b1 = phase_tile_waves(pipe, root, tile_boxes(), card)
    log(f"phase 26b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pre = phase_tile_prewarm(pipe, root, store, card)
    log(f"phase 26c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    b1 += phase_adapter(root, card, pipe.executor.device)
    log(f"phase 26d: {time.perf_counter() - t0:.1f} s")
    return {"B1": b1 + pre["B1"], "B2": pre["B2"]}


def phase_26_alone(card):
    """``--phase 26``: phase 3's archive written and crawled, then phase
    26 alone (after phase 1); no result line."""
    os.environ.update(GSKY_WAVES="0", GSKY_TILE_PIPELINE="0",
                      GSKY_PREFETCH="0")
    root = os.path.join(ROOT, "build", "smoke_archive")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        store = crawl((p, NS) for p in write_archive(root))
        pipe = make_pipeline(store, "cuda")
        render(pipe, root, tile_boxes()[:1], "near")
        t0 = time.perf_counter()
        log(f"phase 26: launches {phase_tiles(pipe, root, store, card)} "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


# -- phase 27: the soak's churn on the card -----------------------------

SOAK_SCENES = 12             # 27: dates, one Landsat 8 scene each
SOAK_SHAPE = (SCENE_H, SCENE_W)
SOAK_CHURN_S = 30.0          # 27: its first quarter fills the cache
SOAK_CONC = 8                # 27


def soak_tool():
    """``tools/soak_torch.py`` of this checkout."""
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import soak_torch
    return soak_torch


def wait_unpinned(pool, timeout=15.0):
    """The pool's pinned count once it is 0, or when ``timeout`` ends."""
    t_end = time.time() + timeout
    while True:
        pinned = pool.stats()["pinned"]
        if pinned == 0 or time.time() > t_end:
            return pinned
        time.sleep(0.25)


def phase_soak(card):
    """27: `tools/soak_torch.py`'s churn on the card over SOAK_SCENES
    dates of one Landsat 8 scene each (more scene bytes than the scene
    cache holds, so that it evicts), with the default serving path
    (waves and the staged GetMap path), then one lap of its wcs
    scenario.  Both must pass the tool's criteria, card memory
    included; the churn's server ends with no page pinned; the churn's
    first B1 and B2 launch of each method are held against their plain
    versions where they run (`CheckWide`: no launch added, no input
    kept past its request).  Returns (launches by kernel, max |diff|
    by kernel)."""
    import torch
    from gsky_tpu_torch.pipeline.scene_cache import _bucket
    st = soak_tool()
    kernels = _kernel_counts()
    root = os.path.join(ROOT, "build", "smoke_soak")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    env = None
    try:
        t0 = time.perf_counter()
        env = st.SoakEnv(root, SOAK_SCENES, SOAK_SHAPE, "cuda")
        disk = sum(os.path.getsize(p) for p in env.paths)
        scene_b = _bucket(SOAK_SHAPE[0]) * _bucket(SOAK_SHAPE[1]) * 4
        log(f"phase 27: {SOAK_SCENES} scenes of {SOAK_SHAPE[0]} x "
            f"{SOAK_SHAPE[1]} int16, one a date ({disk / 1e9:.3f} GB "
            f"uncompressed) written + crawled in "
            f"{time.perf_counter() - t0:.1f} s; resident as padded f32 "
            f"{scene_b} B a scene, {SOAK_SCENES * scene_b} B for all")
        args = st.parse_args(["--seconds", str(SOAK_CHURN_S),
                              "--conc", str(SOAK_CONC)])
        wcs_args = st.parse_args(["--seconds", "1",
                                  "--conc", str(SOAK_CONC)])
        launches = {}
        # phase 1 built the kernels: no prewarm in the soak's servers,
        # so that the first launches held below are the churn's own
        with st.EnvOverride(GSKY_PREWARM="0"), WavesOn():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            chk = CheckWide((256, 256), what="27")
            plain = PlainCalls()
            reset_counts(kernels)
            t0 = time.perf_counter()
            try:
                churn, churn_ok = st.run_churn(env, args)
                launches["churn"] = read_counts(kernels)
                t_churn = time.perf_counter() - t0
                srv = env.servers[-1]
                pinned = wait_unpinned(srv.executor.pool)
                reset_counts(kernels)
                t0 = time.perf_counter()
                wcs, wcs_ok = st.run_wcs(env, wcs_args)
                launches["wcs"] = read_counts(kernels)
                t_wcs = time.perf_counter() - t0
            finally:
                plain.remove()
                chk.remove()
        log(f"phase 27 churn: {json.dumps(churn)}")
        log(f"phase 27 wcs lap: {json.dumps(wcs)}")
        n = churn["requests_ok"] + churn["requests_failed"]
        dev = churn["memory"]["device"]
        log(f"phase 27: churn {n} GetMaps in {t_churn:.1f} s "
            f"({n / t_churn:.2f} tiles/s) from {SOAK_CONC} threads, "
            f"RSS growth {churn['memory']['rss']['growth_mb']} MB and "
            f"memory_allocated growth {dev['allocated_growth_mb']} MB "
            f"after the first quarter (bounds "
            f"{args.max_rss_growth_mb} / {args.max_device_growth_mb}), "
            f"reserved {dev['reserved_mb']} MB, peak allocated "
            f"{dev['max_allocated_mb']} MB; scene cache "
            f"{churn['scene_cache_bytes']} of "
            f"{churn['scene_cache_max_bytes']} B, evictions "
            f"{churn['scene_cache']['evictions']}; pinned pages {pinned}; "
            f"launches {launches['churn']}; wcs lap "
            f"{wcs['exports_ok']} exports in {t_wcs:.1f} s, launches "
            f"{launches['wcs']} ({card})")
        if not churn_ok or not wcs_ok:
            raise AssertionError(f"27: the soak failed: churn "
                                 f"{churn_ok}, wcs {wcs_ok}")
        if SOAK_SCENES * scene_b <= churn["scene_cache_max_bytes"] or \
                not churn["scene_cache"]["evictions"]:
            raise AssertionError("27: the churn's scenes fit the scene "
                                 "cache: it did not evict")
        if pinned:
            raise AssertionError(f"27: {pinned} pages pinned after the "
                                 f"churn")
        if plain.calls:
            raise AssertionError(f"27: {plain.calls} plain-version calls "
                                 f"on the card")
        errs = {}
        for k in ("B1", "B2"):
            if not launches["churn"][k]:
                raise AssertionError(f"27: the churn launched no {k}: "
                                     f"{launches['churn']}")
            held = [v for (kk, _), v in chk.errs.items() if kk == k]
            if not held:
                raise AssertionError(f"27: no {k} launch held against its "
                                     f"plain version")
            errs[k] = max(held)
        log(f"phase 27: the first B1 and B2 launch of each method against "
            f"their plain versions on the same inputs, max |diff| "
            f"{sorted(chk.errs.items())}")
    finally:
        if env is not None:
            env.close()
        shutil.rmtree(root, ignore_errors=True)
    total = {k: launches["churn"][k] + launches["wcs"][k] for k in kernels}
    return total, errs


def phase_27_alone(card):
    """``--phase 27``: phase 27 alone (after phase 1); no result line."""
    os.environ["GSKY_PREFETCH"] = "0"
    t0 = time.perf_counter()
    launches, errs = phase_soak(card)
    log(f"phase 27: launches {launches}, max |diff| {errs} "
        f"({time.perf_counter() - t0:.1f} s)")
    return 0


# -- phase 28: the soak's overload, ingest and fleet on the card -------

SOAK28_SCENES = 4            # 28: the reference's four products, a date each
SOAK28_S = 10.0              # 28: each scenario's --seconds
SOAK28_CONC = 64             # 28: past the WMS limit of 4, so that it sheds
SOAK28_RUNS = ("overload", "ingest", "fleet")


class SoakArchive:
    """Phases 28 and 29's archive: SOAK28_SCENES Landsat-size dates (the
    reference's four products, a date each) under
    ``build/smoke_soak28``, crawled, with the tool's config; written
    once for both phases, deleted on exit."""

    def __enter__(self):
        from gsky_tpu_torch.pipeline.scene_cache import _bucket
        st = soak_tool()
        self.root = os.path.join(ROOT, "build", "smoke_soak28")
        shutil.rmtree(self.root, ignore_errors=True)
        os.makedirs(self.root)
        t0 = time.perf_counter()
        self.env = st.SoakEnv(self.root, SOAK28_SCENES, SOAK_SHAPE, "cuda")
        disk = sum(os.path.getsize(p) for p in self.env.paths)
        scene_b = _bucket(SOAK_SHAPE[0]) * _bucket(SOAK_SHAPE[1]) * 4
        log(f"phases 28-29: {SOAK28_SCENES} scenes of {SOAK_SHAPE[0]} x "
            f"{SOAK_SHAPE[1]} int16, one a product and date "
            f"({disk} B uncompressed, tiled 256) written + crawled in "
            f"{time.perf_counter() - t0:.1f} s; resident as padded f32 "
            f"{scene_b} B a scene, {SOAK28_SCENES * scene_b} B for all")
        return self.env

    def __exit__(self, *exc):
        self.env.close()
        shutil.rmtree(self.root, ignore_errors=True)


def phase_soak_ops(card, env):
    """28: `tools/soak_torch.py`'s overload, ingest and fleet on the card
    over `SoakArchive`'s four Landsat-size dates, each through the
    tool's own scenario function with the default serving path, and
    each held to the tool's criteria; no page pinned at the end of any
    served process, no plain-version call; the phase's first B1 and B2
    launch of each method (`CheckWide`) and its first B4 launch (the
    fleet's remote tiles, mosaicked in this process) held against their
    plain versions.  The worker nodes warp in plain torch (the
    reference's gather), so no kernel of theirs is counted; their
    launch counts (`worker_info`) are logged.  Returns (launches by
    kernel, max |diff| by kernel)."""
    import torch
    from gsky_tpu_torch.ops import first_valid
    st = soak_tool()
    kernels = _kernel_counts()
    outs, launches, secs = {}, {}, {}
    args = st.parse_args(["--seconds", str(SOAK28_S),
                          "--conc", str(SOAK28_CONC)])
    # phase 1 built the kernels: no prewarm in the soak's servers, so
    # that the first launches held are the scenarios' own; the worker
    # nodes prewarm before they listen, as deployed nodes do (their
    # own kernels: none of their launches is held here)
    env.prewarm = False
    with WavesOn():
        torch.cuda.synchronize()
        chk = CheckWide((256, 256), what="28")
        b4 = CaptureFirst(first_valid, "mosaic_first_valid_kernel")
        plain = PlainCalls()
        try:
            for name in SOAK28_RUNS:
                reset_counts(kernels)
                t0 = time.perf_counter()
                try:
                    outs[name] = st.RUNS[name](env, args)
                finally:
                    env.close()
                secs[name] = time.perf_counter() - t0
                launches[name] = read_counts(kernels)
        finally:
            plain.remove()
            b4.remove()
            chk.remove()
    for name in SOAK28_RUNS:
        out, ok = outs[name]
        log(f"phase 28 {name}: {json.dumps(out)}")
        log(f"phase 28 {name}: {'passed' if ok else 'FAILED'} in "
            f"{secs[name]:.1f} s, launches {launches[name]} ({card})")
    failed = {n: outs[n][0].get("unmet") for n in SOAK28_RUNS
              if not outs[n][1]}
    if failed:
        raise AssertionError(f"28: the soak failed, unmet: {failed}")
    ov, ing, fl = (outs[n][0] for n in SOAK28_RUNS)
    holds = [h["hold_s"] for h in ov["cancellation"]["holds"]
             if h["answer"] == "cancelled"]
    log(f"phase 28 overload: storm at {ov['phases']['storm_conc']} "
        f"{ov['phases']['storm']}, sheds {ov['sheds']}, adjustments "
        f"{ov['adjustments']} ({ov['adjustments_since_reconfigure']} "
        f"since the knobs), cancellations {ov['cancellation']['fired']}"
        f" (holds cancelled {holds}; stages "
        f"{ov['cancel']['stages']}), drained "
        f"{ov['cancellation']['drained']}, clamp {ov['clamp']}, "
        f"brownout labels {ov['brownout_labelled']}, recovery "
        f"{ov['phases']['recovery_ok']} of 3")
    legs = ("baseline", "ranged", "prefetch")
    log("phase 28 ingest: " + "; ".join(
        f"{leg} {ing[leg]['bytes_read']} B read "
        f"({ing[leg]['ranged_windows']} ranged windows), p50 "
        f"{ing[leg]['p50_ms']} ms" for leg in legs)
        + f"; planner hit rate {ing['prefetch']['planner']['hit_rate']}"
        f" ({ing['prefetch']['planner']['hit']} hit, "
        f"{ing['prefetch']['planner']['miss']} miss, "
        f"{ing['prefetch']['planner']['declined_budget']} declined for "
        f"budget); card after each leg's close "
        f"{[ing[leg].get('card_after_close') for leg in legs]}")
    log(f"phase 28 fleet: locality {fl['locality']}, rerouted "
        f"{fl['rerouted']} of {fl['routed']}, kill phase "
        f"{fl['kill_phase']}, revived {fl['revived_state']}, hedge "
        f"p99 {fl['hedge'].get('hedged_p99_ms')} ms hedged / "
        f"{fl['hedge'].get('unhedged_p99_ms')} unhedged "
        f"({fl['hedge'].get('hedge_wins')} wins of "
        f"{fl['hedge'].get('hedges')} hedges), stitched traces "
        f"{fl['stitched_traces']}; nodes' VmRSS MB and launches "
        f"{fl['node_rss']}")
    pools = {"overload": ov["pool"], "fleet": fl["pool"],
             **{f"ingest/{leg}": ing[leg]["pool"] for leg in legs}}
    pinned = {k: p["pinned"] for k, p in pools.items() if p["pinned"]}
    if pinned:
        raise AssertionError(f"28: pages pinned at the end: {pinned}")
    if plain.calls:
        raise AssertionError(f"28: {plain.calls} plain-version calls "
                             f"on the card")
    errs = {}
    for k in ("B1", "B2"):
        held = [v for (kk, _), v in chk.errs.items() if kk == k]
        if not held:
            raise AssertionError(f"28: no {k} launch held against its "
                                 f"plain version ({launches})")
        errs[k] = max(held)
    if b4.args is None:
        raise AssertionError(f"28: no B4 launch ({launches})")
    saved = first_valid.first_valid_kernel.launches
    b4_same(first_valid.mosaic_first_valid_kernel(*b4.args[0]),
            first_valid.mosaic_first_valid_plain(*b4.args[0]),
            "28 B4 vs plain")
    first_valid.first_valid_kernel.launches = saved
    errs["B4"] = 0.0
    log(f"phase 28: the first B1 and B2 launch of each method against "
        f"their plain versions on the same inputs, max |diff| "
        f"{sorted(chk.errs.items())}; the first B4 launch "
        f"({tuple(b4.args[0][0].shape)}) bit-exact")
    total = {k: sum(launches[n][k] for n in SOAK28_RUNS) for k in kernels}
    if not total["B4"] or not launches["fleet"]["B4"]:
        raise AssertionError(f"28: the fleet's remote tiles launched no "
                             f"B4: {launches}")
    return total, errs


def phase_28_alone(card):
    """``--phase 28``: phase 28 alone (after phase 1); no result line."""
    os.environ["GSKY_PREFETCH"] = "0"
    t0 = time.perf_counter()
    with SoakArchive() as env:
        launches, errs = phase_soak_ops(card, env)
    log(f"phase 28: launches {launches}, max |diff| {errs} "
        f"({time.perf_counter() - t0:.1f} s)")
    return 0


# -- phase 29: the soak's occupancy, algebra and animation on the card --

# 29: each scenario's --seconds; the occupancy's legs are half of it,
# the reference's shortest (8 s)
SOAK29_S = {"occupancy": 16.0, "algebra": 5.0, "animation": 5.0}
SOAK29_RUNS = tuple(SOAK29_S)


def phase_soak_waves(card, env):
    """29: `tools/soak_torch.py`'s occupancy, algebra and animation on
    the card over `SoakArchive`'s four Landsat-size dates, each through
    the tool's own scenario function on the default serving path (the
    scenarios set their wave knobs), each held to the tool's criteria
    but those read on the host's clock (`HOST_CLOCK`: the occupancy's
    gap comparison, logged, C.26); no page pinned at the end of any, no
    plain-version call; the
    phase's first B1 launch of each method and n_ns (`CheckWide`: the
    algebra's expression lanes at n_ns 2 beside the tiles' n_ns 1) and
    its first B3 launch in each form it took (the drill's per call, the
    waves' K-block form) held against their plain versions.  Returns
    (launches by kernel, B3's K-block form counted in B3, max |diff| by
    kernel)."""
    import torch
    from gsky_tpu_torch.ops import stats
    from gsky_tpu_torch.pipeline import drill
    st = soak_tool()
    kernels = {**_kernel_counts(), "B3K": stats.masked_stats_many_kernel}
    outs, launches, secs = {}, {}, {}
    # no prewarm: the first launches held are the scenarios' own
    env.prewarm = False
    # this process holds every earlier phase's objects: each full
    # collection would scan them inside the storms whose gaps the
    # occupancy reads, pauses a server that starts here does not pay;
    # they are frozen out of the collector for the phase (timed: one
    # full collection over them), and the phase's own collections timed
    t0 = time.perf_counter()
    gc.collect()
    full_ms = (time.perf_counter() - t0) * 1e3
    gc.freeze()
    frozen = gc.get_freeze_count()
    pauses = {0: [], 1: [], 2: []}
    started = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses[info["generation"]].append(
                (time.perf_counter() - started[0]) * 1e3)

    gc.callbacks.append(on_gc)
    with WavesOn():
        torch.cuda.synchronize()
        chk = CheckWide((256, 256), what="29", by_ns=True)
        b3 = {"B3": CaptureFirst(drill, "masked_stats"),
              "B3K": CaptureFirst(stats, "masked_stats_many")}
        plain = PlainCalls()
        try:
            for name in SOAK29_RUNS:
                reset_counts(kernels)
                t0 = time.perf_counter()
                try:
                    outs[name] = st.RUNS[name](env, st.parse_args(
                        ["--seconds", str(SOAK29_S[name])]))
                finally:
                    env.close()
                secs[name] = time.perf_counter() - t0
                launches[name] = read_counts(kernels)
        finally:
            plain.remove()
            for cap in b3.values():
                cap.remove()
            chk.remove()
            gc.callbacks.remove(on_gc)
            gc.unfreeze()
    log(f"phase 29: {frozen} objects of earlier phases frozen out of the "
        f"collector (one full collection over them {full_ms:.1f} ms); "
        f"the phase's collections by generation: " + ", ".join(
            f"{g}: {len(v)}, max {max(v, default=0.0):.2f} ms, total "
            f"{sum(v):.1f} ms" for g, v in pauses.items()))
    for name in SOAK29_RUNS:
        out, ok = outs[name]
        log(f"phase 29 {name}: {json.dumps(out)}")
        log(f"phase 29 {name}: {'passed' if ok else 'FAILED'} in "
            f"{secs[name]:.1f} s, launches {launches[name]} ({card})")
    # held: every criterion but those read on the host's clock, which
    # are reported (C.26)
    held = {n: [c for c in outs[n][0]["unmet"]
                if c not in st.HOST_CLOCK.get(n, ())] for n in SOAK29_RUNS}
    failed = {n: unmet for n, unmet in held.items() if unmet}
    if failed:
        raise AssertionError(f"29: the soak failed, unmet: {failed}")
    oc, al, an = (outs[n][0] for n in SOAK29_RUNS)
    sy, pi = oc["synchronous"], oc["pipelined"]
    log(f"phase 29 occupancy, rounds {oc['rounds']}: gap p99 "
        f"{sy['gap_ms_p99']} ms synchronous / {pi['gap_ms_p99']} ms "
        f"pipelined ({oc['gap_p99_reduction_x']}x; p50 {sy['gap_ms_p50']}"
        f" / {pi['gap_ms_p50']}, p90 {sy['gap_ms_p90']} / "
        f"{pi['gap_ms_p90']}, max {sy['gap_ms_max']} / "
        f"{pi['gap_ms_max']}; samples {sy['gap_samples']} / "
        f"{pi['gap_samples']}); rounds (p99, lead-in ms, idle fraction) "
        f"{[tuple(r.values()) for r in sy['rounds']]} / "
        f"{[tuple(r.values()) for r in pi['rounds']]}; staged waves "
        f"{pi['staged_waves']}, requests {sy['http']} / {pi['http']}; "
        f"the host-clock criteria {st.HOST_CLOCK['occupancy']} "
        f"{'met' if oc['unmet'] == [] else 'unmet'} (reported, C.26)")
    log(f"phase 29 algebra: {al['sources']} sources, {al['structures']} "
        f"structures, expression cache {al['expr_cache']}, fused "
        f"{al['fused']}, escape hatch over {al['escape_hatch_probe']} "
        f"byte-identical {al['escape_hatch_byte_identical']} (unfused "
        f"{al['escape_hatch_unfused']}, with data "
        f"{al['escape_hatch_with_data']}), requests {al['requests']}, "
        f"waves {al['waves']}")
    log(f"phase 29 animation: warm sequence {an['warm_amortisation']}, "
        f"requests {an['requests']}, cancellations "
        f"{an['cancellation']}, temporal {an['temporal']}, waves "
        f"{an['waves']}")
    pinned = {n: outs[n][0]["pool"]["pinned"] for n in SOAK29_RUNS
              if outs[n][0]["pool"]["pinned"]}
    if pinned:
        raise AssertionError(f"29: pages pinned at the end: {pinned}")
    if plain.calls:
        raise AssertionError(f"29: {plain.calls} plain-version calls on "
                             f"the card")
    total = {k: sum(launches[n][k] for n in SOAK29_RUNS) for k in kernels}
    held = {k[1]: v for k, v in chk.errs.items() if k[0] == "B1"}
    if not total["B1"] or not any(k.endswith("n_ns 2") for k in held) \
            or not any(k.endswith("n_ns 1") for k in held):
        raise AssertionError(f"29: B1 launches {total['B1']}, held "
                             f"{sorted(held)}: want tiles (n_ns 1) and "
                             f"expression lanes (n_ns 2)")
    if not total["B3"] + total["B3K"]:
        raise AssertionError(f"29: no B3 launch ({launches})")
    # each form's first launch again, beside its plain version on the
    # same inputs, bit-exact (B3's bound since phase 6); the launch
    # counts left as they were
    b3_shapes = {}
    for key, kernel, plain_fn in (
            ("B3", stats.masked_stats, stats.masked_stats_plain),
            ("B3K", stats.masked_stats_many, stats.masked_stats_many_plain)):
        if b3[key].args is None:
            continue
        a, k = b3[key].args
        saved = kernels[key].launches
        (s, c), (sp, cp) = kernel(*a, **k), plain_fn(*a, **k)
        kernels[key].launches = saved
        if not (torch.equal(s, sp) and torch.equal(c, cp)):
            raise AssertionError(f"29 {key}: kernel != plain")
        b3_shapes[key] = (f"{len(a[0])} x {tuple(a[0][0].shape)}"
                          if key == "B3K" else tuple(a[0].shape))
    log(f"phase 29: the first B1 launch of each method and n_ns against "
        f"its plain version, max |diff| {sorted(held.items())}; the first "
        f"B3 launch of each form bit-exact against its plain version "
        f"{b3_shapes}; launches {total} (B3K: B3's K-block form)")
    errs = {"B1": max(held.values()), "B3": 0.0}
    if any(k == "B2" for k, _ in chk.errs):
        errs["B2"] = max(v for (k, _), v in chk.errs.items() if k == "B2")
    total["B3"] += total.pop("B3K")
    return total, errs


def phase_29_alone(card):
    """``--phase 29``: phase 29 alone (after phase 1); no result line."""
    os.environ["GSKY_PREFETCH"] = "0"
    t0 = time.perf_counter()
    with SoakArchive() as env:
        launches, errs = phase_soak_waves(card, env)
    log(f"phase 29: launches {launches}, max |diff| {errs} "
        f"({time.perf_counter() - t0:.1f} s)")
    return 0


# -- phase 30: the soak's fabric and elastic on the card ----------------

# 30: each scenario's --seconds, the reference's documented commands
SOAK30_S = {"fabric": 20.0, "elastic": 30.0}
SOAK30_RUNS = tuple(SOAK30_S)


def phase_soak_nodes(card, env):
    """30: `tools/soak_torch.py`'s fabric and elastic on the card over
    `SoakArchive`'s four Landsat-size dates, their worker nodes on the
    card (a process each, a page journal each), each through the tool's
    own scenario function on the default serving path and held to the
    tool's criteria; no page pinned at the end of either, no
    plain-version call in this process; the phase's first B1 launch of
    each method (the seed laps' tiles, rendered here: `CheckWide`) and
    its first B4 launch (the remote tiles, mosaicked here) held against
    their plain versions; every node boot's executor on the card
    (``worker_info``'s ``platform``).  The nodes warp the Landsat
    granules in plain torch (the reference's gather: `WarpExecutor.
    warp_all`) and their prewarm, without layers, builds and launches
    nothing, so their launches (``worker_info``'s ``kernels``) are
    reported, not held.  Returns (launches here by kernel, the nodes'
    launches by kernel, max |diff| by kernel, node boots)."""
    import torch
    from gsky_tpu_torch.ops import first_valid
    st = soak_tool()
    kernels = _kernel_counts()
    outs, launches, secs = {}, {}, {}
    # no prewarm in the soak's servers: the first launches held are the
    # scenarios' own; the nodes prewarm before they listen, as deployed
    # nodes do
    env.prewarm = False
    with WavesOn():
        torch.cuda.synchronize()
        chk = CheckWide((256, 256), what="30")
        b4 = CaptureFirst(first_valid, "mosaic_first_valid_kernel")
        plain = PlainCalls()
        try:
            for name in SOAK30_RUNS:
                reset_counts(kernels)
                t0 = time.perf_counter()
                try:
                    outs[name] = st.RUNS[name](env, st.parse_args(
                        ["--seconds", str(SOAK30_S[name])]))
                finally:
                    env.close()
                secs[name] = time.perf_counter() - t0
                launches[name] = read_counts(kernels)
        finally:
            plain.remove()
            b4.remove()
            chk.remove()
    for name in SOAK30_RUNS:
        out, ok = outs[name]
        log(f"phase 30 {name}: {json.dumps(out)}")
        log(f"phase 30 {name}: {'passed' if ok else 'FAILED'} in "
            f"{secs[name]:.1f} s, launches {launches[name]}, on the nodes "
            f"{out.get('node_kernels')} ({card})")
    failed = {n: outs[n][0].get("unmet", outs[n][0].get("error"))
              for n in SOAK30_RUNS if not outs[n][1]}
    if failed:
        raise AssertionError(f"30: the soak failed, unmet: {failed}")
    fa, el = (outs[n][0] for n in SOAK30_RUNS)
    log(f"phase 30 fabric: storm {fa['storm']} (cache {fa['storm_cache']}"
        f"), recovery {fa['recovery']}, replay {fa['recovery_replay']}, "
        f"peer-served {fa['recovery_peer_served']}; the revived node "
        f"{fa['worker_refill']}; escape hatch {fa['fabric_off']}; nodes' "
        f"VmRSS MB {fa['node_rss']}")
    log(f"phase 30 elastic: decisions {el['decisions']}, counters "
        f"{el['counters']}, hand-off {el['handoff']} "
        f"({el['handoff_notes']}), p99 s {el['p99_s']}, responses "
        f"{el['responses']}, escape hatch {el['elastic_off']}; nodes' "
        f"VmRSS MB {el['node_rss']}")
    pinned = {n: outs[n][0]["pool"]["pinned"] for n in SOAK30_RUNS
              if outs[n][0]["pool"]["pinned"]}
    if pinned:
        raise AssertionError(f"30: pages pinned at the end: {pinned}")
    if plain.calls:
        raise AssertionError(f"30: {plain.calls} plain-version calls on "
                             f"the card")
    errs = {}
    held = [v for (k, _), v in chk.errs.items() if k == "B1"]
    if not held:
        raise AssertionError(f"30: no B1 launch held against its plain "
                             f"version ({launches})")
    errs["B1"] = max(held)
    if any(k == "B2" for k, _ in chk.errs):
        errs["B2"] = max(v for (k, _), v in chk.errs.items() if k == "B2")
    if b4.args is None:
        raise AssertionError(f"30: no B4 launch ({launches})")
    saved = first_valid.first_valid_kernel.launches
    b4_same(first_valid.mosaic_first_valid_kernel(*b4.args[0]),
            first_valid.mosaic_first_valid_plain(*b4.args[0]),
            "30 B4 vs plain")
    first_valid.first_valid_kernel.launches = saved
    errs["B4"] = 0.0
    total = {k: sum(launches[n][k] for n in SOAK30_RUNS) for k in kernels}
    nodes = {k: sum(int((outs[n][0].get("node_kernels") or {}).get(s, 0))
                    for n in SOAK30_RUNS for s in syms)
             for k, syms in WORKER_SYMBOLS.items()}
    log(f"phase 30: the first B1 launch of each method against its plain "
        f"version, max |diff| {sorted(chk.errs.items())}; the first B4 "
        f"launch ({tuple(b4.args[0][0].shape)}) bit-exact; launches here "
        f"{total}, on the nodes {nodes}")
    if not total["B4"] or not all(launches[n]["B4"] for n in SOAK30_RUNS):
        raise AssertionError(f"30: a scenario's remote tiles launched no "
                             f"B4: {launches}")
    boots = {f"{n} {b}": p for n in SOAK30_RUNS
             for b, p in outs[n][0]["boot_platforms"].items()}
    off_card = {b: p for b, p in boots.items() if p != "cuda"}
    if off_card or not boots:
        raise AssertionError(f"30: node boots off the card: {off_card}")
    log(f"phase 30: {len(boots)} node boots, each rendering on the card "
        f"(worker_info platform cuda)")
    return total, nodes, errs, len(boots)


def phase_30_alone(card):
    """``--phase 30``: phase 30 alone (after phase 1): its JSON line of
    launches here and on the nodes by kernel, with each kernel's max
    |diff| against its plain version, before the card's line; no
    result line."""
    os.environ["GSKY_PREFETCH"] = "0"
    t0 = time.perf_counter()
    with SoakArchive() as env:
        launches, nodes, errs, boots = phase_soak_nodes(card, env)
    log(f"phase 30: launches {launches}, on the nodes {nodes} ({boots} "
        f"boots), max |diff| {errs} ({time.perf_counter() - t0:.1f} s)")
    names = {"B1": "paged_render (B1)", "B2": "warp_render (B2)",
             "B3": "masked_stats (B3)", "B4": "first_valid (B4)"}
    print(json.dumps({"phase": 30, "kernels": [
        {"name": names[k], "launches": launches[k],
         "node_launches": nodes[k], "max_abs_err": errs.get(k)}
        for k in names]}), flush=True)
    print(f"card: {card}", flush=True)
    return 0


def torch_equal(a, b):
    import torch
    return bool(torch.equal(a, b))


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
    if sys.argv[1:] == ["--phase", "26"]:
        return phase_26_alone(card)
    if sys.argv[1:] == ["--phase", "27"]:
        return phase_27_alone(card)
    if sys.argv[1:] == ["--phase", "28"]:
        return phase_28_alone(card)
    if sys.argv[1:] == ["--phase", "29"]:
        return phase_29_alone(card)
    if sys.argv[1:] == ["--phase", "30"]:
        return phase_30_alone(card)

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
    # the prefetch planner warms through the first server it saw: off
    # until phase 20f, which measures it
    os.environ["GSKY_PREFETCH"] = "0"

    # -- phase 23a, and the worker nodes of phase 23, started now ------
    phase_grpc_probe()
    fleet = Fleet()
    atexit.register(fleet.close)
    workers_ready = fleet.start(2)
    fleet23 = dict.fromkeys(_kernel_counts(), 0)

    def add23(launches):
        for k in fleet23:
            fleet23[k] += launches[k]

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
            got, _ = render(cpu, data_root, boxes[:CPU_TILES], method)
            compare_tiles(method, card_tiles[method][:CPU_TILES], got,
                          "card vs cpu")
            for zoom in ZOOMS:
                got, _ = render(cpu, data_root,
                                zoom_boxes(zoom)[:CPU_TILES], method)
                compare_tiles(method, zoom_tiles[(zoom, method)][:CPU_TILES],
                              got, f"card vs cpu at {zoom}x")
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

        # -- phase 26: the output tiles of B1 and B2, the adapter tier ----
        # (here, while the store holds phase 3's archive alone: later
        # phases ingest copies of it that they delete)
        t0 = time.perf_counter()
        tiles26 = phase_tiles(pipe, data_root, store, card)
        log(f"phase 26: launches {tiles26} "
            f"({time.perf_counter() - t0:.1f} s)")

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

        # -- phase 20a, b, d, f: the serving path under load --------------
        t0 = time.perf_counter()
        srv20 = phase_serving(data_root, data_paths, store, card)
        t20 = time.perf_counter() - t0
        log(f"phase 20a, b, d, f: launches {srv20} ({t20:.1f} s)")

        # -- phase 21a-d: observability on the card ----------------------
        t0 = time.perf_counter()
        obs21, obs21_err = phase_obs(data_root, data_paths, card)
        log(f"phase 21a-d: launches {obs21} "
            f"({time.perf_counter() - t0:.1f} s)")

        # -- phase 22: the device guard, prewarm, the encode pool ---------
        guard22 = phase_guard(data_root, data_paths, card)

        # -- phase 23e, 23f, 24e: the OWS drain, WCS over
        # ows_cluster_nodes, the fabric's peer replay --------------------
        t0 = time.perf_counter()
        fab24e = phase_ows_fleet(data_root, data_paths, card)
        log(f"phase 23e (OWS), 23f, 24e: {time.perf_counter() - t0:.1f} s")

        # -- phase 25a, b, d (GetMap), e: the mesh, virtual on one card ---
        t0 = time.perf_counter()
        mesh25 = phase_mesh(data_root, data_paths, card)
        log(f"phase 25a, b, d, e: launches {mesh25} "
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
        b3_launches, b3_args, b3_wave_launches, b3_wps, mesh25c = \
            phase_drill(drill_root, card)
        b3_row = time_b3(b3_args, card)

        # -- phase 23c: the worker's drill op ---------------------------
        t0 = time.perf_counter()
        workers = workers_ready()
        add23(phase_fleet_drill(drill_root, fleet, workers, card))
        log(f"phase 23c: {time.perf_counter() - t0:.1f} s")
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

        # -- phase 25d: mosaics over config 3's dates with GSKY_SPMD ------
        t0 = time.perf_counter()
        mesh25m = phase_mesh_mosaic(mosaic_root, mosaic, card)
        log(f"phase 25d mosaics: {time.perf_counter() - t0:.1f} s")

        # -- phase 17b: GetFeatureInfo on the masked layer (B4) -----------
        t0 = time.perf_counter()
        b4_gfi = phase_ows_gateway_masked(mosaic_root, mosaic, card)
        log(f"phase 17b: {time.perf_counter() - t0:.1f} s")

        # -- phase 20c: deadlines and a client gone, the masked layer -----
        t0 = time.perf_counter()
        dl20 = phase_deadline(mosaic_root, mosaic, card)
        t20 += time.perf_counter() - t0
        log(f"phase 20c: launches {dl20} ({time.perf_counter() - t0:.1f} s)")

        # -- phase 23b, 23d, 23e: remote tiles, failover, hedging, drain -
        t0 = time.perf_counter()
        add23(phase_fleet_masked(mosaic_root, mosaic, fleet, workers, card))
        sat_ready = fleet.start(1)       # for 23b's swath, phase 18's block
        # phase 24's workers boot while phase 14b's archive is written
        # (set-up); their journals go under phase 18's root
        sat_root = os.path.join(ROOT, "build", "smoke_sat")
        fab_ready = start_fabric_workers(fleet, sat_root)
        log(f"phase 23b masked, 23d, 23e (worker): "
            f"{time.perf_counter() - t0:.1f} s")
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

    # -- phase 18: the grids and formats of satellite archives ---------
    shutil.rmtree(sat_root, ignore_errors=True)
    os.makedirs(sat_root)
    try:
        t0 = time.perf_counter()
        sat, sat_odd, sat_drill_rel = phase_sat(sat_root, card)
        log(f"phase 18: launches {sat}; drills card vs CPU within rel "
            f"{sat_drill_rel}; {time.perf_counter() - t0:.1f} s")

        # -- phase 23b: the curvilinear swath from the workers ----------
        t0 = time.perf_counter()
        swath = os.path.join(sat_root, "swath")
        store23 = crawl([(os.path.join(swath, "MOD021KM.A2020015.nc"), None),
                         (os.path.join(swath, "MOD021KM.A2020016.nc"), None,
                          lambda r: sub_geo_loc(r, SAT_SWATH_SUB))])
        add23(phase_fleet_swath(sat_root, store23, fleet,
                                [workers[0]] + sat_ready(), card))
        log(f"phase 23b swath: {time.perf_counter() - t0:.1f} s")

        # -- phase 24a-d: the cache fabric and the elastic fleet ----------
        t0 = time.perf_counter()
        fab24 = phase_fabric(sat_root, store23, fleet, fab_ready, card)
        log(f"phase 24a-d: launches on the workers {fab24}, on 24e's "
            f"gateways {fab24e} ({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(sat_root, ignore_errors=True)
    fleet.close()
    log(f"phase 23: launches here and on the workers {fleet23}")

    # -- phase 19: the native codec, ranged ingest, a MAS over HTTP ----
    t0 = time.perf_counter()
    n_codec = phase_codec(card)
    ing_root = os.path.join(ROOT, "build", "smoke_ingest")
    shutil.rmtree(ing_root, ignore_errors=True)
    os.makedirs(ing_root)
    try:
        ing, ing_err, be20 = phase_ingest(ing_root, card,
                                          serving=phase_backend)
        log(f"phase 20c (WPS), 20e: launches {be20}")
        log(f"phase 19: {n_codec} codec comparisons; launches {ing}; "
            f"captured launches against their plain versions, max |diff| "
            f"{ing_err}; {time.perf_counter() - t0:.1f} s ({card})")
    finally:
        shutil.rmtree(ing_root, ignore_errors=True)

    # -- phase 27: the soak's churn and a wcs lap -----------------------
    t0 = time.perf_counter()
    soak27, soak27_err = phase_soak(card)
    log(f"phase 27: launches {soak27} ({time.perf_counter() - t0:.1f} s)")

    # -- phases 28 and 29: the soak's overload, ingest and fleet, then
    # its occupancy, algebra and animation, over one archive -----------
    t0 = time.perf_counter()
    with SoakArchive() as env:
        soak28, soak28_err = phase_soak_ops(card, env)
        log(f"phase 28: launches {soak28} "
            f"({time.perf_counter() - t0:.1f} s, the archive included)")
        t0 = time.perf_counter()
        soak29, soak29_err = phase_soak_waves(card, env)
        log(f"phase 29: launches {soak29} "
            f"({time.perf_counter() - t0:.1f} s)")

    # the kernels line reports the bilinear rows (the GetMap default
    # interpolated method): B1 at phase 3's tile, B2 at input (c), the
    # 4x zoomed-out tile; every method's and input's numbers are logged
    # above.  Launches: every main path's run, phase 13's wave runs
    # included (B1 over a wave's lanes, B3's K-block form), and phase
    # 14's (B1: expression tiles per call and in waves; B2: the RGB
    # planes rung and the modular route), and phase 17's (B1: gateway
    # misses, JPEG tiles and clicks; B2: JPEG tiles of the planes rung;
    # B4: clicks on the masked layer), and phase 18's (every kernel;
    # B1 and B2's max_abs_err includes its out-of-domain checks), and
    # phase 19's (every kernel; its captured launches held against their
    # plain versions), and phase 20's (B1: batched flushes, admitted,
    # browned-out, prefetched and fault-retried tiles; B2: the tile
    # whose staging critical pressure declined; B3: the drill after the
    # 504; B4: the masked tile after the 504), and phase 21's (B1 and
    # B2: traced, untraced and profiled tiles; B3 and B4: the profiled
    # drill and masked tile, in be20 and dl20), and phase 22's (B1: the
    # guard's rounds, the incidents' tiles, healthy waves, the encode
    # pool's tiles; B2: the failed wave's per-call legs), and phase 23's
    # (B4 here: the remote tiles' mosaics; B1 and B2 on the workers: the
    # swath's warps; B3 on a worker: its drill op), and phase 24's (B1:
    # the swath's warps on the fabric's workers, 24e's renders on the
    # replay gateways), and phase 25's (the virtual mesh: B1 a member a
    # granule wave, B2 a member a block of the x layout and a GSKY_SPMD
    # tile or mosaic, B3 a member a time wave or GSKY_SPMD reduction),
    # and phases 27's, 28's and 29's (the soak's scenarios: B1 and B2
    # their tiles, B1 the algebra's expression lanes and the animation's
    # frames, B3 the drills in both forms, B4 the fleet's remote tiles
    # mosaicked here)
    m, err1, ms1, pms1, bd1 = b1_rows[1]
    ms2, _, pms2, bd2, _, _ = b2_rows[("c", "bilinear")]
    b3_ms, b3_pms, b3_bd, b3_lib, b3_main_err = b3_row
    kernels = {"kernels": [
        {"name": "paged_render (B1)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/warp_render.cu",
         "replaces": "gsky_tpu/ops/paged.py:173",
         "launches": b1_launches + b1_waves + b1_anim + b1_expr
         + wcs_launches["B1"] + gw_launches["B1"] + sat["B1"]
         + ing["B1"] + srv20["B1"] + dl20["B1"] + be20["B1"]
         + obs21["B1"] + guard22["B1"] + fleet23["B1"] + fab24["B1"]
         + fab24e["B1"] + mesh25["B1"] + tiles26["B1"] + soak27["B1"]
         + soak28["B1"] + soak29["B1"],
         "max_abs_err": max(max(r[1] for r in b1_rows), wide_err, sat_odd,
                            ing_err["B1"], obs21_err, soak27_err["B1"],
                            soak28_err["B1"], soak29_err["B1"],
                            max(v for (k, _), v in wcs_errs.items()
                                if k == "B1")),
         "ms": ms1, "plain_ms": pms1, "bound_ms": bd1,
         "bound_by": "bytes", "library_ms": None},
        {"name": "warp_render (B2)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/warp_render.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:456",
         "launches": b2_launches + b2_rgb + wcs_launches["B2"]
         + gw_launches["B2"] + sat["B2"] + ing["B2"] + srv20["B2"]
         + dl20["B2"] + be20["B2"] + obs21["B2"] + guard22["B2"]
         + fleet23["B2"] + fab24.get("B2", 0) + fab24e["B2"]
         + mesh25["B2"] + mesh25m + tiles26["B2"] + soak27["B2"]
         + soak28["B2"] + soak29["B2"],
         "max_abs_err": max(max(r[5] for r in b2_rows.values()),
                            wide_err, sat_odd, ing_err["B2"],
                            soak27_err["B2"], soak28_err["B2"],
                            soak29_err.get("B2", 0.0),
                            max(v for (k, _), v in wcs_errs.items()
                                if k == "B2")),
         "ms": ms2, "plain_ms": pms2, "bound_ms": bd2,
         "bound_by": "bytes", "library_ms": None},
        {"name": "masked_stats (B3)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/masked_stats.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:362",
         "launches": b3_launches + b3_wave_launches + b3_wps + sat["B3"]
         + ing["B3"] + srv20["B3"] + dl20["B3"] + be20["B3"]
         + fleet23["B3"] + mesh25c["B3"] + mesh25c["B3K"]
         + soak28["B3"] + soak29["B3"],
         "max_abs_err": max(b3_err, b3_main_err, b3k_err, ing_err["B3"],
                            soak29_err["B3"]),
         "ms": b3_ms, "plain_ms": b3_pms, "bound_ms": b3_bd,
         "bound_by": "bytes", "library_ms": b3_lib},
        {"name": "first_valid (B4)", "route": "cuda",
         "source": "gsky_tpu_torch/csrc/first_valid.cu",
         "replaces": "gsky_tpu/ops/pallas_tpu.py:308",
         "launches": b4_launches + b4_wcs + b4_gfi + sat["B4"] + ing["B4"]
         + srv20["B4"] + dl20["B4"] + be20["B4"] + fleet23["B4"]
         + soak28["B4"] + soak29["B4"],
         "max_abs_err": max(b4_row[4], ing_err["B4"], soak28_err["B4"]),
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
